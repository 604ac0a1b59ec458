"""Set-up: process start to the first timed call (imports, the CUDA
context, the kernels' libraries, the traffic and weights made from the
seed, the program's set-up and the warm-up of the cell's own shapes)."""


def read(run):
    return run.setup_s
