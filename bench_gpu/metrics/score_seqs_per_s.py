"""Sequences scored over the whole window's time."""


def read(run):
    return run.work["seqs"] / run.window_s
