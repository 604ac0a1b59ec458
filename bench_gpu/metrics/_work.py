"""The yardstick's arithmetic: the chip's peaks, and the operations and
bytes that the algorithms need, counted from shapes alone (never from a
build of a kernel, so that no later kernel can read above its bound).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W
limit: 67 TFLOP/s in float32 outside the tensor cores (the port keeps TF32
off), 3.35 TB/s of HBM.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# Operations of the library routines and steps of one keyed draw, each
# library routine (log, exp, sin, cos, sqrt, division) counted as one.
PHILOX_BLOCK_OPS = 98  # 10 rounds of 2 wide multiplies (2 each), 4 xors; 9 key bumps of 2 adds
WORD_TO_UNIFORM_OPS = 4  # shift, convert, add, multiply
NORMAL_OPS = 4  # per normal: half of (log, multiply, sqrt, angle multiply), one sin or cos, one product
EXPONENTIAL_OPS = 2  # log, negate
PROPOSAL_OPS = 12  # t = 1 + cc x (2), v = t^3 (2), log v, test 0.5 x x + d - d v + d log v (7)
FINISH_OPS = 3  # log d + log v - e / c: add, divide, subtract
ELEMENT_OPS = 5  # per category, shared by the samples: d = c + 2/3, cc = 1/sqrt(9 d), log d


def cnn_forward_flops(config) -> int:
    """Model FLOPs of one row through the CNN AR: the VALID convolution
    (conv_len x fw x A1 x nf multiply-adds), the dense layer over all conv
    outputs (conv_len x nf x w1) and the head (w1 x A1), two FLOPs a
    multiply-add; normalisations and activations are not counted."""
    m = config["model"]
    lag, A1 = config["lag"], config["alphabet_size"] + 1
    fw, nf, w1 = m["filter_width"], m["num_filters"], m["kmer_layer1_width"]
    cl = lag - fw + 1
    return 2 * (cl * fw * A1 * nf + cl * nf * w1 + w1 * A1)


def count_chunk_bytes(rows: int, read_len: int, sectors: int) -> int:
    """Bytes a count_chunk launch must move: its codes (B L), its row meta
    (four int32 a row) and each distinct 32-byte table sector its keys
    touch, read and written once."""
    return rows * read_len + 16 * rows + 2 * 32 * sectors


def keyed_draw_ops(samples: int, elements: int, A1: int) -> float:
    """Operations of samples x elements picked draws of A1 categories on the
    path where every first proposal is accepted: per draw one fold_in block
    and the Philox words of A1 normals, A1 accept-test and A1 boost
    exponentials, their conversions, Box-Muller, one proposal per category,
    the boost, and the pick (logsumexp over A1 and one subtraction); per
    element the categories' shared constants."""
    words = 3 * A1
    per_draw = (PHILOX_BLOCK_OPS + PHILOX_BLOCK_OPS * words / 4 + WORD_TO_UNIFORM_OPS * words
                + NORMAL_OPS * A1 + EXPONENTIAL_OPS * 2 * A1
                + (PROPOSAL_OPS + FINISH_OPS) * A1 + 4 * A1 + 1)
    return samples * elements * per_draw + elements * ELEMENT_OPS * A1


def keyed_draw_bytes(samples: int, elements: int, A1: int, groups: int, itemsize: int) -> int:
    """Each input read once (the [samples, groups] int64 base keys, int64
    group and row, the concentrations, int32 next symbol of every element)
    and the [samples, elements] output written once."""
    return (samples * groups * 8 + elements * (8 + 8 + A1 * itemsize + 4)
            + samples * elements * itemsize)


def least_seconds(ops: float, nbytes: float):
    """(least seconds, what bounds it) of work of ``ops`` float32
    operations and ``nbytes`` of HBM traffic."""
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
