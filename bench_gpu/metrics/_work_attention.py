"""The attention AR's arithmetic, counted from shapes alone: the model
FLOPs of one row through the block at the configuration's widths."""

from __future__ import annotations


def attention_forward_flops(config) -> int:
    """Model FLOPs of one row through the attention AR as the program
    evaluates it (only the last position's query, attention row, MLP and
    head), two FLOPs a multiply-add: the embedding of every position (lag x
    A1 x D), K and V at every position (2 x lag x D x D), the last query and
    ``wo`` (2 x D x D), its scores and context (2 x lag x D), the MLP (2 x D x
    M) and the head (D x A1). Normalisations, softmaxes and gelu are not
    counted."""
    m = config["model"]
    lag, A1 = config["lag"], config["alphabet_size"] + 1
    D, M = m["d_model"], m["mlp_width"]
    return 2 * (lag * A1 * D + 2 * lag * D * D + 2 * D * D + 2 * lag * D + 2 * D * M + D * A1)
