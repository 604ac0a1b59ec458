"""Host read encoding, the dense transition counter and its histogram
kernel, multi-pass counting of lags 14-15 and the sparse-first counter of
lags 16-30."""

from bear_tpu_torch.counting.engine import (
    ReadChunk,
    TransitionCounter,
    chunk_reads,
    decode_rows,
    split_ambiguous,
    table_rows,
)
from bear_tpu_torch.counting.multipass import MultiPassTransitionCounter, count_multipass
from bear_tpu_torch.counting.sparse import SparseTransitionCounter, max_sparse_lag

__all__ = ["MultiPassTransitionCounter", "ReadChunk", "SparseTransitionCounter",
           "TransitionCounter", "chunk_reads", "count_multipass", "decode_rows",
           "max_sparse_lag", "split_ambiguous", "table_rows"]
