"""Host read encoding, the dense transition counter and its histogram
kernel, multi-pass counting of lags 14-15 and the sparse-first counter of
lags 16-30."""

from bear_tpu_torch.counting.engine import (
    ReadChunk,
    TransitionCounter,
    chunk_reads,
    chunks_from_packed,
    context_to_row,
    decode_rows,
    row_to_context,
    rows_to_contexts,
    split_ambiguous,
    table_rows,
)
from bear_tpu_torch.counting.multipass import MultiPassTransitionCounter, count_multipass
from bear_tpu_torch.counting.sparse import SparseTransitionCounter, max_sparse_lag

__all__ = ["MultiPassTransitionCounter", "ReadChunk", "SparseTransitionCounter",
           "TransitionCounter", "chunk_reads", "chunks_from_packed", "context_to_row",
           "count_multipass", "decode_rows", "max_sparse_lag", "row_to_context",
           "rows_to_contexts", "run_counting", "split_ambiguous", "table_rows"]


def __getattr__(name):
    # Lazy: summarize imports parallel.counting, which imports this package's
    # modules; an eager import here would cycle whenever bear_tpu_torch.parallel
    # loads first (PEP 562 re-export).
    if name == "run_counting":
        from bear_tpu_torch.counting.summarize import run_counting

        return run_counting
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
