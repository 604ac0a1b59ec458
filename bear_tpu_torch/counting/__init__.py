"""Host read encoding, the dense transition counter and its histogram
kernel."""

from bear_tpu_torch.counting.engine import (
    ReadChunk,
    TransitionCounter,
    chunk_reads,
    split_ambiguous,
    table_rows,
)

__all__ = ["ReadChunk", "TransitionCounter", "chunk_reads",
           "split_ambiguous", "table_rows"]
