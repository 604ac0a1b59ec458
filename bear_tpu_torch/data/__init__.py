"""Host-side data layer: count-file loaders and whole-dataset likelihoods."""

from bear_tpu_torch.data.likelihood import bmm_likelihood
from bear_tpu_torch.data.loaders import (
    CountDataset,
    count_kmers,
    discover_files,
    load_dense,
    load_dense_counts,
    load_files,
    load_files_cached,
    load_sparse,
)

__all__ = ["CountDataset", "bmm_likelihood", "count_kmers", "discover_files",
           "load_dense", "load_dense_counts", "load_files", "load_files_cached", "load_sparse"]
