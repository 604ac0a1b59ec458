"""Model loading, batch serving (MAP and posterior-sampled, sequences and
variant Δ-scores), posterior-predictive scoring and assembly."""

from bear_tpu_torch.inference.assemble import assemble_no_ends
from bear_tpu_torch.inference.scoring import (
    DatasetCounter,
    SparseTableIndex,
    TableCounter,
    get_bear_probs,
    get_bear_probs_seqs,
    get_pdf,
    load_bear,
    load_bear_dataset,
    model_column_names,
    parse_var,
)
from bear_tpu_torch.inference.serving import (
    BearServer,
    contexts_to_rows,
    table_from_dataset,
)

__all__ = ["BearServer", "assemble_no_ends", "DatasetCounter", "TableCounter", "contexts_to_rows",
           "get_bear_probs", "get_bear_probs_seqs", "get_pdf", "load_bear",
           "SparseTableIndex",
           "load_bear_dataset", "model_column_names", "parse_var",
           "table_from_dataset"]
