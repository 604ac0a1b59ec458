"""Model loading, batch serving (MAP and posterior-sampled, sequences and
variant Δ-scores) and posterior-predictive scoring."""

from bear_tpu_torch.inference.scoring import (
    DatasetCounter,
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

__all__ = ["BearServer", "DatasetCounter", "TableCounter", "contexts_to_rows",
           "get_bear_probs", "get_bear_probs_seqs", "get_pdf", "load_bear",
           "load_bear_dataset", "model_column_names", "parse_var",
           "table_from_dataset"]
