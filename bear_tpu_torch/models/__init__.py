"""AR functions, BEAR training and evaluation, the reference-guided model,
vBEAR, lag selection and the training CLIs."""

from bear_tpu_torch.models.ar_funcs import CNNAR, LinearAR, StopAR, get_ar_func
from bear_tpu_torch.models.bear_ref import RefAR
from bear_tpu_torch.models.lag_selection import LagSelection, select_lag, select_lag_sparse
from bear_tpu_torch.models.vbear import VBearResult, train_variational_h

__all__ = ["CNNAR", "LagSelection", "LinearAR", "RefAR", "StopAR", "VBearResult",
           "get_ar_func", "select_lag", "select_lag_sparse", "train_variational_h"]
