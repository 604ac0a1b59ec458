"""Probability constants (port of bear_tpu/ops/distributions.py).

Only ``EPSILON`` is needed by the count -> serve path; the Dirichlet-
multinomial and multinomial log-pmfs come with the training port.
"""

# Regulariser added to AR probabilities wherever the reference adds one
# (bear_net.py:43 and :68 in the reference; load_bear's ar_apply).
EPSILON = 1e-7
