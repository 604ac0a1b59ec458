"""Alphabets, codecs, the probability core and the keyed sampler."""

from bear_tpu_torch.ops import alphabets, distributions, keyed_random, loggamma
from bear_tpu_torch.ops.alphabets import (
    alphabet_size,
    decode_kmers,
    encode_kmers,
    input_letters,
    one_hot,
    one_hot_kmers,
    output_letters,
)
from bear_tpu_torch.ops.distributions import (
    EPSILON,
    bmm_marginal_logpmf,
    dirichlet_multinomial_perm_logpmf,
    log_combinations,
    ml_output_dm,
    ml_output_mult,
    multinomial_perm_logpmf,
)
from bear_tpu_torch.ops.loggamma import log_gamma, log_gamma_pdf, sample_dirichlet_log

__all__ = ["alphabets", "distributions", "keyed_random", "loggamma", "EPSILON",
           "alphabet_size", "bmm_marginal_logpmf", "decode_kmers",
           "dirichlet_multinomial_perm_logpmf", "encode_kmers", "input_letters",
           "log_combinations", "log_gamma", "log_gamma_pdf", "ml_output_dm",
           "ml_output_mult", "multinomial_perm_logpmf", "one_hot", "one_hot_kmers",
           "output_letters", "sample_dirichlet_log"]
