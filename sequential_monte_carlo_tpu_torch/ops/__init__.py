from .batched_filter import (
    BatchedPFOut,
    batched_log_likelihood_masked,
    batched_pf_init,
    batched_pf_step,
)
from .particle_filter import PFConfig
from .resampling import get_resampler, multinomial, systematic
from .weights import ess_from_log_weights, log_normalize

__all__ = [
    "BatchedPFOut",
    "PFConfig",
    "batched_log_likelihood_masked",
    "batched_pf_init",
    "batched_pf_step",
    "ess_from_log_weights",
    "get_resampler",
    "log_normalize",
    "multinomial",
    "systematic",
]
