from .batched_filter import (
    BatchedPFOut,
    batched_log_likelihood,
    batched_log_likelihood_masked,
    batched_pf_init,
    batched_pf_step,
)
from .kalman import (
    KalmanState,
    kalman_filter,
    kalman_init,
    kalman_log_likelihood,
    kalman_log_likelihood_masked,
    kalman_step,
)
from .particle_filter import PFConfig, Proposal
from .resampling import (
    get_resampler,
    metropolis,
    multinomial,
    resample,
    residual,
    residual_systematic,
    stratified,
    systematic,
)
from .weights import Normalized, ess_from_log_weights, log_normalize, normalize, reweight

__all__ = [
    "BatchedPFOut",
    "KalmanState",
    "Normalized",
    "PFConfig",
    "Proposal",
    "batched_log_likelihood",
    "batched_log_likelihood_masked",
    "batched_pf_init",
    "batched_pf_step",
    "ess_from_log_weights",
    "get_resampler",
    "kalman_filter",
    "kalman_init",
    "kalman_log_likelihood",
    "kalman_log_likelihood_masked",
    "kalman_step",
    "log_normalize",
    "metropolis",
    "multinomial",
    "normalize",
    "resample",
    "residual",
    "residual_systematic",
    "reweight",
    "stratified",
    "systematic",
]
