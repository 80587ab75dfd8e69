"""sequential_monte_carlo_tpu_torch — the PyTorch port of
``sequential_monte_carlo_tpu`` for NVIDIA Hopper GPUs.

Same layer map as the JAX package, which stays the reference it is tested
against:
  distributions/  L0  distribution kit
  models/         L1  state-space models (UC-SV, linear-Gaussian, SV)
  ops/            L2  weight math, resamplers, the batched particle filter,
                      the Kalman filter
  samplers/       L3  online SMC² and density-tempered SMC, with PMMH
                      rejuvenation
  kernels/        L5  hand-written Hopper kernels (CUDA C++ and Triton)
  interop.py          state and models carried across from the JAX package

The inner filter is the bootstrap filter with systematic or stratified
resampling, at every step or when the ESS falls below a threshold. Entry
points run on the device of the data they are given. Nothing here imports
JAX.
"""
from .distributions import (
    LogNormal,
    MvNormal,
    Normal,
    Product,
    TruncatedNormal,
    TupleProduct,
    Uniform,
    product_distribution,
)
from .models import (
    hodrick_prescott,
    lg_model,
    multivariate_linear_gaussian,
    simulate,
    stochastic_volatility,
    sv_model,
    uc_model,
    ucsv_model,
    univariate_linear_gaussian,
    unobserved_components,
)
from .ops import (
    PFConfig,
    batched_log_likelihood,
    kalman_filter,
    kalman_log_likelihood,
    kalman_log_likelihood_masked,
    stratified,
)
from .samplers import SMC2, SMCConfig, TemperStage, density_tempered, expected_parameters

__all__ = [
    "SMC2",
    "SMCConfig",
    "PFConfig",
    "TemperStage",
    "density_tempered",
    "expected_parameters",
    "batched_log_likelihood",
    "kalman_filter",
    "kalman_log_likelihood",
    "kalman_log_likelihood_masked",
    "stratified",
    "simulate",
    "ucsv_model",
    "lg_model",
    "uc_model",
    "sv_model",
    "stochastic_volatility",
    "hodrick_prescott",
    "univariate_linear_gaussian",
    "multivariate_linear_gaussian",
    "unobserved_components",
    "Normal",
    "LogNormal",
    "TruncatedNormal",
    "Uniform",
    "MvNormal",
    "Product",
    "TupleProduct",
    "product_distribution",
]
