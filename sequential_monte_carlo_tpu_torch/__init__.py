"""sequential_monte_carlo_tpu_torch — the PyTorch port of
``sequential_monte_carlo_tpu`` for NVIDIA Hopper GPUs.

Same layer map as the JAX package, which stays the reference it is tested
against:
  distributions/  L0  distribution kit
  models/         L1  state-space models (UC-SV)
  ops/            L2  weight math, resamplers, the batched particle filter
  samplers/       L3  online SMC² with PMMH rejuvenation
  kernels/        L5  hand-written Hopper kernels (CUDA C++ and Triton)
  interop.py          state carried across from the JAX package (numpy)

This slice runs online SMC² on UC-SV with a bootstrap inner filter that
resamples systematically at every step. Nothing here imports JAX.
"""
from .distributions import Normal, Product, TupleProduct, Uniform, product_distribution
from .models import ucsv_model
from .ops import PFConfig
from .samplers import SMC2, SMCConfig, expected_parameters

__all__ = [
    "SMC2",
    "SMCConfig",
    "PFConfig",
    "ucsv_model",
    "Normal",
    "Uniform",
    "Product",
    "TupleProduct",
    "product_distribution",
    "expected_parameters",
]
