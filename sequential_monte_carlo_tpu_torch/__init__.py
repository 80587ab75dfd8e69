"""sequential_monte_carlo_tpu_torch — the PyTorch port of
``sequential_monte_carlo_tpu`` for NVIDIA Hopper GPUs.

Same layer map as the JAX package, which stays the reference it is tested
against:
  distributions/  L0  distribution kit
  models/         L1  the SSM protocol, state-space models (UC-SV,
                      linear-Gaussian, SV) and the declarative DSL
  ops/            L2  weight math, resamplers, the batched particle filter
                      and the per-θ filters (the batched one at one row),
                      the Kalman filter and smoother, the particle smoothers,
                      conditional SMC
  samplers/       L3  online SMC² (with the exchange step), IBIS and
                      density-tempered SMC, with PMMH rejuvenation; particle
                      Gibbs
  analysis/       L4  posterior summaries (weighted quantiles, SMC² and IBIS
                      summaries) and plotting (matplotlib, imported on use)
  parallel/       L4  SMC² and IBIS sharded over θ and particles with
                      torch.distributed: the launcher, the (theta,
                      particle) mesh, the particle-axis building blocks
  kernels/        L5  hand-written Hopper kernels (CUDA C++ and Triton)
  utils/              checkpoints, the CSV loader, debug and profiling helpers
  examples/           the inflation and linear-Gaussian examples and the SV and
                      UC-SV filtering animations
  interop.py          state and models carried across from the JAX package

The inner filter is the bootstrap, guided or auxiliary particle filter, with
any of the JAX package's resampling schemes, at every step or when the ESS
falls below a threshold. Entry points run on the device of the data they are
given. Nothing here imports JAX.
"""
from . import analysis, distributions, models, ops, parallel, samplers, utils
from .distributions import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .samplers import *  # noqa: F401,F403

__all__ = distributions.__all__ + models.__all__ + ops.__all__ + samplers.__all__
