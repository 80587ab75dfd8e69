"""Hand-written Hopper kernels of the inner filter step, each beside its
plain PyTorch version: ``resample_walk`` (CUDA C++, systematic resample +
ancestor gather), ``resample_sorted`` (CUDA C++, resample + ancestor gather
on explicit sorted grids) and ``propagate`` (Triton, fused propagate +
reweight + normalize). ``_build`` compiles the CUDA sources at first use."""
from .propagate import ElementwiseUpdate, fused_elementwise_step
from .resample_sorted import resample_gather_sorted, stratified_uniforms, systematic_uniforms
from .resample_walk import count_ancestors, resample_gather

__all__ = [
    "ElementwiseUpdate",
    "count_ancestors",
    "fused_elementwise_step",
    "resample_gather",
    "resample_gather_sorted",
    "stratified_uniforms",
    "systematic_uniforms",
]
