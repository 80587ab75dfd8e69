"""Hand-written Hopper kernels of the inner filter step, each beside its
plain PyTorch version: ``resample_walk`` (CUDA C++, systematic resample +
ancestor gather), ``resample_sorted`` (CUDA C++, resample + ancestor gather
on explicit sorted grids), ``propagate`` (Triton, fused propagate +
reweight + normalize, for every model) and ``ucsv`` (CUDA C++, fused UC-SV
propagate + reweight, the auxiliary filter's second stage). ``_build``
compiles the CUDA sources at first use."""
from .propagate import ElementwiseUpdate, fused_elementwise_step
from .resample_sorted import resample_gather_sorted, stratified_uniforms, systematic_uniforms
from .resample_walk import count_ancestors, resample_gather
from .ucsv import ucsv_propagate_reweight

__all__ = [
    "ElementwiseUpdate",
    "count_ancestors",
    "fused_elementwise_step",
    "resample_gather",
    "resample_gather_sorted",
    "stratified_uniforms",
    "systematic_uniforms",
    "ucsv_propagate_reweight",
]
