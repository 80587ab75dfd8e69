from .base import broadcast_model, simulate
from .linear_gaussian import (
    LinearGaussianModel,
    hodrick_prescott,
    lg_model,
    multivariate_linear_gaussian,
    uc_model,
    univariate_linear_gaussian,
    unobserved_components,
)
from .stochastic_volatility import StochasticVolatilityModel, stochastic_volatility, sv_model
from .ucsv import UCSVModel, ucsv_model, ucsv_update

__all__ = [
    "LinearGaussianModel",
    "StochasticVolatilityModel",
    "UCSVModel",
    "broadcast_model",
    "hodrick_prescott",
    "lg_model",
    "multivariate_linear_gaussian",
    "simulate",
    "stochastic_volatility",
    "sv_model",
    "uc_model",
    "ucsv_model",
    "ucsv_update",
    "univariate_linear_gaussian",
    "unobserved_components",
]
