from .base import StateSpaceModel, broadcast_model, model_rows, simulate
from .dsl import DSLModel, ModelSpec, linear_ssm_model, ssm_model
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
from .ucsv import UCSVModel, ucsv_model, ucsv_update, unobserved_components_stochastic_volatility

__all__ = [
    "DSLModel",
    "LinearGaussianModel",
    "ModelSpec",
    "StateSpaceModel",
    "StochasticVolatilityModel",
    "UCSVModel",
    "broadcast_model",
    "hodrick_prescott",
    "lg_model",
    "linear_ssm_model",
    "model_rows",
    "multivariate_linear_gaussian",
    "simulate",
    "stochastic_volatility",
    "ssm_model",
    "sv_model",
    "uc_model",
    "ucsv_model",
    "ucsv_update",
    "univariate_linear_gaussian",
    "unobserved_components",
    "unobserved_components_stochastic_volatility",
]
