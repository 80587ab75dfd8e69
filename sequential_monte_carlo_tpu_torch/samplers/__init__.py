from .base import SMC2State, SMCConfig, StepInfo
from .smc2 import SMC2, expected_parameters

__all__ = ["SMC2", "SMC2State", "SMCConfig", "StepInfo", "expected_parameters"]
