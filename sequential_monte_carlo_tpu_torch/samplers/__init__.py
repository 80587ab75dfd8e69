from .base import SMC2State, SMCConfig, StepInfo
from .density_tempered import TemperStage, density_tempered
from .smc2 import SMC2, expected_parameters

__all__ = ["SMC2", "SMC2State", "SMCConfig", "StepInfo", "TemperStage",
           "density_tempered", "expected_parameters"]
