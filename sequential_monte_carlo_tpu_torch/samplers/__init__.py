from .base import IBISState, SMC2State, SMCConfig, StepInfo
from .density_tempered import TemperStage, density_tempered
from .ibis import IBIS
from .smc2 import SMC2, expected_parameters

__all__ = ["IBIS", "IBISState", "SMC2", "SMC2State", "SMCConfig", "StepInfo", "TemperStage",
           "density_tempered", "expected_parameters"]
