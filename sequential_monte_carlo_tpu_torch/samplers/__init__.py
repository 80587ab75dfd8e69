from .base import IBISState, SMC2State, SMCConfig, StepInfo
from .density_tempered import TemperStage, density_tempered
from .ibis import IBIS
from .particle_gibbs import PGConfig, PGResult, complete_data_log_prob, particle_gibbs
from .smc2 import SMC2, expected_parameters

__all__ = ["IBIS", "IBISState", "PGConfig", "PGResult", "SMC2", "SMC2State", "SMCConfig",
           "StepInfo", "TemperStage", "complete_data_log_prob", "density_tempered",
           "expected_parameters", "particle_gibbs"]
