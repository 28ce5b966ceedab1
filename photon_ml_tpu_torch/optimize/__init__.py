from photon_ml_tpu_torch.optimize.common import (
    OptimizationResult,
    OptimizerConfig,
    PathConfig,
    ToleranceSchedule,
    parse_tolerance_schedule,
)
from photon_ml_tpu_torch.optimize.lbfgs import lbfgs
from photon_ml_tpu_torch.optimize.owlqn import owlqn
from photon_ml_tpu_torch.optimize.tron import tron

OPTIMIZERS = {"lbfgs": lbfgs, "owlqn": owlqn, "tron": tron}


def get_optimizer(name: str):
    key = name.lower()
    if key not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}'; known: "
                         f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[key]
