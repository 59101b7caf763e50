from repro_torch.train.faults import FaultInjector, FaultSpec
from repro_torch.train.loss import IGNORE, cross_entropy, lm_loss, loss_for
from repro_torch.train.preempt import PreemptionHandler
from repro_torch.train.step import (
    GUARD_KEY,
    TrainState,
    make_loss_fn,
    make_train_step,
    tree_all_finite,
)
from repro_torch.train.supervisor import (
    DivergenceError,
    SpikeDetector,
    SupervisorConfig,
    TrainingSupervisor,
)
from repro_torch.train.trainer import Trainer

__all__ = [
    "DivergenceError",
    "GUARD_KEY",
    "FaultInjector",
    "FaultSpec",
    "IGNORE",
    "PreemptionHandler",
    "SpikeDetector",
    "SupervisorConfig",
    "TrainState",
    "Trainer",
    "TrainingSupervisor",
    "cross_entropy",
    "lm_loss",
    "loss_for",
    "make_loss_fn",
    "make_train_step",
    "tree_all_finite",
]
