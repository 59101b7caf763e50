from repro_torch.train.loss import IGNORE, cross_entropy, lm_loss, loss_for
from repro_torch.train.step import TrainState, make_loss_fn, make_train_step
from repro_torch.train.trainer import Trainer

__all__ = [
    "IGNORE",
    "TrainState",
    "Trainer",
    "cross_entropy",
    "lm_loss",
    "loss_for",
    "make_loss_fn",
    "make_train_step",
]
