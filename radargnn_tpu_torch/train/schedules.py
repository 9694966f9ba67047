"""Epoch-level learning-rate schedules with torch parity.

Port of `radargnn_tpu/train/schedules.py`: ReduceLROnPlateau /
ExponentialLR / constant, as host-side state machines stepped once per
epoch on the validation loss; the trainer writes the lr they return into
the optimizer's parameter group.
"""

from __future__ import annotations


class ConstantLR:
    def __init__(self, lr0: float):
        self.lr = lr0

    def step(self, val_loss: float) -> float:
        return self.lr


class ExponentialLR:
    """lr = lr0 · gamma^epoch, stepped once per epoch (torch ExponentialLR)."""

    def __init__(self, lr0: float, gamma: float):
        self.lr = lr0
        self.gamma = gamma

    def step(self, val_loss: float) -> float:
        self.lr *= self.gamma
        return self.lr


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau parity (mode='min', threshold 1e-4 rel,
    cooldown 0, min_lr 0)."""

    def __init__(self, lr0: float, factor: float, patience: int,
                 threshold: float = 1e-4):
        self.lr = lr0
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, val_loss: float) -> float:
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr


def make_scheduler(config) -> object:
    """Selects the scheduler as the reference trainer does: plateau when
    its patience is set, else exponential decay when its factor is, else
    constant."""
    if config.reduce_lr_on_plateau_patience > 0:
        return ReduceLROnPlateau(config.learning_rate,
                                 config.reduce_lr_on_plateau_factor,
                                 config.reduce_lr_on_plateau_patience)
    if config.exponential_lr_decay_factor > 0:
        return ExponentialLR(config.learning_rate,
                             config.exponential_lr_decay_factor)
    return ConstantLR(config.learning_rate)
