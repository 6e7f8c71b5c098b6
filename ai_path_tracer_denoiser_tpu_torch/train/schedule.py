"""Learning-rate schedule: StepLR(step_size=25 epochs, gamma=0.2)
(copy of train/schedule.py).

Matches torch.optim.lr_scheduler.StepLR as configured at train.py:42.
"""
from __future__ import annotations


def step_lr(base_lr: float, epoch: int, step_epochs: int = 25,
            gamma: float = 0.2) -> float:
    return base_lr * (gamma ** (epoch // step_epochs))
