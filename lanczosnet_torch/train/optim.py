"""Optimizer and learning-rate schedule from the YAML ``train:`` section.

Counterpart of ``lanczosnet_tpu/train/optim.py``: Adam or SGD with
momentum; L2 weight decay added to the gradient before the optimizer's
statistics (the coupled form, which ``torch.optim``'s ``weight_decay``
is; not AdamW); ``MultiStepLR`` in which repeated milestones compound.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch


def build_optimizer(
    params: Iterable[torch.nn.Parameter],
    train_cfg: Mapping,
    steps_per_epoch: int = 1,
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LRScheduler, Optional[float]]:
    """→ (optimizer, scheduler, grad_clip). The scheduler is stepped
    once per optimizer step; ``grad_clip`` (a global-norm bound, or
    None) is for the train step to apply before ``optimizer.step()``.

    Keys read, with the reference's names: ``optimizer`` (Adam | SGD),
    ``lr``, ``momentum``, ``wd``, ``lr_decay``, ``lr_decay_epoch`` (a
    list of epochs) or ``lr_decay_steps`` (a list of steps), ``grad_clip``.
    """
    base_lr = float(train_cfg.get("lr", 1e-3))
    decay = float(train_cfg.get("lr_decay", 0.1))
    if "lr_decay_steps" in train_cfg:
        milestones = [int(s) for s in train_cfg["lr_decay_steps"]]
    else:
        milestones = [int(e) * steps_per_epoch for e in train_cfg.get("lr_decay_epoch", [])]
    name = str(train_cfg.get("optimizer", "Adam")).lower()
    wd = float(train_cfg.get("wd", 0.0))
    if name == "adam":
        optimizer = torch.optim.Adam(params, lr=base_lr, weight_decay=wd)
    elif name == "sgd":
        optimizer = torch.optim.SGD(
            params, lr=base_lr, momentum=float(train_cfg.get("momentum", 0.0)), weight_decay=wd
        )
    else:
        raise ValueError(f"unknown optimizer {name!r} (Adam|SGD)")
    # MultiStepLR counts a milestone that is listed twice twice: two
    # epochs that resolve to the same step apply the decay twice.
    scheduler = torch.optim.lr_scheduler.MultiStepLR(optimizer, sorted(milestones), gamma=decay)
    clip = train_cfg.get("grad_clip")
    return optimizer, scheduler, float(clip) if clip else None
