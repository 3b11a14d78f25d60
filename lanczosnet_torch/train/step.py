"""Train and eval steps for graph regression (the QM8 configs).

Counterpart of ``lanczosnet_tpu/train/step.py``. The loss is the
ghost-aware masked MAE on standardized labels: a tail batch is padded
with ghost graphs that its ``valid`` vector weights out, so every step
has one shape. A train step returns its loss as a device tensor and
waits for nothing; the caller fetches losses when it needs them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.ops.precision import bf16_f32_accumulation


def weighted_mae(pred: torch.Tensor, label: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """MAE over (valid graphs × tasks); ghost graphs contribute 0."""
    err = (pred - label).abs() * valid[:, None]
    denom = (valid.sum() * label.shape[-1]).clamp_min(1.0)
    return err.sum() / denom


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    grad_clip: Optional[float] = None,
) -> Callable[[GraphBatch, torch.Tensor], torch.Tensor]:
    """``(batch, valid) → loss``: forward in training mode (dropout on),
    backward, the gradient clipped to the global norm ``grad_clip``
    before the optimizer adds its weight decay, the optimizer step and
    one step of the schedule. The forward and the backward run in
    ``bf16_f32_accumulation``."""

    def train_step(batch: GraphBatch, valid: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with bf16_f32_accumulation():
            loss = weighted_mae(model(batch), batch.label, valid)
            loss.backward()
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(grad_clip))
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach()

    return train_step


def make_eval_step(
    model: torch.nn.Module,
) -> Callable[[GraphBatch, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """``(batch, valid) → (per-task |err| sums [T], count)`` in eval mode:
    sufficient statistics, so the caller sums over batches and divides
    once and the MAE is exact whatever the ghost padding."""

    @torch.inference_mode()
    @bf16_f32_accumulation()
    def eval_step(batch: GraphBatch, valid: torch.Tensor):
        model.eval()
        err = (model(batch) - batch.label).abs() * valid[:, None]
        return err.sum(0), valid.sum()

    return eval_step
