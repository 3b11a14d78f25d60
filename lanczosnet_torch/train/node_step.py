"""Steps for full-graph node classification (citation configs).

Counterpart of ``lanczosnet_tpu/train/node_step.py``: the loss is
softmax cross-entropy over the supervised-node mask, the metrics are the
sufficient statistics of exact masked accuracy.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from lanczosnet_torch.core.graph_batch import GraphBatch


def masked_ce_loss(
    logits: torch.Tensor, labels: torch.Tensor, sup_mask: torch.Tensor
) -> torch.Tensor:
    """Mean cross-entropy over supervised nodes: logits ``[B,N,C]``,
    labels ``[B,N]`` int, sup_mask ``[B,N]`` float."""
    ce = F.cross_entropy(logits.flatten(0, 1), labels.flatten().long(), reduction="none")
    ce = ce.view_as(sup_mask)
    return (ce * sup_mask).sum() / sup_mask.sum().clamp_min(1.0)


def make_node_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    grad_clip: Optional[float] = None,
) -> Callable[[GraphBatch, torch.Tensor], torch.Tensor]:
    """``(batch, sup_mask) → loss``: one full-batch gradient step in
    training mode (dropout on), then one step of the schedule. The
    gradient is clipped to the global norm ``grad_clip`` before the
    optimizer adds its weight decay."""

    def train_step(batch: GraphBatch, sup_mask: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = masked_ce_loss(model(batch), batch.node_label, sup_mask)
        loss.backward()
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(grad_clip))
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach()

    return train_step


def make_node_eval_step(
    model: torch.nn.Module,
) -> Callable[[GraphBatch, torch.Tensor], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(batch, sup_mask) → (correct_count, count, mean_ce)`` in eval
    mode, without recording a graph."""

    @torch.no_grad()
    def eval_step(batch: GraphBatch, sup_mask: torch.Tensor):
        model.eval()
        logits = model(batch)
        pred = logits.argmax(-1)
        correct = ((pred == batch.node_label).to(sup_mask.dtype) * sup_mask).sum()
        return correct, sup_mask.sum(), masked_ce_loss(logits, batch.node_label, sup_mask)

    return eval_step
