"""Steps for full-graph node classification (citation configs).

Counterpart of ``lanczosnet_tpu/train/node_step.py``: the loss is
softmax cross-entropy over the supervised-node mask, the metrics are the
sufficient statistics of exact masked accuracy.

Node-sharded (``comm``, the group of a graph split by node rows), each
rank holds its rows of the logits and of the masks. A rank's loss is its
share of the whole graph's: its masked cross-entropy sum over the
supervised count of the whole graph (``count``, counted once at set-up:
the split masks are constant), so a rank with no supervised node still
runs the backward and joins the all-reduce. The parameter gradients and
the loss get one all-reduce a step (``Comm.all_reduce_flat``) before the
clip and the optimizer; the parameters are replicated, so after it each
rank holds the whole gradient and clips locally. The eval step sums its
statistics over the ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.parallel.comm import Comm


def masked_ce_sum(
    logits: torch.Tensor, labels: torch.Tensor, sup_mask: torch.Tensor
) -> torch.Tensor:
    """Cross-entropy summed over supervised nodes: logits ``[B,N,C]``,
    labels ``[B,N]`` int, sup_mask ``[B,N]`` float."""
    ce = F.cross_entropy(logits.flatten(0, 1), labels.flatten().long(), reduction="none")
    return (ce.view_as(sup_mask) * sup_mask).sum()


def masked_ce_loss(
    logits: torch.Tensor, labels: torch.Tensor, sup_mask: torch.Tensor,
    count: Optional[float] = None,
) -> torch.Tensor:
    """Mean cross-entropy over supervised nodes: logits ``[B,N,C]``,
    labels ``[B,N]`` int, sup_mask ``[B,N]`` float; the sum is divided by
    ``count`` (default: ``sup_mask``'s own count)."""
    total = sup_mask.sum() if count is None else torch.as_tensor(count, dtype=sup_mask.dtype)
    return masked_ce_sum(logits, labels, sup_mask) / total.clamp_min(1.0)


def make_node_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    grad_clip: Optional[float] = None,
    comm: Optional[Comm] = None,
) -> Callable[..., torch.Tensor]:
    """``(batch, sup_mask[, count]) → loss``: one full-batch gradient
    step in training mode (dropout on), then one step of the schedule.
    The gradient is clipped to the global norm ``grad_clip`` before the
    optimizer adds its weight decay. With ``comm`` the batch is this
    rank's rows and ``count`` the whole graph's supervised nodes; the
    loss returned is the whole graph's on every rank."""
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: GraphBatch, sup_mask: torch.Tensor,
                   count: Optional[float] = None) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = masked_ce_loss(model(batch), batch.node_label, sup_mask, count)
        loss.backward()
        loss = loss.detach()
        if comm is not None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            *summed, loss = comm.all_reduce_flat([*grads, loss.reshape(1)])
            for p, g in zip(params, summed):
                p.grad = g
            loss = loss[0]
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(params, float(grad_clip))
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss

    return train_step


def make_node_eval_step(
    model: torch.nn.Module, comm: Optional[Comm] = None,
) -> Callable[[GraphBatch, torch.Tensor], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(batch, sup_mask) → (correct_count, count, mean_ce)`` in eval
    mode, without recording a graph; with ``comm``, of the whole graph
    on every rank."""

    @torch.no_grad()
    def eval_step(batch: GraphBatch, sup_mask: torch.Tensor):
        model.eval()
        logits = model(batch)
        pred = logits.argmax(-1)
        correct = ((pred == batch.node_label).to(sup_mask.dtype) * sup_mask).sum()
        stats = torch.stack([correct, sup_mask.sum(),
                             masked_ce_sum(logits, batch.node_label, sup_mask)])
        if comm is not None:
            stats = comm.all_reduce(stats)
        correct, count, ce = stats
        return correct, count, ce / count.clamp_min(1.0)

    return eval_step
