"""Train and eval steps for graph regression (the QM8 configs).

Counterpart of ``lanczosnet_tpu/train/step.py``. The loss is the
ghost-aware masked MAE on standardized labels: a tail batch is padded
with ghost graphs that its ``valid`` vector weights out, so every step
has one shape. A train step returns its loss as a device tensor and
waits for nothing; the caller fetches losses when it needs them.

Data and tensor parallelism (``train.num_devices``, ``train.tp``): each
data-parallel rank holds a block of the batch and its loss is its share
of the batch's (its error sum over the valid count of the whole batch,
the sum over the ``dp`` ranks); the gradients and the loss get one flat
all-reduce over ``dp`` a step, as ``SparseCitationRunner``'s do. Under
``tp`` the gradient of a cut leaf is its block's (``parallel/tensor.py``)
and the global norm of the clip sums the blocks' squares over ``tp``
and counts each replicated leaf once.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.ops.precision import bf16_f32_accumulation
from lanczosnet_torch.parallel.comm import Comm
from lanczosnet_torch.parallel.tensor import TensorParallel


def weighted_mae(pred: torch.Tensor, label: torch.Tensor, valid: torch.Tensor,
                 count: Optional[float] = None) -> torch.Tensor:
    """MAE over (valid graphs × tasks); ghost graphs contribute 0.
    ``count``: the valid graphs of the whole batch where ``pred`` holds a
    block of it (default: ``valid.sum()``)."""
    err = (pred - label).abs() * valid[:, None]
    n = valid.sum() if count is None else valid.new_tensor(float(count))
    denom = (n * label.shape[-1]).clamp_min(1.0)
    return err.sum() / denom


def clip_grad_norm(params: Sequence[torch.Tensor], max_norm: float, cut: Sequence[bool],
                   tp_comm: Comm) -> torch.Tensor:
    """``clip_grad_norm_`` over a tensor-parallel model: the squares of
    the cut leaves' blocks summed over ``tp``, each replicated leaf
    counted once; every rank scales its gradients by the same factor.
    → the global norm."""
    grads = [p.grad for p in params]
    zero = torch.zeros((), device=grads[0].device)
    sq = [sum((g.float().pow(2).sum() for g, c in zip(grads, cut) if c == part), zero)
          for part in (True, False)]
    norm = (tp_comm.all_reduce(sq[0]) + sq[1]).sqrt()
    coef = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return norm


def _make_update(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler],
    grad_clip: Optional[float],
    dp_comm: Optional[Comm],
    tensor_parallel: Optional[TensorParallel],
) -> Callable[..., torch.Tensor]:
    """``(parts) → loss`` for ``parts``, a sequence of ``(batch, valid,
    count, weight)``: each part's forward and backward in training mode,
    the gradients accumulated with the parts' weights, then one update
    (the dp all-reduce, the clip, the optimizer and the schedule), as
    ``make_train_step`` documents. The loss is the weighted sum."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    dp = dp_comm if dp_comm is not None and dp_comm.size > 1 else None

    def update(parts) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total = None
        for batch, valid, count, weight in parts:
            if dp is not None and count is None:
                raise ValueError("a data-parallel step needs the whole batch's valid count")
            with bf16_f32_accumulation():
                loss = weight * weighted_mae(model(batch), batch.label, valid, count)
                loss.backward()  # a weight of 1.0 changes no bit
            total = loss.detach() if total is None else total + loss.detach()
        loss = total
        if dp is not None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            *summed, loss = dp.all_reduce_flat([*grads, loss.reshape(1)])
            for p, g in zip(params, summed):
                p.grad = g
            loss = loss[0]
        if grad_clip and tensor_parallel is not None:
            clip_grad_norm(params, float(grad_clip), tensor_parallel.cut(), tensor_parallel.comm)
        elif grad_clip:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(grad_clip))
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss

    return update


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    grad_clip: Optional[float] = None,
    dp_comm: Optional[Comm] = None,
    tensor_parallel: Optional[TensorParallel] = None,
) -> Callable[..., torch.Tensor]:
    """``(batch, valid, count=None) → loss``: forward in training mode
    (dropout on), backward, the gradient clipped to the global norm
    ``grad_clip`` before the optimizer adds its weight decay, the
    optimizer step and one step of the schedule. The forward and the
    backward run in ``bf16_f32_accumulation``.

    ``dp_comm`` (more than one rank): ``batch`` is this rank's block,
    ``count`` the valid graphs of the whole batch (the caller knows it
    without a collective: the batch size, where no graph is a ghost),
    and the loss returned is the whole batch's. ``tensor_parallel``: the
    model is cut over its ``tp`` group; the optimizer holds its
    ``parameters()``."""
    update = _make_update(model, optimizer, scheduler, grad_clip, dp_comm, tensor_parallel)

    def train_step(batch: GraphBatch, valid: torch.Tensor,
                   count: Optional[float] = None) -> torch.Tensor:
        return update([(batch, valid, count, 1.0)])

    return train_step


def make_pair_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    grad_clip: Optional[float] = None,
    dp_comm: Optional[Comm] = None,
    tensor_parallel: Optional[TensorParallel] = None,
) -> Callable[..., torch.Tensor]:
    """``(batch_a, count_a, batch_b, count_b) → loss``: one optimizer step
    on two half-batches of two size buckets, as the JAX package's
    ``make_scan_pair_epoch`` body takes it. Each half's loss and gradient
    are weighted by its share of the pair, ``ha/(ha+hb)`` with ``ha`` and
    ``hb`` the halves' graph counts (``count_a``, ``count_b``: what each
    half's loss divides by, as in ``make_train_step``), so the step's
    batch mixes graph sizes. Every graph of a half is real."""
    update = _make_update(model, optimizer, scheduler, grad_clip, dp_comm, tensor_parallel)

    def pair_step(batch_a: GraphBatch, count_a: float, batch_b: GraphBatch,
                  count_b: float) -> torch.Tensor:
        wa = count_a / (count_a + count_b)
        return update([
            (batch_a, torch.ones(batch_a.mask.shape[0], device=batch_a.mask.device), count_a, wa),
            (batch_b, torch.ones(batch_b.mask.shape[0], device=batch_b.mask.device), count_b,
             1.0 - wa),
        ])

    return pair_step


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
