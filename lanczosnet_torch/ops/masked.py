"""Mask-aware softmax, mean and normalization shared by the models.

Counterpart of ``lanczosnet_tpu/ops/masked.py``: every model treats
padding through these, so a padded entry never leaks into a result.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with masked-out entries (``mask <= 0``) at
    probability 0; a slice masked out entirely gives zeros, not NaN.
    ``mask`` broadcasts against ``logits``."""
    keep = mask > 0
    masked = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    m = masked.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(masked - m) * keep
    return unnorm / unnorm.sum(dim=dim, keepdim=True).clamp_min(1e-12)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1,
                eps: float = 1e-12) -> torch.Tensor:
    """Mean of ``x`` over ``dim``, counting only entries where ``mask`` is set."""
    return (x * mask).sum(dim) / mask.sum(dim).clamp_min(eps)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / sqrt(max(Σ x², eps))`` along ``dim``. The squared norm is
    clamped at ``eps``, as the JAX package does, and not the norm as
    ``torch.nn.functional.normalize`` does: the two differ on every row
    whose norm is below ``sqrt(eps)`` = 1e-6."""
    return x / torch.sqrt((x * x).sum(dim, keepdim=True).clamp_min(eps))
