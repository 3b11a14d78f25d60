"""Diffusion (power) features, LanczosNet's short scales on large graphs.

Counterpart of ``lanczosnet_tpu/ops/poly.py:diffusion_features`` and
``diffusion_features_at``: a chain of batched products ``S·X`` that the
JAX package leaves to XLA and the port to ``torch.bmm``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def diffusion_features(op: torch.Tensor, x: torch.Tensor, max_hop: int) -> torch.Tensor:
    """``[S x, S² x, …, S^max_hop x]`` → ``[B, max_hop, N, F]`` for
    ``op [B,N,N]`` and ``x [B,N,F]``."""
    feats = []
    cur = x
    for _ in range(max_hop):
        cur = torch.bmm(op, cur)
        feats.append(cur)
    return torch.stack(feats, dim=1)


def diffusion_features_at(
    op: torch.Tensor, x: torch.Tensor, dists: Sequence[int]
) -> torch.Tensor:
    """The powers ``S^t x`` at the hop distances ``dists`` →
    ``[B, len(dists), N, F]``; every power up to ``max(dists)`` is
    computed in turn and the asked ones gathered."""
    if not dists:
        return x.new_zeros((x.shape[0], 0) + tuple(x.shape[1:]))
    powers = diffusion_features(op, x, max(dists))
    return torch.stack([powers[:, d - 1] for d in dists], dim=1)
