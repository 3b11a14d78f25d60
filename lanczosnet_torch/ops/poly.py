"""Polynomial and diffusion features: ChebyNet's Chebyshev stack, DCNN's
hops and LanczosNet's short scales on large graphs.

Counterpart of ``lanczosnet_tpu/ops/poly.py``: chains of batched
products ``S·X`` that the JAX package leaves to XLA (unrolled, or a
``lax.scan`` above eight steps, with the same values) and the port to
``torch.bmm``. Inputs and outputs are float32.

Each also runs on a row block of a node-sharded graph (``shard``):
``op`` is this rank's rows ``[B, n_loc, N]`` and ``x`` its rows
``[B, n_loc, F]``; every hop gathers its input whole
(``core/graph_batch.py:gather_nodes``) and gives local rows, so no
``[N, N]`` power is formed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from lanczosnet_torch.core.graph_batch import NodeShard, gather_nodes


def _hop(op: torch.Tensor, x: torch.Tensor, shard: Optional[NodeShard]) -> torch.Tensor:
    return torch.bmm(op, gather_nodes(x, shard))


def chebyshev_features(op: torch.Tensor, x: torch.Tensor, order: int,
                       shard: Optional[NodeShard] = None) -> torch.Tensor:
    """``[T_0 x, T_1 x, …, T_order x]`` → ``[B, order+1, N, F]`` for
    ``op [B,N,N]`` (spectrally in [-1, 1], as a symmetric-normalized
    adjacency is) and ``x [B,N,F]``: ``T_0 x = x``, ``T_1 x = S x``,
    ``T_k x = 2 S T_{k-1} x − T_{k-2} x``."""
    if order < 1:
        return x[:, None]
    feats = [x, _hop(op, x, shard)]
    for _ in range(order - 1):
        feats.append(2.0 * _hop(op, feats[-1], shard) - feats[-2])
    return torch.stack(feats, dim=1)


def diffusion_features(op: torch.Tensor, x: torch.Tensor, max_hop: int,
                       shard: Optional[NodeShard] = None) -> torch.Tensor:
    """``[S x, S² x, …, S^max_hop x]`` → ``[B, max_hop, N, F]`` for
    ``op [B,N,N]`` and ``x [B,N,F]``."""
    feats = []
    cur = x
    for _ in range(max_hop):
        cur = _hop(op, cur, shard)
        feats.append(cur)
    return torch.stack(feats, dim=1)


def diffusion_features_at(
    op: torch.Tensor, x: torch.Tensor, dists: Sequence[int],
    shard: Optional[NodeShard] = None,
) -> torch.Tensor:
    """The powers ``S^t x`` at the hop distances ``dists`` →
    ``[B, len(dists), N, F]``; every power up to ``max(dists)`` is
    computed in turn and the asked ones gathered."""
    if not dists:
        return x.new_zeros((x.shape[0], 0) + tuple(x.shape[1:]))
    powers = diffusion_features(op, x, max(dists), shard)
    return torch.stack([powers[:, d - 1] for d in dists], dim=1)
