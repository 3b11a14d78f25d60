"""LanczosNet's long-diffusion path on large graphs, in factored form.

Counterpart of ``lanczosnet_tpu/ops/spectral.py``:
``S^t X ≈ V diag(f_t(D)) Vᵀ X`` from the K Ritz pairs (D, V) as two
batched products, never forming an ``[N, N]`` matrix.

On a node-sharded graph (``shard``) ``ritz_vec`` and ``x`` are this
rank's rows: ``Vᵀx``, a sum over nodes, is the ``psum`` of the blocks'
``V_rᵀ x_r``, and the product back gives local rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from lanczosnet_torch.core.graph_batch import NodeShard, node_sum


def long_scale_features(
    ritz_vec: torch.Tensor, filtered_vals: torch.Tensor, x: torch.Tensor,
    shard: Optional[NodeShard] = None,
) -> torch.Tensor:
    """ritz_vec ``[B,N,K]``, filtered_vals ``[B,S,K]`` (``f_t(D)`` per
    scale), x ``[B,N,F]`` → ``[B,S,N,F]``, one filtered signal per scale."""
    vtx = node_sum(torch.bmm(ritz_vec.transpose(1, 2), x), shard)  # [B,K,F]
    scaled = filtered_vals[:, :, :, None] * vtx[:, None, :, :]  # [B,S,K,F]
    return torch.matmul(ritz_vec[:, None], scaled)  # [B,S,N,F]
