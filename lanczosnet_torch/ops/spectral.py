"""LanczosNet's long-diffusion path on large graphs, in factored form.

Counterpart of ``lanczosnet_tpu/ops/spectral.py``:
``S^t X ≈ V diag(f_t(D)) Vᵀ X`` from the K Ritz pairs (D, V) as two
batched products, never forming an ``[N, N]`` matrix.
"""

from __future__ import annotations

import torch


def long_scale_features(
    ritz_vec: torch.Tensor, filtered_vals: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """ritz_vec ``[B,N,K]``, filtered_vals ``[B,S,K]`` (``f_t(D)`` per
    scale), x ``[B,N,F]`` → ``[B,S,N,F]``, one filtered signal per scale."""
    vtx = torch.bmm(ritz_vec.transpose(1, 2), x)  # [B,K,F]
    scaled = filtered_vals[:, :, :, None] * vtx[:, None, :, :]  # [B,S,K,F]
    return torch.matmul(ritz_vec[:, None], scaled)  # [B,S,N,F]
