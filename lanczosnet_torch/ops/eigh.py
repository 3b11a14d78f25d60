"""Batched symmetric eigendecomposition, forward only.

Counterpart of the forward of ``lanczosnet_tpu/ops/eigh.py:safe_eigh``.
Its clamped backward, which keeps gradients finite on the degenerate
zero Ritz values that padded graphs always give, comes with the
training slice (ROADMAP A2); until then nothing differentiates this.
"""

from __future__ import annotations

import torch


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a [..., K, K]`` → (w ``[..., K]`` ascending, v ``[..., K, K]``)
    with ``sym(a) = v diag(w) vᵀ``, where ``sym(a) = (a + aᵀ)/2``."""
    return torch.linalg.eigh(0.5 * (a + a.transpose(-1, -2)))
