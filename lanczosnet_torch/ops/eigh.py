"""Batched symmetric eigendecomposition with degeneracy-safe gradients.

Counterpart of ``lanczosnet_tpu/ops/eigh.py:safe_eigh``. The standard
eigh backward divides by ``λ_j − λ_i``; padded graphs and broken-down
Lanczos steps always give repeated zero eigenvalues, so that backward
returns inf or NaN there. ``eigh`` is a ``torch.autograd.Function``
whose backward sets the factor between (near-)degenerate pairs to zero;
``torch.linalg.eigh``'s own backward never runs.
"""

from __future__ import annotations

import torch

from lanczosnet_torch.ops.precision import f32_matmul

DEGENERACY_EPS = 1e-6


class _SafeEigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor):
        w, v = torch.linalg.eigh(0.5 * (a + a.transpose(-1, -2)))
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, gw, gv):
        w, v = ctx.saved_tensors
        gw = torch.zeros_like(w) if gw is None else gw
        gv = torch.zeros_like(v) if gv is None else gv
        vt = v.transpose(-1, -2)
        diff = w[..., None, :] - w[..., :, None]  # diff[i, j] = w_j − w_i
        safe = diff.abs() > DEGENERACY_EPS
        f = torch.where(safe, 1.0 / torch.where(safe, diff, torch.ones_like(diff)),
                        torch.zeros_like(diff))
        with f32_matmul():
            core = f * (vt @ gv) + torch.diag_embed(gw)
            ga = v @ core @ vt
        return 0.5 * (ga + ga.transpose(-1, -2))


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a [..., K, K]`` → (w ``[..., K]`` ascending, v ``[..., K, K]``)
    with ``sym(a) = v diag(w) vᵀ``, where ``sym(a) = (a + aᵀ)/2``.
    Differentiable; the gradient is symmetrised and its terms between
    eigenvalues closer than 1e-6 are zero."""
    return _SafeEigh.apply(a)
