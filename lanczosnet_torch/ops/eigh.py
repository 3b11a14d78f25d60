"""Batched symmetric eigendecomposition with degeneracy-safe gradients.

Counterpart of ``lanczosnet_tpu/ops/eigh.py``. The standard eigh
backward divides by ``λ_j − λ_i``; padded graphs and broken-down
Lanczos steps always give repeated zero eigenvalues, so that backward
returns inf or NaN there. ``eigh`` is a ``torch.autograd.Function``
whose backward (``eigh_backward``) sets the factor between
(near-)degenerate pairs to zero; ``torch.linalg.eigh``'s own backward
never runs. ``eigh_dispatch`` picks the solver of a Ritz system:
``eigh`` (LAPACK on the CPU, cuSOLVER on the card) or the fixed-sweep
Jacobi iteration of ``ops/jacobi.py``, which shares the backward.
"""

from __future__ import annotations

import torch

from lanczosnet_torch.ops.precision import f32_matmul

DEGENERACY_EPS = 1e-6

# The fixed sweep budget of the Jacobi solver is validated up to this
# width (lanczosnet_tpu/ops/eigh.py:_JACOBI_MAX_K).
JACOBI_MAX_K = 64


def eigh_backward(w: torch.Tensor, v: torch.Tensor, gw, gv) -> torch.Tensor:
    """The gradient of ``sym(a)`` from the cotangents of ``(w, v)``, its
    terms between eigenvalues closer than ``DEGENERACY_EPS`` zero, then
    symmetrised (``lanczosnet_tpu/ops/eigh.py:_bwd``)."""
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


class _SafeEigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor):
        w, v = torch.linalg.eigh(0.5 * (a + a.transpose(-1, -2)))
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, gw, gv):
        return eigh_backward(*ctx.saved_tensors, gw, gv)


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a [..., K, K]`` → (w ``[..., K]`` ascending, v ``[..., K, K]``)
    with ``sym(a) = v diag(w) vᵀ``, where ``sym(a) = (a + aᵀ)/2``.
    Differentiable; the gradient is symmetrised and its terms between
    eigenvalues closer than 1e-6 are zero."""
    return _SafeEigh.apply(a)


def jacobi_sweeps(k: int) -> int:
    """Sweeps for about 1e-6 convergence: 8 through K=32, then one more
    for each further 16 columns (``lanczosnet_tpu/ops/eigh.py:
    _jacobi_sweeps``)."""
    return 8 + max(0, (k - 32 + 15) // 16)


def eigh_dispatch(a: torch.Tensor, impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """The eigensolver of a Ritz system ``a [..., K, K]``, as ``eigh``
    returns it. ``"lapack"`` is ``eigh``; ``"jacobi"`` is
    ``ops/jacobi.py:jacobi_eigh`` at ``jacobi_sweeps(K)`` sweeps, for K
    up to ``JACOBI_MAX_K``. ``"auto"`` is ``"lapack"``: the JAX package
    takes Jacobi on a TPU only, and the port runs on none. Both share the
    clamped backward."""
    k = int(a.shape[-1])
    if impl == "auto":
        impl = "lapack"
    if impl == "jacobi":
        if k > JACOBI_MAX_K:
            raise ValueError(
                f"jacobi eigh requested for K={k} > {JACOBI_MAX_K}; the fixed-sweep "
                "budget is not validated there; use impl='lapack' (eigh)")
        from lanczosnet_torch.ops.jacobi import jacobi_eigh

        return jacobi_eigh(a, jacobi_sweeps(k))
    if impl != "lapack":
        raise ValueError(f"impl must be 'auto', 'lapack' or 'jacobi', not {impl!r}")
    return eigh(a)
