"""Batched symmetric eigensolver by parallel-order cyclic Jacobi.

Counterpart of ``lanczosnet_tpu/ops/jacobi.py``, the same math: a fixed
number of sweeps, each of K−1 rounds in the round-robin ("circle
method") order, each round K/2 disjoint rotations at once, each the
angle with ``tan 2θ = 2a_pq / (a_qq − a_pp)`` that zeroes ``a_pq``, the
matrix symmetrised again after each round, the eigenvalues sorted
ascending. An odd K is padded to even with a zero row and column, and
the column whose padded-row weight is largest is dropped.

Of the two angles that zero ``a_pq`` the port takes the inner one,
``|θ| ≤ π/4``; the JAX code's ``½·atan2(2a_pq, a_qq − a_pp)`` takes the
outer one, ``π/2`` away, wherever ``a_qq < a_pp``, which swaps the pair
as it rotates. Both give the same eigenpairs once converged, but the
swaps slow the iteration: at the sweeps ``ops/eigh.py:jacobi_sweeps``
gives, the outer angle leaves Ritz values more than 1e-4 off on the
flagship's Lanczos tridiagonals (K=20, 8 sweeps), the inner one about
1e-6 (``tests/test_torch_jacobi.py``).

A round builds the rotation ``J [B, K, K]`` (``J_pp = J_qq = c``,
``J_pq = s``, ``J_qp = −s`` for each pair) by one scatter and applies it
as ``Jᵀ A J`` and ``V J`` in float32 products, TF32 off, as the JAX
code asks ``Precision.HIGHEST``. No step depends on convergence: the
cost is the same for every matrix of a batch, and a round is a fixed
chain of a few launches.

The gradient is ``ops/eigh.py:eigh_backward``, the clamped eigh
backward that ``eigh`` uses: the solver is an implementation detail of
the same function.
"""

from __future__ import annotations

import torch

from lanczosnet_torch.ops.eigh import eigh_backward
from lanczosnet_torch.ops.precision import f32_matmul


def round_robin_pairs(k: int, device=None) -> torch.Tensor:
    """``[k−1, k/2, 2]`` disjoint pairs ``(p < q)``, every pair of ``k``
    indices once a sweep (``lanczosnet_tpu/ops/jacobi.py:
    _round_robin_pairs``): player 0 fixed, the others rotate one place a
    round, round r pairing lineup slot i with slot k−1−i. Built on
    ``device`` by arithmetic, so that no table crosses from the host (a
    copy from pageable memory would wait for the device)."""
    if k % 2:
        raise ValueError(f"k={k} must be even (pad it)")
    r = torch.arange(k - 1, device=device)[:, None]
    slot = torch.arange(k, device=device)[None, :]
    lineup = torch.where(slot == 0, 0, 1 + (slot - 1 - r) % (k - 1))  # [k-1, k]
    a, b = lineup[:, : k // 2], lineup.flip(1)[:, : k // 2]
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b)], -1)


def _jacobi(a: torch.Tensor, sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric ``a [..., K, K]`` → (w ``[..., K]`` ascending, v ``[..., K, K]``)."""
    batch_shape, k0 = a.shape[:-2], a.shape[-1]
    pad = k0 % 2
    if pad:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    k = k0 + pad
    a = a.reshape(-1, k, k).contiguous()
    b, m, dev = a.shape[0], k // 2, a.device

    rounds = round_robin_pairs(k, dev)
    p, q = rounds[..., 0], rounds[..., 1]  # [R, m]
    # flat positions per round: the 2×2 blocks' entries to read (pp, qq,
    # pq) and the rotation's entries to write (pp, qq, pq, qp)
    read = torch.cat([p * k + p, q * k + q, p * k + q], 1)
    write = torch.cat([p * k + p, q * k + q, p * k + q, q * k + p], 1)
    v = torch.eye(k, dtype=a.dtype, device=dev).expand(b, k, k)

    with f32_matmul():
        for _ in range(sweeps):
            for r in range(k - 1):
                app, aqq, apq = a.view(b, k * k).index_select(1, read[r]).split(m, 1)
                d = aqq - app  # the inner angle: atan2 of a non-negative x
                theta = 0.5 * torch.atan2(torch.where(d < 0, -2.0 * apq, 2.0 * apq), d.abs())
                c, s = torch.cos(theta), torch.sin(theta)
                entries = torch.cat([c, c, s, -s], 1)
                jrot = a.new_zeros(b, k * k).scatter_(
                    1, write[r].expand(b, 4 * m), entries).view(b, k, k)
                a = jrot.transpose(1, 2) @ a @ jrot
                a = 0.5 * (a + a.transpose(1, 2))  # rounding drift
                v = v @ jrot

    w, order = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1, stable=True)
    v = torch.take_along_dim(v, order[:, None, :], dim=-1)
    if pad:
        # the padded row decouples with eigenvalue 0, which may sort
        # anywhere among zeros: drop the column that weighs on it most
        drop = v[:, k0, :].abs().argmax(-1)
        dropped = torch.arange(k, device=dev)[None, :] == drop[:, None]
        keep = torch.argsort(dropped.to(torch.int8), dim=-1, stable=True)[:, :k0]
        w = torch.take_along_dim(w, keep, dim=-1)
        v = torch.take_along_dim(v[:, :k0, :], keep[:, None, :], dim=-1)
    return w.reshape(batch_shape + (k0,)), v.reshape(batch_shape + (k0, k0))


class _JacobiEigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor, sweeps: int):
        w, v = _jacobi(0.5 * (a + a.transpose(-1, -2)), sweeps)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, gw, gv):
        return eigh_backward(*ctx.saved_tensors, gw, gv), None


def jacobi_eigh(a: torch.Tensor, sweeps: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops/eigh.py:eigh`` by ``sweeps`` Jacobi sweeps: (w ascending, v)
    with ``sym(a) ≈ v diag(w) vᵀ``, the same clamped backward."""
    return _JacobiEigh.apply(a, sweeps)
