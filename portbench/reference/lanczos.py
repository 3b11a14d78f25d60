"""K Ritz pairs of the operator by Lanczos with full reorthogonalization.

The start vector is LanczosNet's deterministic one: node i gets
``1 + sin(1.9 i + 0.7) + 0.5 cos(0.37 i² + 0.3)``, evaluated in float32
(at 10M nodes ``0.37 i²`` is far past float32's integers, so the
float32 evaluation is the definition), then normalized. Each step
orthogonalizes the new vector against the whole basis twice, so the
basis spans the Krylov space ``K_k(S, q0)``; a β at or under ``eps``
ends the recursion with zero vectors. The reference runs in float64.
"""

from __future__ import annotations

import torch

from portbench.reference.common import EXACT, Precision, spmv


def start_vector(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=device)
    v = 1.0 + torch.sin(1.9 * i + 0.7) + 0.5 * torch.cos(0.37 * i * i + 0.3)
    return v.to(torch.float64)


def ritz_pairs(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, n: int, k: int,
               eps: float = 1e-6, prec: Precision = EXACT, dtype=torch.float64
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(vals [k] ascending, vecs [n, k])`` of ``S`` on ``K_k(S, q0)``,
    in ``dtype``; under ``prec`` the operands of every product round
    as ``prec.f32`` says."""
    r = prec.f32
    val = val.to(dtype)
    q = start_vector(n, row.device).to(dtype)
    q = q / torch.sqrt(torch.clamp_min((q * q).sum(), eps * eps))
    basis, alphas, betas = [q], [], []
    for j in range(k):
        w = spmv(row, col, r(val), n, r(basis[j]))
        alpha = (r(basis[j]) * r(w)).sum()
        w = w - alpha * basis[j] - (betas[-1] * basis[j - 1] if j else 0.0)
        rows = torch.stack(basis)
        for _ in range(2):
            w = w - r(rows).T @ (r(rows) @ r(w))
        beta = torch.sqrt((w * w).sum())
        alphas.append(alpha)
        betas.append(beta if beta > eps else torch.zeros_like(beta))
        if j + 1 < k:
            basis.append(w / beta if beta > eps else torch.zeros_like(w))
    t = torch.diag(torch.stack(alphas))
    if k > 1:
        off = torch.stack(betas[:-1])
        t = t + torch.diag(off, 1) + torch.diag(off, -1)
    vals, u = torch.linalg.eigh(t)
    return vals, torch.stack(basis).T @ u
