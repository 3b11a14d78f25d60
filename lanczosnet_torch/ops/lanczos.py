"""K-step Lanczos tridiagonalization with full reorthogonalization,
in plain PyTorch.

Counterpart of ``lanczosnet_tpu/ops/lanczos.py``. Each step of the
recursion, for every graph of the batch at once:

    w = S q_j ;  α_j = q_j·w ;  w ← w − α_j q_j − β_{j−1} q_prev
    w ← w − Qᵀ(Q w)   (twice: classical Gram–Schmidt, CGS2)
    β_j = sqrt(max(‖w‖², ε²)) ;  q_{j+1} = [β_j > ε] · w / β_j

``lanczos_tridiag_resid`` is the plain version of the CUDA kernel in
``csrc/lanczos_tridiag.cu`` and the baseline it is held against. Both
take every sum term by term in index order, each product and sum
rounded on its own, so on one device they agree bit for bit. That is
needed, not pedantry: on QM8-like graphs the Krylov space is often
exhausted before step K, and there β is rounding noise on the order of
ε itself. Whether such a step counts as a breakdown, and the direction
of the noise vector that becomes q_{j+1} when it does not, then depends
on the order of summation; two orders part by O(1) in Q from that step
on (the JAX package's own Pallas kernel and scan do, on 64 such graphs).
Sums written out term by term also keep the recursion in float32
whatever the TF32 flags say; it lives on orthogonality.
"""

from __future__ import annotations

import torch


def _dot_rows(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Σ_c a[b, r, c] · x[b, c]`` → ``[B, R]``, summed over c in order."""
    acc = a.new_zeros(a.shape[:-1])
    for c in range(a.shape[-1]):
        acc = acc + a[:, :, c] * x[:, None, c]
    return acc


def _combine_rows(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``Σ_r q[b, r, :] · p[b, r]`` → ``[B, N]``, summed over r in order."""
    acc = q.new_zeros((q.shape[0], q.shape[2]))
    for r in range(q.shape[1]):
        acc = acc + q[:, r] * p[:, r, None]
    return acc


def lanczos_start_vector(mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Deterministic generic start vector: mask ``[..., N]`` → unit-norm
    ``q0 [..., N]`` supported on the mask.

    A constant start vector is an eigenvector of every regular graph's
    normalized operator, so Lanczos would break down after one step.
    This one is a masked sum of incommensurate sinusoids of the node
    index, the formula of the JAX package.
    """
    n = mask.shape[-1]
    i = torch.arange(n, dtype=torch.float32, device=mask.device)
    v = 1.0 + torch.sin(1.9 * i + 0.7) + 0.5 * torch.cos(0.37 * i * i + 0.3)
    v = v * mask
    norm = torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), eps * eps))
    return v / norm


def lanczos_tridiag_resid(
    s: torch.Tensor, mask: torch.Tensor, k: int, eps: float = 1e-6
) -> tuple[torch.Tensor, ...]:
    """Batched tridiagonalization with the adjoint residuals.

    s ``[B,N,N]``, mask ``[B,N]`` → (alphas ``[B,k]``, betas_full
    ``[B,k]`` validity-masked, q ``[B,k,N]``, p1 ``[B,k,k]``, p2
    ``[B,k,k]``, w4 ``[B,k,N]``). p1/p2 are the two CGS coefficient
    vectors against all k rows of the basis (rows not yet written are
    zero), w4 the vector before normalization.

    The carry quirk of the reference is kept: the ``q_prev`` that enters
    step j is the previous step's ``q_next``, which is q_j itself, not
    q_{j-1}. S·q is taken row by row; S is not assumed symmetric.
    """
    s = s.to(torch.float32)
    b, n, _ = s.shape
    q0 = lanczos_start_vector(mask.to(torch.float32), eps)
    q_buf = s.new_zeros((b, k, n))
    q_buf[:, 0] = q0
    alphas = s.new_zeros((b, k))
    betas = s.new_zeros((b, k))
    p1s = s.new_zeros((b, k, k))
    p2s = s.new_zeros((b, k, k))
    w4s = s.new_zeros((b, k, n))
    beta_prev = s.new_zeros((b, 1))
    q_prev = s.new_zeros((b, n))
    for j in range(k):
        q_j = q_buf[:, j].clone()
        w = _dot_rows(s, q_j)
        alpha = _dot_rows(q_j[:, None, :], w)
        w = w - alpha * q_j - beta_prev * q_prev
        p1 = _dot_rows(q_buf, w)
        w = w - _combine_rows(q_buf, p1)
        p2 = _dot_rows(q_buf, w)
        w = w - _combine_rows(q_buf, p2)
        beta = torch.sqrt(torch.clamp_min(_dot_rows(w[:, None, :], w), eps * eps))
        valid = (beta > eps).to(torch.float32)
        q_next = valid * w / beta
        alphas[:, j] = alpha[:, 0]
        betas[:, j] = (beta * valid)[:, 0]
        p1s[:, j] = p1
        p2s[:, j] = p2
        w4s[:, j] = w
        if j + 1 < k:
            q_buf[:, j + 1] = q_next
        beta_prev, q_prev = beta * valid, q_next
    return alphas, betas, q_buf, p1s, p2s, w4s


def tridiag_matrix(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Symmetric tridiagonal ``T [..., k, k]`` from the diagonal
    ``alphas [..., k]`` and the off-diagonal ``betas [..., k-1]``."""
    t = torch.diag_embed(alphas)
    if alphas.shape[-1] > 1:
        t = t + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    return t
