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

``lanczos_tridiag_resid_stream`` is the plain version of the streamed
kernel in ``csrc/lanczos_stream.cu`` for graphs of more than 128 nodes,
where a strict index-order sum over thousands of terms would be a chain
too long for kernel and plain version alike. Both take every sum over
the node index in chunks: ``STREAM_CHUNK`` consecutive indices summed
in index order from zero, then the chunk partials summed in chunk order
from zero. Sums over the (at most 64) basis rows stay in index order.

``lanczos_tridiag_matvec`` is the same recursion (plain torch ops,
differentiable by autograd) for one operator given only as a matvec
callback: the sparse full-graph path's Ritz pairs, whole or with the
node axis cut over the ranks of a group (every inner product then
summed over them).

``lanczos_adjoint_bwd`` is the hand-derived reverse recursion that
turns cotangents of (alphas, betas, q) into the cotangent of S from the
residuals either forward leaves; ``LanczosTridiag`` in
``ops/lanczos_cuda.py`` is the ``autograd.Function`` that joins them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lanczosnet_torch.ops.precision import f32_matmul
from lanczosnet_torch.parallel.comm import Comm, psum

# Chunk length of the streamed kernel's order of summation; equal to
# kChunk in csrc/lanczos_stream.cu, the same for every N.
STREAM_CHUNK = 64


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
    v = _start_raw(mask)
    norm = torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), eps * eps))
    return v / norm


def _next_vector(w: torch.Tensor, ww: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The breakdown rule of every recursion here: from w and ``ww = w·w``,
    β = sqrt(max(ww, ε²)) → (q_next, β), both 0 where β ≤ ε."""
    beta = torch.sqrt(torch.clamp_min(ww, eps * eps))
    valid = (beta > eps).to(w.dtype)
    return valid * w / beta, beta * valid


def _start_raw(mask: torch.Tensor, index_offset: int = 0) -> torch.Tensor:
    """The start vector before normalization: the sinusoids of the node
    index, masked. ``index_offset`` is the global id of row 0 (a node-
    sharded rank's block start), so every rank evaluates its rows of the
    one global vector."""
    n = mask.shape[-1]
    i = torch.arange(n, dtype=torch.float32, device=mask.device) + float(index_offset)
    v = 1.0 + torch.sin(1.9 * i + 0.7) + 0.5 * torch.cos(0.37 * i * i + 0.3)
    return v * mask


def lanczos_tridiag_matvec(
    matvec, mask: torch.Tensor, k: int, eps: float = 1e-6,
    axis: Optional[Comm] = None, index_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-step Lanczos of one operator given as a callback ``matvec: [N]
    → [N]`` (symmetric), so it never needs to exist as a matrix: the
    sparse full-graph path runs it on its COO product.

    mask ``[N]`` float32 → (alphas ``[k]``, betas ``[k-1]``, q ``[k,N]``),
    the contract of the JAX package's ``lanczos_tridiag_matvec``: its
    start vector, its carry quirk (the ``q_prev`` that enters step j is
    q_j) and its breakdown rule (β ≤ ε zeroes the next vector and its
    β). The CGS2 projections run against the rows written so far; the
    JAX scan's later rows are zero and add nothing. Autograd runs through
    it (no in-place writes), and every product is float32 whatever the
    TF32 flags say.

    ``axis``: the ``Comm`` over whose ranks the node axis is cut (mask,
    q and the matvec's input and output are this rank's rows); every
    node-axis inner product (α, β, the projections, the start vector's
    norm) is then summed over the ranks, so each rank runs the global
    recursion on its rows. ``index_offset``: the global id of this
    rank's row 0.
    """

    def total(x):
        return x if axis is None else psum(x, axis)

    dtype = mask.dtype
    q0 = _start_raw(mask, index_offset).to(dtype)
    q0 = q0 / torch.sqrt(torch.clamp_min(total((q0 * q0).sum()), eps * eps))
    basis = [q0]
    alphas, betas = [], []
    beta_prev = mask.new_zeros(())
    q_prev = torch.zeros_like(q0)
    with f32_matmul():
        for j in range(k):
            q_j = basis[j]
            w = matvec(q_j)
            alpha = total(torch.dot(q_j, w))
            w = w - alpha * q_j - beta_prev * q_prev
            rows = torch.stack(basis)
            for _ in range(2):
                w = w - rows.T @ total(rows @ w)
            q_next, beta_prev = _next_vector(w, total((w * w).sum()), eps)
            if j + 1 < k:
                basis.append(q_next)
            alphas.append(alpha)
            betas.append(beta_prev)
            q_prev = q_next
    return torch.stack(alphas), torch.stack(betas)[:-1], torch.stack(basis)


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
        q_next, beta_prev = _next_vector(w, _dot_rows(w[:, None, :], w), eps)
        alphas[:, j] = alpha[:, 0]
        betas[:, j] = beta_prev[:, 0]
        p1s[:, j] = p1
        p2s[:, j] = p2
        w4s[:, j] = w
        if j + 1 < k:
            q_buf[:, j + 1] = q_next
        q_prev = q_next
    return alphas, betas, q_buf, p1s, p2s, w4s


def _chunk_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum ``x`` over ``dim`` (non-negative, its length a multiple of
    ``STREAM_CHUNK``) in the streamed kernel's order: each chunk of
    consecutive indices in index order, then the chunks in chunk order."""
    chunks = x.shape[dim] // STREAM_CHUNK
    x = x.unflatten(dim, (chunks, STREAM_CHUNK))
    acc = torch.zeros_like(x.select(dim + 1, 0))
    for t in range(STREAM_CHUNK):
        acc = acc + x.select(dim + 1, t)
    total = torch.zeros_like(acc.select(dim, 0))
    for c in range(chunks):
        total = total + acc.select(dim, c)
    return total


def lanczos_tridiag_resid_stream(
    s: torch.Tensor, mask: torch.Tensor, k: int, eps: float = 1e-6
) -> tuple[torch.Tensor, ...]:
    """The contract of ``lanczos_tridiag_resid`` in the order of
    summation of ``csrc/lanczos_stream.cu``, for large graphs.

    Differences from ``lanczos_tridiag_resid``, all shared with the
    kernel: sums over the node index are chunked (``_chunk_sum``); the
    matvec is ``w_i = Σ_r q_r · S[r, i]``, that is qᵀS, which reads S
    along its rows and equals S q only for a symmetric S (the TPU
    kernel makes the same assumption); the CGS passes project against
    rows 0..j of the basis only, the later rows being zero, and p1/p2
    are zero there. N is padded with zeros to a multiple of the chunk
    inside; outputs come back at the caller's N.
    """
    s = s.to(torch.float32)
    b, n, _ = s.shape
    pad = -n % STREAM_CHUNK
    q0 = F.pad(lanczos_start_vector(mask.to(torch.float32), eps), (0, pad))
    s = F.pad(s, (0, pad, 0, pad))
    n_pad = n + pad
    q_buf = s.new_zeros((b, k, n_pad))
    q_buf[:, 0] = q0
    alphas = s.new_zeros((b, k))
    betas = s.new_zeros((b, k))
    p1s = s.new_zeros((b, k, k))
    p2s = s.new_zeros((b, k, k))
    w4s = s.new_zeros((b, k, n_pad))
    beta_prev = s.new_zeros((b, 1))
    q_prev = s.new_zeros((b, n_pad))
    for j in range(k):
        q_j = q_buf[:, j].clone()
        rows = q_buf[:, : j + 1]
        w = _chunk_sum(s * q_j[:, :, None], 1)
        alpha = _chunk_sum(q_j * w, 1)[:, None]
        w = w - alpha * q_j - beta_prev * q_prev
        p1 = _chunk_sum(rows * w[:, None, :], 2)
        w = w - _combine_rows(rows, p1)
        p2 = _chunk_sum(rows * w[:, None, :], 2)
        w = w - _combine_rows(rows, p2)
        q_next, beta_prev = _next_vector(w, _chunk_sum(w * w, 1)[:, None], eps)
        alphas[:, j] = alpha[:, 0]
        betas[:, j] = beta_prev[:, 0]
        p1s[:, j, : j + 1] = p1
        p2s[:, j, : j + 1] = p2
        w4s[:, j] = w
        if j + 1 < k:
            q_buf[:, j + 1] = q_next
        q_prev = q_next
    return alphas, betas, q_buf[:, :, :n].contiguous(), p1s, p2s, w4s[:, :, :n].contiguous()


def lanczos_adjoint_bwd(
    s: torch.Tensor, alphas: torch.Tensor, betas_full: torch.Tensor, q: torch.Tensor,
    p1: torch.Tensor, p2: torch.Tensor, w4: torch.Tensor,
    bar_alphas: torch.Tensor, bar_betas_full: torch.Tensor, bar_q: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Reverse recursion, batched: cotangents of (alphas ``[B,k]``,
    betas_full ``[B,k]``, q ``[B,k,N]``) → ``bar_s [B,N,N]``.

    Every primal of a step is rebuilt from the residuals (w3 = w4 +
    Qᵀp2, w2 = w3 + Qᵀp1, w1 = w2 + α q_j + β_prev q_prev), so no
    forward matvec is replayed; each step costs one product with Sᵀ,
    and the operator cotangent is one product ``bar_W1ᵀ Q`` at the end.
    It is not symmetrised. The forward's carry quirk is rebuilt as it
    ran: the q_prev of step j is q_j. A step that broke down (its
    betas_full is 0) passes only the α path on, as autograd through the
    clamp would. Products run in float32 under any TF32 flag.
    """
    b, k, n = q.shape
    s = s.to(torch.float32)
    s_t = s.transpose(1, 2)
    bar_qbuf = bar_q.clone()
    bar_beta_c = s.new_zeros((b, 1))
    bar_qprev_c = s.new_zeros((b, n))
    bar_w1s = s.new_zeros((b, k, n))

    def dot(x, y):
        return (x * y).sum(-1, keepdim=True)

    with f32_matmul():
        # What does not depend on the reverse carry, for all steps at once.
        # Step j saw rows 0..j of the basis, hence the lower triangles.
        valid = (betas_full > 0).to(s.dtype)
        betas = torch.where(betas_full > 0, betas_full, torch.full_like(betas_full, eps))
        beta_prevs = F.pad(betas_full[:, :-1], (1, 0))
        tril = torch.ones((k, k), dtype=s.dtype, device=s.device).tril()
        w3s = w4 + (p2 * tril) @ q
        w2s = w3s + (p1 * tril) @ q
        # the carry quirk: the q_prev of step j is q_j; β_prev is 0 at j = 0
        w1s = w2s + alphas[..., None] * q + beta_prevs[..., None] * q
        for j in reversed(range(k)):
            alpha, beta, beta_prev = alphas[:, j, None], betas[:, j, None], beta_prevs[:, j, None]
            valid_j = valid[:, j, None]
            q_j = q_prev = q[:, j]
            qm = q[:, : j + 1]  # the basis as step j saw it
            qm_t = qm.transpose(1, 2)
            p1_j = p1[:, j, : j + 1, None]
            p2_j = p2[:, j, : j + 1, None]
            w4_j, w3, w2, w1 = w4[:, j], w3s[:, j], w2s[:, j], w1s[:, j]
            bar_qnext = bar_qprev_c + bar_qbuf[:, j + 1] if j + 1 < k else bar_qprev_c
            bar_beta_out = bar_betas_full[:, j, None] + bar_beta_c
            # q_next = valid·w4/β ; β = sqrt(max(w4·w4, ε²)) ; out = valid·β
            bar_beta_raw = valid_j * (bar_beta_out - dot(w4_j, bar_qnext) / (beta * beta))
            bar_w4 = valid_j * (bar_qnext / beta + bar_beta_raw * w4_j / beta)
            # CGS pass 2: w4 = w3 − Qᵀp2, p2 = Q w3
            bar_p2 = -(qm @ bar_w4[..., None])
            bar_w3 = bar_w4 + (qm_t @ bar_p2)[..., 0]
            # CGS pass 1: w3 = w2 − Qᵀp1, p1 = Q w2
            bar_p1 = -(qm @ bar_w3[..., None])
            bar_w2 = bar_w3 + (qm_t @ bar_p1)[..., 0]
            # w2 = w1 − α q_j − β_prev q_prev ; α = q_j · w1 ; w1 = S q_j
            bar_alpha = bar_alphas[:, j, None] - dot(q_j, bar_w2)
            bar_beta_c = -dot(q_prev, bar_w2)
            bar_qprev_c = -beta_prev * bar_w2
            bar_w1 = bar_w2 + bar_alpha * q_j
            bar_qj = -alpha * bar_w2 + bar_alpha * w1 + (s_t @ bar_w1[..., None])[..., 0]
            # fold the reads back into the basis cotangent: row j+1 was
            # consumed; rows 0..j gain the cotangent of the basis the two
            # CGS passes read, outer(bar_p2, w3) − outer(p2, bar_w4) +
            # outer(bar_p1, w2) − outer(p1, bar_w3), as one product
            if j + 1 < k:
                bar_qbuf[:, j + 1] = 0.0
            bar_qbuf[:, : j + 1].baddbmm_(
                torch.cat([bar_p2, -p2_j, bar_p1, -p1_j], dim=2),
                torch.stack([w3, bar_w4, w2, bar_w3], dim=1),
            )
            bar_qbuf[:, j] += bar_qj
            bar_w1s[:, j] = bar_w1
        return bar_w1s.transpose(1, 2) @ q  # Σ_j outer(bar_w1_j, q_j)


def tridiag_matrix(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Symmetric tridiagonal ``T [..., k, k]`` from the diagonal
    ``alphas [..., k]`` and the off-diagonal ``betas [..., k-1]``."""
    t = torch.diag_embed(alphas)
    if alphas.shape[-1] > 1:
        t = t + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    return t
