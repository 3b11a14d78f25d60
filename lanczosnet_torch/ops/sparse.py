"""Sparse (COO) full-graph operators: the path for graphs too large for
a dense ``[N, N]`` operator.

Counterpart of the single-device part of ``lanczosnet_tpu/ops/sparse.py``.
The operator lives as COO edges in destination-major order; a product
is a gather of the sources (``index_select``) and a segment sum at the
destinations (``index_add_``), and the K-step Lanczos recursion
(``ops/lanczos.py:lanczos_tridiag_matvec``) runs with that product as
its matvec, so LanczosNet's Ritz machinery works at sparse scale.

Dtypes: a 16-bit message is widened to float32 before every segment
sum and narrowed after it (``_segsum``), so no ``index_add_`` runs in
bfloat16: CUDA's 16-bit atomics are slow and lose mantissa on
high-degree nodes. The gather of node states at the edge sources is
``edge_gather``, an ``autograd.Function`` whose backward scatter-adds
the cotangents at ``col`` in ``col_perm`` order, widened to float32,
in chunks above a size bound. ``LANCZOSNET_BF16_SCATTER``, the JAX
package's opt-in, keeps that sorted scatter in the cotangent's own
16-bit dtype.

The sharded forms of the JAX module (edge- and node-sharded ops, the
ring) are not here.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from lanczosnet_torch.ops.eigh import eigh
from lanczosnet_torch.ops.lanczos import lanczos_tridiag_matvec, tridiag_matrix
from lanczosnet_torch.ops.precision import f32_matmul

_NARROW = (torch.bfloat16, torch.float16)

# Above _BWD_CHUNK_ENGAGE bytes of widened cotangent, the sorted backward
# scatter of edge_gather runs in chunks of about _BWD_CHUNK_TARGET bytes,
# so the float32 [E, F] operand never exists whole (at 10M nodes and
# 25M edges it is 3.2 GB). The values of the JAX package.
_BWD_CHUNK_ENGAGE = 2 * 1024**3
_BWD_CHUNK_TARGET = 1 * 1024**3


@dataclasses.dataclass(frozen=True)
class SparseOp:
    """A graph operator in COO form on one device.

    ``row [E]`` int32 destinations, non-decreasing when ``rows_sorted``;
    ``col [E]`` int32 sources; ``val [E]`` float32 weights, exactly 0 on
    an edge that is not live (consumers read ``val != 0`` as liveness);
    ``n`` the node count; ``col_perm [E]`` int32, the permutation that
    sorts ``col`` (the order of ``edge_gather``'s backward scatter), or
    None; ``n_true`` the count of real nodes when the node axis is
    padded (rows at or past it get no start weight in
    ``sparse_lanczos_ritz``), None when every row is real.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n: int
    rows_sorted: bool = False
    col_perm: Optional[torch.Tensor] = None
    n_true: Optional[int] = None

    def replace(self, **changes) -> "SparseOp":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "SparseOp":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return self.replace(row=move(self.row), col=move(self.col), val=move(self.val),
                            col_perm=move(self.col_perm))

    @property
    def num_edges(self) -> int:
        return int(self.row.shape[0])


def _coo(edges: np.ndarray, n: int, val_of, device) -> SparseOp:
    """Both directions of each undirected edge, weighted by
    ``val_of(row, col, deg)``, in destination-major order."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    row = np.concatenate([e[:, 0], e[:, 1]])
    col = np.concatenate([e[:, 1], e[:, 0]])
    deg = np.bincount(row, minlength=n).astype(np.float64)
    val = val_of(row, col, deg).astype(np.float32)
    order = np.argsort(row, kind="stable")
    col = col[order]
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)  # noqa: E731
    return SparseOp(
        row=as_t(row[order], np.int32),
        col=as_t(col, np.int32),
        val=as_t(val[order], np.float32),
        n=int(n),
        rows_sorted=True,
        col_perm=as_t(np.argsort(col, kind="stable"), np.int32),
    )


def sparse_sym_operator(edges: np.ndarray, n: int, eps: float = 1e-12,
                        device: str | torch.device = "cpu") -> SparseOp:
    """``D^{-1/2} A D^{-1/2}`` of an undirected edge list ``[E, 2]``
    (pairs i != j), built on the host as the JAX constructor builds it
    and placed on ``device``."""

    def val_of(row, col, deg):
        inv_sqrt = np.where(deg > eps, 1.0 / np.sqrt(np.maximum(deg, eps)), 0.0)
        return inv_sqrt[row] * inv_sqrt[col]

    return _coo(edges, n, val_of, device)


def sparse_row_stochastic_operator(edges: np.ndarray, n: int,
                                   device: str | torch.device = "cpu") -> SparseOp:
    """The transition matrix ``D^{-1} A`` (DCNN's diffusion operator)."""
    return _coo(edges, n, lambda row, col, deg: (1.0 / np.maximum(deg, 1.0))[row], device)


def _bf16_sorted_scatter() -> bool:
    """``LANCZOSNET_BF16_SCATTER`` set and not 0: the sorted backward
    scatter of ``edge_gather`` accumulates 16-bit cotangents in their own
    dtype (read at each backward)."""
    return os.environ.get("LANCZOSNET_BF16_SCATTER", "0") not in ("", "0")


class _EdgeGather(torch.autograd.Function):
    """``x[idx]`` whose backward scatter-adds the cotangent at ``idx`` in
    ``perm`` order (``perm`` sorts ``idx``), or in edge order without one,
    accumulating a 16-bit cotangent in float32."""

    @staticmethod
    def forward(ctx, x, idx, perm):
        ctx.save_for_backward(idx, perm)
        ctx.n = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, perm = ctx.saved_tensors
        dt = g.dtype
        narrow = dt in _NARROW
        if narrow and perm is not None and _bf16_sorted_scatter():
            narrow = False
        acc_dt = torch.float32 if narrow else dt
        dx = g.new_zeros((ctx.n,) + g.shape[1:], dtype=acc_dt)
        if perm is None:
            return dx.index_add_(0, idx, g.to(acc_dt)).to(dt), None, None
        e = g.shape[0]
        op_bytes = g.numel() * 4  # the widened operand
        csize = e
        if op_bytes > _BWD_CHUNK_ENGAGE:
            csize = -(-e // -(-op_bytes // _BWD_CHUNK_TARGET))
        # permute in the cotangent's own dtype and widen after: the
        # widening is exact, so the order of the two does not matter
        for s in range(0, e, csize):
            sl = perm[s: s + csize]
            dx.index_add_(0, idx.index_select(0, sl), g.index_select(0, sl).to(acc_dt))
        return dx.to(dt), None, None


def edge_gather(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """``x[op.col]``, its backward the sorted float32 scatter above."""
    return _EdgeGather.apply(x, op.col, op.col_perm)


def row_gather(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """``x[op.row]``, its backward a segment sum at the sorted rows in
    float32 (plain indexing would scatter a 16-bit cotangent in 16 bits)."""
    return _EdgeGather.apply(x, op.row, None)


def _segsum(msg: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of ``msg [E, ...]`` at ``rows`` → ``[n, ...]``; a
    16-bit message is summed in float32 and narrowed after."""
    acc_dt = torch.float32 if msg.dtype in _NARROW else msg.dtype
    out = msg.new_zeros((n,) + msg.shape[1:], dtype=acc_dt)
    return out.index_add(0, rows, msg.to(acc_dt)).to(msg.dtype)


def _edge_scale(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-edge weights ``w [E]`` against ``x [E, ...]``."""
    return w.reshape(w.shape + (1,) * (x.ndim - 1)) * x


def spmv(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """``S @ x`` for ``x [N]`` or ``[N, F]``, in x's dtype (the weights
    are cast to it)."""
    xg = edge_gather(op, x)
    return _segsum(_edge_scale(op.val.to(x.dtype), xg), op.row, op.n)


def live_degree(op: SparseOp) -> torch.Tensor:
    """Per node, the count of live incoming edges (``val != 0``), float32."""
    return _segsum((op.val != 0.0).to(torch.float32), op.row, op.n)


def mean_spmv(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """The mean over each node's live in-neighbours, whatever the
    operator's normalization (GraphSAGE's aggregator); 0 for a node
    without one."""
    live = (op.val != 0.0).to(x.dtype)
    out = _segsum(_edge_scale(live, edge_gather(op, x)), op.row, op.n)
    deg = torch.clamp_min(_segsum(live, op.row, op.n), 1.0)
    return out / deg.reshape(deg.shape + (1,) * (x.ndim - 1))


def masked_val_op(op: SparseOp, keep: torch.Tensor) -> SparseOp:
    """``op`` with the edges where ``keep`` is False set to 0: shapes stay,
    liveness rides ``val``."""
    return op.replace(val=torch.where(keep, op.val, torch.zeros_like(op.val)))


def sym_normalize_coo(op: SparseOp, kernel: torch.Tensor, eps: float = 1e-12) -> SparseOp:
    """``D^{-1/2} K D^{-1/2}`` of per-edge weights ``kernel [E]`` on the
    live edges, differentiable in ``kernel``."""
    k = kernel * (op.val != 0.0).to(kernel.dtype)
    deg = k.new_zeros(op.n).index_add(0, op.row, k)
    inv_sqrt = torch.where(deg > eps, torch.rsqrt(torch.clamp_min(deg, eps)),
                           torch.zeros_like(deg))
    return op.replace(val=k * row_gather(op, inv_sqrt) * edge_gather(op, inv_sqrt))


def learned_kernel_op(op: SparseOp, emb: torch.Tensor, eps: float = 1e-12) -> SparseOp:
    """AdaLanczosNet's learned operator on the edge support: the
    Gaussian kernel ``exp(−‖e_dst − e_src‖² / √dim)`` of node embeddings
    ``emb [N, D]`` on each edge, symmetrically normalized."""
    scale = math.sqrt(float(emb.shape[-1]))
    d2 = ((row_gather(op, emb) - edge_gather(op, emb)) ** 2).sum(-1)
    return sym_normalize_coo(op, torch.exp(-d2 / scale), eps)


def partition_masks(op: SparseOp, part: torch.Tensor) -> tuple[SparseOp, SparseOp]:
    """(intra, cut): ``op`` restricted to the edges whose ends share a
    partition id of ``part [N]``, and to those that cross."""
    same = part.index_select(0, op.row) == part.index_select(0, op.col)
    return masked_val_op(op, same), masked_val_op(op, ~same)


def spectral_project(ritz_vec: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``Vᵀ h`` ``[K, F]`` in float32 whatever h's dtype and the TF32
    flags: the node-axis contraction of LanczosNet's long scales."""
    with f32_matmul():
        return ritz_vec.T @ h.to(torch.float32)


def segment_softmax_coo(
    logits: torch.Tensor,
    op: SparseOp,
    self_logits: Optional[torch.Tensor] = None,
    eps: float = 1e-16,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Stable softmax over each node's live incoming edges.

    ``logits [E, ...]`` per edge; ``self_logits [N, ...]`` of an implicit
    self-edge per node, joined to the normalization. Returns (``p [E,
    ...]`` unnormalized weights, ``denom [N, ...]`` at least ``eps``,
    ``p_self [N, ...]`` or None). The segment max only stabilizes the
    exponent, so its gradient is cut; a node with no live edge and no
    self-edge gets ``denom = eps`` and no NaN.
    """
    live = (op.val != 0.0).to(logits.dtype)
    live = live.reshape(live.shape + (1,) * (logits.ndim - 1))
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    masked = torch.where(live > 0, logits, neg)
    idx = op.row.long().reshape((-1,) + (1,) * (logits.ndim - 1)).expand_as(masked)
    m = torch.full((op.n,) + logits.shape[1:], float("-inf"), dtype=logits.dtype,
                   device=logits.device)
    m = m.scatter_reduce(0, idx, masked.detach(), "amax", include_self=False)
    if self_logits is not None:
        m = torch.maximum(m, self_logits.detach())
    m = torch.maximum(m, neg)  # a segment with no edge stays at -inf
    p = torch.exp(masked - m.index_select(0, op.row)) * live
    denom = _segsum(p, op.row, op.n)
    p_self = None
    if self_logits is not None:
        p_self = torch.exp(self_logits - m)
        denom = denom + p_self
    return p, torch.clamp_min(denom, eps), p_self


def attention_spmv(op: SparseOp, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Σ_{e: row=i} p_e · x[col_e]``: per-edge weights ``p [E, ...]``
    against ``x [N, ..., F]``."""
    return _segsum(p[..., None].to(x.dtype) * edge_gather(op, x), op.row, op.n)


def gat_attention(
    op: SparseOp,
    s_dst: torch.Tensor,
    s_src: torch.Tensor,
    hp: torch.Tensor,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """GAT's neighbourhood attention: per destination, a softmax over its
    live incoming edges and an implicit self-edge of the logits
    ``leaky_relu(s_dst[dst] + s_src[src])`` (``[N, H]`` each), applied to
    ``hp [N, H, D]`` → ``[N, H, D]``."""
    self_logits = F.leaky_relu(s_dst + s_src, negative_slope)
    logits = F.leaky_relu(row_gather(op, s_dst) + edge_gather(op, s_src), negative_slope)
    p, denom, p_self = segment_softmax_coo(logits, op, self_logits)
    msg = attention_spmv(op, p, hp) + p_self[..., None] * hp
    return msg / denom[..., None].to(hp.dtype)


def sparse_lanczos_ritz(op: SparseOp, k: int, eps: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ritz pairs ``(vals [k], vecs [N, k])`` of ``op``: the recursion on
    its product (rows at or past ``n_true`` get no start weight), the
    eigh of the tridiagonal through the clamped backward of
    ``ops/eigh.py``, the rotation in float32. Differentiable in
    ``op.val``."""
    mask = torch.ones(op.n, dtype=torch.float32, device=op.val.device)
    if op.n_true is not None:
        mask[op.n_true:] = 0.0
    alphas, betas, q = lanczos_tridiag_matvec(lambda v: spmv(op, v), mask, k, eps)
    vals, u = eigh(tridiag_matrix(alphas, betas))
    with f32_matmul():
        return vals, q.T @ u


def sparse_diffusion_features(op: SparseOp, x: torch.Tensor, dists) -> list[torch.Tensor]:
    """``[S^t x for t in dists]`` (ascending distances) as a list: the
    JAX function stacks them, the port's callers take them one by one."""
    outs, cur = [], x
    for t in range(1, max(dists, default=0) + 1):
        cur = spmv(op, cur)
        if t in dists:
            outs.append(cur)
    return outs
