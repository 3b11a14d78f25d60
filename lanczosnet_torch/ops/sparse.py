"""Sparse (COO) full-graph operators: the path for graphs too large for
a dense ``[N, N]`` operator.

Counterpart of ``lanczosnet_tpu/ops/sparse.py``. The operator lives as
COO edges in destination-major order; a product is a gather of the
sources (``index_select``) and a segment sum at the destinations
(``index_add_``), and the K-step Lanczos recursion
(``ops/lanczos.py:lanczos_tridiag_matvec``) runs with that product as
its matvec, so LanczosNet's Ritz machinery works at sparse scale.

The product ``spmv`` on a CUDA tensor is one hand-written kernel
(``ops/sparse_cuda.py:csr_spmm``, ``csrc/spmm_csr.cu``) over the
destination-major rows ``SparseOp.row_ptr``, its backward the same
kernel over the transposed view; in ring form one launch a hop, over
that hop's slice (``RingOp.row_ptr``). On a CPU tensor it is the plain
version ``_spmv_plain``, the gather, edge scale and segment sum below,
which the kernel matches bit for bit. GAT's weighted sum
``attention_spmv`` takes the same kernel on the card, one launch a head
(``sparse_cuda.csr_spmm_heads``), its plain version
``_attention_plain`` on the CPU. A CUDA tensor the kernels do not take
(a dtype other than float32 and bfloat16) raises. Every other op here
runs on ATen's gathers and segment sums on either device.

Dtypes: a 16-bit message is widened to float32 before every segment
sum and narrowed after it (``_segsum``), so no ``index_add_`` runs in
bfloat16: CUDA's 16-bit atomics are slow and lose mantissa on
high-degree nodes. The gather of node states at the edge sources is
``edge_gather``, an ``autograd.Function`` whose backward scatter-adds
the cotangents at ``col`` in ``col_perm`` order, widened to float32,
in chunks above a size bound. ``LANCZOSNET_BF16_SCATTER``, the JAX
package's opt-in, keeps that sorted scatter in the cotangent's own
16-bit dtype; the kernel's backward of ``spmv`` on the card sums in
float32 always.

Sharded forms, each a rank's piece (``parallel/mesh.py``) tagged with
the ``Comm`` of its group, so that model code is the same sharded and
not:

- edge-sharded ``SparseOp`` (``axis``): this rank holds a slice of the
  edges and every node array whole; each segment reduction ends in a
  ``psum`` (a ``pmax`` for the softmax's max) over the ranks.
- node-sharded ``SparseOp`` (``gather_axis``): this rank holds a block
  of ``n`` rows and every edge into it (``row`` block-local, ``col``
  global); segment reductions are complete locally, and the one
  collective is the source gather (``gather_nodes``: an all-gather,
  its backward a reduce-scatter).
- ``RingOp``: the node-sharded edges cut again by source block; the D
  source blocks travel the ring one hop a step (``ring_hop``), so a
  rank never holds more than two blocks of sources.

Under the comm layer's convention (``parallel/comm.py``: each rank's
loss is its share, the parameter gradients are summed once a step)
``edge_gather`` needs no collective in its backward in edge mode, where
the JAX package's ends in a ``psum``: each rank's partial gradient
reaches the parameters and their all-reduce sums the parts.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from lanczosnet_torch.ops.eigh import eigh_dispatch
from lanczosnet_torch.ops.lanczos import lanczos_tridiag_matvec, tridiag_matrix
from lanczosnet_torch.ops.precision import f32_matmul
from lanczosnet_torch.ops.sparse_cuda import csr_row_ptr, csr_spmm, csr_spmm_heads
from lanczosnet_torch.parallel.comm import Comm, all_gather_rows, pmax, psum, ring_hop
from lanczosnet_torch.utils.profiling import span

_NARROW = (torch.bfloat16, torch.float16)

# Above _BWD_CHUNK_ENGAGE bytes of widened cotangent, the sorted backward
# scatter of edge_gather runs in chunks of about _BWD_CHUNK_TARGET bytes,
# so the float32 [E, F] operand never exists whole (at 10M nodes and
# 25M edges it is 3.2 GB). The values of the JAX package.
_BWD_CHUNK_ENGAGE = 2 * 1024**3
_BWD_CHUNK_TARGET = 1 * 1024**3


def _move(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device)


@dataclasses.dataclass(frozen=True)
class SparseOp:
    """A graph operator in COO form, whole or one rank's piece.

    ``row [E]`` int32 destinations, non-decreasing when ``rows_sorted``;
    ``col [E]`` int32 sources; ``val [E]`` float32 weights, exactly 0 on
    an edge that is not live (consumers read ``val != 0`` as liveness);
    ``n`` the node count (of this rank's block, node-sharded);
    ``col_perm [E]`` int32, the permutation that sorts ``col`` (the order
    of ``edge_gather``'s backward scatter), or None; ``n_true`` the count
    of real nodes when the node axis is padded (rows at or past it get
    no start weight in ``sparse_lanczos_ritz``), None when every row is
    real. ``axis`` (edge-sharded) or ``gather_axis`` (node-sharded) is
    the ``Comm`` of the group whose ranks hold the other pieces.
    ``row_ptr [n+1]`` int32, where ``row`` is sorted, gives row r's
    edges as ``row_ptr[r]:row_ptr[r+1]`` (``sparse_cuda.csr_row_ptr``):
    the CSR form the card's product kernel walks; None where the op was
    built without it, which only the CPU's plain version takes.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n: int
    rows_sorted: bool = False
    col_perm: Optional[torch.Tensor] = None
    n_true: Optional[int] = None
    axis: Optional[Comm] = None
    gather_axis: Optional[Comm] = None
    row_ptr: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.axis is not None and self.gather_axis is not None:
            raise ValueError("SparseOp cannot be both edge-sharded (axis) and node-sharded "
                             "(gather_axis)")

    def replace(self, **changes) -> "SparseOp":
        """A copy with ``changes``; new ``row`` or ``n`` without a new
        ``row_ptr`` drops the old one, which described the old rows."""
        if ("row" in changes or "n" in changes) and "row_ptr" not in changes:
            changes["row_ptr"] = None
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "SparseOp":
        return self.replace(row=_move(self.row, device), col=_move(self.col, device),
                            val=_move(self.val, device), col_perm=_move(self.col_perm, device),
                            row_ptr=_move(self.row_ptr, device))

    @property
    def num_edges(self) -> int:
        return int(self.row.shape[0])


@dataclasses.dataclass(frozen=True)
class RingOp:
    """A node-sharded operator in ring form: this rank's piece.

    ``row``, ``col``, ``val`` are ``[D, E2]``: slice s holds the edges
    into this rank's block whose sources lie in block s, ``row`` local to
    this rank's block and ``col`` local to block s (dead edges have
    ``val`` 0). ``n`` is a block's rows; ``axis`` the ring's ``Comm``.
    Each slice's rows are non-decreasing, and ``row_ptr [D, n+1]`` int32
    gives slice s's ``csr_row_ptr`` (the card's product kernel walks
    it); None where the op was built without it, which only the CPU's
    plain version takes.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n: int
    axis: Comm
    n_true: Optional[int] = None
    row_ptr: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "RingOp":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "RingOp":
        return self.replace(row=self.row.to(device), col=self.col.to(device),
                            val=self.val.to(device), row_ptr=_move(self.row_ptr, device))

    @property
    def num_edges(self) -> int:
        return int(self.row.numel())


AnyOp = Union[SparseOp, RingOp]


def coo_arrays(edges: np.ndarray, n: int, kind: str = "sym", eps: float = 1e-12) -> dict:
    """Both directions of each undirected edge of ``edges [E, 2]`` (pairs
    i != j) in destination-major order, on the host → ``{"row", "col",
    "val", "col_perm"}``; ``kind`` ``sym`` weighs them ``D^{-1/2} A
    D^{-1/2}``, ``row_stochastic`` ``D^{-1} A`` (DCNN's operator)."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    row = np.concatenate([e[:, 0], e[:, 1]])
    col = np.concatenate([e[:, 1], e[:, 0]])
    deg = np.bincount(row, minlength=n).astype(np.float64)
    if kind == "sym":
        inv_sqrt = np.where(deg > eps, 1.0 / np.sqrt(np.maximum(deg, eps)), 0.0)
        val = inv_sqrt[row] * inv_sqrt[col]
    elif kind == "row_stochastic":
        val = (1.0 / np.maximum(deg, 1.0))[row]
    else:
        raise ValueError(f"operator kind must be 'sym' or 'row_stochastic', got {kind!r}")
    order = np.argsort(row, kind="stable")
    col = col[order].astype(np.int32)
    return {"row": row[order].astype(np.int32), "col": col,
            "val": val[order].astype(np.float32),
            "col_perm": np.argsort(col, kind="stable").astype(np.int32)}


def sparse_op_from_arrays(arrays: dict, n: int, device) -> SparseOp:
    """The whole operator of ``coo_arrays`` on ``device``, its ``row_ptr``
    built there."""
    as_t = lambda k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)  # noqa: E731
    row = as_t("row")
    return SparseOp(row=row, col=as_t("col"), val=as_t("val"), n=int(n), rows_sorted=True,
                    col_perm=as_t("col_perm"), row_ptr=csr_row_ptr(row, int(n)))


def sparse_sym_operator(edges: np.ndarray, n: int, eps: float = 1e-12,
                        device: str | torch.device = "cpu") -> SparseOp:
    """``D^{-1/2} A D^{-1/2}`` of an undirected edge list ``[E, 2]``
    (pairs i != j), built on the host as the JAX constructor builds it
    and placed on ``device``."""
    return sparse_op_from_arrays(coo_arrays(edges, n, "sym", eps), n, device)


def sparse_row_stochastic_operator(edges: np.ndarray, n: int,
                                   device: str | torch.device = "cpu") -> SparseOp:
    """The transition matrix ``D^{-1} A`` (DCNN's diffusion operator)."""
    return sparse_op_from_arrays(coo_arrays(edges, n, "row_stochastic"), n, device)


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


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``, its backward an unsorted float32-accumulated scatter."""
    return _EdgeGather.apply(x, idx, None)


def gather_nodes(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """The whole node axis of ``x`` for ``col`` indexing: ``x`` itself,
    or node-sharded the ranks' blocks all-gathered (transient: alive
    only for the gather that indexes it)."""
    if op.gather_axis is None:
        return x
    return all_gather_rows(x, op.gather_axis)


def edge_gather(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """``gather_nodes(op, x)[op.col]``, its backward the sorted float32
    scatter above."""
    return _EdgeGather.apply(gather_nodes(op, x), op.col, op.col_perm)


def row_gather(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """``x[op.row]``, its backward a segment sum at the sorted rows in
    float32 (plain indexing would scatter a 16-bit cotangent in 16 bits)."""
    return _gather(x, op.row)


def _segsum(msg: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of ``msg [E, ...]`` at ``rows`` → ``[n, ...]``; a
    16-bit message is summed in float32 and narrowed after."""
    acc_dt = torch.float32 if msg.dtype in _NARROW else msg.dtype
    out = msg.new_zeros((n,) + msg.shape[1:], dtype=acc_dt)
    return out.index_add(0, rows, msg.to(acc_dt)).to(msg.dtype)


def _segmax(values: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Segment max of ``values [E, ...]`` at ``rows`` → ``[n, ...]``, −inf
    where a segment is empty; no gradient."""
    idx = rows.long().reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    m = torch.full((n,) + values.shape[1:], float("-inf"), dtype=values.dtype,
                   device=values.device)
    return m.scatter_reduce(0, idx, values.detach(), "amax", include_self=False)


def _edge_scale(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-edge weights ``w [E]`` against ``x [E, ...]``."""
    return w.reshape(w.shape + (1,) * (x.ndim - 1)) * x


def _per_node(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v [N]`` shaped to divide ``x [N, ...]``."""
    return v.reshape(v.shape + (1,) * (x.ndim - 1))


def _edge_sum(op: SparseOp, out: torch.Tensor) -> torch.Tensor:
    """A segment sum finished over the edge shards (edge mode)."""
    return out if op.axis is None else psum(out, op.axis)


def _ring_slice(rop: RingOp, src: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's (rows, cols, vals) from source block ``src``."""
    return rop.row[src], rop.col[src], rop.val[src]


def _ring(rop: RingOp, blocks):
    """The D steps of a ring pass: yields ``(src, blocks)``, where
    ``blocks`` (a tuple of node-block tensors, this rank's at step 0) are
    those that started on rank ``src``; between steps each goes one hop."""
    d, me = rop.axis.size, rop.axis.rank
    for s in range(d):
        yield (me - s) % d, blocks
        if s + 1 < d:
            blocks = tuple(ring_hop(b, rop.axis) for b in blocks)


def ring_spmv(rop: RingOp, x: torch.Tensor) -> torch.Tensor:
    """``S @ x`` for this rank's rows, ``x`` its block; the source blocks
    come round the ring, so at most two are held at a time. Each hop's
    product is the card's kernel over its slice for a CUDA tensor, the
    plain version's gather, scale and segment sum for any other."""
    if x.device.type == "cuda" and rop.row_ptr is None:
        raise ValueError("ring_spmv on the card needs the operator's row_ptr: build it with "
                         "parallel/mesh.py:ring_op_piece")
    acc = None
    for src, (block,) in _ring(rop, (x,)):
        rows, cols, vals = _ring_slice(rop, src)
        if block.device.type == "cuda":
            part = csr_spmm(rop.row_ptr[src], rows, cols, vals, None, block)
        else:
            part = _segsum(_edge_scale(vals.to(x.dtype), _gather(block, cols)), rows, rop.n)
        acc = part if acc is None else acc + part
    return acc


def ring_mean_spmv(rop: RingOp, x: torch.Tensor) -> torch.Tensor:
    """The neighbour mean in ring form: live-edge counts accumulate
    beside the messages, so degrees are complete after one pass."""
    acc = deg = None
    for src, (block,) in _ring(rop, (x,)):
        rows, cols, vals = _ring_slice(rop, src)
        live = (vals != 0.0).to(x.dtype)
        part = _segsum(_edge_scale(live, _gather(block, cols)), rows, rop.n)
        cnt = _segsum(live, rows, rop.n)
        acc, deg = (part, cnt) if acc is None else (acc + part, deg + cnt)
    return acc / _per_node(torch.clamp_min(deg, 1.0), x)


def _spmv_plain(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """The plain version of the card's product kernel: the gather, the
    edge scale in x's dtype and the float32 segment sum, which on the CPU
    adds in edge order as the kernel does."""
    xg = edge_gather(op, x)
    return _edge_sum(op, _segsum(_edge_scale(op.val.to(x.dtype), xg), op.row, op.n))


def _card_row_ptr(op: SparseOp, what: str) -> torch.Tensor:
    """``op.row_ptr``, which the card's kernels need; raises without it."""
    if op.row_ptr is None:
        raise ValueError(f"{what} on the card needs the operator's row_ptr: build it with "
                         "sparse_op_from_arrays or parallel/mesh.py:sparse_op_piece, or "
                         "pass row_ptr=csr_row_ptr(row, n) for sorted rows")
    return op.row_ptr


def spmv(op: AnyOp, x: torch.Tensor) -> torch.Tensor:
    """``S @ x`` for ``x [N]`` or ``[N, F]`` (this rank's block when node-
    sharded), in x's dtype (the weights are cast to it); traced as the
    span ``sparse.spmv``. A CUDA tensor goes to the CSR kernel
    (``sparse_cuda.csr_spmm``, which needs ``op.row_ptr`` and raises on a
    dtype it does not take), any other to ``_spmv_plain``."""
    with span("sparse.spmv"):
        if isinstance(op, RingOp):
            return ring_spmv(op, x)
        if x.device.type != "cuda":
            return _spmv_plain(op, x)
        row_ptr = _card_row_ptr(op, "spmv")
        xg = gather_nodes(op, x)
        return _edge_sum(op, csr_spmm(row_ptr, op.row, op.col, op.val, op.col_perm, xg))


def live_degree(op: AnyOp) -> torch.Tensor:
    """Per node, the count of live incoming edges (``val != 0``), float32."""
    live = (op.val != 0.0).to(torch.float32)
    if isinstance(op, RingOp):
        return _segsum(live.reshape(-1), op.row.reshape(-1), op.n)
    return _edge_sum(op, _segsum(live, op.row, op.n))


def mean_spmv(op: AnyOp, x: torch.Tensor) -> torch.Tensor:
    """The mean over each node's live in-neighbours, whatever the
    operator's normalization (GraphSAGE's aggregator); 0 for a node
    without one."""
    if isinstance(op, RingOp):
        return ring_mean_spmv(op, x)
    live = (op.val != 0.0).to(x.dtype)
    out = _edge_sum(op, _segsum(_edge_scale(live, edge_gather(op, x)), op.row, op.n))
    deg = torch.clamp_min(_edge_sum(op, _segsum(live, op.row, op.n)), 1.0)
    return out / _per_node(deg, x)


def masked_val_op(op: AnyOp, keep: torch.Tensor) -> AnyOp:
    """``op`` with the edges where ``keep`` is False set to 0: shapes stay,
    liveness rides ``val``."""
    return op.replace(val=torch.where(keep, op.val, torch.zeros_like(op.val)))


def sym_normalize_coo(op: SparseOp, kernel: torch.Tensor, eps: float = 1e-12) -> SparseOp:
    """``D^{-1/2} K D^{-1/2}`` of per-edge weights ``kernel [E]`` on the
    live edges, differentiable in ``kernel`` (degrees summed over the
    edge shards; node-sharded they are complete locally and the source
    side's normalizer comes through the gather). A ``RingOp`` goes
    through ``learned_kernel_op``."""
    if isinstance(op, RingOp):
        raise TypeError("sym_normalize_coo takes a SparseOp; for ring form use "
                        "learned_kernel_op")
    k = kernel * (op.val != 0.0).to(kernel.dtype)
    deg = _edge_sum(op, _segsum(k, op.row, op.n))
    inv_sqrt = torch.where(deg > eps, torch.rsqrt(torch.clamp_min(deg, eps)),
                           torch.zeros_like(deg))
    return op.replace(val=k * row_gather(op, inv_sqrt) * edge_gather(op, inv_sqrt))


def learned_kernel_op(op: AnyOp, emb: torch.Tensor, eps: float = 1e-12) -> AnyOp:
    """AdaLanczosNet's learned operator on the edge support: the
    Gaussian kernel ``exp(−‖e_dst − e_src‖² / √dim)`` of node embeddings
    ``emb [N, D]`` on each edge, symmetrically normalized.

    Ring form takes two passes: the embedding blocks go round once to
    weigh each (destination, source) slice; then, the degrees being
    local sums over all slices, the inverse-sqrt degrees go round once
    to scale each slice by its sources' normalizer."""
    scale = math.sqrt(float(emb.shape[-1]))
    if not isinstance(op, RingOp):
        d2 = ((row_gather(op, emb) - edge_gather(op, emb)) ** 2).sum(-1)
        return sym_normalize_coo(op, torch.exp(-d2 / scale), eps)
    kvals = [None] * op.axis.size
    for src, (block,) in _ring(op, (emb,)):
        rows, cols, vals = _ring_slice(op, src)
        d2 = ((_gather(emb, rows) - _gather(block, cols)) ** 2).sum(-1)
        kvals[src] = torch.exp(-d2 / scale) * (vals != 0.0).to(emb.dtype)
    kval = torch.stack(kvals)
    deg = _segsum(kval.reshape(-1), op.row.reshape(-1), op.n)
    inv = torch.where(deg > eps, torch.rsqrt(torch.clamp_min(deg, eps)), torch.zeros_like(deg))
    vals_out = [None] * op.axis.size
    for src, (block,) in _ring(op, (inv,)):
        rows, cols, _ = _ring_slice(op, src)
        vals_out[src] = kval[src] * _gather(inv, rows) * _gather(block, cols)
    return op.replace(val=torch.stack(vals_out))


def partition_masks(op: AnyOp, part: torch.Tensor) -> tuple[AnyOp, AnyOp]:
    """(intra, cut): ``op`` restricted to the edges whose ends share a
    partition id of ``part [N]`` (this rank's block when node-sharded),
    and to those that cross. Ring form sends the ids round once, so each
    slice compares against its sources' block."""
    if not isinstance(op, RingOp):
        same = part.index_select(0, op.row) == gather_nodes(op, part).index_select(0, op.col)
        return masked_val_op(op, same), masked_val_op(op, ~same)
    same = [None] * op.axis.size
    for src, (block,) in _ring(op, (part,)):
        rows, cols, _ = _ring_slice(op, src)
        same[src] = part.index_select(0, rows) == block.index_select(0, cols)
    same = torch.stack(same)
    return masked_val_op(op, same), masked_val_op(op, ~same)


def _node_axis(op: AnyOp) -> Optional[Comm]:
    """The ``Comm`` over which the node axis is cut, or None."""
    return op.axis if isinstance(op, RingOp) else op.gather_axis


def spectral_project(ritz_vec: torch.Tensor, h: torch.Tensor,
                     op: Optional[AnyOp] = None) -> torch.Tensor:
    """``Vᵀ h`` ``[K, F]`` in float32 whatever h's dtype and the TF32
    flags: the node-axis contraction of LanczosNet's long scales; summed
    over the ranks where ``op`` cuts the node axis."""
    with f32_matmul():
        vtx = ritz_vec.T @ h.to(torch.float32)
    axis = None if op is None else _node_axis(op)
    return vtx if axis is None else psum(vtx, axis)


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
    self-edge gets ``denom = eps`` and no NaN. Edge-sharded, the max and
    the denominator span every shard (``pmax``, ``psum``).
    """
    live = (op.val != 0.0).to(logits.dtype)
    live = live.reshape(live.shape + (1,) * (logits.ndim - 1))
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    masked = torch.where(live > 0, logits, neg)
    m = _segmax(masked, op.row, op.n)
    if op.axis is not None:
        m = pmax(m, op.axis)
    if self_logits is not None:
        m = torch.maximum(m, self_logits.detach())
    m = torch.maximum(m, neg)  # a segment with no edge stays at -inf
    p = torch.exp(masked - m.index_select(0, op.row)) * live
    denom = _edge_sum(op, _segsum(p, op.row, op.n))
    p_self = None
    if self_logits is not None:
        p_self = torch.exp(self_logits - m)
        denom = denom + p_self
    return p, torch.clamp_min(denom, eps), p_self


def _attention_plain(op: SparseOp, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``attention_spmv``: the gather, the edge scale
    in x's dtype and the float32 segment sum."""
    return _edge_sum(op, _segsum(p[..., None].to(x.dtype) * edge_gather(op, x), op.row, op.n))


def attention_spmv(op: SparseOp, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Σ_{e: row=i} p_e · x[col_e]``: per-edge weights ``p [E, ...]``
    against ``x [N, ..., F]``. On the card, heads ``p [E, H]`` and ``x
    [N, H, D]`` (this rank's block when node-sharded) take the CSR kernel
    a head (``sparse_cuda.csr_spmm_heads`` on x laid out head-major,
    ``p``'s columns its weights), with no ``[E, H, D]`` tensor, and any
    other shape raises; a CPU tensor takes ``_attention_plain``, which the
    kernel matches bit for bit."""
    if x.device.type != "cuda":
        return _attention_plain(op, p, x)
    if p.dim() != 2 or x.dim() != 3:
        raise ValueError(f"attention_spmv on the card takes p [E, H] and x [N, H, D], got "
                         f"{tuple(p.shape)} and {tuple(x.shape)}")
    row_ptr = _card_row_ptr(op, "attention_spmv")
    xg = gather_nodes(op, x).permute(1, 0, 2)
    w = p.to(x.dtype).to(torch.float32).t()
    out = csr_spmm_heads(row_ptr, op.row, op.col, w, op.col_perm, xg)
    return _edge_sum(op, out.permute(1, 0, 2))


def gat_attention(
    op: AnyOp,
    s_dst: torch.Tensor,
    s_src: torch.Tensor,
    hp: torch.Tensor,
    negative_slope: float = 0.2,
    eps: float = 1e-16,
) -> torch.Tensor:
    """GAT's neighbourhood attention: per destination, a softmax over its
    live incoming edges and an implicit self-edge of the logits
    ``leaky_relu(s_dst[dst] + s_src[src])`` (``[N, H]`` each), applied to
    ``hp [N, H, D]`` → ``[N, H, D]``.

    Ring form is an online softmax: the source blocks of ``s_src`` and
    ``hp`` go round the ring, and each destination carries a running
    max, denominator and weighted sum, rescaled by ``exp(m − m_new)`` as
    each block arrives; the self-edge joins after the last. Exact: the
    softmax does not depend on the running max, whose gradient is cut."""
    self_logits = F.leaky_relu(s_dst + s_src, negative_slope)
    if not isinstance(op, RingOp):
        logits = F.leaky_relu(row_gather(op, s_dst) + edge_gather(op, s_src), negative_slope)
        p, denom, p_self = segment_softmax_coo(logits, op, self_logits)
        msg = attention_spmv(op, p, hp) + p_self[..., None] * hp
        return msg / denom[..., None].to(hp.dtype)
    n, h = s_dst.shape
    # -1e30, not -inf: exp(neg − neg) = 1 rescales an empty accumulator
    # and exp(neg − m) underflows to 0, with no inf − inf anywhere
    neg = torch.tensor(-1e30, dtype=s_dst.dtype, device=s_dst.device)
    m = torch.full((n, h), -1e30, dtype=s_dst.dtype, device=s_dst.device)
    den = torch.zeros((n, h), dtype=s_dst.dtype, device=s_dst.device)
    acc = torch.zeros_like(hp)
    for src, (s_blk, hp_blk) in _ring(op, (s_src, hp)):
        rows, cols, vals = _ring_slice(op, src)
        live = (vals != 0.0).to(s_dst.dtype)[:, None]
        logits = F.leaky_relu(_gather(s_dst, rows) + _gather(s_blk, cols), negative_slope)
        masked = torch.where(live > 0, logits, neg)
        m_new = torch.maximum(m, torch.maximum(_segmax(masked, rows, n), neg))
        scale = torch.exp(m - m_new)
        p = torch.exp(masked - m_new.index_select(0, rows)) * live
        den = den * scale + _segsum(p, rows, n)
        acc = acc * scale[..., None] + _segsum(
            p[..., None].to(hp.dtype) * _gather(hp_blk, cols), rows, n)
        m = m_new
    m_fin = torch.maximum(m, self_logits.detach())
    rescale = torch.exp(m - m_fin)
    p_self = torch.exp(self_logits - m_fin)
    den = den * rescale + p_self
    acc = acc * rescale[..., None] + p_self[..., None] * hp
    return acc / torch.clamp_min(den, eps)[..., None].to(hp.dtype)


def sparse_lanczos_ritz(op: AnyOp, k: int, eps: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ritz pairs ``(vals [k], vecs [N, k])`` of ``op``: the recursion on
    its product (rows at or past ``n_true`` get no start weight), the
    eigensolve of the tridiagonal through ``ops/eigh.py:eigh_dispatch``
    and its clamped backward, the rotation in float32. Differentiable in
    ``op.val``.

    Node-sharded (either form) the recursion is the global one on this
    rank's rows: every inner product summed over the ranks, the start
    vector at the global node ids; ``vals`` come out the same on every
    rank and ``vecs`` are this rank's ``[n, k]`` rows. Edge-sharded the
    vectors are whole on every rank and only the product is summed."""
    axis = _node_axis(op)
    offset = axis.rank * op.n if axis is not None else 0
    mask = torch.ones(op.n, dtype=torch.float32, device=op.val.device)
    if op.n_true is not None:
        mask[max(0, min(op.n, op.n_true - offset)):] = 0.0
    alphas, betas, q = lanczos_tridiag_matvec(lambda v: spmv(op, v), mask, k, eps,
                                              axis=axis, index_offset=offset)
    vals, u = eigh_dispatch(tridiag_matrix(alphas, betas))
    with f32_matmul():
        return vals, q.T @ u


def sparse_diffusion_features(op: AnyOp, x: torch.Tensor, dists) -> list[torch.Tensor]:
    """``[S^t x for t in dists]`` (ascending distances) as a list: the
    JAX function stacks them, the port's callers take them one by one."""
    outs, cur = [], x
    for t in range(1, max(dists, default=0) + 1):
        cur = spmv(op, cur)
        if t in dists:
            outs.append(cur)
    return outs
