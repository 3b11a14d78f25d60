"""Host side of the CSR product kernels (``csrc/spmm_csr.cu``) and their
autograd wrapper, ``_CsrSpmm``.

``ops/sparse.py:spmv`` on a CUDA tensor calls ``csr_spmm``: one launch
of ``spmm_csr_kernel`` for ``out = S x`` over the destination-major
rows (``SparseOp.row_ptr``, built once with the operator); in the
backward the same kernel over the source-major view for ``dx = Sᵀ g``
(``csr_transpose``: ``col_ptr``, ``row[col_perm]`` and ``val[col_perm]``,
built on the device inside the backward and dropped after it), and,
only where the weights require a gradient (AdaLanczosNet's learned
operator, GAT's attention weights), ``spmm_sddmm_kernel`` for ``dval_e
= Σ_f g[row_e, f] · x[col_e, f]``. ``_CsrSpmm`` launches them for H
products over one CSR (heads); ``csr_spmm``'s product is one head. The
plain versions are ``ops/sparse.py:_spmv_plain`` and ``_attention_plain``,
which ``spmv`` and ``attention_spmv`` run for a CPU tensor; a CUDA
tensor launches the kernels or raises.

Numerics are the plain version's: each edge's message is the weight
cast to x's dtype times x's element, rounded to x's dtype, summed in
float32 in edge order (the backward in ``col_perm`` order, the order of
the plain version's sorted scatter) and narrowed once; the weights'
gradient is summed in float32 and rounded to x's dtype, as the gradient
of the weights' cast is. So the kernels' sums are deterministic, where
the card's ``index_add`` atomics added in a changing order.
``LANCZOSNET_BF16_SCATTER``, the opt-in to a 16-bit sorted scatter, does
not reach this backward: it accumulates in float32 always, which is the
plain version's default.

GAT's attention (``ops/sparse.py:attention_spmv``) calls
``csr_spmm_heads``: H products over one CSR, each with its own edge
weights (a head's attention weights), on a head-major ``x [H, N, D]``,
one launch of each kernel a head; its backward builds the transposed
view once for the H heads. No ``[E, H, D]`` tensor exists.

The launch shape comes from the row's width alone (``spmm_plan``): one
algorithm whose parameters the shape sets, with no knob. Each kernel
counts its launches (``spmm_launches``, ``spmm_t_launches``,
``sddmm_launches``), so a run can show that every product went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from lanczosnet_torch.ops import _build
from lanczosnet_torch.ops.lanczos_cuda import LaunchCounter

# csrc/spmm_csr.cu's constants, checked against the library when it loads
THREADS = 64
UNROLL = 4
MAX_LANES = 32
VPLS = (1, 2, 4)  # 16-byte vectors (or elements) a lane holds, a tile
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# forward products; backward products to x; weight gradients
spmm_launches = LaunchCounter()
spmm_t_launches = LaunchCounter()
sddmm_launches = LaunchCounter()


@dataclass(frozen=True)
class SpmmPlan:
    """A launch's shape: each row is ``f / width`` chunks of ``width``
    elements (``width`` elements make 16 bytes in the vector form, 1 in
    the scalar form); a group of ``lanes`` threads takes one tile of
    ``lanes * vpl`` chunks, lane j chunks j, j + lanes, …; ``tiles``
    tiles cover a row."""

    width: int
    lanes: int
    vpl: int
    tiles: int


def spmm_plan(f: int, itemsize: int, vector: bool = True) -> SpmmPlan:
    """The launch shape for rows of ``f`` elements of ``itemsize`` bytes:
    16-byte vectors where the row is a whole number of them (and
    ``vector``: the operands are 16-byte aligned), else one element a
    lane; the least power-of-two group up to a warp that holds the row's
    chunks, then up to 4 chunks a lane, then tiles."""
    if f < 1:
        raise ValueError(f"f={f}: a row needs at least one element")
    width = 16 // itemsize if vector and (f * itemsize) % 16 == 0 else 1
    chunks = f // width
    lanes = 1 << (min(chunks, MAX_LANES) - 1).bit_length()
    need = -(-chunks // lanes)
    vpl = next((v for v in VPLS if v >= need), VPLS[-1])
    return SpmmPlan(width, lanes, vpl, -(-chunks // (lanes * vpl)))


def csr_row_ptr(row: torch.Tensor, n: int) -> torch.Tensor:
    """``ptr [n+1]`` int32 on ``row``'s device: rows ``r``'s edges are
    ``ptr[r]:ptr[r+1]`` of ``row``, which must be non-decreasing."""
    marks = torch.arange(n + 1, dtype=row.dtype, device=row.device)
    return torch.searchsorted(row, marks, out_int32=True)


def csr_transpose(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                  col_perm: Optional[torch.Tensor], n_src: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The source-major view of the edges → (``col_ptr [n_src+1]`` int32,
    ``row[perm]``, ``val[..., perm]``), ``perm`` being ``col_perm`` or,
    without one, the stable sort of ``col`` (edge order within a source);
    ``val`` is ``[E]`` or one row of weights a head, ``[H, E]``."""
    perm = col_perm if col_perm is not None else torch.argsort(col, stable=True)
    col_ptr = csr_row_ptr(col.index_select(0, perm), n_src)
    return col_ptr, row.index_select(0, perm), val.index_select(val.dim() - 1, perm)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_csr")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spmm_csr_launch, lib.spmm_sddmm_launch):
        fn.argtypes = [ptr] * 5 + [i] * 7 + [ptr, i]
        fn.restype = i
    lib.spmm_csr_error_string.argtypes = [i]
    lib.spmm_csr_error_string.restype = ctypes.c_char_p
    for fn, want in ((lib.spmm_csr_threads, THREADS), (lib.spmm_csr_unroll, UNROLL)):
        fn.restype = i
        if fn() != want:
            raise RuntimeError("csrc/spmm_csr.cu and its Python constants disagree")
    return lib


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _plan_for(*tensors: torch.Tensor) -> SpmmPlan:
    """The plan for 2-D operands ``[*, f]`` of one dtype."""
    f = tensors[0].shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return spmm_plan(f, tensors[0].element_size(), aligned)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().spmm_csr_error_string(rc).decode()
        raise RuntimeError(f"spmm_csr {what} failed: {msg} ({rc})")


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """``[n]`` → ``[n, 1]``, ``[n, f]`` as it is; contiguous."""
    return (t.unsqueeze(1) if t.dim() == 1 else t).contiguous()


def _launch_spmm(ptr, idx, val, x: torch.Tensor, counter: LaunchCounter,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[ptr.numel() - 1, f]`` in x's dtype: the kernel over the CSR
    (``ptr``, ``idx``, ``val``) against ``x [*, f]``, into ``out`` where
    given (contiguous)."""
    n_out = ptr.numel() - 1
    if out is None:
        out = torch.empty((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    plan = _plan_for(x, out)
    _check(_lib().spmm_csr_launch(
        ptr.data_ptr(), idx.data_ptr(), val.data_ptr(), x.data_ptr(), out.data_ptr(), n_out,
        x.shape[1], DTYPES[x.dtype], plan.width, plan.lanes, plan.vpl, plan.tiles,
        torch.cuda.current_stream(x.device).cuda_stream, _device_index(x.device)), "launch")
    counter.add()
    return out


def _launch_sddmm(ptr, col, g: torch.Tensor, x: torch.Tensor,
                  dval: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dval [E]`` float32: per edge, g's destination row against x's
    source row, summed in float32 and rounded to their dtype; into
    ``dval`` where given (contiguous)."""
    if dval is None:
        dval = torch.empty(col.shape[0], dtype=torch.float32, device=x.device)
    plan = _plan_for(g, x)
    _check(_lib().spmm_sddmm_launch(
        ptr.data_ptr(), col.data_ptr(), g.data_ptr(), x.data_ptr(), dval.data_ptr(),
        ptr.numel() - 1, x.shape[1], DTYPES[x.dtype], plan.width, plan.lanes, plan.vpl,
        plan.tiles, torch.cuda.current_stream(x.device).cuda_stream,
        _device_index(x.device)), "sddmm launch")
    sddmm_launches.add()
    return dval


class _CsrSpmm(torch.autograd.Function):
    """Per head h, ``S_h x[h]``: the CSR (``row_ptr``, ``col``) weighted by
    ``val[h]``, x ``[H, N_src, f]`` → ``[H, n, f]``, one launch a head (a
    plain product is one head); the backward builds the transposed view
    once for every head (``val``'s rows gathered together) and launches
    the kernel over it a head, and, where ``val`` requires a gradient, the
    sddmm kernel a head."""

    @staticmethod
    def forward(ctx, x, val, row_ptr, row, col, col_perm):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, val, row_ptr, row, col,
                              col_perm)
        ctx.n_src = x.shape[1]
        out = torch.empty((x.shape[0], row_ptr.numel() - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
        for h in range(x.shape[0]):
            _launch_spmm(row_ptr, col, val[h], x[h], spmm_launches, out[h])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, val, row_ptr, row, col, col_perm = ctx.saved_tensors
        g = g.contiguous()
        dx = dval = None
        if ctx.needs_input_grad[0]:
            col_ptr, row_t, val_t = csr_transpose(row, col, val, col_perm, ctx.n_src)
            dx = g.new_empty((g.shape[0], ctx.n_src, g.shape[2]))
            for h in range(g.shape[0]):
                _launch_spmm(col_ptr, row_t, val_t[h], g[h], spmm_t_launches, dx[h])
            del col_ptr, row_t, val_t
        if ctx.needs_input_grad[1]:
            dval = torch.empty_like(val)
            for h in range(g.shape[0]):
                _launch_sddmm(row_ptr, col, g[h], x[h], dval[h])
        return dx, dval, None, None, None, None


def _check_operands(what: str, row_ptr, row, col, val, col_perm, x: torch.Tensor) -> None:
    """Raise on operands the kernels do not take: x off the card or of
    another dtype than float32 and bfloat16, weights not float32, indices
    not int32, anything on another device than x."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on the card; x is on {x.device} (the plain version "
                         "is ops/sparse.py:_spmv_plain)")
    if x.dtype not in DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16 x, got {x.dtype}")
    if val.dtype != torch.float32:
        raise ValueError(f"{what} takes float32 weights, got {val.dtype}")
    for name, t in (("row_ptr", row_ptr), ("row", row), ("col", col), ("col_perm", col_perm)):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{what} takes int32 {name}, got {t.dtype}")
    for t in (row_ptr, row, col, val, col_perm):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: operator on {t.device}, x on {x.device}")


def csr_spmm_heads(row_ptr: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                   val: torch.Tensor, col_perm: Optional[torch.Tensor], x: torch.Tensor
                   ) -> torch.Tensor:
    """Per head h, ``S_h x[h]`` on the card, ``S_h`` the CSR of ``csr_spmm``
    with the weights ``val [H, E]`` float32, for ``x [H, N_src, D]``
    (float32 or bfloat16; each head's rows contiguous) → ``[H, n, D]`` in
    x's dtype; differentiable in ``x`` and ``val``. Raises on what the
    kernels do not take."""
    _check_operands("csr_spmm_heads", row_ptr, row, col, val, col_perm, x)
    if x.dim() != 3 or val.dim() != 2 or val.shape[0] != x.shape[0] or x.shape[2] == 0:
        raise ValueError(f"csr_spmm_heads takes x [H, N, D] and val [H, E], got "
                         f"{tuple(x.shape)} and {tuple(val.shape)}")
    return _CsrSpmm.apply(x.contiguous(), val.contiguous(), row_ptr, row, col, col_perm)


def csr_spmm(row_ptr: torch.Tensor, row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
             col_perm: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``S x`` on the card for ``x [N_src]`` or ``[N_src, F]`` (float32 or
    bfloat16) → ``[n]`` or ``[n, F]`` in x's dtype, ``n = row_ptr.numel() -
    1``; differentiable in ``x`` and ``val``. ``row`` must be sorted and
    ``row_ptr`` its ``csr_row_ptr``; ``col_perm`` sorts ``col`` (None:
    stable-sorted in the backward). Raises on what the kernels do not
    take."""
    _check_operands("csr_spmm", row_ptr, row, col, val, col_perm, x)
    if x.dim() not in (1, 2):
        raise ValueError(f"csr_spmm takes x [N] or [N, F], got {tuple(x.shape)}")
    if x.dim() == 2 and x.shape[1] == 0:
        return x.new_zeros((row_ptr.numel() - 1, 0))
    # one head: views in and out, whose backward is a view too (indexing's
    # would copy the gradient into a zeroed tensor)
    out = _CsrSpmm.apply(_as_rows(x).unsqueeze(0), val.contiguous().unsqueeze(0), row_ptr, row,
                         col, col_perm).squeeze(0)
    return out.squeeze(1) if x.dim() == 1 else out
