"""Host side of GAT's edge softmax kernels (``csrc/gat_softmax.cu``) and
their autograd wrapper, ``_GatSoftmax``.

``ops/sparse.py:gat_attention`` on a CUDA tensor calls ``gat_softmax``:
one launch of ``gat_softmax_kernel`` over the destination-major CSR the
operator already has (``SparseOp.row_ptr``, ``col``, ``val``) computes
each row's logits ``leaky_relu(s_dst[r] + s_src[col])``, their max over
the live edges and the self-edge, the weights ``p`` (written float32
``[H, E]``, head-major, the layout ``sparse_cuda.csr_spmm_heads`` reads),
the denominator and the self-edge's weight. An edge-sharded piece needs
the max over every shard: ``gat_softmax_max`` runs the kernel's max pass
alone, the caller takes ``pmax``, and ``gat_softmax`` then runs the
exponential pass with that max. The backward is two kernels:
``gat_softmax_grad_kernel`` over the destination rows (each edge's logit
gradient, written ``[E, H]``, and ``s_dst``'s gradient) and
``gat_softmax_src_grad_kernel`` over the source-major view
(``sparse_cuda.csr_source_view``: ``col_perm`` and ``col_ptr``; ``s_src``'s
gradient). No ``[E, H]`` logits, mask or exponential tensor exists and
no atomic runs.

Numerics are the plain version's (``ops/sparse.py:segment_softmax_coo``
and autograd through ``gat_attention`` on the CPU): each op rounds its
result to the scores' dtype where ATen's 16-bit op does, sums are float32
in edge order (``col_perm`` order for ``s_src``) and narrowed once; the
one difference is the card's ``expf`` against the CPU's ``exp`` (a
float32 ulp, so at most a bfloat16 ulp in a weight). The weights are
float32 holding values of the scores' dtype: what ``attention_spmv``'s
cast made of them. ``LANCZOSNET_BF16_SCATTER`` does not reach these sums:
they accumulate in float32 always, the plain version's default.

The launch shape comes from the heads and the dtype alone
(``head_block``), with no knob. Each kernel counts its launches
(``softmax_launches``, ``softmax_grad_launches``,
``softmax_src_grad_launches``), so a run can show that every softmax went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from lanczosnet_torch.ops import _build
from lanczosnet_torch.ops.lanczos_cuda import LaunchCounter
from lanczosnet_torch.ops.sparse_cuda import _device_index, csr_source_view

# csrc/gat_softmax.cu's constants, checked against the library when it loads
THREADS = 64
LANES = 16
HEAD_BLOCKS = (8, 4, 2, 1)  # heads a lane moves in one load, widest first
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BOTH, MAX_ONLY, EXP_ONLY = 0, 1, 2  # the forward's passes

# forward launches (a max pass alone counts too); destination and source
# sides of the gradient
softmax_launches = LaunchCounter()
softmax_grad_launches = LaunchCounter()
softmax_src_grad_launches = LaunchCounter()


def head_block(heads: int, itemsize: int, aligned_to: int = 16) -> int:
    """Heads a lane loads at once, and a walk of a row covers: the widest
    of ``HEAD_BLOCKS`` that divides ``heads`` and takes at most 16 bytes,
    and no more than ``aligned_to`` bytes (the least alignment of the
    ``[*, H]`` operands' addresses)."""
    if heads < 1:
        raise ValueError(f"heads={heads}: a softmax needs at least one head")
    return next(hb for hb in HEAD_BLOCKS
                if heads % hb == 0 and hb * itemsize <= min(16, aligned_to))


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    while a > 1 and any(t.data_ptr() % a for t in tensors):
        a //= 2
    return a


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gat_softmax")
    ptr, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.gat_softmax_launch.argtypes = [ptr] * 10 + [i, i, ll, f, i, i, i, ptr, i]
    lib.gat_softmax_grad_launch.argtypes = [ptr] * 10 + [i, i, ll, f, i, i, ptr, i]
    lib.gat_softmax_src_grad_launch.argtypes = [ptr] * 4 + [i, i, i, i, ptr, i]
    for fn in (lib.gat_softmax_launch, lib.gat_softmax_grad_launch,
               lib.gat_softmax_src_grad_launch):
        fn.restype = i
    lib.gat_softmax_error_string.argtypes = [i]
    lib.gat_softmax_error_string.restype = ctypes.c_char_p
    for fn, want in ((lib.gat_softmax_threads, THREADS), (lib.gat_softmax_lanes, LANES)):
        fn.restype = i
        if fn() != want:
            raise RuntimeError("csrc/gat_softmax.cu and its Python constants disagree")
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().gat_softmax_error_string(rc).decode()
        raise RuntimeError(f"gat_softmax {what} failed: {msg} ({rc})")


def _stream(t: torch.Tensor) -> tuple[int, int]:
    return torch.cuda.current_stream(t.device).cuda_stream, _device_index(t.device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_operands(row_ptr, col, val, s_dst, s_src, self_logits) -> None:
    """Raise on operands the kernels do not take: scores off the card, of
    another dtype than float32 and bfloat16 or of different dtypes or
    heads, weights not float32, indices not int32, shapes that do not fit
    the CSR, anything on another device than the scores."""
    what = "gat_softmax"
    if s_dst.device.type != "cuda":
        raise ValueError(f"{what} runs on the card; the scores are on {s_dst.device} (the plain "
                         "version is ops/sparse.py:segment_softmax_coo)")
    if s_dst.dtype not in DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16 scores, got {s_dst.dtype}")
    if s_src.dtype != s_dst.dtype or self_logits.dtype != s_dst.dtype:
        raise ValueError(f"{what} takes scores of one dtype, got {s_dst.dtype}, {s_src.dtype} "
                         f"and {self_logits.dtype}")
    if val.dtype != torch.float32:
        raise ValueError(f"{what} takes float32 edge values, got {val.dtype}")
    for name, t in (("row_ptr", row_ptr), ("col", col)):
        if t.dtype != torch.int32:
            raise ValueError(f"{what} takes int32 {name}, got {t.dtype}")
    for t in (row_ptr, col, val, s_src, self_logits):
        if t.device != s_dst.device:
            raise ValueError(f"{what}: operator or scores on {t.device}, s_dst on {s_dst.device}")
    n = row_ptr.numel() - 1
    if (s_dst.dim() != 2 or s_src.dim() != 2 or s_dst.shape[0] != n
            or s_src.shape[1] != s_dst.shape[1] or self_logits.shape != s_dst.shape
            or col.shape != val.shape):
        raise ValueError(f"{what} takes s_dst and self_logits [n, H] for {n} rows, s_src "
                         f"[N_src, H] and col, val [E]; got {tuple(s_dst.shape)}, "
                         f"{tuple(self_logits.shape)}, {tuple(s_src.shape)}, "
                         f"{tuple(col.shape)}, {tuple(val.shape)}")


def _forward(mode: int, row_ptr, col, val, s_dst, s_src, self_logits,
             m: Optional[torch.Tensor], slope: float):
    """One launch of ``gat_softmax_kernel`` → ``(m, p, den, p_self)``; the
    max pass alone leaves the last three None."""
    n, heads = s_dst.shape
    e = col.numel()
    if m is None:
        m = torch.empty_like(s_dst)
    p = den = p_self = None
    if mode != MAX_ONLY:
        p = torch.empty((heads, e), dtype=torch.float32, device=s_dst.device)
        den, p_self = torch.empty_like(s_dst), torch.empty_like(s_dst)
    hb = head_block(heads, s_dst.element_size(), _alignment(s_dst, s_src, self_logits, m))
    _check(_lib().gat_softmax_launch(
        row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), s_dst.data_ptr(), s_src.data_ptr(),
        self_logits.data_ptr(), m.data_ptr(), _ptr(p), _ptr(den), _ptr(p_self), n, heads, e,
        slope, DTYPES[s_dst.dtype], hb, mode, *_stream(s_dst)), "launch")
    softmax_launches.add()
    return m, p, den, p_self


class _GatSoftmax(torch.autograd.Function):
    """``(p [H, E] float32, den [n, H], p_self [n, H])`` of the scores; the
    max ``m`` given (an edge-sharded piece's, over every shard) or found by
    the same launch. The backward launches the destination side, then,
    where ``s_src`` needs it, the source side over ``(perm, col_ptr)``
    (built here where the caller gave none)."""

    @staticmethod
    def forward(ctx, s_dst, s_src, self_logits, m, row_ptr, col, val, perm, col_ptr, slope):
        m, p, den, p_self = _forward(BOTH if m is None else EXP_ONLY, row_ptr, col, val, s_dst,
                                     s_src, self_logits, m, slope)
        ctx.save_for_backward(s_dst, s_src, m, p_self, row_ptr, col, val, perm, col_ptr)
        ctx.slope = slope
        return p, den, p_self

    @staticmethod
    @once_differentiable
    def backward(ctx, dp, dden, dp_self):
        s_dst, s_src, m, p_self, row_ptr, col, val, perm, col_ptr = ctx.saved_tensors
        ds_dst = ds_src = dself = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dp = None if dp is None else dp.contiguous()
            dden = None if dden is None else dden.contiguous()
            gl, ds_dst = _grad(row_ptr, col, val, s_dst, s_src, m, dp, dden, ctx.slope)
            if ctx.needs_input_grad[1]:
                if col_ptr is None:
                    perm, col_ptr = csr_source_view(col, perm, s_src.shape[0])
                ds_src = _src_grad(col_ptr, perm, gl, s_src.shape[0])
            del gl
        if ctx.needs_input_grad[2] and dp_self is not None:
            dself = dp_self * p_self  # exp's backward, rounded as autograd rounds it
        return ds_dst, ds_src, dself, None, None, None, None, None, None, None


def _grad(row_ptr, col, val, s_dst, s_src, m, dp: Optional[torch.Tensor],
          dden: Optional[torch.Tensor], slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``gat_softmax_grad_kernel`` → ``(gl [E, H], ds_dst [n,
    H])``: each edge's logit gradient and their sums by destination, from
    the weights' gradient ``dp [H, E]`` float32 and the denominator's
    ``dden [n, H]`` (None: no gradient reached it)."""
    n, heads = s_dst.shape
    e = col.numel()
    gl = torch.empty((e, heads), dtype=s_dst.dtype, device=s_dst.device)
    ds_dst = torch.empty_like(s_dst)
    ops = [s_dst, s_src, m, gl, ds_dst] + ([dden] if dden is not None else [])
    hb = head_block(heads, s_dst.element_size(), _alignment(*ops))
    _check(_lib().gat_softmax_grad_launch(
        row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), s_dst.data_ptr(), s_src.data_ptr(),
        m.data_ptr(), _ptr(dp), _ptr(dden), gl.data_ptr(), ds_dst.data_ptr(), n, heads, e,
        slope, DTYPES[s_dst.dtype], hb, *_stream(s_dst)), "grad launch")
    softmax_grad_launches.add()
    return gl, ds_dst


def _src_grad(col_ptr, perm, gl: torch.Tensor, n_src: int) -> torch.Tensor:
    """One launch of ``gat_softmax_src_grad_kernel`` → ``ds_src [n_src, H]``:
    the logit gradients ``gl [E, H]`` summed by source in ``perm`` order."""
    heads = gl.shape[1]
    ds_src = gl.new_empty((n_src, heads))
    hb = head_block(heads, gl.element_size(), _alignment(gl, ds_src))
    _check(_lib().gat_softmax_src_grad_launch(
        col_ptr.data_ptr(), perm.data_ptr(), gl.data_ptr(), ds_src.data_ptr(), n_src, heads,
        DTYPES[gl.dtype], hb, *_stream(gl)), "source grad launch")
    softmax_src_grad_launches.add()
    return ds_src


def gat_softmax_max(row_ptr, col, val, s_dst, s_src, self_logits, slope: float) -> torch.Tensor:
    """The kernel's max pass alone → ``m [n, H]``: per row and head the max
    of the live edges' logits, the self-edge's and −1e30, in the scores'
    dtype; no gradient. An edge-sharded piece's, before the ``pmax`` over
    the shards."""
    check_operands(row_ptr, col, val, s_dst, s_src, self_logits)
    with torch.no_grad():
        return _forward(MAX_ONLY, row_ptr, col, val, s_dst.contiguous(), s_src.contiguous(),
                        self_logits.contiguous(), None, float(slope))[0]


def gat_softmax(row_ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                s_dst: torch.Tensor, s_src: torch.Tensor, self_logits: torch.Tensor,
                slope: float, m: Optional[torch.Tensor] = None,
                view: Optional[tuple[torch.Tensor, torch.Tensor]] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GAT's edge softmax on the card over the CSR (``row_ptr`` over the n
    destination rows, ``col`` into ``s_src``'s rows, ``val`` 0 on a dead
    edge), the logits ``leaky_relu(s_dst[r] + s_src[col], slope)`` and the
    self-edges' ``self_logits`` (all ``[*, H]``, float32 or bfloat16) →
    ``(p [H, E] float32, den [n, H], p_self [n, H])``: the unnormalized
    weights (0 on a dead edge), their sum over each row's edges, and the
    self-edge's weight, against the max ``m`` (given: an edge-sharded
    piece's over every shard; else found here). Differentiable in the
    three scores; ``view`` is ``sparse_cuda.csr_source_view``'s, for the backward's
    source side (built there when not given). Raises on what the kernels
    do not take."""
    check_operands(row_ptr, col, val, s_dst, s_src, self_logits)
    perm, col_ptr = view if view is not None else (None, None)
    if m is not None:
        m = m.contiguous()
    return _GatSoftmax.apply(s_dst.contiguous(), s_src.contiguous(), self_logits.contiguous(),
                             m, row_ptr, col, val, perm, col_ptr, float(slope))
