"""Host side of the CUDA Lanczos kernels, their autograd wrapper, and
the Ritz-pair dispatch.

Counterpart of ``lanczosnet_tpu/ops/lanczos_pallas.py``:
``lanczos_tridiag_cuda_resid`` has the contract of
``lanczos_tridiag_pallas_resid`` and picks the kernel from the shape.
Graphs of at most 128 nodes go to ``csrc/lanczos_tridiag.cu`` (one
block per graph, S in shared memory; replaces the Pallas
``_lanczos_kernel``), larger ones up to 16384 nodes to
``csrc/lanczos_stream.cu`` (S streamed from device memory each step;
replaces ``_lanczos_stream_kernel``). On a CPU tensor it runs the chosen
kernel's plain version (``ops/lanczos.py``); on a CUDA tensor it
launches the kernel or raises, unless the caller asks for the plain
version by name (``impl="plain"``), as the comparisons on the card do.

``LanczosTridiag`` is the ``torch.autograd.Function`` around either
forward whose backward is the adjoint recursion
(``ops/lanczos.py:lanczos_adjoint_bwd``) on the residuals the forward
left; gradients never come from autograd through the plain loop.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from lanczosnet_torch.ops import _build
from lanczosnet_torch.ops.eigh import eigh
from lanczosnet_torch.ops.lanczos import (
    STREAM_CHUNK,
    lanczos_adjoint_bwd,
    lanczos_start_vector,
    lanczos_tridiag_resid,
    lanczos_tridiag_resid_stream,
    tridiag_matrix,
)
from lanczosnet_torch.ops.precision import f32_matmul

# The largest padded graph the shared-memory kernel takes: S, the basis
# and the work vectors of one graph live in one block's shared memory.
# Equal to the JAX model's fused-path limit (_FUSED_N_MAX).
N_MAX = 128
# The streamed kernel's limits: the work vector and the chunk partials of
# one graph fit one block's shared memory up to this N; K is capped where
# the sums over basis rows stay short.
STREAM_N_MAX = 16384
STREAM_K_MAX = 64
IMPLS = ("auto", "kernel", "plain")


class LaunchCounter:
    """Counts kernel launches, so a run can show it went through the kernel."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count = 0

    def add(self) -> None:
        with self._lock:
            self._count += 1

    def reset(self) -> None:
        with self._lock:
            self._count = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


# One counter per kernel. ``stream_launches`` counts calls of
# ``launch_stream``; each is 2K device launches (a matvec and a finish
# kernel per Lanczos step).
launches = LaunchCounter()
stream_launches = LaunchCounter()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lanczos_tridiag")
    ptr = ctypes.c_void_p
    lib.lanczos_tridiag_launch.argtypes = [ptr] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ptr, ctypes.c_int,
    ]
    lib.lanczos_tridiag_launch.restype = ctypes.c_int
    lib.lanczos_tridiag_error_string.argtypes = [ctypes.c_int]
    lib.lanczos_tridiag_error_string.restype = ctypes.c_char_p
    lib.lanczos_tridiag_max_n.restype = ctypes.c_int
    if lib.lanczos_tridiag_max_n() != N_MAX:
        raise RuntimeError("csrc/lanczos_tridiag.cu and N_MAX disagree")
    return lib


@functools.cache
def _stream_lib() -> ctypes.CDLL:
    lib = _build.load("lanczos_stream")
    ptr = ctypes.c_void_p
    lib.lanczos_stream_launch.argtypes = [ptr] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ptr, ctypes.c_int,
    ]
    lib.lanczos_stream_launch.restype = ctypes.c_int
    lib.lanczos_stream_error_string.argtypes = [ctypes.c_int]
    lib.lanczos_stream_error_string.restype = ctypes.c_char_p
    for fn, want in (
        (lib.lanczos_stream_chunk, STREAM_CHUNK),
        (lib.lanczos_stream_max_n, STREAM_N_MAX),
        (lib.lanczos_stream_max_k, STREAM_K_MAX),
    ):
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError("csrc/lanczos_stream.cu and its Python constants disagree")
    return lib


def check_shapes(s: torch.Tensor, mask: torch.Tensor, k: int) -> None:
    """Raise ``ValueError`` on shapes neither kernel takes: N ≤ 128 goes
    to the shared-memory kernel (1 ≤ K ≤ N), 128 < N ≤ 16384 to the
    streamed kernel (1 ≤ K ≤ 64)."""
    if s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"s must be [B, N, N], got {tuple(s.shape)}")
    b, n, _ = s.shape
    if tuple(mask.shape) != (b, n):
        raise ValueError(f"mask must be [{b}, {n}], got {tuple(mask.shape)}")
    if b < 1:
        raise ValueError("empty batch")
    if n > STREAM_N_MAX:
        raise ValueError(
            f"n={n} > {STREAM_N_MAX}: the streamed Lanczos kernel takes at most "
            f"{STREAM_N_MAX} nodes (the shared-memory kernel {N_MAX})"
        )
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n={n}]")
    if n > N_MAX and k > STREAM_K_MAX:
        raise ValueError(
            f"k={k} > {STREAM_K_MAX}: the streamed Lanczos kernel (n={n} > {N_MAX}) "
            f"takes at most {STREAM_K_MAX} steps"
        )


def launch(s: torch.Tensor, q0: torch.Tensor, outs: tuple[torch.Tensor, ...],
           k: int, eps: float) -> None:
    """Launch the kernel on the current stream into preallocated ``outs``
    (alphas, betas_full, q, p1, p2, w4). All tensors float32, contiguous,
    on one CUDA device; shapes as ``lanczos_tridiag_cuda_resid`` makes them.
    ``eps * eps`` reaches the kernel rounded to float32, as the plain
    version's clamp rounds it."""
    b, n, _ = s.shape
    rc = _lib().lanczos_tridiag_launch(
        s.data_ptr(), q0.data_ptr(), *(o.data_ptr() for o in outs),
        b, n, k, eps, eps * eps, torch.cuda.current_stream(s.device).cuda_stream,
        s.device.index if s.device.index is not None else torch.cuda.current_device(),
    )
    if rc != 0:
        msg = _lib().lanczos_tridiag_error_string(rc).decode()
        raise RuntimeError(f"lanczos_tridiag launch failed: {msg} ({rc})")
    launches.add()


def launch_stream(s: torch.Tensor, q: torch.Tensor, part: torch.Tensor,
                  outs: tuple[torch.Tensor, ...], k: int, eps: float) -> None:
    """Run the streamed kernel's K steps on the current stream. ``q``
    ``[B,k,N]`` holds the start vector in row 0 and receives the basis;
    ``part`` ``[B, ceil(N/64), N]`` is scratch; ``outs`` are (alphas,
    betas_full, p1, p2, w4), preallocated. All float32, contiguous, on
    one CUDA device."""
    b, n, _ = s.shape
    lib = _stream_lib()
    rc = lib.lanczos_stream_launch(
        s.data_ptr(), q.data_ptr(), part.data_ptr(), *(o.data_ptr() for o in outs),
        b, n, k, eps, eps * eps, torch.cuda.current_stream(s.device).cuda_stream,
        s.device.index if s.device.index is not None else torch.cuda.current_device(),
    )
    if rc != 0:
        msg = lib.lanczos_stream_error_string(rc).decode()
        raise RuntimeError(f"lanczos_stream launch failed: {msg} ({rc})")
    stream_launches.add()


def stream_buffers(b: int, n: int, k: int, device) -> tuple[torch.Tensor, ...]:
    """The streamed kernel's scratch and outputs: (q, part, alphas,
    betas_full, p1, p2, w4), uninitialised."""
    shapes = ((b, k, n), (b, -(-n // STREAM_CHUNK), n), (b, k), (b, k),
              (b, k, k), (b, k, k), (b, k, n))
    return tuple(torch.empty(shape, dtype=torch.float32, device=device) for shape in shapes)


def lanczos_tridiag_cuda_resid(
    s: torch.Tensor, mask: torch.Tensor, k: int, eps: float = 1e-6, impl: str = "auto"
) -> tuple[torch.Tensor, ...]:
    """s ``[B,N,N]``, mask ``[B,N]`` → (alphas ``[B,k]``, betas_full
    ``[B,k]``, q ``[B,k,N]``, p1 ``[B,k,k]``, p2 ``[B,k,k]``, w4 ``[B,k,N]``),
    the contract of ``lanczos_tridiag_resid``.

    The shape picks the kernel: N ≤ 128 the shared-memory one, larger N
    the streamed one (which takes qᵀS for S q and so needs S symmetric).
    ``impl="auto"`` launches it for a CUDA tensor and runs its plain
    version for a CPU tensor; ``"kernel"`` refuses a CPU tensor;
    ``"plain"`` runs the plain version wherever the tensor lies."""
    check_shapes(s, mask, k)
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} must be one of {IMPLS}")
    b, n, _ = s.shape
    stream = n > N_MAX
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Lanczos kernel for device {s.device}")
    if impl == "kernel" and s.device.type != "cuda":
        raise ValueError("impl='kernel' needs a CUDA tensor; the kernels run only on the card")
    if impl == "plain" or s.device.type == "cpu":
        plain = lanczos_tridiag_resid_stream if stream else lanczos_tridiag_resid
        return plain(s, mask, k, eps)
    s = s.to(torch.float32).contiguous()
    q0 = lanczos_start_vector(mask.to(s.device, torch.float32), eps)
    if stream:
        q, part, *outs = stream_buffers(b, n, k, s.device)
        q[:, 0] = q0
        launch_stream(s, q, part, tuple(outs), k, eps)
        alphas, betas, p1, p2, w4 = outs
        return alphas, betas, q, p1, p2, w4
    outs = tuple(
        torch.empty(shape, dtype=torch.float32, device=s.device)
        for shape in ((b, k), (b, k), (b, k, n), (b, k, k), (b, k, k), (b, k, n))
    )
    launch(s, q0.contiguous(), outs, k, eps)
    return outs


class LanczosTridiag(torch.autograd.Function):
    """(s, mask, k, eps, impl) → (alphas ``[B,k]``, betas_full ``[B,k]``,
    q ``[B,k,N]``), differentiable in ``s``.

    Forward is ``lanczos_tridiag_cuda_resid`` (either kernel, or its
    plain version on the CPU), run without recording; backward is the
    adjoint recursion on the saved residuals. The gradient of ``mask``
    is zero. ``bar_s`` is returned as the recursion gives it, not
    symmetrised."""

    @staticmethod
    def forward(ctx, s, mask, k, eps, impl):
        alphas, betas, q, p1, p2, w4 = lanczos_tridiag_cuda_resid(s.detach(), mask, k, eps, impl)
        ctx.save_for_backward(s, alphas, betas, q, p1, p2, w4)
        ctx.eps = eps
        return alphas, betas, q

    @staticmethod
    def backward(ctx, bar_alphas, bar_betas, bar_q):
        s, alphas, betas, q, p1, p2, w4 = ctx.saved_tensors
        bar_s = lanczos_adjoint_bwd(
            s.detach(), alphas, betas, q, p1, p2, w4,
            torch.zeros_like(alphas) if bar_alphas is None else bar_alphas,
            torch.zeros_like(betas) if bar_betas is None else bar_betas,
            torch.zeros_like(q) if bar_q is None else bar_q,
            ctx.eps,
        )
        return bar_s.to(s.dtype), None, None, None, None


def ritz_from_tridiag(
    alphas: torch.Tensor, betas: torch.Tensor, q: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(alphas ``[B,k]``, betas ``[B,k-1]``, q ``[B,k,N]``) → Ritz pairs
    (vals ``[B,k]``, vecs ``[B,N,k]``): eigh of T with its clamped
    backward, then the rotation QᵀU in float32 under any TF32 flag."""
    vals, u = eigh(tridiag_matrix(alphas, betas))
    with f32_matmul():
        vecs = q.transpose(1, 2) @ u
    return vals, vecs


def batched_lanczos_ritz_dispatch(
    s: torch.Tensor, mask: torch.Tensor, k: int, eps: float = 1e-6, impl: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ritz pairs ``(vals [B,k], vecs [B,N,k])`` of ``s [B,N,N]``: a CUDA
    tensor goes to the kernel its shape picks, a CPU tensor to that
    kernel's plain version (``impl`` as in ``lanczos_tridiag_cuda_resid``).
    Where ``s`` requires a gradient the call goes through
    ``LanczosTridiag``, so the backward is the adjoint recursion."""
    if s.requires_grad and torch.is_grad_enabled():
        alphas, betas, q = LanczosTridiag.apply(s, mask, k, eps, impl)
    else:
        alphas, betas, q, *_ = lanczos_tridiag_cuda_resid(s, mask, k, eps, impl)
    return ritz_from_tridiag(alphas, betas[:, : k - 1], q)
