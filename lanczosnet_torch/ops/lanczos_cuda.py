"""Host side of the CUDA Lanczos kernel, and the Ritz-pair dispatch.

Counterpart of ``lanczosnet_tpu/ops/lanczos_pallas.py``'s molecular
path: ``lanczos_tridiag_cuda_resid`` has the contract of
``lanczos_tridiag_pallas_resid`` and launches
``csrc/lanczos_tridiag.cu`` in place of the Pallas ``_lanczos_kernel``.
On a CPU tensor it runs the kernel's plain version
(``ops/lanczos.py:lanczos_tridiag_resid``); on a CUDA tensor it launches
the kernel or raises. Graphs larger than one block's shared memory
takes (N > 128) need the streamed kernel, which is not ported yet
(ROADMAP B2); the wrapper refuses them.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from lanczosnet_torch.ops import _build
from lanczosnet_torch.ops.eigh import eigh
from lanczosnet_torch.ops.lanczos import (
    lanczos_start_vector,
    lanczos_tridiag_resid,
    tridiag_matrix,
)

# The largest padded graph the kernel takes: S, the basis and the work
# vectors of one graph live in one block's shared memory. Equal to the
# JAX model's fused-path limit (_FUSED_N_MAX).
N_MAX = 128


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


launches = LaunchCounter()


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


def check_shapes(s: torch.Tensor, mask: torch.Tensor, k: int) -> None:
    """Raise ``ValueError`` on shapes the kernel does not take."""
    if s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"s must be [B, N, N], got {tuple(s.shape)}")
    b, n, _ = s.shape
    if tuple(mask.shape) != (b, n):
        raise ValueError(f"mask must be [{b}, {n}], got {tuple(mask.shape)}")
    if b < 1:
        raise ValueError("empty batch")
    if n > N_MAX:
        raise ValueError(
            f"n={n} > {N_MAX}: the shared-memory Lanczos kernel takes at most "
            f"{N_MAX} nodes; larger graphs need the streamed kernel (ROADMAP B2)"
        )
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n={n}]")


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


def lanczos_tridiag_cuda_resid(
    s: torch.Tensor, mask: torch.Tensor, k: int, eps: float = 1e-6
) -> tuple[torch.Tensor, ...]:
    """s ``[B,N,N]``, mask ``[B,N]`` → (alphas ``[B,k]``, betas_full
    ``[B,k]``, q ``[B,k,N]``, p1 ``[B,k,k]``, p2 ``[B,k,k]``, w4 ``[B,k,N]``),
    the contract of ``lanczos_tridiag_resid``; through the CUDA kernel for
    a CUDA tensor, through the plain version for a CPU tensor."""
    check_shapes(s, mask, k)
    if s.device.type == "cpu":
        return lanczos_tridiag_resid(s, mask, k, eps)
    if s.device.type != "cuda":
        raise ValueError(f"no Lanczos kernel for device {s.device}")
    b, n, _ = s.shape
    s = s.to(torch.float32).contiguous()
    q0 = lanczos_start_vector(mask.to(s.device, torch.float32), eps).contiguous()
    outs = tuple(
        torch.empty(shape, dtype=torch.float32, device=s.device)
        for shape in ((b, k), (b, k), (b, k, n), (b, k, k), (b, k, k), (b, k, n))
    )
    launch(s, q0, outs, k, eps)
    return outs


def ritz_from_tridiag(
    alphas: torch.Tensor, betas: torch.Tensor, q: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(alphas ``[B,k]``, betas ``[B,k-1]``, q ``[B,k,N]``) → Ritz pairs
    (vals ``[B,k]``, vecs ``[B,N,k]``): eigh of T, then the rotation QᵀU,
    taken as a product and a sum so it stays float32 under any TF32 flag."""
    vals, u = eigh(tridiag_matrix(alphas, betas))
    vecs = (q[:, :, :, None] * u[:, :, None, :]).sum(1)
    return vals, vecs


def batched_lanczos_ritz_dispatch(
    s: torch.Tensor, mask: torch.Tensor, k: int, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ritz pairs ``(vals [B,k], vecs [B,N,k])`` of ``s [B,N,N]``: a CUDA
    tensor goes to the kernel, a CPU tensor to the plain version."""
    if s.device.type == "cuda":
        alphas, betas, q, *_ = lanczos_tridiag_cuda_resid(s, mask, k, eps)
    else:
        alphas, betas, q, *_ = lanczos_tridiag_resid(s, mask, k, eps)
    return ritz_from_tridiag(alphas, betas[:, : k - 1], q)
