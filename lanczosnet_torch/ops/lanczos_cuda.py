"""Host side of the CUDA Lanczos kernels, their autograd wrapper, and
the Ritz-pair dispatch.

Counterpart of ``lanczosnet_tpu/ops/lanczos_pallas.py``:
``lanczos_tridiag_cuda_resid`` has the contract of
``lanczos_tridiag_pallas_resid`` and picks the kernel from the shape.
Graphs of at most 128 nodes go to ``csrc/lanczos_tridiag.cu`` (one
block per graph, S in shared memory; replaces the Pallas
``_lanczos_kernel``), larger ones up to 16384 nodes to
``csrc/lanczos_stream.cu`` (S streamed from device memory each step by
one persistent cooperative launch, laid out by ``plan_stream``;
replaces ``_lanczos_stream_kernel``). On a CPU tensor it runs the chosen
kernel's plain version (``ops/lanczos.py``); on a CUDA tensor it
launches the kernel or raises, unless the caller asks for the plain
version by name (``impl="plain"``), as the comparisons on the card do.

Past the kernels' limits (``kernel_limit``: N > 16384, K > 64 at
N > 128, or at N ≤ 128 a K above the padded N of the shared-memory
kernel's block) the default ``impl="auto"`` runs the plain version on either
device and counts the call in ``plain_routes``; ``impl="kernel"``
raises there.

``LanczosTridiag`` is the ``torch.autograd.Function`` around either
forward whose backward is the adjoint recursion
(``ops/lanczos.py:lanczos_adjoint_bwd``) on the residuals the forward
left; gradients never come from autograd through the plain loop. Where
no gradient is asked the dispatch calls the custom operator
``lanczosnet::lanczos_tridiag_resid`` (``lanczos_tridiag_resid_op``,
registered when this module is imported), which ``torch.export``
records as one node of an exported request program.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from lanczosnet_torch.ops import _build
from lanczosnet_torch.ops.eigh import eigh_dispatch
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
# The streamed kernel's limits: K is capped where the sums over basis rows
# stay short and one thread per basis row fits a chunk's 64 threads.
STREAM_N_MAX = 16384
STREAM_K_MAX = 64
# Its launch shape: threads of a block (teams of STREAM_TILE threads take
# the matvec's units) and the dynamic shared memory a Hopper block may ask
# for. One block of 1024 threads fills an SM.
STREAM_THREADS = 1024
STREAM_TILE = 128
STREAM_SMEM_LIMIT = 232448
IMPLS = ("auto", "kernel", "plain")


class LaunchCounter:
    """Counts kernel launches, so a run can show it went through the kernel
    (or, as ``plain_routes``, the calls that went around it)."""

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


# One counter per kernel; each counts that kernel's launches on the
# device. A call of ``launch_stream`` is ``StreamPlan.launches`` of them
# (one, unless the batch does not fit one co-resident grid).
launches = LaunchCounter()
stream_launches = LaunchCounter()
# calls under impl="auto" that the shape sent to a plain version, past
# the kernels' limits (``kernel_limit``)
plain_routes = LaunchCounter()


def tridiag_padded_n(n: int) -> int:
    """The padded N of the shared-memory kernel for a graph of ``n`` nodes:
    the least of 32, 64, 128 that holds it. It is the block's thread
    count and the compile-time length of every sum; the padding is zeros,
    which add nothing. One instantiation of the kernel per value."""
    return next(np_ for np_ in (32, 64, N_MAX) if n <= np_)


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
    lib.lanczos_tridiag_padded_n.argtypes = [ctypes.c_int]
    lib.lanczos_tridiag_padded_n.restype = ctypes.c_int
    if lib.lanczos_tridiag_max_n() != N_MAX or any(
        lib.lanczos_tridiag_padded_n(n) != tridiag_padded_n(n) for n in range(1, N_MAX + 1)
    ):
        raise RuntimeError("csrc/lanczos_tridiag.cu and its Python constants disagree")
    return lib


@functools.cache
def _stream_lib() -> ctypes.CDLL:
    lib = _build.load("lanczos_stream")
    ptr = ctypes.c_void_p
    lib.lanczos_stream_launch.argtypes = [ptr] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, ctypes.c_int,
    ]
    lib.lanczos_stream_launch.restype = ctypes.c_int
    lib.lanczos_stream_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.lanczos_stream_occupancy.restype = ctypes.c_int
    lib.lanczos_stream_barrier_probe.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, ctypes.c_int,
    ]
    lib.lanczos_stream_barrier_probe.restype = ctypes.c_int
    lib.lanczos_stream_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.lanczos_stream_smem_bytes.restype = ctypes.c_longlong
    lib.lanczos_stream_error_string.argtypes = [ctypes.c_int]
    lib.lanczos_stream_error_string.restype = ctypes.c_char_p
    for fn, want in (
        (lib.lanczos_stream_chunk, STREAM_CHUNK),
        (lib.lanczos_stream_max_n, STREAM_N_MAX),
        (lib.lanczos_stream_max_k, STREAM_K_MAX),
        (lib.lanczos_stream_tile, STREAM_TILE),
        (lib.lanczos_stream_smem_limit, STREAM_SMEM_LIMIT),
    ):
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError("csrc/lanczos_stream.cu and its Python constants disagree")
    for shape in ((129, 1, 1), (2708, 20, 1), (16384, 64, 2)):
        if lib.lanczos_stream_smem_bytes(*shape, STREAM_THREADS) != stream_smem_bytes(*shape):
            raise RuntimeError("csrc/lanczos_stream.cu and stream_smem_bytes disagree")
    return lib


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _stream_check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _stream_lib().lanczos_stream_error_string(rc).decode()
        raise RuntimeError(f"lanczos_stream {what} failed: {msg} ({rc})")


def stream_smem_bytes(n: int, k: int, slots: int) -> int:
    """Dynamic shared memory of one block of the streamed kernel that owns
    ``slots`` (graph, chunk) pairs: per pair its 64 columns of Q (K rows
    of 65 floats), its chunk of w and the previous beta; the coefficients
    of a pass; each matvec team's chunk of q; and the staging area for
    what crosses the grid (K rows of chunk partials, or a 64-row tile of
    matvec partials). Mirrors ``smem_floats`` in csrc/lanczos_stream.cu."""
    nchunk = -(-n // STREAM_CHUNK)
    stage = max(k * (nchunk | 1), min(nchunk, STREAM_CHUNK) * STREAM_CHUNK)
    per_pair = k * (STREAM_CHUNK + 1) + STREAM_CHUNK + 1
    return 4 * (slots * per_pair + k + (STREAM_THREADS // STREAM_TILE) * STREAM_CHUNK + stage)


@dataclass(frozen=True)
class StreamPlan:
    """How a call of the streamed kernel is laid on the card: ``launches``
    cooperative launches of ``grid`` blocks of ``STREAM_THREADS``, each
    launch taking ``graphs_per_launch`` graphs and each block owning up to
    ``slots`` (graph, chunk) pairs in ``smem_bytes`` of shared memory."""

    grid: int
    slots: int
    graphs_per_launch: int
    launches: int
    smem_bytes: int


def plan_stream(b: int, n: int, k: int, sm_count: int, blocks_per_sm: int) -> StreamPlan:
    """Lay ``b`` graphs of ``n`` nodes and ``k`` steps on a device that
    holds ``sm_count * blocks_per_sm`` blocks at once. A pure function of
    the shape and the device's properties; it never looks at a failure.

    Every (graph, chunk) pair of a launch needs an owner among co-resident
    blocks. Blocks own one pair each while the grid has enough of them,
    then several ("slots") as far as shared memory allows, and beyond
    that the graphs go in equal groups, one launch each. The grid is no
    larger than the work: every pair an owner, every matvec unit a team.
    Raises ``ValueError`` where even one graph cannot be held."""
    if min(b, n, k, sm_count, blocks_per_sm) < 1:
        raise ValueError("plan_stream needs positive sizes")
    nchunk = -(-n // STREAM_CHUNK)
    resident = sm_count * blocks_per_sm
    max_slots = 0
    while stream_smem_bytes(n, k, max_slots + 1) <= STREAM_SMEM_LIMIT:
        max_slots += 1
    if resident * max_slots < nchunk:
        raise ValueError(
            f"the streamed Lanczos kernel cannot hold one graph of n={n}, k={k}: its "
            f"{nchunk} chunks need owners among {resident} co-resident blocks with room "
            f"for {max_slots} chunks each ({STREAM_SMEM_LIMIT} bytes of shared memory)"
        )
    launches = -(-b // (resident * max_slots // nchunk))  # whole graphs only
    graphs = -(-b // launches)
    pairs = graphs * nchunk
    units = pairs * -(-n // STREAM_TILE)
    teams = STREAM_THREADS // STREAM_TILE
    grid = min(resident, max(pairs, -(-units // teams)))
    slots = -(-pairs // grid)
    return StreamPlan(grid, slots, graphs, -(-b // graphs), stream_smem_bytes(n, k, slots))


@functools.cache
def stream_plan(b: int, n: int, k: int, device: int) -> StreamPlan:
    """``plan_stream`` for the CUDA device of this index: the occupancy of
    the kernel at the planned shared memory is asked of the runtime, and
    the plan is made again if more slots lowered it. The query also opens
    the kernel's shared memory on that device, so every launch comes after
    a plan; the plan is kept, and a launch asks the runtime nothing."""
    lib = _stream_lib()
    sm_count, per_sm = ctypes.c_int(), ctypes.c_int()
    smem = stream_smem_bytes(n, k, 1)
    while True:
        _stream_check(lib.lanczos_stream_occupancy(
            STREAM_THREADS, smem, device, ctypes.byref(sm_count), ctypes.byref(per_sm)),
            "occupancy query")
        if per_sm.value < 1:
            raise RuntimeError(f"no block of the streamed kernel fits an SM at n={n}, k={k}")
        plan = plan_stream(b, n, k, sm_count.value, per_sm.value)
        if plan.smem_bytes == smem:
            return plan
        smem = plan.smem_bytes


def check_shapes(s: torch.Tensor, mask: torch.Tensor, k: int) -> None:
    """Raise ``ValueError`` on shapes no path takes: ``s`` ``[B,N,N]``
    with B ≥ 1, ``mask`` ``[B,N]``, K ≥ 1. K may exceed N, as in the JAX
    package: the steps after the Krylov space runs out break down (β ≤ ε
    zeroes the next vector), which gives zero Ritz pairs. The kernels'
    own limits are ``kernel_limit``'s."""
    if s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"s must be [B, N, N], got {tuple(s.shape)}")
    b, n, _ = s.shape
    if tuple(mask.shape) != (b, n):
        raise ValueError(f"mask must be [{b}, {n}], got {tuple(mask.shape)}")
    if b < 1:
        raise ValueError("empty batch")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")


def kernel_limit(n: int, k: int) -> str | None:
    """Why no kernel takes ``n`` nodes and ``k`` steps, or None where one
    does: N ≤ 128 goes to the shared-memory kernel (K up to its padded N,
    ``tridiag_padded_n``: a block has that many threads and thread r
    writes CGS coefficient r), 128 < N ≤ 16384 to the streamed kernel
    (K ≤ 64). Read at call time, so a test may lower the limits."""
    if n > STREAM_N_MAX:
        return (f"n={n} > {STREAM_N_MAX}: the streamed Lanczos kernel takes at most "
                f"{STREAM_N_MAX} nodes (the shared-memory kernel {N_MAX})")
    if n > N_MAX and k > STREAM_K_MAX:
        return (f"k={k} > {STREAM_K_MAX}: the streamed Lanczos kernel (n={n} > {N_MAX}) "
                f"takes at most {STREAM_K_MAX} steps")
    if n <= N_MAX and k > tridiag_padded_n(n):
        return (f"k={k} > {tridiag_padded_n(n)}: the shared-memory Lanczos kernel takes at "
                f"most its padded n ({tridiag_padded_n(n)} for n={n}) steps")
    return None


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
        _device_index(s.device),
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
    one CUDA device. The graphs go ``StreamPlan.graphs_per_launch`` to a
    cooperative launch. The chunk partials that cross the grid are
    allocated here, per call, and the grid barrier keeps no state of the
    caller's: two calls at once, from two threads or on two streams,
    share nothing."""
    b, n, _ = s.shape
    lib = _stream_lib()
    device = _device_index(s.device)
    plan = stream_plan(b, n, k, device)
    scratch = torch.empty((b, 2 + 2 * k, -(-n // STREAM_CHUNK)), dtype=torch.float32,
                          device=s.device)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    for g0 in range(0, b, plan.graphs_per_launch):
        group = [t[g0: g0 + plan.graphs_per_launch] for t in (s, q, part, scratch, *outs)]
        _stream_check(lib.lanczos_stream_launch(
            *(t.data_ptr() for t in group), group[0].shape[0], n, k, eps, eps * eps,
            plan.grid, STREAM_THREADS, plan.slots, stream, device,
        ), "launch")
        stream_launches.add()


def launch_barrier_probe(grid: int, threads: int, count: int, device: torch.device) -> None:
    """One cooperative launch of ``grid`` blocks of ``threads`` on the
    current stream that does ``count`` grid barriers and nothing else:
    timed with ``count`` and with none, it says what a barrier of the
    streamed kernel costs on that grid."""
    _stream_check(_stream_lib().lanczos_stream_barrier_probe(
        grid, threads, count, torch.cuda.current_stream(device).cuda_stream,
        _device_index(device),
    ), "barrier probe")


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
    ``"plain"`` runs the plain version wherever the tensor lies.

    Above the kernels' limits (``kernel_limit``) ``"auto"`` runs the
    plain version on either device and counts it in ``plain_routes``,
    as the JAX dispatch falls back to its scan; ``"kernel"`` raises,
    naming the limit. The route is decided from the shape before any
    launch; a failed build or launch always raises."""
    check_shapes(s, mask, k)
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} must be one of {IMPLS}")
    b, n, _ = s.shape
    stream = n > N_MAX
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Lanczos kernel for device {s.device}")
    limit = kernel_limit(n, k)
    if impl == "kernel" and limit is not None:
        raise ValueError(limit)
    if impl == "kernel" and s.device.type != "cuda":
        raise ValueError("impl='kernel' needs a CUDA tensor; the kernels run only on the card")
    if impl == "plain" or s.device.type == "cpu" or limit is not None:
        if impl == "auto" and limit is not None:
            plain_routes.add()
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


Tensor6 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("lanczosnet::lanczos_tridiag_resid", mutates_args=())
def lanczos_tridiag_resid_op(s: torch.Tensor, mask: torch.Tensor, k: int, eps: float,
                             impl: str) -> Tensor6:
    """``lanczos_tridiag_cuda_resid`` as the operator
    ``torch.ops.lanczosnet.lanczos_tridiag_resid``, so ``torch.export``
    records one call where it cannot trace a ``ctypes`` launch. Its body
    is that function, run each time the exported program runs: the
    kernel on a CUDA tensor, the plain version on a CPU tensor, and the
    same routing by shape. No autograd: ``LanczosTridiag`` serves
    gradients."""
    return lanczos_tridiag_cuda_resid(s, mask, k, eps, impl)


@lanczos_tridiag_resid_op.register_fake
def _lanczos_tridiag_resid_fake(s, mask, k, eps, impl):
    b, n = s.shape[0], s.shape[1]
    shapes = ((b, k), (b, k), (b, k, n), (b, k, k), (b, k, k), (b, k, n))
    return tuple(s.new_empty(shape, dtype=torch.float32) for shape in shapes)


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
    (vals ``[B,k]``, vecs ``[B,N,k]``): the eigensolve of T through
    ``eigh_dispatch`` with its clamped backward, then the rotation QᵀU in
    float32 under any TF32 flag."""
    vals, u = eigh_dispatch(tridiag_matrix(alphas, betas))
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
    ``LanczosTridiag``, so the backward is the adjoint recursion; where
    none is asked (serving, packing, an exported program) through the
    custom operator ``lanczos_tridiag_resid_op``."""
    if s.requires_grad and torch.is_grad_enabled():
        alphas, betas, q = LanczosTridiag.apply(s, mask, k, eps, impl)
    else:
        alphas, betas, q, *_ = lanczos_tridiag_resid_op(s, mask, k, eps, impl)
    return ritz_from_tridiag(alphas, betas[:, : k - 1], q)
