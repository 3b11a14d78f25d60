"""The collectives of the sharded sparse path, each with its transpose.

No JAX file stands behind this module. Inside ``jax.shard_map`` the JAX
package writes ``psum``, ``pmax``, ``all_gather`` and ``ppermute`` and
JAX transposes them itself. Here every rank is a process of a
``torch.distributed`` group, and each collective is an explicit
``torch.autograd.Function`` whose backward is its transpose under the
one convention the sharded runner keeps: each rank's loss is its share
of the total (the shares sum to it), and the parameter gradients get
one all-reduce a step (``Comm.all_reduce_flat``), before the optimizer.

- ``psum``: the sum over ranks; its backward is the sum over ranks of
  the cotangents.
- ``pmax``: the max over ranks, outside autograd (its callers use it on
  a segment max whose gradient they cut, as the JAX package does).
- ``all_gather_rows``: the ranks' row blocks concatenated in rank
  order; its backward is a reduce-scatter.
- ``ring_hop``: send to rank+1, receive from rank−1; its backward is the
  reverse hop.

The tensor-parallel QM8 runner (``parallel/tensor.py``) keeps another
convention inside a ``tp`` group: its ranks compute one replicated
function on the same graphs, so each holds the whole loss and the whole
cotangent of a gathered value.

- ``all_gather_features``: the ranks' blocks of one axis concatenated;
  its backward is this rank's block of the cotangent (a reduce-scatter
  would count the cotangent once for each rank);
- ``psum_cotangent``: the identity; its backward is the sum over ranks
  of the cotangents (the input of a column-parallel product, of which
  each rank differentiates its columns only).

``Comm.rank`` and ``Comm.size`` are JAX's ``axis_index`` and the axis
size. A ``Comm`` runs on the default group or on the ``group`` it is
given (the QM8 runner's ``dp`` and ``tp`` groups, ``parallel/
multihost.py:mesh2d``).

A replicated value is not one logical value here but a copy on each
rank, so a gather from it (``edge_gather`` in edge mode) needs no
collective in its backward: each rank's share of the gradient reaches
the parameters, and their all-reduce sums the shares.

Transport and staging live here and nowhere else. NCCL takes CUDA
tensors for everything. gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` only (``GLOO_CUDA_NATIVE``); every other collective on a
CUDA tensor is staged: copied into a pinned host buffer, sent, and the
result copied back to the card. The rule is read from the backend and
the tensor's device before the call; nothing switches paths on failure.
``Comm.stats`` counts calls and bytes of every collective. It times on
the host's clock only what blocks the host anyway: the staging copies
(``staging_s``) and the transport of staged collectives and of CPU
tensors (``transport_s``). A staged collective synchronizes the stream
before its first copy, since the copy must wait for the kernels that
wrote its input; that wait is counted in neither. A collective that
runs on CUDA tensors unstaged (NCCL, and gloo's all-reduce) stays
ordered on the stream: the comm layer neither synchronizes nor times it.

Host data (the pieces rank 0 cuts from the graph) travels over
``cpu_group``, a gloo group: the main group where it is gloo, a second
group of the same ranks where the main one is NCCL. A ``Comm`` on a
sub-group carries device collectives; its host data would travel over
the sub-group itself.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the collectives gloo runs on CUDA tensors itself; any other on a CUDA
# tensor is staged through the host
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "broadcast"})


@dataclasses.dataclass
class CommStats:
    """What the comm layer did, on the host's clock."""

    calls: int = 0
    bytes: int = 0  # payload of this rank's side of each collective
    staged_bytes: int = 0  # of which copied through the host
    staging_s: float = 0.0  # device↔host copies
    transport_s: float = 0.0  # the collective itself

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def minus(self, before: "CommStats") -> dict:
        """The counts since ``before`` (a copy taken earlier)."""
        return {k: v - getattr(before, k) for k, v in self.as_dict().items()}

    def copy(self) -> "CommStats":
        return dataclasses.replace(self)


class Comm:
    """A process group as the sharded ops use it (``group``; None: the
    default one): this rank's place in it, its size, the backend, the
    staging rule and its pinned buffers, the counts. ``cpu_group``
    carries host data where the group is NCCL (None: ``group`` itself)."""

    def __init__(self, group=None, cpu_group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.cpu_group = group if cpu_group is None else cpu_group
        self.stats = CommStats()
        self._host: dict = {}

    def __repr__(self) -> str:
        return f"Comm(rank={self.rank}, size={self.size}, backend={self.backend})"

    def stages(self, collective: str, t: torch.Tensor) -> bool:
        """Whether ``collective`` on ``t`` goes through host buffers."""
        return t.is_cuda and self.backend == "gloo" and collective not in GLOO_CUDA_NATIVE

    # ------------------------------------------------------------------ staging
    def _buffer(self, slot: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer kept for reuse under ``slot``; every use
        ends before the call that took it returns."""
        key = (slot, tuple(shape), dtype)
        if key not in self._host:
            # a normal tensor even when made under inference mode (an
            # evaluation), so that training may write it later
            with torch.inference_mode(False):
                self._host[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return self._host[key]

    def _to_host(self, slot: str, t: torch.Tensor) -> torch.Tensor:
        torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        buf = self._buffer(slot, t.shape, t.dtype)
        buf.copy_(t)
        self.stats.staging_s += time.perf_counter() - t0
        self.stats.staged_bytes += t.numel() * t.element_size()
        return buf

    def _to_device(self, buf: torch.Tensor, device) -> torch.Tensor:
        t0 = time.perf_counter()
        out = torch.empty(buf.shape, dtype=buf.dtype, device=device)
        out.copy_(buf)
        torch.cuda.current_stream(device).synchronize()
        self.stats.staging_s += time.perf_counter() - t0
        self.stats.staged_bytes += buf.numel() * buf.element_size()
        return out

    def _count(self, t: torch.Tensor) -> None:
        self.stats.calls += 1
        self.stats.bytes += t.numel() * t.element_size()

    def _run(self, t: torch.Tensor, collective, *args, **kwargs) -> None:
        """``collective(*args)`` on ``t``'s side, timed where it blocks the
        host (``t`` on the CPU or staged there)."""
        if t.is_cuda:
            collective(*args, **kwargs)
            return
        t0 = time.perf_counter()
        collective(*args, **kwargs)
        self.stats.transport_s += time.perf_counter() - t0

    # -------------------------------------------------------------- collectives
    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A new tensor: ``x`` reduced over the ranks."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        self._count(out)
        self._run(out, dist.all_reduce, out, op=op, group=self.group)
        return out

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The sum over ranks of each tensor, in one all-reduce of their
        concatenation (one dtype)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        flat = self.all_reduce(flat)
        return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` on each rank → ``[size·n, ...]``, blocks in rank order."""
        x = x.detach().contiguous()
        self._count(x)
        shape = (self.size * x.shape[0],) + x.shape[1:]
        if self.stages("all_gather", x):
            h = self._to_host("gather_in", x)
            out_h = self._buffer("gather_out", shape, x.dtype)
            self._run(h, dist.all_gather, list(out_h.chunk(self.size)), h, group=self.group)
            return self._to_device(out_h, x.device)
        out = x.new_empty(shape)
        self._run(x, dist.all_gather, list(out.chunk(self.size)), x, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``[size·n, ...]`` on each rank → this rank's block ``[n, ...]``
        of the sum over ranks."""
        x = x.detach().contiguous()
        self._count(x)
        shape = (x.shape[0] // self.size,) + x.shape[1:]
        if self.stages("reduce_scatter", x):
            h = self._to_host("scatter_in", x)
            out_h = self._buffer("scatter_out", shape, x.dtype)
            self._run(h, dist.reduce_scatter, out_h, list(h.chunk(self.size)), group=self.group)
            return self._to_device(out_h, x.device)
        out = x.new_empty(shape)
        self._run(x, dist.reduce_scatter, out, list(x.chunk(self.size)), group=self.group)
        return out

    def hop(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """Send ``x`` to rank + step and receive the block of rank − step."""
        x = x.detach().contiguous()
        to, frm = (self._global((self.rank + s) % self.size) for s in (step, -step))
        self._count(x)
        if self.stages("ring_hop", x):
            h = self._to_host("hop_send", x)
            r = self._buffer("hop_recv", x.shape, x.dtype)
            self._run(h, _send_recv, h, r, to, frm, self.group)
            return self._to_device(r, x.device)
        out = torch.empty_like(x)
        self._run(x, _send_recv, x, out, to, frm, self.group)
        return out

    def _global(self, rank: int) -> int:
        """The default group's number of this group's ``rank``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    # --------------------------------------------------------- host data, rank 0
    def broadcast_object(self, obj=None):
        """``obj`` of rank 0 on every rank (pickled over ``cpu_group``)."""
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(0), group=self.cpu_group)
        return box[0]

    def scatter_arrays(self, per_rank: Optional[Sequence[np.ndarray]], shape, dtype) -> np.ndarray:
        """Rank r's array ``per_rank[r]`` (given on rank 0 only, each of
        ``shape`` and ``dtype``) on rank r."""
        out = torch.empty(tuple(shape), dtype=_torch_dtype(dtype))
        pieces = None
        if self.rank == 0:
            pieces = [torch.from_numpy(np.ascontiguousarray(a, dtype)) for a in per_rank]
        t0 = time.perf_counter()
        dist.scatter(out, pieces, src=self._global(0), group=self.cpu_group)
        self.stats.calls += 1
        self.stats.bytes += out.numel() * out.element_size()
        self.stats.transport_s += time.perf_counter() - t0
        return out.numpy()

    def broadcast_array(self, a: Optional[np.ndarray], shape, dtype) -> np.ndarray:
        """Rank 0's array ``a`` on every rank."""
        t = (torch.from_numpy(np.ascontiguousarray(a, dtype)) if self.rank == 0
             else torch.empty(tuple(shape), dtype=_torch_dtype(dtype)))
        t0 = time.perf_counter()
        dist.broadcast(t, src=self._global(0), group=self.cpu_group)
        self.stats.calls += 1
        self.stats.bytes += t.numel() * t.element_size()
        self.stats.transport_s += time.perf_counter() - t0
        return t.numpy()

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _send_recv(send: torch.Tensor, recv: torch.Tensor, to: int, frm: int, group) -> None:
    ops = [dist.P2POp(dist.isend, send, to, group), dist.P2POp(dist.irecv, recv, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g), None


class _AllGatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.width = comm, dim, x.shape[dim]
        return comm.all_gather(x.movedim(dim, 0)).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.comm.rank * ctx.width, ctx.width), None, None


class _PSumCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.hop(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.hop(g, -1), None


def psum(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank."""
    return _PSum.apply(x, comm)


def pmax(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The max of ``x`` over the ranks, on every rank; no gradient."""
    return comm.all_reduce(x.detach(), op=dist.ReduceOp.MAX)


def all_gather_rows(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The ranks' row blocks of ``x`` in rank order; backward a reduce-scatter."""
    return _AllGatherRows.apply(x, comm)


def all_gather_features(x: torch.Tensor, comm: Comm, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``x`` on axis ``dim`` concatenated in rank
    order; backward this rank's block of the cotangent, which every rank
    of the group holds whole."""
    return _AllGatherFeatures.apply(x, comm, dim)


def psum_cotangent(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``x`` itself; backward the sum over ranks of the cotangents."""
    return _PSumCotangent.apply(x, comm)


def ring_hop(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The block of rank − 1 (``x`` goes to rank + 1); backward the reverse hop."""
    return _RingHop.apply(x, comm)
