"""Process groups: joining one, starting one, and what a rank knows.

Counterpart of ``lanczosnet_tpu/parallel/multihost.py``. JAX runs one
process over a mesh of devices; the port runs one process per rank, in
PyTorch's idiom. A rank joins a ``torch.distributed`` group in one of
three ways (``initialize``):

- ``launch`` started it: the launcher passes rank, size and a
  ``file://`` rendezvous (a ``FileStore``) on its command line;
- ``torchrun`` started it: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
  ``MASTER_ADDR``/``MASTER_PORT`` are in the environment (``env://``);
- the group exists already: its size is checked.

A world size that differs from the one asked for raises; nothing
shrinks it to the cards that are visible.

Device and transport. Rank r runs on ``cuda:{local_rank % device_count}``
unless the caller names a device (the tests name ``cpu``). The backend
follows the topology: NCCL when every rank of the host has a card of its
own, gloo when ranks share a card or run on the CPU (NCCL refuses two
ranks on one card). ``World`` records the backend and how many ranks
share a card; the runner logs both.

The QM8 runner lays its ranks out as JAX's 2-D ``(data, model)`` mesh
(``mesh2d``): rank ``r = d·tp + t`` holds column ``t`` of the model axis
and row ``d`` of the data axis, with a ``Comm`` on the ``tp`` ranks of
its row and one on the ``dp`` ranks of its column.

``global_put`` (the JAX function that lets each process of a multi-host
mesh place its shards of a full host array) has no counterpart: here
rank 0 builds every rank's piece and each rank receives only its own
(``parallel/mesh.py``, ``Comm.scatter_arrays``).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from lanczosnet_torch.parallel.comm import Comm

# a rank that fails ends the launch: the launcher stops the others, which
# would otherwise wait in their next collective until this timeout
GROUP_TIMEOUT = datetime.timedelta(minutes=20)
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


@dataclasses.dataclass(frozen=True)
class World:
    """This rank's place in the group."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    ranks_per_card: int  # 0 on the CPU
    comm: Comm
    meshes: dict = dataclasses.field(default_factory=dict)  # (dp, tp) → Mesh2D

    def describe(self) -> dict:
        return {"rank": self.rank, "world_size": self.size, "local_rank": self.local_rank,
                "device": str(self.device), "backend": self.backend,
                "ranks_per_card": self.ranks_per_card}


_WORLD: Optional[World] = None  # set once per process by initialize


def rank_device(local_rank: int, device: str | torch.device | None = None) -> torch.device:
    """The device of a rank: ``device`` where named, else its card; with
    no card visible and none named this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> tuple[str, int]:
    """(backend, ranks sharing a card) for ``local_world`` ranks of one
    host on ``device``'s kind."""
    if device.type != "cuda":
        return "gloo", 0
    share = math.ceil(local_world / torch.cuda.device_count())
    return ("nccl" if share == 1 else "gloo"), share


def in_torchrun() -> bool:
    """Whether ``torchrun`` (or another ``env://`` launcher) started us."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(world_size: int, device: str | torch.device | None = None,
               rank: Optional[int] = None, init_method: Optional[str] = None) -> World:
    """Join (or check) the group of ``world_size`` ranks → this rank's ``World``."""
    global _WORLD
    if _WORLD is not None:
        if _WORLD.size != world_size:
            raise RuntimeError(f"train.num_devices={world_size}, but the process group has "
                               f"{_WORLD.size} ranks")
        return _WORLD
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        local_rank, local_world = rank, size
    elif rank is not None and init_method is not None:
        size, local_rank, local_world = world_size, rank, world_size
    elif in_torchrun():
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        init_method = "env://"
    else:
        raise RuntimeError("not inside a process group: start the ranks with "
                           "parallel.multihost.launch or torchrun")
    if size != world_size:
        raise RuntimeError(f"train.num_devices={world_size}, but the process group has "
                           f"{size} ranks")
    dev = rank_device(local_rank, device)
    backend, share = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=size, timeout=GROUP_TIMEOUT, **kwargs)
    backend = str(dist.get_backend())
    cpu_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    _WORLD = World(rank, size, local_rank, dev, backend, share, Comm(cpu_group=cpu_group))
    return _WORLD


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place in a ``(dp, tp)`` layout of the group: rank
    ``d·tp + t``; ``tp_comm`` spans the ranks ``d·tp + j`` (j < tp),
    ``dp_comm`` the ranks ``i·tp + t`` (i < dp)."""

    dp: int
    tp: int
    d: int
    t: int
    dp_comm: Comm
    tp_comm: Comm

    def describe(self) -> dict:
        return {"dp": self.dp, "tp": self.tp, "d": self.d, "t": self.t}


def mesh2d(dp: int, tp: int) -> Mesh2D:
    """The ``(dp, tp)`` layout of this rank's group (whose size must be
    dp·tp). Every rank makes every group, in one order, the first time a
    layout is asked for; later calls return the same ``Mesh2D``."""
    w = world()
    if w.size != dp * tp:
        raise RuntimeError(f"a mesh of dp={dp} × tp={tp} needs {dp * tp} ranks, the process "
                           f"group has {w.size}")
    if (dp, tp) not in w.meshes:
        d, t = divmod(w.rank, tp)
        rows = [dist.new_group([i * tp + j for j in range(tp)]) for i in range(dp)]
        cols = [dist.new_group([i * tp + j for i in range(dp)]) for j in range(tp)]
        w.meshes[(dp, tp)] = Mesh2D(dp, tp, d, t, Comm(cols[t]), Comm(rows[d]))
    return w.meshes[(dp, tp)]


def world() -> World:
    """This rank's ``World``; raises outside a group."""
    if _WORLD is None:
        raise RuntimeError("multihost.initialize has not run in this process")
    return _WORLD


def is_primary() -> bool:
    """True on rank 0, and in a process without a group: the one that
    writes checkpoints, ``run.log`` and ``metrics.jsonl``."""
    return _WORLD is None or _WORLD.rank == 0


def barrier() -> None:
    """Wait until every rank is here (nothing without a group): where one
    rank reads a file another wrote."""
    if _WORLD is not None and _WORLD.size > 1:
        _WORLD.comm.barrier()


def shutdown() -> None:
    """Leave the group (the end of a rank's process)."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def launch(world_size: int, target: str, args: Sequence = (), *, device: Optional[str] = None,
           store_dir: str | Path | None = None, threads: Optional[int] = None,
           pythonpath: Sequence[str] = (), timeout: Optional[float] = None) -> int:
    """Start ``world_size`` local ranks, each a fresh Python process that
    joins the group and calls ``target`` (``"module:function"``) with
    ``args`` (JSON-serializable) → the exit code: 0 when every rank
    returned 0, else the first failure's code. When a rank fails, or
    ``timeout`` seconds pass, the others are stopped; every process
    started here has ended when this returns.

    The rendezvous is a ``FileStore`` in a fresh directory under
    ``store_dir`` (the system's temporary directory by default).
    ``threads`` is each rank's ``torch.set_num_threads`` (the host's
    cores shared out by default); ``pythonpath`` directories are put
    before this package's root on the ranks' ``PYTHONPATH``.
    """
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    rendezvous = Path(tempfile.mkdtemp(prefix="rendezvous_", dir=store_dir))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*map(str, pythonpath), _PACKAGE_ROOT, *filter(None, [env.get("PYTHONPATH")])])
    env["OMP_NUM_THREADS"] = str(threads)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    spec = json.dumps({"world": world_size, "init": f"file://{rendezvous}/store",
                       "device": device, "threads": threads, "target": target,
                       "args": list(args)})
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from lanczosnet_torch.parallel.multihost import rank_main; "
         "rank_main()", str(r), spec], env=env) for r in range(world_size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    code = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                code = failed[0]
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks of {target} still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
        else:
            code = next((p.returncode for p in procs if p.returncode != 0), 0)
    finally:
        _stop(procs)
        for f in rendezvous.iterdir():
            f.unlink()
        rendezvous.rmdir()
    return code


def _stop(procs: list) -> None:
    """End every process still running: SIGTERM, then SIGKILL after 10 s."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    end = time.monotonic() + 10.0
    for p in procs:
        try:
            p.wait(timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def rank_main() -> None:
    """A rank's process, as ``launch`` starts it: join, call the target,
    leave; the exit code is the target's (an int it returns, else 0), 1
    when it raised."""
    import importlib

    rank, spec = int(sys.argv[1]), json.loads(sys.argv[2])
    torch.set_num_threads(int(spec["threads"]))
    code = 1
    try:
        initialize(spec["world"], spec["device"], rank=rank, init_method=spec["init"])
        module, name = spec["target"].split(":")
        result = getattr(importlib.import_module(module), name)(*spec["args"])
        code = result if isinstance(result, int) else 0
    except Exception:  # a rank reports any failure as its exit code
        traceback.print_exc()
    finally:
        if code == 0:
            shutdown()
    sys.exit(code)
