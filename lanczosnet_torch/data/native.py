"""ctypes binding of the native graph packer
(``lanczosnet_torch/native/graphpack.cc``).

Counterpart of ``lanczosnet_tpu/data/native.py``, over the port's own
copy of the source (unchanged from ``native/graphpack.cc``). One
multithreaded C++ pass pads the graphs and builds every channel's
normalized operator, the ``{atom_type, ops, mask}`` arrays of
``core/graph_batch.py:batch_graphs`` plus ``ops/normalize.py``, on the
host. ``data/dataset.py:pack_dataset(use_native=True)`` uses it where
the JAX package does.

The library is built with g++ at first use into ``build/native/``
beside the package, named by a hash of the source and the flags (as
``serve_native.py`` builds the front). Where it cannot be built or
loaded, ``pack_arrays`` returns None and the caller runs the torch path;
``fallbacks`` counts those calls.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from lanczosnet_torch.ops._build import Built, build_cxx
from lanczosnet_torch.ops.lanczos_cuda import LaunchCounter
from lanczosnet_torch.utils.logger import get_logger

SOURCE = Path(__file__).resolve().parents[1] / "native" / "graphpack.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# native/Makefile's flags
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread")

# calls of pack_arrays that found no library (the caller packs in torch)
fallbacks = LaunchCounter()


def build() -> Built:
    """Compile ``graphpack.cc`` unless a build of this source and these
    flags exists (``Built.seconds`` is then 0.0); raises with g++'s
    output if the build fails."""
    return build_cxx("graphpack", SOURCE, CXX_FLAGS, BUILD_DIR)


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build().path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        get_logger().warning("native packer unavailable, packing in torch: %s", exc)
        return None
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.graphpack_pack.restype = ctypes.c_int
    lib.graphpack_pack.argtypes = [
        ctypes.c_int, i32, i32, i64, f32, i64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32, f32, f32,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def pack_arrays(graphs: Sequence[dict], n_max: int, kind: str = "sym",
                num_threads: int = 0) -> Optional[dict]:
    """Graph dicts → ``{atom_type [G,N] int32, ops [G,E+1,N,N], mask
    [G,N]}`` numpy arrays, or None where the library is unavailable or
    fails (the call is counted in ``fallbacks``). A graph of more than ``n_max``
    nodes raises ``ValueError`` naming ``n_max``. ``num_threads`` 0: the
    library picks."""
    lib = _load()
    if lib is None:
        fallbacks.add()
        return None
    g = len(graphs)
    n_nodes = np.asarray([np.asarray(gr["atom_type"]).shape[0] for gr in graphs], np.int32)
    num_edge = int(np.asarray(graphs[0]["adj"]).shape[0]) if g else 0
    atom_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(gr["atom_type"], np.int32) for gr in graphs])
        if g else np.zeros(0, np.int32))
    atom_off = np.zeros(g + 1, np.int64)
    np.cumsum(n_nodes, out=atom_off[1:])
    adj_blocks = [np.asarray(gr["adj"], np.float32).ravel() for gr in graphs]
    adj_off = np.zeros(g + 1, np.int64)
    np.cumsum([b.size for b in adj_blocks], out=adj_off[1:])
    adj_flat = (np.ascontiguousarray(np.concatenate(adj_blocks)) if adj_blocks
                else np.zeros(0, np.float32))
    atom_out = np.empty((g, n_max), np.int32)
    ops_out = np.empty((g, num_edge + 1, n_max, n_max), np.float32)
    mask_out = np.empty((g, n_max), np.float32)
    rc = lib.graphpack_pack(g, n_nodes, atom_flat, atom_off, adj_flat, adj_off, num_edge,
                            n_max, 0 if kind == "sym" else 1, num_threads,
                            atom_out, ops_out, mask_out)
    if rc == -1:
        big = int(n_nodes.max()) if g else 0
        raise ValueError(f"graph has {big} nodes > n_max={n_max}")
    if rc != 0:
        get_logger().warning("native packer failed (%d), packing in torch", rc)
        fallbacks.add()
        return None
    return {"atom_type": atom_out, "ops": ops_out, "mask": mask_out}
