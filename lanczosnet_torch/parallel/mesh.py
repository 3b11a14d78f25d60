"""The QM8 runner's mesh, and the sharded forms of a COO operator and of
node arrays, on the host.

Counterpart of ``lanczosnet_tpu/parallel/mesh.py``. The dense half is
the QM8 runner's ``(dp, tp)`` mesh: ``mesh_shape`` is the JAX runner's
formula (``lanczosnet_tpu/train/runner.py``), and each data-parallel
rank takes a contiguous block of every batch (``batch_rows``), as
``P("data")`` places a batch on the JAX mesh.

The sparse half follows.
Each function takes the whole host operator (``row``, ``col``, ``val``
numpy arrays, destination-major) and returns every rank's piece stacked
on a leading ``[D]`` axis: the arrays the JAX functions place on the
mesh, element for element. Rank 0 builds them and each rank receives
its own slice (``train/sparse_citation_runner.py``); ``sparse_op_piece``
and ``ring_op_piece`` turn a rank's slice into its operator.

- ``shard_sparse_arrays`` (edge mode): the edge list padded with dead
  edges to a multiple of D and cut into D contiguous slices; the pads
  take the LAST node id as their row, so every slice stays
  non-decreasing; each slice gets its own stable ``col_perm``.
- ``node_shard_arrays`` (node mode): nodes in D contiguous blocks of
  ``n_loc`` rows; each rank holds the edges whose destination is in its
  block (``row`` block-local, ``col`` global), every rank padded to the
  largest bucket with dead edges at row ``n_loc − 1``.
- ``ring_shard_arrays`` (ring mode): the same destination buckets, each
  cut again by the source's block (``col`` local to that block), every
  ``[D, D]`` slice padded to the largest.
- ``shard_node_array``: a node-major array zero-padded to D·n_loc rows
  and cut into the blocks.

Last the dense full graph (``shard_full_graph``, the dense citation
runner's node-sharding): a packed B=1 graph, already padded to a
multiple of D, cut into rank r's rows, by the rule of the JAX function
of that name.

Bucketing keeps each bucket's edges in their order in the input (a
stable sort by bucket, as the JAX functions' boolean masks keep it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lanczosnet_torch.parallel.comm import Comm


def largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def mesh_shape(batch_size: int, num_devices: int = 0, tp: int = 1) -> tuple[int, int]:
    """(dp, tp) of the QM8 runner: with ``tp > 1``, ``dp`` is the largest
    divisor of the batch that fits ``num_devices // tp``; otherwise the
    largest that fits ``num_devices``. Devices past ``dp·tp`` are left
    out, as the JAX runner leaves them out. ``num_devices`` 0 (not set)
    means ``tp``: the port starts a process a rank, so it shards only
    where a config asks, where JAX takes every device it sees."""
    tp = max(1, int(tp))
    ndev = int(num_devices) or tp
    if ndev < tp:
        raise ValueError(f"train.tp={tp} needs at least {tp} devices, "
                         f"train.num_devices={num_devices}")
    return largest_divisor_leq(int(batch_size), ndev // tp), tp


def batch_rows(batch_size: int, dp: int, d: int) -> slice:
    """Data-parallel rank ``d``'s rows of a batch: its contiguous
    ``batch_size/dp``."""
    n = batch_size // dp
    return slice(d * n, (d + 1) * n)


def padded_nodes(n: int, ndev: int) -> tuple[int, int]:
    """(n_pad, n_loc): n rounded up to a multiple of ``ndev``, and a block."""
    n_pad = -(-n // ndev) * ndev
    return n_pad, n_pad // ndev


def shard_sparse_arrays(row, col, val, n: int, ndev: int) -> dict:
    """Edge mode → ``{"row", "col", "val", "col_perm"}``, each ``[D, E/D]``."""
    pad = (-len(row)) % ndev
    row = np.concatenate([np.asarray(row, np.int32), np.full(pad, n - 1, np.int32)])
    col = np.concatenate([np.asarray(col, np.int32), np.zeros(pad, np.int32)])
    val = np.concatenate([np.asarray(val, np.float32), np.zeros(pad, np.float32)])
    cut = lambda a: a.reshape(ndev, -1)  # noqa: E731
    perm = np.argsort(cut(col), axis=1, kind="stable").astype(np.int32)
    return {"row": cut(row), "col": cut(col), "val": cut(val), "col_perm": perm}


def _buckets(key: np.ndarray, nbucket: int) -> tuple[np.ndarray, np.ndarray]:
    """(order, starts): the edges sorted stably by ``key``, and where each
    of the ``nbucket`` buckets starts in that order (``starts[-1]`` = E)."""
    order = np.argsort(key, kind="stable")
    starts = np.searchsorted(key[order], np.arange(nbucket + 1))
    return order, starts


def node_shard_arrays(row, col, val, n: int, ndev: int) -> tuple[dict, int]:
    """Node mode → (``{"row", "col", "val", "col_perm"}`` each ``[D, e_max]``,
    n_pad)."""
    row, col, val = (np.asarray(a) for a in (row, col, val))
    n_pad, n_loc = padded_nodes(n, ndev)
    order, starts = _buckets(row // n_loc, ndev)
    e_max = max(int(np.diff(starts).max()), 1)
    r = np.full((ndev, e_max), n_loc - 1, np.int32)
    c = np.zeros((ndev, e_max), np.int32)
    v = np.zeros((ndev, e_max), np.float32)
    for d in range(ndev):
        sel = order[starts[d]:starts[d + 1]]
        k = len(sel)
        r[d, :k] = row[sel] - d * n_loc
        c[d, :k] = col[sel]
        v[d, :k] = val[sel]
    perm = np.argsort(c, axis=1, kind="stable").astype(np.int32)
    return {"row": r, "col": c, "val": v, "col_perm": perm}, n_pad


def ring_shard_arrays(row, col, val, n: int, ndev: int) -> tuple[dict, int]:
    """Ring mode → (``{"row", "col", "val"}`` each ``[D, D, e_max]``: rank
    d's slice s holds its edges from block s), n_pad)."""
    row, col, val = (np.asarray(a) for a in (row, col, val))
    n_pad, n_loc = padded_nodes(n, ndev)
    order, starts = _buckets((row // n_loc) * ndev + col // n_loc, ndev * ndev)
    e_max = max(int(np.diff(starts).max()), 1)
    r = np.full((ndev, ndev, e_max), n_loc - 1, np.int32)
    c = np.zeros((ndev, ndev, e_max), np.int32)
    v = np.zeros((ndev, ndev, e_max), np.float32)
    for d in range(ndev):
        for s in range(ndev):
            sel = order[starts[d * ndev + s]:starts[d * ndev + s + 1]]
            k = len(sel)
            r[d, s, :k] = row[sel] - d * n_loc
            c[d, s, :k] = col[sel] - s * n_loc
            v[d, s, :k] = val[sel]
    return {"row": r, "col": c, "val": v}, n_pad


def shard_node_array(x: np.ndarray, n_pad: int, ndev: int) -> np.ndarray:
    """``x [n, ...]`` zero-padded to ``n_pad`` rows → ``[D, n_pad/D, ...]``."""
    x = np.asarray(x)
    pad = np.zeros((n_pad - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad]).reshape((ndev, n_pad // ndev) + x.shape[1:])


def node_axes(arrays: dict) -> dict:
    """The axis each array of a packed B=1 full graph is cut on (None:
    whole), by ``lanczosnet_tpu/parallel/mesh.py:shard_full_graph``'s
    rule: ``ops [1, E, N, N]`` by rows (axis 2), every ``[1, N, ...]``
    on axis 1, the rest (``ritz_val``, ``label``) whole. ``N`` is the
    padded node count, ``mask``'s second axis."""
    n_pad = arrays["mask"].shape[1]
    axes = {}
    for key, a in arrays.items():
        if a is None:
            continue
        if a.ndim == 4 and a.shape[2] == n_pad:
            axes[key] = 2
        elif a.ndim >= 2 and a.shape[1] == n_pad:
            axes[key] = 1
        else:
            axes[key] = None
    return axes


def node_rows(a: np.ndarray, axis: int, ndev: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s contiguous block of ``a`` on ``axis`` (a view)."""
    n_loc = a.shape[axis] // ndev
    return a[(slice(None),) * axis + (slice(rank * n_loc, (rank + 1) * n_loc),)]


def shard_full_graph(arrays: dict, ndev: int, rank: int) -> dict:
    """Rank ``rank``'s piece of a packed B=1 full graph (``arrays``: the
    ``GraphBatch`` fields and split masks as numpy, the node axis padded
    to a multiple of ``ndev``): each array cut as ``node_axes`` says,
    and the column vectors whole, ``col.mask`` (``pair_mask``'s columns)
    and, where GPNN's partition is packed, ``col.cluster``."""
    if arrays["mask"].shape[1] % ndev:
        raise ValueError(f"{arrays['mask'].shape[1]} padded nodes do not split over {ndev} ranks")
    piece = {k: arrays[k] if axis is None else node_rows(arrays[k], axis, ndev, rank)
             for k, axis in node_axes(arrays).items()}
    piece["col.mask"] = arrays["mask"]
    if arrays.get("cluster") is not None:
        piece["col.cluster"] = arrays["cluster"]
    return piece


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def sparse_op_piece(piece: dict, n: int, comm: Comm, mode: str, device,
                    n_true: Optional[int] = None):
    """A rank's ``SparseOp`` from its slice of ``shard_sparse_arrays``
    (``mode`` ``"edges"``: ``n`` the whole graph's nodes) or of
    ``node_shard_arrays`` (``"nodes"``: ``n`` the block's rows). Both
    keep each piece's rows non-decreasing, so ``rows_sorted`` holds."""
    from lanczosnet_torch.ops.sparse import SparseOp

    axes = {"axis": comm} if mode == "edges" else {"gather_axis": comm, "n_true": n_true}
    return SparseOp(row=_tensor(piece["row"], device), col=_tensor(piece["col"], device),
                    val=_tensor(piece["val"], device), n=int(n), rows_sorted=True,
                    col_perm=_tensor(piece["col_perm"], device), **axes)


def ring_op_piece(piece: dict, n_loc: int, comm: Comm, device, n_true: Optional[int] = None):
    """A rank's ``RingOp`` from its slice of ``ring_shard_arrays``."""
    from lanczosnet_torch.ops.sparse import RingOp

    return RingOp(row=_tensor(piece["row"], device), col=_tensor(piece["col"], device),
                  val=_tensor(piece["val"], device), n=int(n_loc), axis=comm, n_true=n_true)
