"""The dense, padded, masked graph batch every model consumes.

Counterpart of ``lanczosnet_tpu/core/graph_batch.py``. Graphs are
padded to one global ``n_max`` and carry a node mask; operators are
stored ``[B, E, N, N]`` with channel 0 the normalized operator of the
merged graph and channels ``1..E`` the per-edge-type operators.

A node-sharded batch (one citation graph split by node rows over the
ranks of a process group, ``train/citation_runner.py``) holds only this
rank's rows: ``ops [1, E, N/D, N]`` (local rows, every column), every
node array ``[1, N/D, ...]``, and a ``NodeShard`` with the whole column
vectors. The models run unchanged on it through three helpers:
``gather_nodes`` before each contraction over the node axis,
``node_sum`` for a sum over nodes, and ``row_eye`` for the diagonal of
the row block; on a batch without a shard each is the one-device form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from lanczosnet_torch.parallel.comm import Comm, all_gather_rows, psum


@dataclass
class NodeShard:
    """Where a node-sharded batch's rows sit in the whole graph: they
    start at row ``offset``; ``comm`` is the group; the column vectors are
    whole, ``mask [B, n_pad]`` and GPNN's ``cluster [B, n_pad]`` (or
    None). Each rank's loss is its share of the whole graph's, so every
    gather's backward is a reduce-scatter and every sum's a sum."""

    comm: Comm
    offset: int
    mask: torch.Tensor
    cluster: Optional[torch.Tensor] = None


@dataclass
class GraphBatch:
    """A batch of padded dense graphs; all tensors share leading dim B.

    atom_type ``[B, N]`` int (0 is padding), node_feat ``[B, N, Fc]``
    float (Fc may be 0), ops ``[B, E, N, N]`` float, mask ``[B, N]``
    float (1 real, 0 padding), and optionally label ``[B, T]``,
    ritz_val ``[B, K]``, ritz_vec ``[B, N, K]``, cluster ``[B, N]`` int
    (GPNN's partition assignment, 0 on padded nodes) and node_label
    ``[B, N]`` int (per-node classes for full-graph node classification;
    which nodes are supervised is a separate mask given to the loss).
    """

    atom_type: torch.Tensor
    node_feat: torch.Tensor
    ops: torch.Tensor
    mask: torch.Tensor
    label: Optional[torch.Tensor] = None
    ritz_val: Optional[torch.Tensor] = None
    ritz_vec: Optional[torch.Tensor] = None
    cluster: Optional[torch.Tensor] = None
    node_label: Optional[torch.Tensor] = None
    shard: Optional[NodeShard] = field(default=None, repr=False)

    @property
    def n_max(self) -> int:
        """The rows this batch holds (a node-sharded batch: its block)."""
        return self.mask.shape[1]

    @property
    def row_offset(self) -> int:
        """The whole graph's row at which this batch's rows start."""
        return 0 if self.shard is None else self.shard.offset

    @property
    def n_nodes(self) -> int:
        """The padded nodes of the whole graph: the operator's columns."""
        return self.col_mask.shape[1]

    @property
    def col_mask(self) -> torch.Tensor:
        """``[B, n_nodes]``: the node mask of every column."""
        return self.mask if self.shard is None else self.shard.mask

    @property
    def col_cluster(self) -> Optional[torch.Tensor]:
        """``[B, n_nodes]``: GPNN's cluster of every column, or None."""
        return self.cluster if self.shard is None else self.shard.cluster

    @property
    def num_ops(self) -> int:
        return self.ops.shape[1]

    def pair_mask(self) -> torch.Tensor:
        """``[B, N, N]`` outer product of the node mask (node-sharded:
        this block's rows against every column)."""
        return self.mask[:, :, None] * self.col_mask[:, None, :]


def gather_nodes(h: torch.Tensor, shard: Optional[NodeShard]) -> torch.Tensor:
    """``h [B, rows, ...]`` → every node's ``[B, n_pad, ...]``: the identity
    without a shard, else the ranks' row blocks in rank order
    (``all_gather_rows``, whose backward is a reduce-scatter)."""
    if shard is None:
        return h
    return all_gather_rows(h.movedim(1, 0).contiguous(), shard.comm).movedim(0, 1)


def node_sum(x: torch.Tensor, shard: Optional[NodeShard]) -> torch.Tensor:
    """A partial sum over this rank's nodes → the whole graph's (``psum``);
    the identity without a shard."""
    return x if shard is None else psum(x, shard.comm)


def row_eye(batch: GraphBatch, dtype=torch.float32) -> torch.Tensor:
    """``[rows, n_nodes]``: the identity's rows that this batch holds (the
    whole identity without a shard)."""
    device = batch.mask.device
    rows = torch.arange(batch.n_max, device=device) + batch.row_offset
    return (rows[:, None] == torch.arange(batch.n_nodes, device=device)).to(dtype)


def pad_graph(
    atom_type: np.ndarray,
    node_feat: Optional[np.ndarray],
    adj: np.ndarray,
    n_max: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad one graph to ``n_max`` nodes: atom_type ``[n]``, node_feat
    ``[n, Fc]`` or None, adj ``[E, n, n]`` → (atom_type ``[n_max]``,
    node_feat ``[n_max, Fc]``, adj ``[E, n_max, n_max]``, mask ``[n_max]``)."""
    n = int(atom_type.shape[0])
    if n > n_max:
        raise ValueError(f"graph has {n} nodes > n_max={n_max}")
    at = np.zeros((n_max,), dtype=np.int32)
    at[:n] = atom_type
    fc = 0 if node_feat is None else node_feat.shape[-1]
    nf = np.zeros((n_max, fc), dtype=np.float32)
    if node_feat is not None:
        nf[:n] = node_feat
    a = np.zeros((adj.shape[0], n_max, n_max), dtype=np.float32)
    a[:, :n, :n] = adj
    mask = np.zeros((n_max,), dtype=np.float32)
    mask[:n] = 1.0
    return at, nf, a, mask


def batch_graphs(graphs: Sequence[dict], n_max: int) -> dict:
    """Stack graph dicts (``atom_type [n]``, ``adj [E,n,n]``,
    ``label [T]``, optional ``node_feat [n,Fc]``) into padded numpy
    arrays keyed ``atom_type``, ``node_feat``, ``adj``, ``mask``, ``label``."""
    cols: dict[str, list] = {k: [] for k in ("atom_type", "node_feat", "adj", "mask", "label")}
    for g in graphs:
        feat = g.get("node_feat")
        at, nf, a, m = pad_graph(
            np.asarray(g["atom_type"]),
            None if feat is None else np.asarray(feat),
            np.asarray(g["adj"]),
            n_max,
        )
        for key, val in zip(("atom_type", "node_feat", "adj", "mask"), (at, nf, a, m)):
            cols[key].append(val)
        cols["label"].append(np.asarray(g["label"], dtype=np.float32))
    return {k: np.stack(v) for k, v in cols.items()}
