"""GPNN: graph partition neural network.

Counterpart of ``lanczosnet_tpu/models/gpnn.py``. Each graph's nodes
carry a cluster id (``batch.cluster``, from ``data/partition.py`` at
pack time; without it the whole graph is one cluster). The ``same`` and
``cross`` pair masks split the operator stack into intra-cluster and cut
operators; ``boundary`` marks the nodes with a cut edge in channel 0.
Per layer the schedule is ``num_prop`` repetitions of

- ``num_intra_prop`` intra steps ``h ← ReLU(intra([h ‖ A^intra h]))·mask``,
- ``num_cut_prop`` cut steps ``h ← (boundary·ReLU(cut([h ‖ A^cut h])) +
  (1 − boundary)·h)·mask``, with ``carry`` projecting ``h`` first where
  the width changes,

then one Dropout. The ``Linear``s are named ``intra_{l}_{p}_{i}``,
``cut_{l}_{p}_{c}`` and ``carry_{l}_{p}_{c}``, as the flax model's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.models.base import (
    Dense,
    Dropout,
    GraphModel,
    NodeEncoder,
    check_num_ops,
    common_config,
    make_head,
)
from lanczosnet_torch.models.gcn import with_messages


def partition_operators(batch: GraphBatch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(intra_ops, cut_ops [B,E+1,N,N], boundary [B,N])``, float32 (a
    node-sharded batch: its rows against every column)."""
    pair = batch.pair_mask()
    if batch.cluster is None:
        same = pair
    else:
        same = (batch.cluster[:, :, None] == batch.col_cluster[:, None, :]).float() * pair
    cross = pair - same
    intra_ops = batch.ops * same[:, None]
    cut_ops = batch.ops * cross[:, None]
    boundary = ((cut_ops[:, 0] != 0.0).sum(-1) > 0).float() * batch.mask
    return intra_ops, cut_ops, boundary


class GPNN(GraphModel):
    """GPNN over a ``GraphBatch`` (with ``cluster``, or one cluster a
    graph) → ``[B, T]`` or ``[B, N, T]``."""

    def __init__(
        self,
        num_atom: int,
        embed_dim: int,
        hidden_dim: Sequence[int],
        num_task: int,
        num_prop: int = 2,
        num_intra_prop: int = 1,
        num_cut_prop: int = 1,
        output_hidden_dim: Sequence[int] = (),
        dropout: float = 0.0,
        num_edge_type: int = 4,
        node_feat_dim: int = 0,
        task: str = "graph",
        dtype: str | None = None,
    ):
        super().__init__(task, dtype)
        self.num_edge_type = int(num_edge_type)
        self.encoder = NodeEncoder(num_atom, embed_dim)
        num_ops = self.num_edge_type + 1
        d = embed_dim + node_feat_dim
        # the schedule, step by step: (kind, Linear's name, carry's name or None)
        self.schedule: list[tuple[str, str, str | None]] = []
        dense = {}
        for li, dim in enumerate(hidden_dim):
            for p in range(int(num_prop)):
                for i in range(int(num_intra_prop)):
                    name = f"intra_{li}_{p}_{i}"
                    dense[name] = Dense(d * (1 + num_ops), dim, act_dtype=self.dtype)
                    self.schedule.append(("intra", name, None))
                    d = dim
                for c in range(int(num_cut_prop)):
                    name, carry = f"cut_{li}_{p}_{c}", None
                    dense[name] = Dense(d * (1 + num_ops), dim, act_dtype=self.dtype)
                    if d != dim:
                        carry = f"carry_{li}_{p}_{c}"
                        dense[carry] = Dense(d, dim, act_dtype=self.dtype)
                    self.schedule.append(("cut", name, carry))
                    d = dim
            self.schedule.append(("dropout", "", None))
        self.dense = nn.ModuleDict(dense)
        self.dropout = Dropout(dropout)
        self.readout = make_head(task, d, num_task, output_hidden_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "GPNN":
        return cls(
            embed_dim=cfg.get("embed_dim", cfg["hidden_dim"][0]),
            num_prop=cfg.get("num_prop", 2),
            num_intra_prop=cfg.get("num_intra_prop", 1),
            num_cut_prop=cfg.get("num_cut_prop", 1),
            **common_config(cfg),
        )

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        check_num_ops(batch, self.num_edge_type)
        cdt = self.dtype
        h = self.encoder(batch.atom_type, batch.node_feat, batch.mask).to(cdt)
        mask = batch.mask.to(cdt)[..., None]
        intra_ops, cut_ops, boundary = partition_operators(batch)
        boundary = boundary.to(cdt)[..., None]
        for kind, name, carry in self.schedule:
            if kind == "dropout":
                h = self.dropout(h)
                continue
            ops = intra_ops if kind == "intra" else cut_ops
            upd = torch.relu(self.dense[name](with_messages(h, ops, batch.shard)))
            if kind == "intra":
                h = upd * mask
            else:
                if carry is not None:
                    h = self.dense[carry](h)
                h = (boundary * upd + (1.0 - boundary) * h) * mask
        return self.readout(h.float(), batch.mask)
