"""GCN: per-edge-type dense graph convolution.

Counterpart of ``lanczosnet_tpu/models/gcn.py``. Per layer the node
states propagate through every operator channel (channel 0, the merged
graph, included), and ``Linear([h ‖ {A_e h}_e])`` → ReLU → Dropout →
mask; the head follows the last layer. The propagation accumulates in
float32 and is stored at the activation dtype.

``GCN`` is also the frame of GraphSAGE, DCNN and ChebyNet: one ``Linear``
a layer whose input is the layer's features (``features``) of the
operator stack the model propagates through (``operators``), of width
``layer_in(d)`` for node states of width ``d``.

On a node-sharded batch (``core/graph_batch.py``) the operators are this
rank's rows and each propagation gathers the node states whole first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lanczosnet_torch.core.graph_batch import GraphBatch, NodeShard, gather_nodes
from lanczosnet_torch.models.base import (
    Dense,
    Dropout,
    GraphModel,
    NodeEncoder,
    check_num_ops,
    common_config,
    edge_message_concat,
    make_head,
)


def with_messages(h: torch.Tensor, ops: torch.Tensor,
                  shard: Optional[NodeShard] = None) -> torch.Tensor:
    """``[h ‖ {A_e h}_e]`` for ``ops [B,E,N,N]``: the propagation in
    float32, stored at ``h``'s dtype."""
    msgs = edge_message_concat(ops, gather_nodes(h, shard).float())
    return torch.cat([h, msgs.to(h.dtype)], dim=-1)


class GCN(GraphModel):
    """GCN over a ``GraphBatch`` → ``[B, T]`` or, with ``task="node"``,
    ``[B, N, T]``."""

    def __init__(
        self,
        num_atom: int,
        embed_dim: int,
        hidden_dim: Sequence[int],
        num_task: int,
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
        d_in = embed_dim + node_feat_dim
        layers = []
        for dim in hidden_dim:
            layers.append(Dense(self.layer_in(d_in), dim, act_dtype=self.dtype))
            d_in = dim
        self.layers = nn.ModuleList(layers)
        self.dropout = Dropout(dropout)
        self.readout = make_head(task, d_in, num_task, output_hidden_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "GCN":
        return cls(embed_dim=cfg.get("embed_dim", cfg["hidden_dim"][0]), **common_config(cfg))

    def layer_in(self, d: int) -> int:
        """A layer's input width for node states of width ``d``: ``h`` and
        one message a channel."""
        return d * (self.num_edge_type + 2)

    def operators(self, batch: GraphBatch) -> torch.Tensor:
        """The ``[B, E+1, N, N]`` stack the layers propagate through,
        formed once a forward."""
        return batch.ops

    def features(self, h: torch.Tensor, ops: torch.Tensor,
                 shard: Optional[NodeShard]) -> torch.Tensor:
        """A layer's ``Linear`` input (``shard``: the batch's, or None)."""
        return with_messages(h, ops, shard)

    def activate(self, h: torch.Tensor) -> torch.Tensor:
        """After the layer's ``Linear``, before the Dropout."""
        return torch.relu(h)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        check_num_ops(batch, self.num_edge_type)
        cdt = self.dtype
        h = self.encoder(batch.atom_type, batch.node_feat, batch.mask).to(cdt)
        mask = batch.mask.to(cdt)[..., None]
        ops = self.operators(batch)
        for layer in self.layers:
            h = self.activate(layer(self.features(h, ops, batch.shard)))
            h = self.dropout(h) * mask
        return self.readout(h.float(), batch.mask)
