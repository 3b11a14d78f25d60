"""GAT: dense masked multi-head graph attention, per edge channel.

Counterpart of ``lanczosnet_tpu/models/gat.py``. A layer has one
projection ``w_e`` and two score vectors ``a_src_e``, ``a_dst_e`` (no
biases) for each of the ``E+1`` operator channels. Channel ``e`` scores
``leaky_relu(a_src_i + a_dst_j, 0.2)`` in float32, softmaxes it over the
support ``ops[:, e] > 0`` or the diagonal, times both node masks, and
aggregates ``w_e h``; the layer sums over channels. Per-head width is
``max(dim // heads, 1)``; ELU, Dropout and the mask follow.

The channels' projections run as one ``Linear`` on their concatenated
weights, and the channels' attention as one batched product that sums
over channel and neighbour at once: the same values, fewer launches.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lanczosnet_torch.core.graph_batch import GraphBatch, gather_nodes, row_eye
from lanczosnet_torch.models.base import (
    Dropout,
    GraphModel,
    NodeEncoder,
    check_num_ops,
    common_config,
    make_head,
)
from lanczosnet_torch.ops.masked import masked_softmax

LEAKY_SLOPE = 0.2


class GATLayer(nn.Module):
    """One attention layer over ``num_ops`` channels → ``[B, N, heads·out_dim]``
    at the activation dtype."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, num_ops: int,
                 act_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_dim, self.num_heads, self.act_dtype = out_dim, num_heads, act_dtype

        def linears(width):
            return nn.ModuleList(nn.Linear(in_dim, width, bias=False) for _ in range(num_ops))

        self.w = linears(num_heads * out_dim)
        self.a_src = linears(num_heads)
        self.a_dst = linears(num_heads)

    def forward(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        """Node states ``h [B, N, F]`` over ``batch``'s operators (a
        node-sharded batch: ``h`` its rows; the targets ``j`` are every
        node, their projections gathered)."""
        b, n, _ = h.shape
        cols = batch.n_nodes
        e, hd, fd = len(self.w), self.num_heads, self.out_dim
        weight = torch.cat([lin.weight for group in (self.a_src, self.w, self.a_dst)
                            for lin in group]).to(self.act_dtype)
        proj = F.linear(h.to(self.act_dtype), weight)
        # the targets' projections, gathered where the batch is node-sharded
        a_src, targets = proj[..., : e * hd], gather_nodes(proj[..., e * hd:], batch.shard)
        z, a_dst = targets.split([e * hd * fd, e * hd], dim=-1)
        z = z.reshape(b, cols, e, hd, fd)
        a_src = a_src.reshape(b, n, e, hd).permute(0, 2, 3, 1)  # [B,E,H,N]
        a_dst = a_dst.reshape(b, cols, e, hd).permute(0, 2, 3, 1)
        # the sum at the activation dtype, then float32, as the JAX layer
        scores = (a_src[..., :, None] + a_dst[..., None, :]).float()  # [B,E,H,N,N]
        scores = F.leaky_relu(scores, LEAKY_SLOPE)
        eye = row_eye(batch, torch.bool)
        support = ((batch.ops > 0) | eye).float() * batch.pair_mask()[:, None]
        att = masked_softmax(scores, support[:, :, None])
        out = torch.einsum("behij,bjehf->bihf", att, z.float())
        return out.reshape(b, n, hd * fd).to(self.act_dtype)


class GAT(GraphModel):
    """GAT over a ``GraphBatch`` → ``[B, T]`` or ``[B, N, T]``."""

    def __init__(
        self,
        num_atom: int,
        embed_dim: int,
        hidden_dim: Sequence[int],
        num_task: int,
        num_heads: int = 4,
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
            per_head = max(dim // num_heads, 1)
            layers.append(GATLayer(d_in, per_head, num_heads, self.num_edge_type + 1, self.dtype))
            d_in = per_head * num_heads
        self.layers = nn.ModuleList(layers)
        self.dropout = Dropout(dropout)
        self.readout = make_head(task, d_in, num_task, output_hidden_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "GAT":
        return cls(embed_dim=cfg.get("embed_dim", cfg["hidden_dim"][0]),
                   num_heads=cfg.get("num_heads", 4), **common_config(cfg))

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        check_num_ops(batch, self.num_edge_type)
        cdt = self.dtype
        h = self.encoder(batch.atom_type, batch.node_feat, batch.mask).to(cdt)
        mask = batch.mask.to(cdt)[..., None]
        for layer in self.layers:
            h = F.elu(layer(h, batch))
            h = self.dropout(h) * mask
        return self.readout(h.float(), batch.mask)
