"""MPNN: edge-conditioned messages and a GRU update (Gilmer et al.).

Counterpart of ``lanczosnet_tpu/models/mpnn.py``. The state width is
``hidden_dim[0]``; ``in_proj`` exists only when node features widen the
encoder's output. Each of ``num_prop`` steps:

- messages: ``z = h · w_msg`` read as ``[B,N,E+1,dim]``, moved to
  ``[B,E+1,N,dim]``, and ``m_i = Σ_e Σ_j ops[e,i,j] z[e,j]`` in float32;
- the update is not ``torch.nn.GRUCell``: the gates are
  ``σ(m·W_in + b + h·W_st)`` over fused z|r|c blocks with the bias on
  the input side only, the candidate ``tanh(c_in + r ⊙ c_st)``, and
  ``h ← ((1 − u) h + u c) · mask`` every step.

Dropout applies once, after the last step. The parameters are the flax
model's raw matrices (glorot-uniform, the bias zero), cast once a
forward to the activation dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lanczosnet_torch.core.graph_batch import GraphBatch, gather_nodes
from lanczosnet_torch.models.base import (
    Dropout,
    GraphModel,
    NodeEncoder,
    check_num_ops,
    common_config,
    glorot_uniform_,
    make_head,
)


class MPNN(GraphModel):
    """MPNN over a ``GraphBatch`` → ``[B, T]`` or ``[B, N, T]``."""

    def __init__(
        self,
        num_atom: int,
        hidden_dim: Sequence[int],
        num_task: int,
        num_prop: int = 3,
        output_hidden_dim: Sequence[int] = (),
        dropout: float = 0.0,
        num_edge_type: int = 4,
        node_feat_dim: int = 0,
        task: str = "graph",
        dtype: str | None = None,
    ):
        super().__init__(task, dtype)
        dim = int(hidden_dim[0])
        self.dim, self.num_prop = dim, int(num_prop)
        self.num_edge_type = int(num_edge_type)
        num_ops = self.num_edge_type + 1
        self.encoder = NodeEncoder(num_atom, dim)
        self.in_proj = nn.Linear(dim + node_feat_dim, dim) if node_feat_dim > 0 else None
        self.w_msg = nn.Parameter(torch.zeros(dim, num_ops * dim))
        self.gru_w_in = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.gru_w_st = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.gru_b = nn.Parameter(torch.zeros(3 * dim))
        self.dropout = Dropout(dropout)
        self.readout = make_head(task, dim, num_task, output_hidden_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "MPNN":
        return cls(num_prop=cfg.get("num_prop", 3), **common_config(cfg))

    def init_extra(self, generator: torch.Generator) -> None:
        for w in (self.w_msg, self.gru_w_in, self.gru_w_st):
            glorot_uniform_(w, w.shape[0], w.shape[1], generator)
        self.gru_b.zero_()

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        check_num_ops(batch, self.num_edge_type)
        h = self.encoder(batch.atom_type, batch.node_feat, batch.mask)
        if self.in_proj is not None:
            h = self.in_proj(h)
        cdt = self.dtype
        b, n = batch.mask.shape
        cols = batch.n_nodes  # n on one device; a node-sharded batch holds n of them
        e, dim = batch.num_ops, self.dim
        w_msg, w_in, w_st, b_gru = (p.to(cdt) for p in
                                    (self.w_msg, self.gru_w_in, self.gru_w_st, self.gru_b))
        mask = batch.mask.to(cdt)[..., None]
        # Σ_e Σ_j ops[e,i,j] z[e,j] as one product over (e, j): [B, N, E·N]
        ops_cat = batch.ops.transpose(1, 2).reshape(b, n, e * cols)
        h = h.to(cdt)
        for _ in range(self.num_prop):
            z = gather_nodes(h @ w_msg, batch.shard)
            z = z.reshape(b, cols, e, dim).transpose(1, 2)  # [B,E,N,dim]
            m = torch.bmm(ops_cat, z.float().reshape(b, e * cols, dim)).to(cdt)
            zi, ri, ci = (m @ w_in + b_gru).chunk(3, dim=-1)
            zs, rs, cs = (h @ w_st).chunk(3, dim=-1)
            update = torch.sigmoid(zi + zs)
            reset = torch.sigmoid(ri + rs)
            cand = torch.tanh(ci + reset * cs)
            h = ((1.0 - update) * h + update * cand) * mask
        h = self.dropout(h)
        return self.readout(h.float(), batch.mask)
