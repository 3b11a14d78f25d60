"""DCNN: diffusion-convolutional features over operator powers.

Counterpart of ``lanczosnet_tpu/models/dcnn.py``. Per layer, the hops
``P h, P² h, …, P^max_hop h`` of every operator channel (``P``
row-stochastic with ``dataset.operator_kind: row``), in the order
channel, then hop, then feature, beside ``h`` into one ``Linear`` →
ReLU → Dropout → mask. The hops are float32; the stack is stored at the
activation dtype.
"""

from __future__ import annotations

import torch

from lanczosnet_torch.models.base import common_config
from lanczosnet_torch.models.gcn import GCN
from lanczosnet_torch.ops.poly import diffusion_features


def per_channel(fn, ops: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``fn(op, x) → [B', P, N, F]`` applied to every channel of ``ops
    [B,E,N,N]`` with ``x = h [B,N,F]`` as float32, in one batched call →
    ``[B, N, E·P·F]`` in the order channel, then ``P``, then feature."""
    b, e, n, cols = ops.shape  # a node-sharded batch: its n rows of every column
    x = h.float()[:, None].expand(b, e, n, h.shape[-1]).reshape(b * e, n, -1)
    feats = fn(ops.reshape(b * e, n, cols), x)  # [B·E, P, N, F]
    feats = feats.reshape(b, e, feats.shape[1], n, -1)
    return feats.permute(0, 3, 1, 2, 4).reshape(b, n, -1)


class DCNN(GCN):
    """DCNN over a ``GraphBatch`` → ``[B, T]`` or ``[B, N, T]``."""

    def __init__(self, *args, max_hop: int = 3, **kwargs):
        self.max_hop = int(max_hop)  # before the frame sizes its layers by layer_in
        super().__init__(*args, **kwargs)

    @classmethod
    def from_config(cls, cfg: dict) -> "DCNN":
        return cls(embed_dim=cfg.get("embed_dim", cfg["hidden_dim"][0]),
                   max_hop=cfg.get("max_hop", 3), **common_config(cfg))

    def layer_in(self, d: int) -> int:
        return d * (1 + (self.num_edge_type + 1) * self.max_hop)

    def features(self, h: torch.Tensor, ops: torch.Tensor, shard) -> torch.Tensor:
        hops = per_channel(lambda op, x: diffusion_features(op, x, self.max_hop, shard), ops, h)
        return torch.cat([h, hops.to(h.dtype)], dim=-1)
