"""ChebyNet: Chebyshev-polynomial spectral filters.

Counterpart of ``lanczosnet_tpu/models/chebynet.py``. Per layer the
Chebyshev stack ``T_0 h … T_P h`` of every operator channel
(``ops/poly.py:chebyshev_features``; ``T_0 h`` is ``h`` itself, so no
separate ``h`` joins it), in the order channel, then order, then
feature, into one ``Linear`` → ReLU → Dropout → mask. The recurrence is
float32; the stack is stored at the activation dtype.
"""

from __future__ import annotations

import torch

from lanczosnet_torch.models.base import common_config
from lanczosnet_torch.models.dcnn import per_channel
from lanczosnet_torch.models.gcn import GCN
from lanczosnet_torch.ops.poly import chebyshev_features


class ChebyNet(GCN):
    """ChebyNet over a ``GraphBatch`` → ``[B, T]`` or ``[B, N, T]``."""

    def __init__(self, *args, poly_order: int = 3, **kwargs):
        self.poly_order = int(poly_order)  # before the frame sizes its layers by layer_in
        super().__init__(*args, **kwargs)

    @classmethod
    def from_config(cls, cfg: dict) -> "ChebyNet":
        return cls(embed_dim=cfg.get("embed_dim", cfg["hidden_dim"][0]),
                   poly_order=cfg.get("poly_order", 3), **common_config(cfg))

    def layer_in(self, d: int) -> int:
        return d * (self.num_edge_type + 1) * (self.poly_order + 1)

    def features(self, h: torch.Tensor, ops: torch.Tensor, shard) -> torch.Tensor:
        cheb = per_channel(lambda op, x: chebyshev_features(op, x, self.poly_order, shard),
                           ops, h)
        return cheb.to(h.dtype)
