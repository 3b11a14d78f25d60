"""GraphSAGE: the mean aggregator on dense masked adjacency.

Counterpart of ``lanczosnet_tpu/models/graph_sage.py``. The mean
operator of each edge channel is rebuilt from the operator's support
(``ops > 0``) times the pair mask, divided by ``max(deg, 1)``, in
float32 and whatever the stack's normalization. Per layer
``Linear([h ‖ {mean_e h}_e])`` → ReLU → L2 normalization (the squared
norm clamped, ``ops/masked.py``) → Dropout → mask.
"""

from __future__ import annotations

import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.models.gcn import GCN
from lanczosnet_torch.ops.masked import l2_normalize


def mean_operator(batch: GraphBatch) -> torch.Tensor:
    """``[B, E+1, N, N]`` float32 row means over each channel's support."""
    support = (batch.ops > 0).float() * batch.pair_mask()[:, None]
    return support / support.sum(-1, keepdim=True).clamp_min(1.0)


class GraphSAGE(GCN):
    """GraphSAGE over a ``GraphBatch`` → ``[B, T]`` or ``[B, N, T]``."""

    def operators(self, batch: GraphBatch) -> torch.Tensor:
        return mean_operator(batch)

    def activate(self, h: torch.Tensor) -> torch.Tensor:
        return l2_normalize(torch.relu(h))
