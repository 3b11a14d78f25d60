"""Graph-operator construction: normalized adjacency stacks.

Counterpart of ``lanczosnet_tpu/ops/normalize.py``. Every function is
mask-aware and zero-degree-safe: padded rows and columns come out
exactly zero, so no later product leaks padding.

Both normalizations also take a row block of a node-sharded graph
(``shard``, ``core/graph_batch.py:NodeShard``; ``B = 1``): ``adj`` is
this rank's rows ``[1, n_loc, N]``, ``mask`` their mask. The row degrees
are local; the columns take the whole mask and, for the symmetric form,
every node's degree, gathered. (The operator is symmetric, so the
column scaling uses the row degrees, as on one device.)
"""

from __future__ import annotations

from typing import Optional

import torch

from lanczosnet_torch.core.graph_batch import NodeShard, gather_nodes


def _masked_adj(adj: torch.Tensor, mask: torch.Tensor,
                col_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero padded rows/cols. adj ``[..., N, N]``, mask ``[..., N]`` (the
    columns' ``col_mask`` where they are other nodes than the rows)."""
    col_mask = mask if col_mask is None else col_mask
    return adj * mask[..., :, None] * col_mask[..., None, :]


def sym_normalize(
    adj: torch.Tensor, mask: torch.Tensor, eps: float = 1e-12,
    shard: Optional[NodeShard] = None,
) -> torch.Tensor:
    """``D^{-1/2} A D^{-1/2}``; rows of zero degree stay zero."""
    a = _masked_adj(adj, mask, None if shard is None else shard.mask)
    deg = a.sum(-1)
    inv_sqrt = torch.where(deg > eps, 1.0 / torch.sqrt(deg.clamp_min(eps)), 0.0)
    return a * inv_sqrt[..., :, None] * gather_nodes(inv_sqrt, shard)[..., None, :]


def row_normalize(
    adj: torch.Tensor, mask: torch.Tensor, eps: float = 1e-12,
    shard: Optional[NodeShard] = None,
) -> torch.Tensor:
    """Row-stochastic ``D^{-1} A``; rows of zero degree stay zero."""
    a = _masked_adj(adj, mask, None if shard is None else shard.mask)
    deg = a.sum(-1)
    inv = torch.where(deg > eps, 1.0 / deg.clamp_min(eps), 0.0)
    return a * inv[..., :, None]


def build_operator_stack(
    adj: torch.Tensor,
    mask: torch.Tensor,
    kind: str = "sym",
    add_self_loop: bool = False,
) -> torch.Tensor:
    """Raw per-edge-type adjacency ``[B, E, N, N]`` → ``[B, E+1, N, N]``.

    Channel 0 normalizes the merged graph (the sum over edge types),
    channels ``1..E`` each edge type. ``kind`` is ``sym`` or ``row``;
    ``add_self_loop`` adds the masked identity before normalizing.
    """
    n = adj.shape[-1]
    full = adj.sum(1)
    stacked = torch.cat([full[:, None], adj], dim=1)
    if add_self_loop:
        eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
        stacked = stacked + eye * mask[:, None, :, None] * mask[:, None, None, :]
    norm = sym_normalize if kind == "sym" else row_normalize
    return norm(stacked, mask[:, None, :])
