"""The graph operator: ``S = D^{-1/2} A D^{-1/2}`` of an undirected edge
list, as COO arrays in (row, col) order."""

from __future__ import annotations

import torch

from portbench.reference.common import EXACT, Precision


def sym_operator(edges: torch.Tensor, n: int, prec: Precision = EXACT
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``edges [E, 2]`` (pairs i != j, each once) → ``(row, col, val)``
    with both directions of every edge, sorted by row then col; ``val``
    float64 from the float64 degrees (a node without an edge has none),
    stored as ``prec`` stores float32 data."""
    e = edges.to(torch.int64)
    row = torch.cat([e[:, 0], e[:, 1]])
    col = torch.cat([e[:, 1], e[:, 0]])
    order = torch.argsort(row * n + col)
    row, col = row[order], col[order]
    deg = torch.bincount(row, minlength=n).to(torch.float64)
    inv_sqrt = torch.where(deg > 0, deg.clamp_min(1.0).rsqrt(), torch.zeros_like(deg))
    val = inv_sqrt[row] * inv_sqrt[col]
    return row, col, prec.store(val.to(torch.float32)).to(torch.float64)
