"""GCN on a whole graph (Kipf and Welling, ICLR 2017, arXiv:1609.02907), in
the form of the sparse node classifier: layer l maps ``h`` to
``dropout(relu(W_l [h, S h] + b_l))``; the head is ``W h + b``."""

from __future__ import annotations

import torch

from portbench.reference.common import EXACT, Precision, dense, spmv

NEEDS_RITZ = False


def param_shapes(model: dict, in_dim: int, num_class: int) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, with the port's module names."""
    shapes, f = {}, in_dim
    for li, d in enumerate(int(d) for d in model["hidden_dim"]):
        shapes[f"layers.{li}.weight"] = (d, 2 * f)
        shapes[f"layers.{li}.bias"] = (d,)
        f = d
    shapes["head.weight"] = (num_class, f)
    shapes["head.bias"] = (num_class,)
    return shapes


def logits(model: dict, params: dict, x: torch.Tensor, op, extras=(), prec: Precision = EXACT,
           dropout=None) -> torch.Tensor:
    """``[N, C]`` float32 logits; ``op = (row, col, val, n)``."""
    row, col, val, n = op
    h = prec.act(x)
    for li in range(len(model["hidden_dim"])):
        h = torch.relu(dense(torch.cat([h, spmv(row, col, val, n, h, prec)], 1),
                             params[f"layers.{li}.weight"], params[f"layers.{li}.bias"], prec))
        if dropout is not None:
            h = dropout(li, h)
    return dense(h, params["head.weight"], params["head.bias"], prec)
