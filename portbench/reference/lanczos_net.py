"""LanczosNet on a whole graph (Liao et al., ICLR 2019, arXiv:1901.01484),
in the form of the sparse node classifier.

Layer l maps ``h [N, f]`` to ``dropout(relu(W_l [h, S^a h for a in
short, V diag(φ_{l,b}(λ)) Vᵀ h for b in long] + b_l))``, where ``(λ [K],
V [N, K])`` are the Ritz pairs of S and ``φ_{l,b}`` is a ReLU MLP
``2 → filter_hidden_dim → 1`` of ``[λ, λ^b]``; the head is ``W h + b``.
The spectral part (``Vᵀh``, the filters, the reconstruction) is float32
in the configuration's dtype contract, the rest is the activation dtype.
"""

from __future__ import annotations

import torch

from portbench.reference.common import EXACT, Precision, dense, spmv

NEEDS_RITZ = True


def param_shapes(model: dict, in_dim: int, num_class: int) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape (the names of the port's modules,
    so that one set of weights loads into both)."""
    hidden = [int(d) for d in model["hidden_dim"]]
    short, long_ = model["short_diffusion_dist"], model["long_diffusion_dist"]
    fh = int(model["filter_hidden_dim"])
    parts = 1 + len(short) + len(long_)
    shapes, f = {}, in_dim
    for li, d in enumerate(hidden):
        shapes[f"layers.{li}.weight"] = (d, parts * f)
        shapes[f"layers.{li}.bias"] = (d,)
        f = d
    for li in range(len(hidden)):
        for t in long_:
            pre = f"filters.filter_{li}_t{t}.dense"
            shapes.update({f"{pre}.0.weight": (fh, 2), f"{pre}.0.bias": (fh,),
                           f"{pre}.1.weight": (1, fh), f"{pre}.1.bias": (1,)})
    shapes["head.weight"] = (num_class, f)
    shapes["head.bias"] = (num_class,)
    return shapes


def logits(model: dict, params: dict, x: torch.Tensor, op, extras, prec: Precision = EXACT,
           dropout=None) -> torch.Tensor:
    """``[N, C]`` float32 logits of features ``x [N, F]`` under ``op =
    (row, col, val, n)`` and ``extras = (λ, V)``; ``dropout(layer, h)``
    masks a layer's output in training."""
    row, col, val, n = op
    lam, vec = (e.to(torch.float32) for e in extras)
    short = sorted(int(t) for t in model["short_diffusion_dist"])
    long_ = [int(t) for t in model["long_diffusion_dist"]]
    r = prec.f32
    h = prec.act(x)
    for li in range(len(model["hidden_dim"])):
        parts, cur = [h], h
        for a in range(1, max(short, default=0) + 1):
            cur = spmv(row, col, val, n, cur, prec)
            if a in short:
                parts.append(cur)
        if long_:
            vtx = r(vec).T @ r(h)
        for b in long_:
            pre = f"filters.filter_{li}_t{b}.dense"
            feat = torch.stack([lam, lam ** b], dim=-1)
            phi = torch.relu(r(feat) @ r(params[f"{pre}.0.weight"]).T + params[f"{pre}.0.bias"])
            phi = (r(phi) @ r(params[f"{pre}.1.weight"]).T + params[f"{pre}.1.bias"])[:, 0]
            parts.append(prec.act(r(vec) @ r(phi[:, None] * vtx)))
        h = torch.relu(dense(torch.cat(parts, 1), params[f"layers.{li}.weight"],
                             params[f"layers.{li}.bias"], prec))
        if dropout is not None:
            h = dropout(li, h)
    return dense(h, params["head.weight"], params["head.bias"], prec)
