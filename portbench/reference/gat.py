"""GAT on a whole graph as PyTorch Geometric publishes it for ogbn-products
(``examples/ogbn_products_gat.py``: ``GAT(100, 128, 47, num_layers=3,
heads=4)``; Veličković et al., ICLR 2018, arXiv:1710.10903).

Layer i of ``len(hidden_dim) + 1`` maps ``h`` to ``hp = W_i h``, cut
into H heads of D; per head, ``α_ij = softmax_j(leaky_relu(a_dst·hp_i +
a_src·hp_j, 0.2))`` over i's live in-edges and a self-loop; ``Σ_j α_ij
hp_j``, concatenated over the heads (the hidden layers) or averaged (the
last); plus the bias ``b_i``; plus the skip ``Linear(h)`` with its bias.
Between layers ELU, then dropout; the last layer's output is the logits.

Departures from PyG's ``GATConv``, none of which changes the function:

- the edges are both directions of each undirected pair, without
  self-loops, and every node gets one self-loop (PyG removes the
  self-loops and adds one a node: the same edges);
- the softmax subtracts each node's max over its in-edges and its
  self-loop before the exponent (PyG's scatter softmax does too);
- attention dropout is 0, as the published model has it;
- each head's weighted sum is a sparse product (``torch.sparse.mm`` of
  a CSR matrix, in float32) and not a message scatter; its backward is
  written out (``_Attention``) so that no ``[E, H, D]`` tensor exists,
  and each layer but its dropout is recomputed in the backward
  (``torch.utils.checkpoint``), so the reference fits one card at
  ogbn-products' size; the gradients are those of the function;
- under ``prec`` (the control) the weights, the node states, the edge
  weights and each sum round, not each message of a sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import EDGE_CHUNK, EXACT, Precision, dense

NEEDS_RITZ = False
NEGATIVE_SLOPE = 0.2
GATHER_FLOATS = 32 * EDGE_CHUNK  # floats of a gathered [edges, H, D] chunk: 1 GiB


def layer_shapes(model: dict, num_class: int) -> list[tuple[int, int, bool]]:
    """``(heads, head width, averaged)`` of each layer."""
    heads = int(model["num_head"])
    out = [(heads, -(-int(d) // heads), False) for d in model["hidden_dim"]]
    return out + [(heads, num_class, True)]


def param_shapes(model: dict, in_dim: int, num_class: int) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, with the port's module names."""
    shapes, f = {}, in_dim
    for li, (h, d, averaged) in enumerate(layer_shapes(model, num_class)):
        out = d if averaged else h * d
        shapes[f"proj.{li}.weight"] = (h * d, f)
        shapes[f"att_src.{li}"] = (h, d)
        shapes[f"att_dst.{li}"] = (h, d)
        shapes[f"bias.{li}"] = (out,)
        shapes[f"skip.{li}.weight"] = (out, f)
        shapes[f"skip.{li}.bias"] = (out,)
        f = h * d
    return shapes


class Edges:
    """The live edges twice: by destination, as a CSR's rows (``crow``,
    ``col``), and by source (``ccol``, ``row_t``, ``perm`` the order)."""

    def __init__(self, row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, n: int):
        live = val != 0
        row, col = row[live].long(), col[live].long()
        order = torch.argsort(row * n + col)
        self.row, self.col, self.n = row[order], col[order], n
        marks = torch.arange(n + 1, device=row.device)
        self.crow = torch.searchsorted(self.row, marks)
        self.perm = torch.argsort(self.col * n + self.row)
        self.row_t = self.row[self.perm]
        self.ccol = torch.searchsorted(self.col[self.perm], marks)

    def product(self, w: torch.Tensor, x: torch.Tensor, transposed: bool = False) -> torch.Tensor:
        """``Σ_e w_e x[col_e]`` at each row (``transposed``: ``Σ_e w_e
        x[row_e]`` at each source, ``w`` in source order)."""
        ptr, idx = (self.ccol, self.row_t) if transposed else (self.crow, self.col)
        a = torch.sparse_csr_tensor(ptr, idx, w.contiguous(), (self.n, x.shape[0]),
                                    check_invariants=False)
        return torch.sparse.mm(a, x.contiguous())


def _leaky_grad(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z > 0, torch.ones_like(z), torch.full_like(z, slope))


class _Attention(torch.autograd.Function):
    """``[n, H, D]``: each node's softmax-weighted sum over its in-edges and
    its self-loop, from the scores ``s_dst``, ``s_src [n, H]`` and the
    states ``hp [n, H, D]``; the softmax's max carries no gradient."""

    @staticmethod
    def _weights(s_dst, s_src, edges: Edges, slope, act):
        z = s_dst[edges.row] + s_src[edges.col]
        zs = s_dst + s_src
        logit, self_logit = act(F.leaky_relu(z, slope)), act(F.leaky_relu(zs, slope))
        m = self_logit.scatter_reduce(0, edges.row[:, None].expand_as(logit), logit, "amax")
        p = act(torch.exp(logit - m[edges.row]))
        ps = act(torch.exp(self_logit - m))
        return z, zs, p, ps

    @staticmethod
    def forward(ctx, s_dst, s_src, hp, edges: Edges, slope: float, act):
        _, _, p, ps = _Attention._weights(s_dst, s_src, edges, slope, act)
        den = act(ps.index_add(0, edges.row, p))
        acc = torch.stack([edges.product(p[:, k], hp[:, k]) for k in range(hp.shape[1])], 1)
        out = act(act(act(acc) + ps[..., None] * hp) / den[..., None])
        ctx.save_for_backward(s_dst, s_src, hp, den, out)
        ctx.edges, ctx.slope, ctx.act = edges, slope, act
        return out

    @staticmethod
    def backward(ctx, g):
        s_dst, s_src, hp, den, out = ctx.saved_tensors
        edges, slope = ctx.edges, ctx.slope
        z, zs, p, ps = _Attention._weights(s_dst, s_src, edges, slope, ctx.act)
        d_acc = g / den[..., None]
        d_den = -(g * out).sum(-1) / den
        pt = p[edges.perm]
        d_hp = ps[..., None] * d_acc + torch.stack(
            [edges.product(pt[:, k], d_acc[:, k], transposed=True) for k in range(hp.shape[1])],
            1)
        del pt
        d_p = torch.empty_like(p)
        step = max(1, GATHER_FLOATS // (hp.shape[1] * hp.shape[2]))
        for s in range(0, p.shape[0], step):
            r, c = edges.row[s: s + step], edges.col[s: s + step]
            d_p[s: s + step] = (d_acc[r] * hp[c]).sum(-1)
        d_logit = (d_p + d_den[edges.row]) * p * _leaky_grad(z, slope)
        d_self = ((d_acc * hp).sum(-1) + d_den) * ps * _leaky_grad(zs, slope)
        d_dst = d_self.index_add(0, edges.row, d_logit)
        d_src = d_self.index_add(0, edges.col, d_logit)
        return d_dst, d_src, d_hp, None, None, None


def logits(model: dict, params: dict, x: torch.Tensor, op, extras=(), prec: Precision = EXACT,
           dropout=None) -> torch.Tensor:
    """``[N, C]`` float32 logits; ``op = (row, col, val, n)``; ``dropout(layer,
    h)`` masks a hidden layer's output in training."""
    row, col, val, n = op
    edges = Edges(row, col, val, n)
    layers = len(model["hidden_dim"]) + 1
    act = prec.act

    def layer(li: int, h: torch.Tensor) -> torch.Tensor:
        a_src, a_dst = act(params[f"att_src.{li}"]), act(params[f"att_dst.{li}"])
        hp = act(h @ act(params[f"proj.{li}.weight"]).T).reshape(n, *a_src.shape)
        s_src, s_dst = act((hp * a_src).sum(-1)), act((hp * a_dst).sum(-1))
        agg = _Attention.apply(s_dst, s_src, hp, edges, NEGATIVE_SLOPE, act)
        out = act(agg.mean(1)) if li == layers - 1 else agg.reshape(n, -1)
        out = act(out + act(params[f"bias.{li}"]))
        return act(out + dense(h, params[f"skip.{li}.weight"], params[f"skip.{li}.bias"], prec))

    h = act(x)
    for li in range(layers):
        if torch.is_grad_enabled():
            out = checkpoint(layer, li, h, use_reentrant=False)
        else:
            out = layer(li, h)
        if li == layers - 1:
            return out
        h = act(F.elu(out))
        if dropout is not None:
            h = dropout(li, h)
