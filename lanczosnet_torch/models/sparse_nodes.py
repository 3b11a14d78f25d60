"""Sparse full-graph node classifiers: one graph, a COO operator.

Counterpart of ``lanczosnet_tpu/models/sparse_nodes.py``. Each model
maps ``(x [N, F], op: SparseOp, *extras)`` to logits ``[N, C]``; every
node is real, so there is no mask. The nine families:

- ``SparseGCN``: ``[h, S h]`` through one dense layer;
- ``SparseChebyNet``: the Chebyshev recurrence ``T_k = 2 S T_{k-1} − T_{k-2}``;
- ``SparseGAT``: multi-head attention, softmax over each node's
  incoming edges and an implicit self-edge (``ops/sparse.py:gat_attention``);
  with ``skip``, PyG's ``GATConv`` stack with skip connections (the
  published ogbn-products GAT);
- ``SparseDCNN``: hop features of the row-stochastic operator;
- ``SparseGraphSAGE``: the exact neighbour mean, self concat, L2 norm;
- ``SparseMPNN``: linear messages through S and a GRU shared over steps;
- ``SparseGPNN``: intra-partition then cut-graph propagation, by the
  partition ids ``part [N]``;
- ``SparseAdaLanczosNet``: a learned Gaussian kernel on the edges,
  normalized, and the K-step Lanczos of it inside the forward (autograd
  runs through the kernel, the normalization, the loop and the eigh);
- ``SparseLanczosNet``: short scales by repeated products, long scales
  by ``V f(D) Vᵀ h`` from precomputed Ritz pairs ``(ritz_val [K],
  ritz_vec [N, K])``.

Each runs unchanged on a rank's piece of a sharded operator (edge,
node or ring form, ``ops/sparse.py``): every reduction that crosses
ranks is inside the sparse ops.

The dtype contract of the JAX models: parameters, the kernel embedding,
the Lanczos recursion and the spectral reconstruction are float32;
``dtype`` (bfloat16) carries only the E·F gathers and scatters and the
dense layers. ``remat_layers`` (``train.remat: layers``, GCN and
LanczosNet) recomputes each layer in the backward
(``torch.utils.checkpoint``), so two layers' parts never coexist.

Parameter names follow the flax trees (``weights.py:sparse_state_dict``):
``layer_<i>`` → ``layers.<i>``, ``filter_<i>_t<t>`` →
``filters.filter_<i>_t<t>``, ``proj_<i>`` → ``proj.<i>``, GPNN's
``intra_*``/``cut_*``/``carry_*`` → ``dense.<name>``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lanczosnet_torch.models.base import (
    MLP,
    Dense,
    Dropout,
    SumDense,
    compute_dtype,
    glorot_uniform_,
    lecun_normal_,
)
from lanczosnet_torch.ops.precision import f32_matmul
from lanczosnet_torch.ops.sparse import (
    SparseOp,
    gat_attention,
    learned_kernel_op,
    live_degree,
    mean_spmv,
    partition_masks,
    sparse_diffusion_features,
    sparse_lanczos_ritz,
    spectral_project,
    spmv,
)
from lanczosnet_torch.utils.profiling import span


def replaying(fn, generator: Optional[torch.Generator]):
    """``fn`` made to draw the same dropout masks each time
    ``torch.utils.checkpoint`` recomputes it: the state ``generator`` has
    now is set again before every call after the first, and the state
    it had put back after. (The checkpoint replays PyTorch's default
    generators by itself, not one that a caller made.)"""
    if generator is None:
        return fn
    state = generator.get_state()
    calls = []

    def run(*args):
        if not calls:
            calls.append(1)
            return fn(*args)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*args)
        finally:
            generator.set_state(now)

    return run


class SparseNodeModel(nn.Module):
    """What the nine share: the activation dtype, dropout, the head (left
    out with ``head=False``, where the last layer gives the logits), the
    per-layer checkpointing and the initialization."""

    supports_remat_layers = False

    def __init__(self, width: int, num_class: int, dropout: float, dtype, head: bool = True):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.drop = Dropout(dropout)
        if head:
            self.head = Dense(width, num_class, act_dtype=self.dtype)
        self.remat_layers = False

    def set_remat_layers(self, on: bool) -> None:
        if on and not self.supports_remat_layers:
            raise ValueError(
                f"train.remat: layers — {type(self).__name__} has no per-layer remat "
                "(use 'full' or 'dots')")
        self.remat_layers = bool(on)

    def run_layer(self, fn, *args):
        """``fn(*args)``, recomputed in the backward under ``remat_layers``
        (the dropout mask too: the recomputation replays the generator)."""
        if self.remat_layers and torch.is_grad_enabled():
            return checkpoint(replaying(fn, self.drop.generator), *args, use_reentrant=False)
        return fn(*args)

    def init_extra(self, generator: torch.Generator) -> None:
        """Draw the parameters that are not a ``Linear``'s."""

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: every ``Linear`` lecun-normal with a zero
        bias, then ``init_extra``."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        self.init_extra(generator)


def _sum_dense_layers(in_dim: int, hidden: Sequence[int], parts: int, dtype) -> nn.ModuleList:
    """``layer_<i>``: a ``SumDense`` over ``parts`` same-width inputs."""
    dims = [in_dim, *hidden]
    return nn.ModuleList(SumDense(parts * a, b, act_dtype=dtype)
                         for a, b in zip(dims[:-1], dims[1:]))


class SparseGCN(SparseNodeModel):
    supports_remat_layers = True

    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 dropout: float = 0.5, dtype=None):
        super().__init__(hidden_dim[-1], num_class, dropout, dtype)
        self.layers = _sum_dense_layers(in_dim, hidden_dim, 2, self.dtype)

    def _layer(self, li: int, h: torch.Tensor, op: SparseOp) -> torch.Tensor:
        return self.drop(torch.relu(self.layers[li]([h, spmv(op, h)])))

    def forward(self, x: torch.Tensor, op: SparseOp) -> torch.Tensor:
        h = x.to(self.dtype)
        for li in range(len(self.layers)):
            h = self.run_layer(self._layer, li, h, op)
        return self.head(h)


class SparseChebyNet(SparseNodeModel):
    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 poly_order: int = 3, dropout: float = 0.5, dtype=None):
        super().__init__(hidden_dim[-1], num_class, dropout, dtype)
        self.poly_order = int(poly_order)
        self.layers = _sum_dense_layers(in_dim, hidden_dim, self.poly_order + 1, self.dtype)

    def forward(self, x: torch.Tensor, op: SparseOp) -> torch.Tensor:
        h = x.to(self.dtype)
        for layer in self.layers:
            feats = [h]
            if self.poly_order >= 1:
                feats.append(spmv(op, h))
            for _ in range(self.poly_order - 1):
                feats.append(2.0 * spmv(op, feats[-1]) - feats[-2])
            h = self.drop(torch.relu(layer(feats)))
        return self.head(h)


class SparseGAT(SparseNodeModel):
    """GAT (Veličković et al., ICLR 2018, arXiv:1710.10903): layer i maps
    ``h`` to ``hp = W_i h`` (``proj.<i>``, no bias) cut into heads, each
    head's softmax over a node's live in-edges and a self-edge of
    ``leaky_relu(a_dst·hp_i + a_src·hp_j)`` (``att_dst.<i>``,
    ``att_src.<i>``), the weighted sum of ``hp`` concatenated over the
    heads (``gat_attention``, traced as the span ``model.attention``),
    then ELU and dropout; the ``head`` gives the logits. The projections
    (and skips) are traced as the span ``model.dense``.

    ``skip`` makes it PyG's ``GATConv`` stack with skip connections, the
    published ogbn-products GAT: each layer a ``GATConv`` (a bias after
    the aggregation, ``bias.<i>``) plus a skip ``Dense(in → out)`` with
    bias (``skip.<i>``), added before the ELU, and in place of the
    ``head`` a last such layer of ``num_head`` heads of ``num_class``,
    averaged, whose output is the logits. Without it the model and its
    parameter names are those of the JAX package's ``SparseGAT``."""

    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 num_head: int = 4, negative_slope: float = 0.2, dropout: float = 0.5,
                 dtype=None, skip: bool = False):
        num_head = int(num_head)
        head_dims = [-(-d // num_head) for d in hidden_dim]
        super().__init__(num_head * head_dims[-1], num_class, dropout, dtype, head=not skip)
        if skip:
            head_dims.append(int(num_class))
        self.negative_slope = negative_slope
        self.proj = nn.ModuleList()
        self.att_src = nn.ParameterList()
        self.att_dst = nn.ParameterList()
        self.bias = nn.ParameterList() if skip else None
        self.skip = nn.ModuleList() if skip else None
        width = in_dim
        for li, hd in enumerate(head_dims):
            out = hd if skip and li == len(head_dims) - 1 else num_head * hd
            self.proj.append(Dense(width, num_head * hd, bias=False, act_dtype=self.dtype))
            self.att_src.append(nn.Parameter(torch.zeros(num_head, hd)))
            self.att_dst.append(nn.Parameter(torch.zeros(num_head, hd)))
            if skip:
                self.bias.append(nn.Parameter(torch.zeros(out)))
                self.skip.append(Dense(width, out, act_dtype=self.dtype))
            width = num_head * hd

    def init_extra(self, generator: torch.Generator) -> None:
        for p in [*self.att_src, *self.att_dst]:
            glorot_uniform_(p, p.shape[0], p.shape[1], generator)

    def forward(self, x: torch.Tensor, op: SparseOp) -> torch.Tensor:
        h = x.to(self.dtype)
        n = h.shape[0]
        last = len(self.proj) - 1
        for li, (proj, a_src, a_dst) in enumerate(zip(self.proj, self.att_src, self.att_dst)):
            with span("model.dense"):
                hp = proj(h).reshape(n, a_src.shape[0], -1)  # [N, H, D]
            s_src = (hp * a_src.to(self.dtype)).sum(-1)  # [N, H]
            s_dst = (hp * a_dst.to(self.dtype)).sum(-1)
            with span("model.attention"):
                msg = gat_attention(op, s_dst, s_src, hp, self.negative_slope)
            if self.skip is None:
                h = self.drop(F.elu(msg.reshape(n, -1)))
                continue
            out = msg.mean(1) if li == last else msg.reshape(n, -1)
            # the bias added before the skip is made, as in ``out + bias +
            # skip``: autograd takes the later node first, so the skip's
            # backward runs before the attention's, not beside its peak
            out = out + self.bias[li].to(self.dtype)
            with span("model.dense"):
                out = out + self.skip[li](h)
            if li == last:
                return out
            h = self.drop(F.elu(out))
        return self.head(h)


class SparseDCNN(SparseNodeModel):
    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 max_hop: int = 3, dropout: float = 0.5, dtype=None):
        super().__init__(hidden_dim[-1], num_class, dropout, dtype)
        self.hops = tuple(range(1, int(max_hop) + 1))
        self.layers = _sum_dense_layers(in_dim, hidden_dim, 1 + len(self.hops), self.dtype)

    def forward(self, x: torch.Tensor, op: SparseOp) -> torch.Tensor:
        h = x.to(self.dtype)
        for layer in self.layers:
            h = self.drop(torch.relu(layer([h, *sparse_diffusion_features(op, h, self.hops)])))
        return self.head(h)


class SparseGraphSAGE(SparseNodeModel):
    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 dropout: float = 0.5, dtype=None):
        super().__init__(hidden_dim[-1], num_class, dropout, dtype)
        self.layers = _sum_dense_layers(in_dim, hidden_dim, 2, self.dtype)

    def forward(self, x: torch.Tensor, op: SparseOp) -> torch.Tensor:
        h = x.to(self.dtype)
        for layer in self.layers:
            h = torch.relu(layer([h, mean_spmv(op, h)]))
            # the norm in float32: 16-bit sums of squares lose what it needs
            norm = torch.sqrt(torch.clamp_min(
                (h.to(torch.float32) ** 2).sum(-1, keepdim=True), 1e-12))
            h = self.drop(h / norm.to(self.dtype))
        return self.head(h)


class SparseMPNN(SparseNodeModel):
    """``hidden_dim[0]`` is the state width; the GRU runs ``num_prop`` steps."""

    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 num_prop: int = 3, dropout: float = 0.5, dtype=None):
        dim = int(hidden_dim[0])
        super().__init__(dim, num_class, dropout, dtype)
        self.num_prop = int(num_prop)
        self.in_proj = Dense(in_dim, dim, act_dtype=self.dtype)
        self.w_msg = nn.Parameter(torch.zeros(dim, dim))
        self.gru_w_in = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.gru_w_st = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.gru_b = nn.Parameter(torch.zeros(3 * dim))

    def init_extra(self, generator: torch.Generator) -> None:
        for p in (self.w_msg, self.gru_w_in, self.gru_w_st):
            glorot_uniform_(p, p.shape[0], p.shape[1], generator)
        self.gru_b.zero_()

    def forward(self, x: torch.Tensor, op: SparseOp) -> torch.Tensor:
        dt = self.dtype
        w_msg, w_in, w_st, b = (p.to(dt) for p in
                                (self.w_msg, self.gru_w_in, self.gru_w_st, self.gru_b))
        h = self.in_proj(x.to(dt))
        for _ in range(self.num_prop):
            m = spmv(op, h @ w_msg)
            zi, ri, ci = (m @ w_in + b).chunk(3, dim=-1)
            zs, rs, cs = (h @ w_st).chunk(3, dim=-1)
            update = torch.sigmoid(zi + zs)
            reset = torch.sigmoid(ri + rs)
            cand = torch.tanh(ci + reset * cs)
            h = (1.0 - update) * h + update * cand
        return self.head(self.drop(h))


class SparseGPNN(SparseNodeModel):
    """Per layer, ``num_prop`` rounds of ``num_intra_prop`` steps over the
    intra-partition edges, then ``num_cut_prop`` steps over the cut edges
    that only boundary nodes take; ``forward(x, op, part)``."""

    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 num_prop: int = 2, num_intra_prop: int = 1, num_cut_prop: int = 1,
                 dropout: float = 0.5, dtype=None):
        super().__init__(hidden_dim[-1], num_class, dropout, dtype)
        self.schedule = []  # per layer: [(kind, name)] in the order they run
        self.dense = nn.ModuleDict()
        width = in_dim
        for li, dim in enumerate(hidden_dim):
            steps = []
            for p in range(num_prop):
                for i in range(num_intra_prop):
                    name = f"intra_{li}_{p}_{i}"
                    self.dense[name] = SumDense(2 * width, dim, act_dtype=self.dtype)
                    steps.append(("intra", name, None))
                    width = dim
                for c in range(num_cut_prop):
                    name = f"cut_{li}_{p}_{c}"
                    self.dense[name] = SumDense(2 * width, dim, act_dtype=self.dtype)
                    carry = None
                    if width != dim:
                        carry = f"carry_{li}_{p}_{c}"
                        self.dense[carry] = Dense(width, dim, act_dtype=self.dtype)
                    steps.append(("cut", name, carry))
                    width = dim
            self.schedule.append(steps)

    def forward(self, x: torch.Tensor, op: SparseOp, part: torch.Tensor) -> torch.Tensor:
        intra_op, cut_op = partition_masks(op, part)
        boundary = (live_degree(cut_op) > 0).to(self.dtype)[:, None]
        h = x.to(self.dtype)
        for steps in self.schedule:
            for kind, name, carry in steps:
                if kind == "intra":
                    h = torch.relu(self.dense[name]([h, spmv(intra_op, h)]))
                    continue
                upd = torch.relu(self.dense[name]([h, spmv(cut_op, h)]))
                if carry is not None:
                    h = self.dense[carry](h)
                h = boundary * upd + (1.0 - boundary) * h
            h = self.drop(h)
        return self.head(h)


class _SpectralLayers(SparseNodeModel):
    """The layer of both LanczosNets: ``[h, S^t h for t in short,
    V f_t(D) Vᵀ h for t in long]`` through ``layer_<i>``, where ``f_t`` is
    the MLP ``filter_<i>_t<t>`` of ``[D, D^t]``; the long scales are
    traced as the span ``model.spectral``."""

    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 short_diffusion_dist: Sequence[int], long_diffusion_dist: Sequence[int],
                 filter_hidden_dim: int, dropout: float, dtype):
        super().__init__(hidden_dim[-1], num_class, dropout, dtype)
        self.short = tuple(int(t) for t in short_diffusion_dist)
        self.long = tuple(int(t) for t in long_diffusion_dist)
        parts = 1 + len(self.short) + len(self.long)
        self.layers = _sum_dense_layers(in_dim, hidden_dim, parts, self.dtype)
        self.filters = nn.ModuleDict(
            {f"filter_{li}_t{t}": MLP(2, (filter_hidden_dim, 1))
             for li in range(len(hidden_dim)) for t in self.long})

    def _layer(self, li: int, h: torch.Tensor, op: SparseOp, ritz_val: torch.Tensor,
               ritz_vec: torch.Tensor) -> torch.Tensor:
        parts = [h]
        if self.short:
            parts.extend(sparse_diffusion_features(op, h, self.short))
        with span("model.spectral"):
            for t in self.long:
                feat = torch.stack([ritz_val, ritz_val ** t], dim=-1)  # [K, 2]
                f = self.filters[f"filter_{li}_t{t}"](feat)[..., 0]  # [K]
                vtx = spectral_project(ritz_vec, h, op)  # [K, F] float32
                with f32_matmul():
                    recon = ritz_vec @ (f[:, None] * vtx)
                parts.append(recon.to(h.dtype))
        return self.drop(torch.relu(self.layers[li](parts)))

    def propagate(self, x, op, ritz_val, ritz_vec) -> torch.Tensor:
        h = x.to(self.dtype)
        for li in range(len(self.layers)):
            h = self.run_layer(self._layer, li, h, op, ritz_val, ritz_vec)
        return self.head(h)


class SparseLanczosNet(_SpectralLayers):
    supports_remat_layers = True

    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 short_diffusion_dist: Sequence[int] = (1, 2),
                 long_diffusion_dist: Sequence[int] = (5, 10),
                 filter_hidden_dim: int = 16, dropout: float = 0.5, dtype=None):
        super().__init__(in_dim, hidden_dim, num_class, short_diffusion_dist,
                         long_diffusion_dist, filter_hidden_dim, dropout, dtype)

    def forward(self, x: torch.Tensor, op: SparseOp, ritz_val: torch.Tensor,
                ritz_vec: torch.Tensor) -> torch.Tensor:
        return self.propagate(x, op, ritz_val, ritz_vec)


class SparseAdaLanczosNet(_SpectralLayers):
    def __init__(self, in_dim: int, hidden_dim: Sequence[int], num_class: int,
                 kernel_dim: int = 16, short_diffusion_dist: Sequence[int] = (1, 2),
                 long_diffusion_dist: Sequence[int] = (5, 10), num_eig_vec: int = 20,
                 filter_hidden_dim: int = 16, dropout: float = 0.5, dtype=None):
        super().__init__(in_dim, hidden_dim, num_class, short_diffusion_dist,
                         long_diffusion_dist, filter_hidden_dim, dropout, dtype)
        self.num_eig_vec = int(num_eig_vec)
        self.kernel_embed = nn.Linear(in_dim, kernel_dim)

    def forward(self, x: torch.Tensor, op: SparseOp) -> torch.Tensor:
        # the embedding, the learned operator and its Ritz pairs are
        # float32 whatever dtype the features are stored in
        emb = self.kernel_embed(x.to(torch.float32))
        lop = learned_kernel_op(op, emb)
        ritz_val, ritz_vec = sparse_lanczos_ritz(lop, self.num_eig_vec)
        return self.propagate(x, lop, ritz_val, ritz_vec)


def build_sparse_model(mcfg: dict, in_dim: int, num_class: int) -> SparseNodeModel:
    """The sparse model of the YAML ``model:`` section, with the JAX
    runner's defaults, for features of width ``in_dim``."""
    name = mcfg["name"]
    common = dict(in_dim=in_dim, hidden_dim=tuple(mcfg.get("hidden_dim", (64,))),
                  num_class=num_class, dropout=float(mcfg.get("dropout", 0.5)),
                  dtype=mcfg.get("dtype"))
    spectral = dict(short_diffusion_dist=tuple(mcfg.get("short_diffusion_dist", (1, 2))),
                    long_diffusion_dist=tuple(mcfg.get("long_diffusion_dist", (5, 10))),
                    filter_hidden_dim=int(mcfg.get("filter_hidden_dim", 16)))
    if name == "LanczosNet":
        return SparseLanczosNet(**common, **spectral)
    if name == "AdaLanczosNet":
        return SparseAdaLanczosNet(**common, **spectral,
                                   kernel_dim=int(mcfg.get("kernel_dim", 16)),
                                   num_eig_vec=int(mcfg.get("num_eig_vec", 20)))
    if name == "GCN":
        return SparseGCN(**common)
    if name == "ChebyNet":
        return SparseChebyNet(**common, poly_order=int(mcfg.get("poly_order", 3)))
    if name == "GAT":
        return SparseGAT(**common, num_head=int(mcfg.get("num_head", 4)),
                         skip=bool(mcfg.get("skip", False)))
    if name == "DCNN":
        return SparseDCNN(**common, max_hop=int(mcfg.get("max_hop", 3)))
    if name == "GraphSAGE":
        return SparseGraphSAGE(**common)
    if name == "MPNN":
        return SparseMPNN(**common, num_prop=int(mcfg.get("num_prop", 3)))
    if name == "GPNN":
        return SparseGPNN(**common, num_prop=int(mcfg.get("num_prop", 2)),
                          num_intra_prop=int(mcfg.get("num_intra_prop", 1)),
                          num_cut_prop=int(mcfg.get("num_cut_prop", 1)))
    raise KeyError(
        "SparseCitationRunner supports all nine model families (GCN | ChebyNet | GAT | "
        f"DCNN | GraphSAGE | MPNN | GPNN | LanczosNet | AdaLanczosNet), got {name!r}")
