"""LanczosNet: multi-scale spectral graph convolution (arXiv:1901.01484).

Counterpart of ``lanczosnet_tpu/models/lanczos_net.py``. Per layer the
propagation channels are, in this (c-major) order:

- short scales ``S^t`` for ``t`` in ``short_diffusion_dist``, the exact
  powers of the channel-0 operator, formed once per forward;
- long scales ``V diag(f_t(D)) Vᵀ`` for ``t`` in ``long_diffusion_dist``
  from the K Ritz pairs (D, V), with ``f_t`` a learned per-(layer,
  scale) MLP over ``[D, D^t]`` (``spectral_filter_kind: MLP``) or the
  plain power ``D^t``;
- one-hop per-edge-type operators, channels ``1..E`` of the stack.

The layer is ``Linear([h ‖ channels @ h])`` → ReLU → Dropout → mask.
Up to 128 padded nodes the channels are formed as explicit ``[N, N]``
matrices and applied in one stacked product (the fused path); above,
each is applied in factored form (``ops/poly.py``, ``ops/spectral.py``)
and no ``[N, N]`` matrix beyond S itself is formed. A node-sharded batch
always takes the factored path, on its rows: the hops gather the node
states, ``Vᵀh`` sums over the ranks, and the Ritz vectors are cut by
rows like every node array. The gated attention
readout (``task: graph``) or the per-node head (``task: node``) follows
the last layer.

``model.dtype: bfloat16``: the parameters, the filter bank and the
operator powers stay float32; each channel is cast to bfloat16 after its
float32 formation, the channel product accumulates in float32 and is
stored as bfloat16, the layer ``Linear`` runs in bfloat16, and the node
states go back to float32 before the head. ``model.sum_dense: true``
applies the fused path's layer as ``SumDense([h, channels @ h])`` with
the same parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lanczosnet_torch.core.graph_batch import GraphBatch, gather_nodes
from lanczosnet_torch.models.base import (
    Dense,
    Dropout,
    GraphModel,
    NodeEncoder,
    SumDense,
    check_num_ops,
    common_config,
    edge_message_concat,
    flatten_feature_stack,
    lecun_normal_,
    make_head,
)
from lanczosnet_torch.ops.poly import diffusion_features_at
from lanczosnet_torch.ops.spectral import long_scale_features

# Above this many padded nodes forming the long-scale matrices costs
# more than applying them in factored form (S·N²·K against K·N·F·(1+S)
# multiply-adds), so larger graphs take the factored path.
FUSED_N_MAX = 128


def integer_pow(x: torch.Tensor, t: int) -> torch.Tensor:
    """``x ** t`` for an integer ``t ≥ 1`` by repeated squaring, in the
    order of ``jax.lax.integer_pow``: exact in sign for negative ``x``
    and the same rounding as the JAX model."""
    acc = None
    while t > 0:
        if t & 1:
            acc = x if acc is None else acc * x
        t >>= 1
        if t > 0:
            x = x * x
    return acc


class SpectralFilterBank(nn.Module):
    """All layers' per-scale filters at once: ``[B,K]`` → ``[B,L,S,K]``.

    Parameters are stacked as in the flax bank: ``w1 [L,S,2,H]``,
    ``b1 [L,S,H]``, ``w2 [L,S,H,1]``, ``b2 [L,S,1]``.
    """

    def __init__(self, num_layers: int, long_dists: Sequence[int],
                 kind: str = "MLP", filter_hidden_dim: int = 16):
        super().__init__()
        self.num_layers = num_layers
        self.long_dists = tuple(int(t) for t in long_dists)
        self.mlp = kind.upper() == "MLP"
        if self.mlp:
            l, s, h = num_layers, len(self.long_dists), filter_hidden_dim
            self.w1 = nn.Parameter(torch.zeros(l, s, 2, h))
            self.b1 = nn.Parameter(torch.zeros(l, s, h))
            self.w2 = nn.Parameter(torch.zeros(l, s, h, 1))
            self.b2 = nn.Parameter(torch.zeros(l, s, 1))

    def forward(self, ritz_val: torch.Tensor) -> torch.Tensor:
        power = torch.stack([integer_pow(ritz_val, t) for t in self.long_dists], dim=1)
        b = ritz_val.shape[0]
        if not self.mlp:
            return power[:, None].expand(b, self.num_layers, *power.shape[1:])
        feat = torch.stack([ritz_val[:, None, :].expand_as(power), power], dim=-1)
        z = torch.relu(
            torch.einsum("bskc,lsch->blskh", feat, self.w1) + self.b1[None, :, :, None, :]
        )
        out = torch.einsum("blskh,lsho->blsko", z, self.w2) + self.b2[None, :, :, None, :]
        return out[..., 0]


def operator_powers(s_op: torch.Tensor, dists: Sequence[int]) -> torch.Tensor:
    """``[S^t for t in dists]`` → ``[B,T,N,N]``, each power formed once."""
    pows = {1: s_op}
    cur = s_op
    for t in range(2, max(dists) + 1):
        cur = torch.bmm(s_op, cur)
        pows[t] = cur
    return torch.stack([pows[t] for t in dists], dim=1)


def channel_stack(
    short_ops: torch.Tensor | None,
    ritz_vec: torch.Tensor | None,
    filt: torch.Tensor | None,
    edge_ops: torch.Tensor | None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One layer's propagation operators ``[B, C, N, N]``:
    ``[S^t… ‖ V f_s(D) Vᵀ… ‖ A_e…]`` in that order, each channel formed
    in float32 and then cast to ``dtype``."""
    chans = []
    if short_ops is not None:
        chans.append(short_ops.to(dtype))
    if filt is not None:
        scaled_v = filt[:, :, None, :] * ritz_vec[:, None, :, :]  # [B,S,N,K]
        chans.append(torch.matmul(scaled_v, ritz_vec.transpose(1, 2)[:, None]).to(dtype))
    if edge_ops is not None:
        chans.append(edge_ops.to(dtype))
    return torch.cat(chans, dim=1) if len(chans) > 1 else chans[0]


def spectral_layer_channels(
    h: torch.Tensor,
    short_ops: torch.Tensor | None,
    ritz_vec: torch.Tensor | None,
    filt: torch.Tensor | None,
    edge_ops: torch.Tensor | None,
) -> torch.Tensor:
    """All of a layer's propagation channels applied to ``h [B,N,F]`` in
    one batched product → ``[B, N, C·F]`` at ``h``'s dtype. A bfloat16
    product accumulates in float32 and rounds once, at its output."""
    stack = channel_stack(short_ops, ritz_vec, filt, edge_ops, h.dtype)
    return flatten_feature_stack(torch.matmul(stack, h[:, None]))


class FusedChannelDense(nn.Linear):
    """``Linear([h ‖ flatten(stack @ h)])`` with the weight folded into
    the channel contraction: ``G[b,c,j,d] = Σ_f h[b,j,f] W_c[d,f]``, then
    ``Σ_{c,j} stack[b,c,i,j] G[b,c,j,d]``, plus ``h W_h`` and the bias.
    The same operations as the product and then the ``Linear``, in
    another order, and no ``[B, N, C·F]`` concat. The JAX package keeps
    it as a measured negative result (slower in its full train step) and
    no model uses it; its parameters are those of the ``Linear`` on the
    concat, float32."""

    def __init__(self, in_dim: int, channels: int, out_features: int):
        super().__init__(in_dim * (1 + channels), out_features)
        self.channels = channels

    def forward(self, h: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
        f = h.shape[-1]
        w_h = self.weight[:, :f]  # [D, F]
        w_p = self.weight[:, f:].reshape(self.out_features, self.channels, f)  # [D, C, F]
        g = torch.einsum("bjf,dcf->bcjd", h, w_p)
        b, c, n, _ = stack.shape
        # contract over (c, j) at once: [B, N, C·N] @ [B, C·N, D]
        out = torch.bmm(stack.transpose(1, 2).reshape(b, n, c * n), g.reshape(b, c * n, -1))
        return out + h @ w_h.T + self.bias


class LanczosNet(GraphModel):
    """LanczosNet over a ``GraphBatch`` carrying Ritz pairs → ``[B, T]``
    (``task="graph"``) or per-node logits ``[B, N, T]`` (``task="node"``).

    ``num_edge_type`` and ``node_feat_dim`` fix the layer widths that
    flax infers from the first batch.
    """

    def __init__(
        self,
        num_atom: int,
        embed_dim: int,
        hidden_dim: Sequence[int],
        num_task: int,
        short_diffusion_dist: Sequence[int] = (1, 2, 3),
        long_diffusion_dist: Sequence[int] = (5, 7, 10, 20, 30),
        num_eig_vec: int = 20,
        spectral_filter_kind: str = "MLP",
        filter_hidden_dim: int = 16,
        output_hidden_dim: Sequence[int] = (),
        dropout: float = 0.0,
        num_edge_type: int = 4,
        node_feat_dim: int = 0,
        task: str = "graph",
        sum_dense: bool = False,
        dtype: str | None = None,
    ):
        super().__init__(task, dtype)
        self.short_dists = tuple(int(t) for t in short_diffusion_dist)
        self.long_dists = tuple(int(t) for t in long_diffusion_dist)
        self.num_eig_vec = int(num_eig_vec)
        self.num_edge_type = int(num_edge_type)
        self.sum_dense = bool(sum_dense)
        self.encoder = NodeEncoder(num_atom, embed_dim)
        self.spectral_filters = (
            SpectralFilterBank(len(hidden_dim), self.long_dists,
                               spectral_filter_kind, filter_hidden_dim)
            if self.long_dists else None
        )
        channels = len(self.short_dists) + len(self.long_dists) + self.num_edge_type
        d_in = embed_dim + node_feat_dim
        layer = SumDense if self.sum_dense else Dense
        layers = []
        for dim in hidden_dim:
            layers.append(layer(d_in * (1 + channels), dim, act_dtype=self.dtype))
            d_in = dim
        self.layers = nn.ModuleList(layers)
        self.dropout = Dropout(dropout)
        self.readout = make_head(task, d_in, num_task, output_hidden_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "LanczosNet":
        """From the YAML ``model:`` section with ``num_atom`` and
        ``num_task`` merged in, as the JAX model reads it."""
        return cls(
            embed_dim=cfg.get("embed_dim", cfg["hidden_dim"][0]),
            short_diffusion_dist=tuple(cfg.get("short_diffusion_dist", (1, 2, 3))),
            long_diffusion_dist=tuple(cfg.get("long_diffusion_dist", (5, 7, 10, 20, 30))),
            num_eig_vec=cfg.get("num_eig_vec", 20),
            spectral_filter_kind=cfg.get("spectral_filter_kind", "MLP"),
            filter_hidden_dim=cfg.get("filter_hidden_dim", 16),
            sum_dense=bool(cfg.get("sum_dense", False)),
            **common_config(cfg),
        )

    def init_extra(self, generator: torch.Generator) -> None:
        bank = self.spectral_filters
        if bank is not None and bank.mlp:
            lecun_normal_(bank.w1, bank.w1.shape[-2], generator)
            lecun_normal_(bank.w2, bank.w2.shape[-2], generator)
            bank.b1.zero_()
            bank.b2.zero_()

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        if batch.ritz_val is None or batch.ritz_vec is None:
            raise ValueError("LanczosNet needs the batch's Ritz pairs (ritz_val/ritz_vec)")
        h = self.encoder(batch.atom_type, batch.node_feat, batch.mask)
        return self.propagate(batch, h, batch.ops[:, 0], batch.ritz_val, batch.ritz_vec)

    def propagate(
        self, batch: GraphBatch, h: torch.Tensor, s_op: torch.Tensor,
        ritz_val: torch.Tensor, ritz_vec: torch.Tensor,
    ) -> torch.Tensor:
        """The layer loop and the head on node states ``h [B,N,F]``, with
        ``s_op [B,N,N]`` driving the short scales and the Ritz pairs the
        long ones. ``h`` and everything before the loop are float32; the
        loop runs at the activation dtype."""
        check_num_ops(batch, self.num_edge_type)
        cdt = self.dtype
        h = h.to(cdt)
        mask = batch.mask.to(cdt)
        shard = batch.shard
        fused = shard is None and batch.n_max <= FUSED_N_MAX
        filt_bank = self.spectral_filters(ritz_val) if self.spectral_filters is not None else None
        short_ops = operator_powers(s_op, self.short_dists) if fused and self.short_dists else None
        edge_ops = batch.ops[:, 1:] if batch.num_ops > 1 else None
        for li, layer in enumerate(self.layers):
            filt = filt_bank[:, li] if filt_bank is not None else None
            if fused and (short_ops is not None or filt is not None or edge_ops is not None):
                prop = spectral_layer_channels(h, short_ops, ritz_vec, filt, edge_ops)
                h = layer([h, prop]) if self.sum_dense else layer(torch.cat([h, prop], dim=-1))
            else:
                # the factored helpers take and give float32
                x = h.float()
                parts = [h]
                if self.short_dists:
                    short = diffusion_features_at(s_op, x, self.short_dists, shard)
                    parts.append(flatten_feature_stack(short).to(cdt))
                if filt is not None:
                    long_ = long_scale_features(ritz_vec, filt, x, shard)
                    parts.append(flatten_feature_stack(long_).to(cdt))
                if edge_ops is not None:
                    parts.append(edge_message_concat(edge_ops, gather_nodes(x, shard)).to(cdt))
                h = layer(torch.cat(parts, dim=-1) if len(parts) > 1 else h)
            h = torch.relu(h)
            h = self.dropout(h)
            h = h * mask[..., None]
        return self.readout(h.float(), batch.mask)
