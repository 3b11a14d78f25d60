"""AdaLanczosNet: a learned graph kernel with Lanczos inside the forward.

Counterpart of ``lanczosnet_tpu/models/ada_lanczos_net.py``:

1. node embeddings define a Gaussian similarity
   ``S_ij ∝ exp(−‖e_i − e_j‖² / √kernel_dim)``, restricted to the graph's
   support (``use_graph_support``), masked and symmetrically normalized;
2. the K-step tridiagonalization of that learned operator runs inside
   the forward, through the CUDA kernel its size picks on the card, and
   gradients reach the embedding through the adjoint recursion
   (``ops/lanczos_cuda.py:LanczosTridiag``) and the clamped eigh
   backward (``ops/eigh.py``);
3. downstream is LanczosNet's multi-scale layer loop with the learned S
   driving the short scales too.

``model.dtype: bfloat16`` casts the node states to bfloat16 only after
the learned kernel, the Lanczos call and the Ritz pairs, which stay
float32; the layer loop then runs as LanczosNet's. ``lanczos_impl`` is
``auto`` (the kernel on a CUDA tensor, its plain version on a CPU
tensor), ``kernel`` or ``plain``.

On a node-sharded batch each rank forms its rows of the learned
operator (against every node's gathered embedding), gathers the rows
whole (``all_gather_rows``; 29 MB at Cora) and runs the same Lanczos
call as one device, so every rank holds the same Ritz pairs and keeps
its rows of V. Each rank's loss is its share, so the cotangents of the
gathered operator differ by rank: the gather's backward, a
reduce-scatter, sums them and hands each rank its rows.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from lanczosnet_torch.core.graph_batch import GraphBatch, gather_nodes, row_eye
from lanczosnet_torch.models.lanczos_net import LanczosNet
from lanczosnet_torch.ops.lanczos_cuda import IMPLS, batched_lanczos_ritz_dispatch
from lanczosnet_torch.ops.normalize import sym_normalize


class AdaLanczosNet(LanczosNet):
    """AdaLanczosNet over a ``GraphBatch`` (its Ritz fields are not read)
    → ``[B, T]`` or, with ``task="node"``, ``[B, N, T]``."""

    def __init__(
        self,
        num_atom: int,
        embed_dim: int,
        hidden_dim: Sequence[int],
        num_task: int,
        kernel_dim: int = 16,
        use_graph_support: bool = True,
        lanczos_impl: str = "auto",
        node_feat_dim: int = 0,
        **lanczos_net_args,
    ):
        super().__init__(
            num_atom=num_atom, embed_dim=embed_dim, hidden_dim=hidden_dim,
            num_task=num_task, node_feat_dim=node_feat_dim, **lanczos_net_args,
        )
        if lanczos_impl not in IMPLS:
            raise ValueError(f"lanczos_impl={lanczos_impl!r} must be one of {IMPLS}")
        self.lanczos_impl = lanczos_impl
        self.use_graph_support = bool(use_graph_support)
        self.kernel_embed = nn.Linear(embed_dim + node_feat_dim, kernel_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "AdaLanczosNet":
        """From the YAML ``model:`` section with ``num_atom`` and
        ``num_task`` merged in, as the JAX model reads it."""
        return cls(
            num_atom=cfg["num_atom"],
            embed_dim=cfg.get("embed_dim", cfg["hidden_dim"][0]),
            hidden_dim=tuple(cfg["hidden_dim"]),
            num_task=cfg["num_task"],
            kernel_dim=cfg.get("kernel_dim", 16),
            use_graph_support=cfg.get("use_graph_support", True),
            short_diffusion_dist=tuple(cfg.get("short_diffusion_dist", (1, 2, 3))),
            long_diffusion_dist=tuple(cfg.get("long_diffusion_dist", (5, 7, 10, 20, 30))),
            num_eig_vec=cfg.get("num_eig_vec", 20),
            spectral_filter_kind=cfg.get("spectral_filter_kind", "MLP"),
            filter_hidden_dim=cfg.get("filter_hidden_dim", 16),
            output_hidden_dim=tuple(cfg.get("output_hidden_dim", ())),
            dropout=cfg.get("dropout", 0.0),
            lanczos_impl=cfg.get("lanczos_impl", "auto"),
            num_edge_type=cfg.get("num_edge_type", 4),
            node_feat_dim=cfg.get("node_feat_dim", 0),
            task=cfg.get("task", "graph"),
            dtype=cfg.get("dtype"),
        )

    def learned_operator(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        """Node states ``h [B,N,F]`` → the normalized learned operator
        ``[B,N,N]``: Gaussian similarity of the kernel embeddings on the
        graph's support plus the diagonal. Symmetric up to the rounding
        of the pairwise product."""
        emb = self.kernel_embed(h) * batch.mask[..., None]
        sq = (emb * emb).sum(-1)
        emb_all, sq_all = gather_nodes(emb, batch.shard), gather_nodes(sq, batch.shard)
        d2 = sq[:, :, None] + sq_all[:, None, :] - 2.0 * torch.bmm(emb, emb_all.transpose(1, 2))
        kernel = torch.exp(-d2.clamp_min(0.0) / math.sqrt(float(emb.shape[-1])))
        if self.use_graph_support:
            support = (batch.ops[:, 0] > 0).to(kernel.dtype) + row_eye(batch, kernel.dtype)
            kernel = kernel * support.clamp_max(1.0)
        kernel = kernel * batch.pair_mask()
        return sym_normalize(kernel, batch.mask, shard=batch.shard)

    def ritz_pairs(self, s_op: torch.Tensor, mask: torch.Tensor):
        """Ritz pairs ``(vals [B,K], vecs [B,N,K])`` of the learned operator."""
        return batched_lanczos_ritz_dispatch(
            s_op, mask, self.num_eig_vec, impl=self.lanczos_impl
        )

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h = self.encoder(batch.atom_type, batch.node_feat, batch.mask)
        s_op = self.learned_operator(h, batch)
        ritz_val, ritz_vec = self.ritz_pairs(gather_nodes(s_op, batch.shard), batch.col_mask)
        ritz_vec = ritz_vec.narrow(1, batch.row_offset, batch.n_max)
        return self.propagate(batch, h, s_op, ritz_val, ritz_vec)
