"""Shared model components.

Counterpart of ``lanczosnet_tpu/models/base.py``. A model maps a
``GraphBatch`` to predictions ``[B, T]``; parameter names follow the
flax modules so ``weights.py`` can map one onto the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def mae_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over batch and tasks."""
    return (pred - label).abs().mean()


def flatten_feature_stack(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, N, F]`` per-channel features → ``[B, N, C·F]``, channel-major."""
    b, c, n, f = x.shape
    return x.movedim(1, 2).reshape(b, n, c * f)


def edge_message_concat(ops: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Per-edge-type propagation ``[B,E,N,N]·[B,N,F]`` → ``[B,N,E·F]``."""
    return flatten_feature_stack(torch.einsum("beij,bjf->beif", ops, h))


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from ``generator`` when one is
    set (a runner seeds one per run, on the model's device) and from
    PyTorch's default stream otherwise."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} is not in [0, 1)")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            return F.dropout(x, self.p, training=True)
        keep = 1.0 - self.p
        scale = torch.empty_like(x).bernoulli_(keep, generator=self.generator).div_(keep)
        return x * scale


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Draw every ``Dropout`` mask of ``model`` from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


class OneHotEmbed(nn.Module):
    """Embedding computed as ``one_hot(ids) @ table``, as the flax module
    does: for the tiny vocabularies here (atom types) the backward is a
    matrix product and not a scatter-add, and an id outside
    ``[0, num_embeddings)`` gives zeros. ``weight`` is the flax
    ``embedding`` table."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        classes = torch.arange(self.weight.shape[0], device=ids.device)
        onehot = (ids[..., None] == classes).to(self.weight.dtype)
        return onehot @ self.weight


class NodeEncoder(nn.Module):
    """Atom-type embedding ⊕ continuous node features, padding zeroed."""

    def __init__(self, num_atom: int, embed_dim: int):
        super().__init__()
        self.atom_embed = OneHotEmbed(num_atom, embed_dim)

    def forward(
        self, atom_type: torch.Tensor, node_feat: torch.Tensor, mask: torch.Tensor
    ) -> torch.Tensor:
        h = self.atom_embed(atom_type)
        if node_feat is not None and node_feat.shape[-1] > 0:
            h = torch.cat([h, node_feat], dim=-1)
        return h * mask[..., None]


class AttentionReadout(nn.Module):
    """Gated attention pooling → ``[B, T]``:
    ``Σ_n mask_n · σ(gate(h_n)) · head(h_n)``."""

    def __init__(self, in_dim: int, num_task: int, output_hidden_dim: Sequence[int] = ()):
        super().__init__()
        self.att_gate = nn.Linear(in_dim, 1)
        hidden = []
        for d in output_hidden_dim:
            hidden.append(nn.Linear(in_dim, d))
            in_dim = d
        self.out_hidden = nn.ModuleList(hidden)
        self.out_proj = nn.Linear(in_dim, num_task)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.att_gate(h))
        out = h
        for lin in self.out_hidden:
            out = torch.relu(lin(out))
        out = self.out_proj(out)
        return (gate * out * mask[..., None]).sum(1)


class NodeHead(nn.Module):
    """Per-node classification head → ``[B, N, C]`` logits: the hidden
    stack of ``AttentionReadout`` without the pooling; padded nodes get
    zero logits."""

    def __init__(self, in_dim: int, num_task: int, output_hidden_dim: Sequence[int] = ()):
        super().__init__()
        hidden = []
        for d in output_hidden_dim:
            hidden.append(nn.Linear(in_dim, d))
            in_dim = d
        self.out_hidden = nn.ModuleList(hidden)
        self.node_proj = nn.Linear(in_dim, num_task)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        out = h
        for lin in self.out_hidden:
            out = torch.relu(lin(out))
        return self.node_proj(out) * mask[..., None]
