"""Shared model components.

Counterpart of ``lanczosnet_tpu/models/base.py``. A model maps a
``GraphBatch`` to predictions ``[B, T]``; parameter names follow the
flax modules so ``weights.py`` can map one onto the other.

``model.dtype`` (``compute_dtype``) is the activation dtype of the
layer loop. Parameters stay float32 and are cast per call (``Dense``);
products that the JAX package pins to float32 accumulation
(``preferred_element_type``) accumulate in float32 here too, either in a
bfloat16 GEMM whose one rounding is at its output or on operands
upcast to float32 (their products are exact); node states go back to
float32 before the head.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lanczosnet_torch.utils.profiling import span


def mae_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over batch and tasks."""
    return (pred - label).abs().mean()


def compute_dtype(name) -> torch.dtype:
    """The ``model.dtype`` config knob → a torch dtype: float32 (the
    default, also for ``None`` and ``""``) or bfloat16."""
    if name is None or str(name) in ("", "float32", "f32"):
        return torch.float32
    if str(name) in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"model.dtype must be float32 or bfloat16, got {name!r}")


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
    PyTorch's default stream otherwise.

    Across ranks every rank's generator has the run's seed, and ``rows =
    (d, dp)`` says that ``x`` holds block ``d`` of ``dp`` equal blocks of
    the whole tensor on ``axis``: the rank draws the whole tensor's mask,
    as one device would, and keeps its block. In a data- or
    tensor-parallel QM8 run the axis is the batch (0): the ``tp`` ranks
    of one block draw the same masks (they compute one replicated
    function), and a dp × tp run draws the masks of one device. In a
    node-sharded citation run it is the node axis (1): each rank keeps
    its rows of the whole graph's mask, so D ranks draw one device's
    masks too."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} is not in [0, 1)")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None
        self.rows = (0, 1)
        self.axis = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            return F.dropout(x, self.p, training=True)
        keep = 1.0 - self.p
        d, dp = self.rows
        n = x.shape[self.axis]
        shape = list(x.shape)
        shape[self.axis] = dp * n
        whole = x.new_empty(shape).bernoulli_(keep, generator=self.generator)
        return x * whole.narrow(self.axis, d * n, n).div_(keep)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator],
                          rows: tuple[int, int] = (0, 1), axis: int = 0) -> None:
    """Draw every ``Dropout`` mask of ``model`` from ``generator``, block
    ``rows = (d, dp)`` on ``axis`` of the whole tensor's (see ``Dropout``)."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
            mod.rows = rows
            mod.axis = axis


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


class MLP(nn.Module):
    """ReLU MLP ``in_dim → features[0] → … → features[-1]``, float32
    (the flax ``MLP`` of the sparse models' spectral filters; its
    ``dense_<i>`` are ``dense.<i>`` here)."""

    def __init__(self, in_dim: int, features: Sequence[int]):
        super().__init__()
        dims = [in_dim, *features]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.dense[:-1]:
            x = torch.relu(lin(x))
        return self.dense[-1](x)


class Dense(nn.Linear):
    """``nn.Linear`` run at the activation dtype ``act_dtype``: the
    float32 weight and bias are cast to it per call, as flax's
    ``nn.Dense(dtype=...)`` casts its params; at float32 it is
    ``nn.Linear`` itself."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 act_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.act_dtype = act_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_dtype == torch.float32:
            return super().forward(x)
        dt = self.act_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class SumDense(Dense):
    """``Dense(concat(parts))`` without the concat: each part contracts
    against its column slice of the one weight ``[out, ΣF_i]``, the
    partial products and the bias add in float32, and the sum is cast to
    ``act_dtype`` once. At bfloat16 the parts and the weight (rounded to
    bfloat16 first, as flax's ``promote_dtype`` does) are upcast, so
    every product is exact and only the sum rounds. The parameters are
    those of the ``Dense`` on the concat; on a single tensor it is that
    ``Dense``. The list path is traced as the span ``model.dense``."""

    def forward(self, parts) -> torch.Tensor:
        if isinstance(parts, torch.Tensor):
            return super().forward(parts)
        with span("model.dense"):
            w = self.weight.to(self.act_dtype).float()
            acc, off = None, 0
            for p in parts:
                f = p.shape[-1]
                partial = F.linear(p.float(), w[:, off: off + f])
                acc = partial if acc is None else acc + partial
                off += f
            if off != self.in_features:
                raise ValueError(f"parts have {off} features in all, the weight {self.in_features}")
            if self.bias is not None:
                acc = acc + self.bias.to(self.act_dtype).float()
            return acc.to(self.act_dtype)


def lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Normal with variance 1/fan_in (flax's lecun_normal, untruncated)."""
    p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))


def glorot_uniform_(p: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> None:
    """Uniform on ±sqrt(6 / (fan_in + fan_out)) (flax's glorot_uniform)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * limit)


def make_head(task: str, in_dim: int, num_task: int,
              output_hidden_dim: Sequence[int] = ()) -> nn.Module:
    """``AttentionReadout`` for ``task: graph``, ``NodeHead`` for ``node``."""
    head = NodeHead if task == "node" else AttentionReadout
    return head(in_dim, num_task, output_hidden_dim)


def check_num_ops(batch, num_edge_type: int) -> None:
    """The layer widths follow the number of operator channels, which
    flax infers from the first batch and the port takes at construction."""
    if batch.num_ops - 1 != num_edge_type:
        raise ValueError(
            f"batch has {batch.num_ops - 1} edge-type operators, model "
            f"was built for num_edge_type={num_edge_type}"
        )


def common_config(cfg: dict) -> dict:
    """The ``model:`` keys every model reads, with the JAX defaults;
    ``num_edge_type`` and ``node_feat_dim`` are the widths a runner
    reads from its packed split."""
    return dict(
        num_atom=cfg["num_atom"],
        hidden_dim=tuple(cfg["hidden_dim"]),
        num_task=cfg["num_task"],
        output_hidden_dim=tuple(cfg.get("output_hidden_dim", ())),
        dropout=cfg.get("dropout", 0.0),
        num_edge_type=cfg.get("num_edge_type", 4),
        node_feat_dim=cfg.get("node_feat_dim", 0),
        task=cfg.get("task", "graph"),
        dtype=cfg.get("dtype"),
    )


class GraphModel(nn.Module):
    """What the models share: the activation dtype, the atom encoder, the
    head and the initialization. Subclasses build ``encoder`` and
    ``readout`` and may add parameters that are not a ``Linear`` in
    ``init_extra``."""

    def __init__(self, task: str, dtype):
        super().__init__()
        if task not in ("graph", "node"):
            raise ValueError(f"task={task!r} must be 'graph' or 'node'")
        self.dtype = compute_dtype(dtype)

    def init_extra(self, generator: torch.Generator) -> None:
        """Draw the parameters that are not a ``Linear``'s."""

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator``: the embedding, then
        ``init_extra``, then every ``Linear`` lecun-normal with its bias
        zero."""
        # flax's variance_scaling(fan_in, out_axis=0) on the [num_atom,
        # features] table takes the feature width as fan_in
        emb = self.encoder.atom_embed.weight
        lecun_normal_(emb, emb.shape[1], generator)
        self.init_extra(generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
