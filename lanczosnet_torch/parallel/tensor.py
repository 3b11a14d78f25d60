"""Tensor parallelism of the dense models (``train.tp``) over a ``tp`` group.

Counterpart of ``lanczosnet_tpu/parallel/mesh.py:tp_state_sharding`` and
of the collectives GSPMD inserts for its shardings.

The rule is JAX's, stated on the flax shapes: a leaf of two or more
dimensions whose last (output-feature) axis divides by ``tp`` is cut on
that axis, a one-dimensional leaf that divides is cut on its only axis,
and every other leaf is replicated. Adam's moments have their
parameter's shape, so the one rule cuts both: a rank holds 1/tp of each
cut leaf and of its moments. ``weights.py:flax_transposed`` carries the
flax axis over to torch, so the same logical axis is cut: dim 0 of a
``Linear`` weight ``[out, in]`` (a flax kernel ``[in, out]``), the last
dim of every other leaf (the embedding, the filter bank's ``w1``/``b1``,
MPNN's ``w_msg`` and ``gru_*``, the biases).

A rank computes with its blocks in one of two ways:

- column-parallel ``Dense``, ``SumDense`` and ``FusedChannelDense``: the
  layer computes this rank's output columns from its rows of the weight
  and its block of the bias, and ``all_gather_features`` puts the
  columns together. Backward: the gather keeps this rank's block of the
  output's cotangent, and ``psum_cotangent`` on each input sums the
  ranks' parts of the input's cotangent.
- gather-on-use for every other cut leaf: a parametrization
  (``torch.nn.utils.parametrize``, unsafe, since the shape changes)
  gathers the whole tensor where the model reads it. Its backward keeps
  this rank's block: the ranks compute one replicated function, so the
  gathered tensor's gradient is already whole on each (a sum over the
  ranks would count it ``tp`` times).

Between layers the activations are whole on every rank (gathered at
each column-parallel layer), where GSPMD keeps them cut on the feature
axis through the diffusion ops. The nine models need no edit.

A checkpoint holds the one-device state: ``full_state_dict`` and
``full_optimizer_state`` gather it (every rank of the group calls them),
``load_full_state_dict`` and ``shard_optimizer_state`` cut it again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn.utils import parametrize

from lanczosnet_torch.models.base import Dense, SumDense
from lanczosnet_torch.models.lanczos_net import FusedChannelDense
from lanczosnet_torch.parallel.comm import Comm, all_gather_features, psum_cotangent
from lanczosnet_torch.weights import flax_transposed


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """A parameter of the one-device model and what the rule does with it."""

    name: str
    shape: tuple  # the whole leaf's torch shape
    axis: Optional[int]  # the torch axis it is cut on; None: replicated
    itemsize: int


def is_cut(flax_shape: Sequence[int], tp: int) -> bool:
    """JAX's ``tp_state_sharding``: whether a leaf of ``flax_shape`` is
    cut on its last axis over ``tp`` ranks."""
    return len(flax_shape) >= 1 and flax_shape[-1] % tp == 0 and flax_shape[-1] >= tp


def cut_axis(shape: Sequence[int], transposed: bool, tp: int) -> Optional[int]:
    """The torch axis a leaf of torch ``shape`` is cut on (None where it
    is replicated); ``transposed``: the leaf is a flax kernel's transpose."""
    flax_shape = tuple(reversed(shape)) if transposed else tuple(shape)
    if not is_cut(flax_shape, tp):
        return None
    return 0 if transposed else len(shape) - 1


def state_plan(model: nn.Module, tp: int) -> list[LeafPlan]:
    """The rule over the parameters of a one-device model, in the order
    of ``model.named_parameters()`` (the optimizer's order)."""
    transposed = flax_transposed(model)
    return [LeafPlan(name, tuple(p.shape), cut_axis(p.shape, transposed[name], tp),
                     p.element_size()) for name, p in model.named_parameters()]


def predicted_state_bytes(plan: Sequence[LeafPlan], tp: int, moments: int = 2) -> int:
    """A rank's bytes of parameters and of ``moments`` optimizer moments
    (Adam: 2) by the rule: 1/tp of each cut leaf, all of the others."""
    return sum(math.prod(leaf.shape) // (tp if leaf.axis is not None else 1) * leaf.itemsize
               for leaf in plan) * (1 + moments)


def measured_state_bytes(params: Sequence[torch.Tensor], optimizer) -> int:
    """The bytes a rank holds of ``params`` and of the optimizer's
    per-element state of each (Adam's moments; not its step counts)."""
    total = 0
    for p in params:
        total += p.numel() * p.element_size()
        for v in optimizer.state.get(p, {}).values():
            if torch.is_tensor(v) and v.shape == p.shape:
                total += v.numel() * v.element_size()
    return total


def block(whole: torch.Tensor, axis: Optional[int], tp: int, t: int) -> torch.Tensor:
    """Rank ``t``'s block of ``whole`` cut on ``axis`` (all of it where
    None), in memory of its own."""
    if axis is None:
        return whole
    n = whole.shape[axis] // tp
    return whole.narrow(axis, t * n, n).clone(memory_format=torch.contiguous_format)


def shard_state_dict(plan: Sequence[LeafPlan], state: dict, tp: int, t: int) -> dict:
    """Rank ``t``'s blocks of a one-device ``state_dict``."""
    return {leaf.name: block(state[leaf.name], leaf.axis, tp, t) for leaf in plan}


class _ColumnParallel:
    """The column-parallel form of a ``Linear``-like layer: its weight
    holds this rank's output rows, its bias this rank's block."""

    tp_comm: Comm

    def forward(self, *inputs):
        comm = self.tp_comm
        inputs = [type(x)(psum_cotangent(p, comm) for p in x) if isinstance(x, (list, tuple))
                  else psum_cotangent(x, comm) for x in inputs]
        return all_gather_features(super().forward(*inputs), comm)


class ColumnParallelDense(_ColumnParallel, Dense):
    pass


class ColumnParallelSumDense(_ColumnParallel, SumDense):
    pass


class ColumnParallelFusedChannelDense(_ColumnParallel, FusedChannelDense):
    pass


COLUMN_PARALLEL = {Dense: ColumnParallelDense, SumDense: ColumnParallelSumDense,
                   FusedChannelDense: ColumnParallelFusedChannelDense}


class GatherOnUse(nn.Module):
    """The parametrization of a cut leaf: its whole tensor, gathered."""

    def __init__(self, comm: Comm, axis: int):
        super().__init__()
        self.comm, self.axis = comm, axis

    def forward(self, part: torch.Tensor) -> torch.Tensor:
        return all_gather_features(part, self.comm, self.axis)


class TensorParallel:
    """Cuts a one-device ``model`` in place for rank ``comm.rank`` of the
    ``tp`` group ``comm``: every rank passes the same model (the same
    weights). ``parameters()`` are this rank's, in the one-device order;
    give them to the optimizer."""

    def __init__(self, model: nn.Module, comm: Comm):
        self.comm, self.tp, self.t = comm, comm.size, comm.rank
        self.plan = state_plan(model, self.tp)
        axes = {leaf.name: leaf.axis for leaf in self.plan}
        held = {}
        for prefix, mod in list(model.named_modules()):
            own = {f"{prefix}.{n}" if prefix else n: n
                   for n, _ in mod.named_parameters(recurse=False)}
            if not own:
                continue
            weight = f"{prefix}.weight" if prefix else "weight"
            if type(mod) in COLUMN_PARALLEL and axes.get(weight) == 0:
                self._column_parallel(mod)
                held.update({full: getattr(mod, n) for full, n in own.items()})
                continue
            for full, n in own.items():
                held[full] = (self._gather_on_use(mod, n, axes[full]) if axes[full] is not None
                              else getattr(mod, n))
        self.params = [held[leaf.name] for leaf in self.plan]

    def _block(self, whole: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        return block(whole, axis, self.tp, self.t)

    def _column_parallel(self, mod: nn.Linear) -> None:
        mod.__class__ = COLUMN_PARALLEL[type(mod)]
        mod.tp_comm = self.comm
        mod.weight = nn.Parameter(self._block(mod.weight.detach(), 0))
        if mod.bias is not None:
            mod.bias = nn.Parameter(self._block(mod.bias.detach(), 0))
        mod.out_features //= self.tp

    def _gather_on_use(self, mod: nn.Module, name: str, axis: int) -> nn.Parameter:
        setattr(mod, name, nn.Parameter(self._block(getattr(mod, name).detach(), axis)))
        parametrize.register_parametrization(mod, name, GatherOnUse(self.comm, axis), unsafe=True)
        return mod.parametrizations[name].original

    def parameters(self) -> list[nn.Parameter]:
        return list(self.params)

    def cut(self) -> list[bool]:
        """For each of ``parameters()``: whether it is a block of its leaf."""
        return [leaf.axis is not None for leaf in self.plan]

    # ------------------------------------------------------------ one-device state
    def _whole(self, part: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        part = part.detach()
        if axis is None:
            return part
        return self.comm.all_gather(part.movedim(axis, 0)).movedim(0, axis).contiguous()

    @torch.no_grad()
    def full(self, parts: Sequence[torch.Tensor]) -> dict:
        """Per-parameter tensors of this rank (blocks where the parameter
        is cut: gradients, say), whole and by name, as one device holds
        them (every rank of the group calls this)."""
        return {leaf.name: self._whole(x, leaf.axis) for leaf, x in zip(self.plan, parts)}

    def full_state_dict(self) -> dict:
        """The one-device ``state_dict`` (every rank of the group calls this)."""
        return self.full(self.params)

    @torch.no_grad()
    def load_full_state_dict(self, state: dict) -> None:
        """Load this rank's blocks of a one-device ``state_dict``; the keys
        must be the model's, exactly."""
        names = [leaf.name for leaf in self.plan]
        if set(state) != set(names):
            raise KeyError(f"state_dict keys differ from the model's: missing "
                           f"{sorted(set(names) - set(state))}, unexpected "
                           f"{sorted(set(state) - set(names))}")
        for leaf, p in zip(self.plan, self.params):
            whole = state[leaf.name]
            if tuple(whole.shape) != leaf.shape:
                raise ValueError(f"{leaf.name}: shape {tuple(whole.shape)}, the model's "
                                 f"{leaf.shape}")
            p.copy_(self._block(whole.to(p.device), leaf.axis))

    def _per_element(self, v, i: int, shape: tuple) -> bool:
        return torch.is_tensor(v) and v.dim() > 0 and tuple(v.shape) == shape \
            and self.plan[i].axis is not None

    def full_optimizer_state(self, state: dict) -> dict:
        """An optimizer's ``state_dict()`` over ``parameters()`` → the
        one-device one: each per-element state gathered (every rank of
        the group calls this)."""
        out = {}
        for i, s in state["state"].items():
            shape = tuple(self.params[i].shape)
            out[i] = {k: self._whole(v, self.plan[i].axis) if self._per_element(v, i, shape)
                      else v for k, v in s.items()}
        return {"state": out, "param_groups": state["param_groups"]}

    def shard_optimizer_state(self, state: dict) -> dict:
        """A one-device optimizer ``state_dict`` → this rank's, for
        ``optimizer.load_state_dict``."""
        out = {}
        for i, s in state["state"].items():
            i = int(i)
            shape = self.plan[i].shape
            out[i] = {k: self._block(v, self.plan[i].axis) if self._per_element(v, i, shape)
                      else v for k, v in s.items()}
        return {"state": out, "param_groups": state["param_groups"]}
