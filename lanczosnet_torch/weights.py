"""Flax parameter trees → the port's ``state_dict``s.

The map is explicit, not a generic tree walk, so a change of model
structure on either side fails loudly. A flax Dense ``kernel [in, out]``
becomes a ``Linear.weight [out, in]``; the embedding table and the
stacked spectral filter bank keep their layout. Every flax leaf must be
used exactly once, or the map raises; ``load_state_dict(strict=True)``
holds the torch side to the same rule.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


class _Leaves:
    """Reads leaves of a nested flax param dict by path and records
    which were read."""

    def __init__(self, params: Mapping[str, Any]):
        self._tree = params
        self._unused = set(self._paths(params))

    @staticmethod
    def _paths(tree: Mapping[str, Any], prefix: tuple = ()) -> list[tuple]:
        out = []
        for key, val in tree.items():
            if isinstance(val, Mapping):
                out.extend(_Leaves._paths(val, prefix + (key,)))
            else:
                out.append(prefix + (key,))
        return out

    def has(self, *path: str) -> bool:
        node = self._tree
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                return False
            node = node[key]
        return True

    def take(self, *path: str) -> torch.Tensor:
        if path not in self._unused:
            state = "used twice" if self.has(*path) else "missing"
            raise KeyError(f"flax leaf {'/'.join(path)} is {state}")
        self._unused.discard(path)
        node = self._tree
        for key in path:
            node = node[key]
        return torch.from_numpy(np.array(node, dtype=np.float32))

    def check_all_used(self) -> None:
        if self._unused:
            names = sorted("/".join(p) for p in self._unused)
            raise KeyError(f"flax leaves not mapped: {names}")


def flax_transposed(model: torch.nn.Module) -> dict[str, bool]:
    """For each parameter of a port model, by name: True where the map
    transposes its flax leaf (a Dense ``kernel [in, out]`` that became a
    ``Linear.weight [out, in]``, ``_linear``), False where the flax leaf
    keeps its layout (biases, the embedding table, the filter bank,
    MPNN's raw matrices). ``parallel/tensor.py`` states JAX's sharding
    rule on the flax shapes through it."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            out[full] = isinstance(mod, torch.nn.Linear) and name == "weight"
    return out


def _linear(out: dict, leaves: _Leaves, prefix: str, *path: str, bias: bool = True) -> None:
    out[f"{prefix}.weight"] = leaves.take(*path, "kernel").T.contiguous()
    if bias:
        out[f"{prefix}.bias"] = leaves.take(*path, "bias")


def _embedding(out: dict, leaves: _Leaves) -> None:
    out["encoder.atom_embed.weight"] = leaves.take("NodeEncoder_0", "atom_embed", "embedding")


def _head(out: dict, leaves: _Leaves) -> None:
    """``AttentionReadout_0`` (``task: graph``) or ``NodeHead_0``
    (``task: node``) → ``readout.*``."""
    node = leaves.has("NodeHead_0")
    head = "NodeHead_0" if node else "AttentionReadout_0"
    if not node:
        _linear(out, leaves, "readout.att_gate", head, "att_gate")
    hi = 0
    while leaves.has(head, f"out_hidden_{hi}"):
        _linear(out, leaves, f"readout.out_hidden.{hi}", head, f"out_hidden_{hi}")
        hi += 1
    last = "node_proj" if node else "out_proj"
    _linear(out, leaves, f"readout.{last}", head, last)


def _layers(out: dict, leaves: _Leaves) -> None:
    """``layer_0, layer_1, …`` (a Dense, or a ``SumDense`` with the same
    leaves) → ``layers.<i>``."""
    li = 0
    while leaves.has(f"layer_{li}"):
        _linear(out, leaves, f"layers.{li}", f"layer_{li}")
        li += 1


def _spectral_net_state_dict(leaves: _Leaves) -> dict[str, torch.Tensor]:
    """The leaves LanczosNet and AdaLanczosNet share: the embedding, the
    filter bank, the layers and the head."""
    out = {}
    _embedding(out, leaves)
    if leaves.has("spectral_filters"):
        for name in ("w1", "b1", "w2", "b2"):
            out[f"spectral_filters.{name}"] = leaves.take("spectral_filters", name)
    _layers(out, leaves)
    _head(out, leaves)
    return out


def lanczos_net_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of a flax ``LanczosNet`` (numpy leaves), with
    either head, ``sum_dense`` or not → the ``state_dict`` of
    ``lanczosnet_torch.models.LanczosNet``."""
    leaves = _Leaves(params)
    out = _spectral_net_state_dict(leaves)
    leaves.check_all_used()
    return out


def ada_lanczos_net_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of a flax ``AdaLanczosNet`` (numpy leaves) → the
    ``state_dict`` of ``lanczosnet_torch.models.AdaLanczosNet``."""
    leaves = _Leaves(params)
    out = _spectral_net_state_dict(leaves)
    _linear(out, leaves, "kernel_embed", "kernel_embed")
    leaves.check_all_used()
    return out


def gcn_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of a flax ``GCN``, ``GraphSAGE``, ``DCNN`` or
    ``ChebyNet`` (one tree: the embedding, ``layer_<i>`` and the head)
    → the ``state_dict`` of the port's model of that name."""
    leaves = _Leaves(params)
    out = {}
    _embedding(out, leaves)
    _layers(out, leaves)
    _head(out, leaves)
    leaves.check_all_used()
    return out


def gat_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of a flax ``GAT``: ``layer_<i>/{w,a_src,a_dst}_<e>``
    kernels (no biases) → ``layers.<i>.{w,a_src,a_dst}.<e>.weight``."""
    leaves = _Leaves(params)
    out = {}
    _embedding(out, leaves)
    li = 0
    while leaves.has(f"layer_{li}"):
        e = 0
        while leaves.has(f"layer_{li}", f"w_{e}"):
            for name in ("w", "a_src", "a_dst"):
                _linear(out, leaves, f"layers.{li}.{name}.{e}", f"layer_{li}", f"{name}_{e}",
                        bias=False)
            e += 1
        li += 1
    _head(out, leaves)
    leaves.check_all_used()
    return out


def mpnn_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of a flax ``MPNN``: the raw ``w_msg``, ``gru_w_in``,
    ``gru_w_st`` and ``gru_b`` keep their layout; ``in_proj``, where node
    features made one, is a Dense."""
    leaves = _Leaves(params)
    out = {}
    _embedding(out, leaves)
    if leaves.has("in_proj"):
        _linear(out, leaves, "in_proj", "in_proj")
    for name in ("w_msg", "gru_w_in", "gru_w_st", "gru_b"):
        out[name] = leaves.take(name)
    _head(out, leaves)
    leaves.check_all_used()
    return out


def gpnn_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of a flax ``GPNN``: its schedule's Denses
    ``intra_*``, ``cut_*`` and ``carry_*`` → ``dense.<name>``."""
    leaves = _Leaves(params)
    out = {}
    _embedding(out, leaves)
    for name in sorted(params):
        if name.split("_")[0] in ("intra", "cut", "carry"):
            _linear(out, leaves, f"dense.{name}", name)
    _head(out, leaves)
    leaves.check_all_used()
    return out


def sparse_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of any of the nine flax models of
    ``lanczosnet_tpu/models/sparse_nodes.py`` → the ``state_dict`` of the
    port's model of that name (``models/sparse_nodes.py``). Each
    top-level name has one rule; a name that fits none raises."""
    leaves = _Leaves(params)
    out = {}
    for name in sorted(params):
        kind, _, rest = name.partition("_")
        if name in ("head", "kernel_embed", "in_proj"):
            _linear(out, leaves, name, name)
        elif kind == "layer":
            _linear(out, leaves, f"layers.{rest}", name)
        elif kind == "proj":  # GAT's projections have no bias
            _linear(out, leaves, f"proj.{rest}", name, bias=False)
        elif name.startswith(("att_src_", "att_dst_")):
            out[f"{name[:7]}.{name[8:]}"] = leaves.take(name)
        elif name in ("w_msg", "gru_w_in", "gru_w_st", "gru_b"):
            out[name] = leaves.take(name)
        elif kind in ("intra", "cut", "carry"):
            _linear(out, leaves, f"dense.{name}", name)
        elif kind == "filter":
            for dense in sorted(params[name]):
                _linear(out, leaves, f"filters.{name}.dense.{dense.split('_')[1]}", name, dense)
        else:
            raise KeyError(f"flax leaf {name} of a sparse model has no map")
    leaves.check_all_used()
    return out


#: the map of each model of the registry, by its ``model.name``; the
#: sparse models, under the names of their flax classes (``SparseGCN``, …)
STATE_DICT_MAPS = {
    "GCN": gcn_state_dict,
    "GraphSAGE": gcn_state_dict,
    "DCNN": gcn_state_dict,
    "ChebyNet": gcn_state_dict,
    "GAT": gat_state_dict,
    "MPNN": mpnn_state_dict,
    "GPNN": gpnn_state_dict,
    "LanczosNet": lanczos_net_state_dict,
    "AdaLanczosNet": ada_lanczos_net_state_dict,
    **{f"Sparse{name}": sparse_state_dict for name in (
        "GCN", "ChebyNet", "GAT", "DCNN", "GraphSAGE", "MPNN", "GPNN", "LanczosNet",
        "AdaLanczosNet")},
}


def state_dict_from_flax(model_name: str, params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of the flax model ``model_name`` (a ``model.name``
    of the registry) → the port model's ``state_dict``."""
    if model_name not in STATE_DICT_MAPS:
        raise KeyError(f"no flax map for model {model_name!r}; known: {sorted(STATE_DICT_MAPS)}")
    return STATE_DICT_MAPS[model_name](params)
