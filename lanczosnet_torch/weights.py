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


def _linear(out: dict, leaves: _Leaves, prefix: str, *path: str) -> None:
    out[f"{prefix}.weight"] = leaves.take(*path, "kernel").T.contiguous()
    out[f"{prefix}.bias"] = leaves.take(*path, "bias")


def _spectral_net_state_dict(leaves: _Leaves) -> dict[str, torch.Tensor]:
    """The leaves LanczosNet and AdaLanczosNet share: the embedding, the
    filter bank, the layers and the head (``AttentionReadout_0`` for
    ``task: graph``, ``NodeHead_0`` for ``task: node``)."""
    out = {"encoder.atom_embed.weight": leaves.take("NodeEncoder_0", "atom_embed", "embedding")}
    if leaves.has("spectral_filters"):
        for name in ("w1", "b1", "w2", "b2"):
            out[f"spectral_filters.{name}"] = leaves.take("spectral_filters", name)
    li = 0
    while leaves.has(f"layer_{li}"):
        _linear(out, leaves, f"layers.{li}", f"layer_{li}")
        li += 1
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
    return out


def lanczos_net_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` of a flax ``LanczosNet`` (numpy leaves), with
    either head → the ``state_dict`` of
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
