"""Packed fixed-shape datasets.

Counterpart of ``lanczosnet_tpu/data/dataset.py``. Packing is done once
a split: graph dicts → one set of padded numpy arrays at a global
``n_max``, with the normalized operator stack, the precomputed Ritz
pairs of the channel-0 operator (LanczosNet's D and V) and label
standardization. Training then only slices these arrays.

The operators come from the C++ packer (``data/native.py``, the JAX
package's default) or are built on ``device`` by ``ops/normalize.py``,
and the Ritz precompute runs on ``device`` through
``batched_lanczos_ritz_dispatch``: on the card, for graphs of at most
128 padded nodes, that is the CUDA Lanczos kernel
(``csrc/lanczos_tridiag.cu``), one launch per chunk of 256 graphs.
GPNN's partition (``cluster``) is computed on the host from the packed
operators. ``save_packed``/``load_packed`` use the JAX
package's npz keys, so each package reads the other's packed split.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import GraphBatch, batch_graphs
from lanczosnet_torch.data import native
from lanczosnet_torch.data.partition import cluster_of_ops
from lanczosnet_torch.ops.lanczos_cuda import batched_lanczos_ritz_dispatch
from lanczosnet_torch.ops.normalize import build_operator_stack
from lanczosnet_torch.utils.device import resolve_device

# Version of what pack_dataset produces for given inputs. The runner's
# pack cache folds it into its digest: bump it with any change to the
# padding, the operators, the Ritz precompute or the standardization.
PACK_FORMAT_VERSION = 1
RITZ_CHUNK = 256


@dataclass(frozen=True)
class LabelStats:
    """Per-task standardization stats; metrics report in original units."""

    mean: np.ndarray  # [T]
    std: np.ndarray  # [T]

    def standardize(self, y: np.ndarray) -> np.ndarray:
        return (y - self.mean) / self.std

    def unstandardize_mae(self, mae_std: np.ndarray) -> np.ndarray:
        """MAE on standardized labels → MAE in original units."""
        return mae_std * self.std

    @staticmethod
    def fit(labels: np.ndarray, eps: float = 1e-8) -> "LabelStats":
        return LabelStats(mean=labels.mean(0), std=np.maximum(labels.std(0), eps))


@dataclass
class PackedDataset:
    """A padded split in host memory as numpy arrays."""

    atom_type: np.ndarray  # [G, N] int32
    node_feat: np.ndarray  # [G, N, Fc] float32
    ops: np.ndarray  # [G, E+1, N, N] float32
    mask: np.ndarray  # [G, N] float32
    label: np.ndarray  # [G, T] float32 (standardized iff stats is not None)
    stats: Optional[LabelStats] = None
    ritz_val: Optional[np.ndarray] = None  # [G, K]
    ritz_vec: Optional[np.ndarray] = None  # [G, N, K]
    cluster: Optional[np.ndarray] = None  # [G, N] int32

    def __len__(self) -> int:
        return self.mask.shape[0]

    @property
    def n_max(self) -> int:
        return self.mask.shape[1]

    def slice_batch(self, idx) -> GraphBatch:
        """The graphs ``idx`` (an index array or a slice) as a
        ``GraphBatch`` of CPU tensors."""

        def take(a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
            return None if a is None else torch.from_numpy(np.ascontiguousarray(a[idx]))

        return GraphBatch(
            atom_type=take(self.atom_type), node_feat=take(self.node_feat), ops=take(self.ops),
            mask=take(self.mask), label=take(self.label), ritz_val=take(self.ritz_val),
            ritz_vec=take(self.ritz_vec), cluster=take(self.cluster),
        )


def _chunked_ritz(
    ops0: torch.Tensor, mask: torch.Tensor, k: int, chunk: int = RITZ_CHUNK
) -> tuple[np.ndarray, np.ndarray]:
    """Ritz pairs of ``ops0 [G,N,N]`` in chunks of ``chunk`` graphs (the
    tail chunk padded with empty graphs, so one shape serves every chunk
    of a split; a split smaller than a chunk is one chunk of its own
    size). Every chunk is dispatched before any result is fetched."""
    g = ops0.shape[0]
    chunk = min(chunk, g) or 1
    pending = []
    with torch.inference_mode():
        for lo in range(0, g, chunk):
            s, m = ops0[lo : lo + chunk], mask[lo : lo + chunk]
            real = s.shape[0]
            if real < chunk:
                s = torch.cat([s, s.new_zeros((chunk - real,) + s.shape[1:])])
                m = torch.cat([m, m.new_zeros((chunk - real,) + m.shape[1:])])
            d, v = batched_lanczos_ritz_dispatch(s.contiguous(), m.contiguous(), k)
            pending.append((d[:real], v[:real]))
        vals = np.concatenate([d.cpu().numpy() for d, _ in pending])
        vecs = np.concatenate([v.cpu().numpy() for _, v in pending])
    return vals, vecs


def pack_dataset(
    graphs: Sequence[dict],
    n_max: int,
    operator_kind: str = "sym",
    num_eig_vec: int = 0,
    num_cluster: int = 0,
    stats: Optional[LabelStats] = None,
    standardize: bool = False,
    device: str | torch.device | None = None,
    use_native: bool = True,
) -> PackedDataset:
    """Graph dicts → ``PackedDataset``.

    ``num_eig_vec > 0`` precomputes that many Ritz pairs of each graph's
    channel-0 operator on ``device`` (the card unless the caller names
    another). ``num_cluster > 0`` attaches GPNN's spectral partition of
    channel 0 (``data/partition.py``, on the host). ``stats`` reuses the
    training split's standardization; with ``standardize`` and no
    ``stats`` they are fitted here. ``use_native`` (the JAX package's
    default): the padding and the operators come from the C++ packer
    (``data/native.py``) on the host and go to ``device`` for the Ritz
    pairs; where it cannot be built they are built on ``device`` in
    torch, and ``native.fallbacks`` counts the call.
    """
    dev = resolve_device(device)
    graphs = list(graphs)
    packed = None
    if use_native and graphs:
        packed = native.pack_arrays(graphs, n_max, kind=operator_kind)
    if packed is not None:
        mask = packed["mask"]
        mask_t = torch.from_numpy(mask).to(dev)
        ops_t = torch.from_numpy(packed["ops"]).to(dev)
        feat = graphs[0].get("node_feat")
        fc = 0 if feat is None else np.asarray(feat).shape[-1]
        node_feat = np.zeros((len(graphs), n_max, fc), np.float32)
        for i, g in enumerate(graphs if fc else ()):
            nf = np.asarray(g["node_feat"], np.float32)
            node_feat[i, : nf.shape[0]] = nf
        host = {"atom_type": packed["atom_type"], "node_feat": node_feat,
                "label": np.stack([np.asarray(g["label"], np.float32) for g in graphs])}
    else:
        host = batch_graphs(graphs, n_max)
        mask = host["mask"].astype(np.float32)
        mask_t = torch.from_numpy(mask).to(dev)
        with torch.inference_mode():
            ops_t = build_operator_stack(
                torch.from_numpy(host["adj"]).to(dev), mask_t, kind=operator_kind
            )
    label = host["label"]
    if standardize:
        if stats is None:
            stats = LabelStats.fit(label)
        label = stats.standardize(label).astype(np.float32)

    ritz_val = ritz_vec = None
    if num_eig_vec > 0:
        ritz_val, ritz_vec = _chunked_ritz(ops_t[:, 0], mask_t, num_eig_vec)
    ops = ops_t.cpu().numpy()
    return PackedDataset(
        atom_type=host["atom_type"],
        node_feat=host["node_feat"],
        ops=ops,
        mask=mask,
        label=label,
        stats=stats if standardize else None,
        ritz_val=ritz_val,
        ritz_vec=ritz_vec,
        cluster=cluster_of_ops(ops, mask, num_cluster) if num_cluster > 0 else None,
    )


def save_packed(ds: PackedDataset, path: str | Path) -> None:
    """Write a packed split as one compressed npz (the JAX package's keys)."""
    arrays = {
        "atom_type": ds.atom_type,
        "node_feat": ds.node_feat,
        "ops": ds.ops,
        "mask": ds.mask,
        "label": ds.label,
    }
    for name in ("ritz_val", "ritz_vec", "cluster"):
        v = getattr(ds, name)
        if v is not None:
            arrays[name] = v
    if ds.stats is not None:
        arrays["label_mean"] = ds.stats.mean
        arrays["label_std"] = ds.stats.std
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_packed(path: str | Path) -> PackedDataset:
    with np.load(path) as z:
        stats = None
        if "label_mean" in z:
            stats = LabelStats(mean=z["label_mean"], std=z["label_std"])
        return PackedDataset(
            atom_type=z["atom_type"],
            node_feat=z["node_feat"],
            ops=z["ops"],
            mask=z["mask"],
            label=z["label"],
            stats=stats,
            ritz_val=z["ritz_val"] if "ritz_val" in z else None,
            ritz_vec=z["ritz_vec"] if "ritz_vec" in z else None,
            cluster=z["cluster"] if "cluster" in z else None,
        )
