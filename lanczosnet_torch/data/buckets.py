"""Size-bucketed packing: each graph padded to the smallest bound that
holds it, not to one global ``n_max``.

Counterpart of ``lanczosnet_tpu/data/buckets.py``. QM8-shaped graphs (6
to 28 nodes, about 17 on average) padded to 32 spend about 45% of the
``[N, N]`` operator work on padding. With ``dataset.buckets: [16, 24,
32]`` each split becomes one ``PackedDataset`` a bound, and the resident
trainer runs the buckets' batches as pieces of one epoch
(``train/runner.py``). Label standardization is fitted on the union of
the labels, so every bucket shares one scale.

A bound under ``model.num_eig_vec`` is packed with more Lanczos steps
than nodes (K > N), as the JAX package packs it: the steps after the
Krylov space runs out break down and give zero Ritz pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from lanczosnet_torch.data.dataset import LabelStats, PackedDataset, pack_dataset


def bucket_of(n: int, bounds: Sequence[int]) -> int:
    """The smallest bound ≥ ``n``; raises if the graph exceeds every bound."""
    for b in sorted(bounds):
        if n <= b:
            return b
    raise ValueError(f"graph has {n} nodes > largest bucket {max(bounds)}")


def group_by_bucket(graphs: Sequence[dict], bounds: Sequence[int],
                    min_count: int = 0) -> dict[int, list]:
    """Graph dicts → ``{bound: graphs}``, empty bounds left out. A bucket
    of fewer than ``min_count`` graphs merges upward into the next bound
    (the trainer passes its batch size: a bucket smaller than a batch
    would never give a step); an undersized largest bucket merges
    downward, its bound kept so that every graph still fits."""
    by_bucket: dict[int, list] = {}
    for g in graphs:
        by_bucket.setdefault(bucket_of(int(np.asarray(g["atom_type"]).shape[0]), bounds),
                             []).append(g)
    if min_count > 0:
        ordered = sorted(by_bucket)
        for i, bound in enumerate(ordered):
            if len(by_bucket.get(bound, ())) < min_count and i + 1 < len(ordered):
                by_bucket.setdefault(ordered[i + 1], []).extend(by_bucket.pop(bound))
        ordered = sorted(by_bucket)
        if len(ordered) > 1 and len(by_bucket[ordered[-1]]) < min_count:
            by_bucket[ordered[-1]].extend(by_bucket.pop(ordered[-2]))
    return dict(sorted(by_bucket.items()))


def pack_dataset_bucketed(
    graphs: Sequence[dict],
    bounds: Sequence[int],
    stats: Optional[LabelStats] = None,
    standardize: bool = False,
    min_count: int = 0,
    **pack_kwargs,
) -> tuple[dict[int, PackedDataset], Optional[LabelStats]]:
    """Graph dicts → (``{bound: PackedDataset}``, the label stats), the
    buckets of ``group_by_bucket``. With ``standardize`` and no ``stats``
    the stats are fitted on all of ``graphs``' labels and returned, so
    that validation and test reuse the training split's. ``pack_kwargs``
    go to ``pack_dataset`` (``operator_kind``, ``num_eig_vec``,
    ``num_cluster``, ``device``, ``use_native``)."""
    if standardize and stats is None:
        stats = LabelStats.fit(np.stack([np.asarray(g["label"], np.float32) for g in graphs]))
    packed = {
        bound: pack_dataset(gs, n_max=bound, stats=stats, standardize=standardize, **pack_kwargs)
        for bound, gs in group_by_bucket(graphs, bounds, min_count).items()
    }
    return packed, stats
