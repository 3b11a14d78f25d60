"""The benchmark's graph: a stochastic block model drawn on the device.

Same statistics as the port's ``data/citation.py:synthetic_citation_edges``
(frozen here, so that a change to the program cannot move the yardstick):

- labels uniform over ``num_class`` classes;
- ``int(n * avg_degree / 2)`` candidate edges from uniform sources, each
  kept inside the source's class with probability ``homophily`` (0.75)
  and sent to a uniform node otherwise; self loops and duplicates
  dropped, so the average degree is a hair under ``avg_degree``;
- features ``centroid[label] * Bernoulli(0.5) + Bernoulli(feat_density)``
  with centroids ``Bernoulli(3 * feat_density)``, rows normalized by
  ``max(row sum, 1)``;
- 20 training nodes a class, then 500 validation and 1000 test nodes
  from the rest (fewer on a small graph).

Unlike the port's generator it draws in a few large calls of a
``torch.Generator`` on the device, in float32 and never as a float64
``[N, F]`` array, so a 10M-node graph takes about a second and not half
a minute. Every seed draws the same number of values of every kind: the
sizes of the work do not depend on the seed (the edge count only on
the few duplicates it drops).
"""

from __future__ import annotations

import numpy as np
import torch

TRAIN_PER_CLASS = 20
VAL_NODES = 500
TEST_NODES = 1000
HOMOPHILY = 0.75
FEAT_DENSITY = 0.02
_FEATURE_ROWS = 1 << 20  # feature rows drawn at a time: keeps the draw's memory small


def draw_graph(n: int, num_class: int, feat_dim: int, avg_degree: float, seed: int,
               device: str | torch.device, homophily: float = HOMOPHILY,
               feat_density: float = FEAT_DENSITY) -> dict:
    """The graph of ``seed`` as host arrays, in the layout the port's
    runners take: ``features [N, F]`` float32, ``labels [N]`` int32,
    ``edges [E, 2]`` int64 (i < j, unique, sorted), ``train_mask``,
    ``val_mask``, ``test_mask`` ``[N]`` bool, ``num_class``."""
    dev = torch.device(device)
    g = torch.Generator(dev).manual_seed(int(seed) % 2**63)
    c = int(num_class)

    labels = torch.randint(0, c, (n,), generator=g, device=dev)
    by_class = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=c)
    starts = torch.cumsum(counts, 0) - counts

    m = int(n * avg_degree / 2)
    src = torch.randint(0, n, (m,), generator=g, device=dev)
    same = torch.rand(m, generator=g, device=dev) < homophily
    pick = torch.rand(m, generator=g, device=dev)
    anywhere = torch.randint(0, n, (m,), generator=g, device=dev)
    cls = labels[src]
    offset = torch.minimum((pick * counts[cls]).long(), counts[cls] - 1)
    dst = torch.where(same, by_class[starts[cls] + offset], anywhere)
    del pick, anywhere, cls, offset, same
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    del src, dst, keep
    key = torch.unique(lo * n + hi)  # sorted
    edges = torch.stack([key // n, key % n], 1)
    del lo, hi, key

    centroids = (torch.rand((c, feat_dim), generator=g, device=dev)
                 < 3 * feat_density).to(torch.float32)
    features = torch.empty((n, feat_dim), dtype=torch.float32)
    for s in range(0, n, _FEATURE_ROWS):
        rows = min(_FEATURE_ROWS, n - s)
        half = torch.rand((rows, feat_dim), generator=g, device=dev) < 0.5
        noise = torch.rand((rows, feat_dim), generator=g, device=dev) < feat_density
        f = centroids[labels[s: s + rows]] * half + noise
        f /= torch.clamp_min(f.sum(1, keepdim=True), 1.0)
        features[s: s + rows] = f.cpu()
        del half, noise, f

    # 20 a class: the smallest keys within each class
    key1 = torch.rand(n, generator=g, device=dev)
    order = torch.argsort(key1)
    order = order[torch.argsort(labels[order], stable=True)]
    rank = torch.arange(n, device=dev) - starts[labels[order]]
    train = torch.zeros(n, dtype=torch.bool, device=dev)
    train[order[rank < TRAIN_PER_CLASS]] = True
    # validation and test: the rest in the order of a second key
    key2 = torch.rand(n, generator=g, device=dev)
    key2[train] = 2.0
    rest = torch.argsort(key2)[: n - int(train.sum())]
    n_val = min(VAL_NODES, max(1, len(rest) // 2))
    n_test = min(TEST_NODES, len(rest) - n_val)
    val = torch.zeros(n, dtype=torch.bool, device=dev)
    test = torch.zeros(n, dtype=torch.bool, device=dev)
    val[rest[:n_val]] = True
    test[rest[n_val: n_val + n_test]] = True

    return {
        "features": features.numpy(),
        "labels": labels.to(torch.int32).cpu().numpy(),
        "edges": edges.cpu().numpy().astype(np.int64),
        "train_mask": train.cpu().numpy(),
        "val_mask": val.cpu().numpy(),
        "test_mask": test.cpu().numpy(),
        "num_class": c,
    }
