"""Spectral graph partitioning for GPNN, on the host at pack time.

The port's own copy of ``lanczosnet_tpu/data/partition.py:_kmeans``,
``spectral_partition`` and ``spectral_partition_batch``: the top
eigenvectors of each graph's channel-0 operator (the smoothest modes of
its Laplacian), row-normalized, then a small deterministic k-means
(Philox, seed 0). Pure numpy, so the same operators give the same
clusters in both packages. ``cluster_of_ops`` is the one entry the pack
and the ``Predictor`` share.
"""

from __future__ import annotations

import numpy as np


def _kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    """Deterministic k-means: ``x [n, d]`` → labels ``[n]``."""
    n = x.shape[0]
    rng = np.random.Generator(np.random.Philox(seed))
    if n <= k:
        return np.arange(n) % k
    centers = x[rng.choice(n, size=k, replace=False)]
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = ((x[:, None] - centers[None]) ** 2).sum(-1)
        new = d2.argmin(-1)
        if (new == labels).all():
            break
        labels = new
        for c in range(k):
            pts = x[labels == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return labels


def spectral_partition(op: np.ndarray, mask: np.ndarray, num_cluster: int) -> np.ndarray:
    """One graph's real nodes in ``num_cluster`` groups: ``op [N, N]``
    (its symmetric normalized operator), ``mask [N]`` → ``[N]`` int32
    cluster ids, 0 on padded nodes."""
    n_real = int(mask.sum())
    out = np.zeros(op.shape[0], np.int32)
    if n_real == 0 or num_cluster <= 1:
        return out
    sub = op[:n_real, :n_real]
    _, v = np.linalg.eigh(0.5 * (sub + sub.T))
    emb = v[:, -min(num_cluster, n_real):]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    out[:n_real] = _kmeans(emb, num_cluster).astype(np.int32)
    return out


def spectral_partition_batch(ops0: np.ndarray, mask: np.ndarray, num_cluster: int) -> np.ndarray:
    """``spectral_partition`` over graphs: ``[G,N,N]``, ``[G,N]`` → ``[G,N]``."""
    return np.stack(
        [spectral_partition(ops0[g], mask[g], num_cluster) for g in range(len(ops0))]
    )


def cluster_of_ops(ops: np.ndarray, mask: np.ndarray, num_cluster: int) -> np.ndarray:
    """GPNN's partition of packed graphs from channel 0 of their operator
    stack ``ops [G,E+1,N,N]`` → ``[G,N]`` int32."""
    return spectral_partition_batch(np.asarray(ops[:, 0]), np.asarray(mask), num_cluster)
