"""Spectral graph partitioning for GPNN, on the host at pack time.

The port's own copy of ``lanczosnet_tpu/data/partition.py:_kmeans``,
``spectral_partition`` and ``spectral_partition_batch``: the top
eigenvectors of each graph's channel-0 operator (the smoothest modes of
its Laplacian), row-normalized, then a small deterministic k-means
(Philox, seed 0). Pure numpy, so the same operators give the same
clusters in both packages. ``cluster_of_ops`` is the one entry the pack
and the ``Predictor`` share.

For one large graph the full eigh is too slow, so ``ritz_partition``
(a dense operator, ``pack_citation``) and ``sparse_spectral_partition``
(a COO operator, ``SparseGPNN``) embed the nodes with the operator's top
K Ritz vectors instead, computed on the operator's device (the dense
one through the Lanczos dispatch, so a CUDA kernel on the card), then
run the same k-means on the host. The two embed alike, so dense and
sparse GPNN on one graph cluster alike.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosnet_torch.ops.lanczos_cuda import batched_lanczos_ritz_dispatch
from lanczosnet_torch.ops.sparse import SparseOp, sparse_lanczos_ritz


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


def _kmeans_of_ritz(vecs: torch.Tensor, num_cluster: int, seed: int) -> np.ndarray:
    """k-means of the rows of the last ``num_cluster`` Ritz vectors
    ``vecs [n, k]`` (the top of the spectrum), each row normalized."""
    emb = vecs[:, -min(num_cluster, vecs.shape[1]):].cpu().numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    return _kmeans(emb, num_cluster, seed=seed).astype(np.int32)


@torch.no_grad()
def ritz_partition(op: torch.Tensor, mask: torch.Tensor, num_cluster: int,
                   k: int | None = None, seed: int = 0) -> np.ndarray:
    """GPNN's partition of one graph with a dense operator ``op [N, N]``
    and ``mask [N]``: its top-K Ritz vectors (K = max(2·num_cluster, 8)
    unless given) through ``batched_lanczos_ritz_dispatch`` on op's
    device, then k-means → ``[N]`` int32, 0 on padded nodes."""
    out = np.zeros(op.shape[0], np.int32)
    if num_cluster <= 1:
        return out
    n_real = int(mask.sum())
    k = k if k is not None else max(2 * num_cluster, 8)
    k = min(k, max(n_real, 1))
    _, vecs = batched_lanczos_ritz_dispatch(op.to(torch.float32)[None],
                                            mask.to(torch.float32)[None], k)
    out[:n_real] = _kmeans_of_ritz(vecs[0, :n_real], num_cluster, seed)
    return out


@torch.no_grad()
def sparse_spectral_partition(op: SparseOp, num_cluster: int, k: int | None = None,
                              seed: int = 0) -> np.ndarray:
    """GPNN's partition of a COO-operator graph: its top-K Ritz vectors
    (``ops/sparse.py:sparse_lanczos_ritz`` on op's device), then k-means
    → ``[N]`` int32."""
    if num_cluster <= 1:
        return np.zeros(op.n, np.int32)
    k = k if k is not None else max(2 * num_cluster, 8)
    _, vecs = sparse_lanczos_ritz(op, min(k, op.n))
    return _kmeans_of_ritz(vecs, num_cluster, seed)
