"""Full-graph citation datasets (Cora / Citeseer / Pubmed shapes).

Counterpart of ``lanczosnet_tpu/data/citation.py``: semi-supervised
node classification on one graph in the Planetoid protocol (20 labelled
nodes per class for training, 500 validation, 1000 test).
``synthetic_citation_graph`` draws a stochastic-block-model graph with
class-correlated sparse bag-of-words features at the real datasets'
shapes from numpy's Philox generator, so one seed gives both packages
the same arrays. ``pack_citation`` turns it into a B=1 ``GraphBatch``
that every model takes with ``task: node``; the split masks ride beside
the batch. ``import_planetoid`` reads the classic ``ind.<name>.*`` files
that a user supplies into the same dict. ``synthetic_citation_edges``
draws a graph of millions of nodes as an edge list, in O(E) memory, for
the sparse path (``train/sparse_citation_runner.py``); it draws the
JAX generator's Philox stream in the same order, so one seed gives both
packages the same graph element for element.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.data.partition import ritz_partition
from lanczosnet_torch.ops.lanczos_cuda import batched_lanczos_ritz_dispatch
from lanczosnet_torch.ops.normalize import build_operator_stack
from lanczosnet_torch.utils.device import resolve_device

# (num_nodes, feat_dim, num_class, avg_degree) of the real datasets
PRESETS = {
    "cora": (2708, 1433, 7, 3.9),
    "citeseer": (3327, 3703, 6, 2.8),
    "pubmed": (19717, 500, 3, 4.5),
}


def synthetic_citation_graph(
    name: str = "cora",
    seed: int = 0,
    scale: float = 1.0,
    feat_density: float = 0.015,
) -> dict:
    """A stand-in for a Planetoid dataset at its shape (or ``scale``
    times its node count, for tests).

    Returns ``{features [N,F] f32, labels [N] i32, adj [N,N] f32,
    train_mask/val_mask/test_mask [N] bool, num_class}``.
    """
    n0, f, c, avg_deg = PRESETS[name]
    n = max(c * 25, int(n0 * scale))
    f = max(16, int(f * min(1.0, scale * 2)))
    rng = np.random.Generator(np.random.Philox(seed))

    labels = rng.integers(0, c, size=n).astype(np.int32)
    # stochastic block model: most edges inside a class
    p_in = avg_deg * 0.75 / (n / c)
    p_out = avg_deg * 0.25 / (n - n / c)
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((n, n)) < prob, 1)
    adj = (upper | upper.T).astype(np.float32)
    np.fill_diagonal(adj, 0.0)

    # class centroids in sparse random directions plus sparse per-node noise
    centroids = (rng.random((c, f)) < feat_density * 3).astype(np.float32)
    noise = (rng.random((n, f)) < feat_density).astype(np.float32)
    features = np.clip(centroids[labels] * (rng.random((n, f)) < 0.5) + noise,
                       0.0, 1.0).astype(np.float32)
    # row-normalize, as the Planetoid loaders do
    rs = features.sum(1, keepdims=True)
    features = features / np.maximum(rs, 1.0)

    train_mask = np.zeros(n, bool)
    for cls in range(c):
        idx = np.nonzero(labels == cls)[0]
        train_mask[rng.choice(idx, size=min(20, len(idx)), replace=False)] = True
    rest = np.nonzero(~train_mask)[0]
    rng.shuffle(rest)
    n_val = min(500, max(50, n // 5))
    n_test = min(1000, max(100, n // 3))
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    val_mask[rest[:n_val]] = True
    test_mask[rest[n_val: n_val + n_test]] = True

    return {
        "features": features,
        "labels": labels,
        "adj": adj,
        "train_mask": train_mask,
        "val_mask": val_mask,
        "test_mask": test_mask,
        "num_class": c,
    }


def synthetic_citation_edges(
    n: int,
    num_class: int = 10,
    feat_dim: int = 256,
    avg_degree: float = 5.0,
    homophily: float = 0.75,
    seed: int = 0,
    feat_density: float = 0.02,
) -> dict:
    """A stochastic-block-model-like graph of ``n`` nodes as an edge list
    (the dense generator above holds an ``[N, N]`` matrix and stops
    scaling near Pubmed's size): the dict of ``synthetic_citation_graph``
    with ``edges [E, 2]`` int64 (i < j, unique) in place of ``adj``.

    The draws are the JAX generator's, in its order; reordering or
    fusing them would change the graph. At 10M nodes and F=32 the two
    ``rng.random((n, feat_dim))`` draws are 2.56 GB of float64 each.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    labels = rng.integers(0, num_class, size=n).astype(np.int32)
    by_class = [np.nonzero(labels == c)[0] for c in range(num_class)]

    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, size=m)
    same = rng.random(m) < homophily
    dst = np.empty(m, np.int64)
    for c in range(num_class):
        pool = by_class[c]
        sel = same & (labels[src] == c)
        if sel.any() and len(pool):
            dst[sel] = pool[rng.integers(0, len(pool), size=int(sel.sum()))]
    rand_sel = ~same
    dst[rand_sel] = rng.integers(0, n, size=int(rand_sel.sum()))
    keep = src != dst
    edges = np.unique(np.sort(np.stack([src[keep], dst[keep]], 1), axis=1), axis=0)

    centroids = (rng.random((num_class, feat_dim)) < feat_density * 3).astype(np.float32)
    features = centroids[labels] * (rng.random((n, feat_dim)) < 0.5) + (
        rng.random((n, feat_dim)) < feat_density)
    features = features.astype(np.float32)
    features /= np.maximum(features.sum(1, keepdims=True), 1.0)

    train_mask = np.zeros(n, bool)
    for c in range(num_class):
        pool = by_class[c]
        if len(pool):
            train_mask[rng.choice(pool, size=min(20, len(pool)), replace=False)] = True
    rest = np.nonzero(~train_mask)[0]
    rng.shuffle(rest)
    # Planetoid-style 500/1000 validation/test, scaled down so that a
    # small graph still has a test split
    n_val = min(500, max(1, len(rest) // 2))
    n_test = min(1000, len(rest) - n_val)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    val_mask[rest[:n_val]] = True
    test_mask[rest[n_val: n_val + n_test]] = True
    return {
        "features": features,
        "labels": labels,
        "edges": edges.astype(np.int64),
        "train_mask": train_mask,
        "val_mask": val_mask,
        "test_mask": test_mask,
        "num_class": num_class,
    }


def import_planetoid(data_dir: str | Path, name: str) -> dict:
    """The Planetoid files ``ind.<name>.{x,y,tx,ty,allx,ally,graph,
    test.index}`` in ``data_dir`` → the dict of
    ``synthetic_citation_graph``.

    Nodes ``[0, allx.rows)`` are ``allx``; the test nodes sit at the
    indices of ``test.index``. Citeseer has isolated test nodes missing
    from ``tx``: they get zero features and labels (and have no edges).
    The training nodes are the first ``x.rows``, validation the next
    500. The pickles are read as the format has them: only open files
    from a source you trust.
    """
    data_dir = Path(data_dir)

    def load(part):
        with open(data_dir / f"ind.{name}.{part}", "rb") as fh:
            return pickle.load(fh, encoding="latin1")

    x, y, tx, ty, allx, ally, graph = (
        load(p) for p in ("x", "y", "tx", "ty", "allx", "ally", "graph"))
    test_idx = np.asarray(
        [int(line) for line in (data_dir / f"ind.{name}.test.index").read_text().split()],
        np.int64)

    def dense(m):
        return np.asarray(m.todense() if hasattr(m, "todense") else m, np.float32)

    allx, tx, x = dense(allx), dense(tx), dense(x)
    n = max(allx.shape[0] + tx.shape[0], int(test_idx.max()) + 1, len(graph))
    features = np.zeros((n, allx.shape[1]), np.float32)
    features[: allx.shape[0]] = allx
    features[test_idx] = tx

    labels_oh = np.zeros((n, ally.shape[1]), np.float32)
    labels_oh[: ally.shape[0]] = ally
    labels_oh[test_idx] = ty
    labels = labels_oh.argmax(1).astype(np.int32)

    adj = np.zeros((n, n), np.float32)
    for i, nbrs in graph.items():
        for j in nbrs:
            if i != j and i < n and j < n:
                adj[i, j] = adj[j, i] = 1.0

    train_mask = np.zeros(n, bool)
    train_mask[: x.shape[0]] = True
    val_mask = np.zeros(n, bool)
    val_mask[x.shape[0]: x.shape[0] + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx] = True
    return {
        "features": features,
        "labels": labels,
        "adj": adj,
        "train_mask": train_mask,
        "val_mask": val_mask,
        "test_mask": test_mask,
        "num_class": int(labels_oh.shape[1]),
    }


def pack_citation(
    graph: dict,
    pad_to: int = 8,
    operator_kind: str = "sym",
    num_eig_vec: int = 0,
    num_cluster: int = 0,
    device: str | torch.device | None = None,
    spectral_device: str | torch.device | None = None,
) -> tuple[GraphBatch, dict]:
    """Citation dict → (B=1 ``GraphBatch``, split masks ``[1, N]`` float
    padded alike), all on ``device`` (a CUDA card unless one is named).

    The node axis is padded to a multiple of ``pad_to``. ``atom_type``
    is 1 for every real node: citation nodes carry continuous features
    and the embedding is a shared bias. With ``num_eig_vec > 0`` the
    Ritz pairs of the channel-0 operator are attached, computed on
    ``device`` through the Lanczos dispatch (on the card, the CUDA
    kernel the graph's size picks). ``num_cluster > 0`` attaches GPNN's
    partition (``cluster [1, N]``, ``data/partition.py:ritz_partition``,
    its Lanczos call on ``device`` too). ``spectral_device``, where
    given, runs those two instead: the node-sharded runner's rank 0
    packs on the host and moves only channel 0 to its card for them.
    """
    device = resolve_device(device)
    spectral = device if spectral_device is None else torch.device(spectral_device)
    n = graph["features"].shape[0]
    n_pad = -(-n // pad_to) * pad_to
    feats = np.zeros((1, n_pad, graph["features"].shape[1]), np.float32)
    feats[0, :n] = graph["features"]
    atom = np.zeros((1, n_pad), np.int32)
    atom[0, :n] = 1
    mask = np.zeros((1, n_pad), np.float32)
    mask[0, :n] = 1.0
    adj = np.zeros((1, 1, n_pad, n_pad), np.float32)
    adj[0, 0, :n, :n] = graph["adj"]
    node_label = np.zeros((1, n_pad), np.int32)
    node_label[0, :n] = graph["labels"]

    mask_t = torch.from_numpy(mask).to(device)
    ops = build_operator_stack(torch.from_numpy(adj).to(device), mask_t, kind=operator_kind)
    ritz_val = ritz_vec = None
    if num_eig_vec > 0:
        with torch.no_grad():
            ritz_val, ritz_vec = batched_lanczos_ritz_dispatch(
                ops[:, 0].to(spectral), mask_t.to(spectral), num_eig_vec)
        ritz_val, ritz_vec = ritz_val.to(device), ritz_vec.to(device)
    cluster = None
    if num_cluster > 0:
        cluster = torch.from_numpy(ritz_partition(ops[0, 0].to(spectral), mask_t[0].to(spectral),
                                                  num_cluster)[None])

    batch = GraphBatch(
        atom_type=torch.from_numpy(atom).to(device),
        node_feat=torch.from_numpy(feats).to(device),
        ops=ops,
        mask=mask_t,
        label=torch.zeros((1, 1), device=device),  # unused in the node task
        ritz_val=ritz_val,
        ritz_vec=ritz_vec,
        node_label=torch.from_numpy(node_label).to(device),
        cluster=None if cluster is None else cluster.to(device),
    )
    splits = {}
    for split in ("train", "val", "test"):
        m = np.zeros((1, n_pad), np.float32)
        m[0, :n] = graph[f"{split}_mask"].astype(np.float32)
        splits[split] = torch.from_numpy(m).to(device)
    return batch, splits
