"""Full-graph citation datasets (Cora / Citeseer / Pubmed shapes).

Counterpart of ``lanczosnet_tpu/data/citation.py``: semi-supervised
node classification on one graph in the Planetoid protocol (20 labelled
nodes per class for training, 500 validation, 1000 test).
``synthetic_citation_graph`` draws a stochastic-block-model graph with
class-correlated sparse bag-of-words features at the real datasets'
shapes from numpy's Philox generator, so one seed gives both packages
the same arrays. ``pack_citation`` turns it into a B=1 ``GraphBatch``
that every model takes with ``task: node``; the split masks ride beside
the batch. The Planetoid file importer and the edge-list generator for
large graphs are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
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


def pack_citation(
    graph: dict,
    pad_to: int = 8,
    operator_kind: str = "sym",
    num_eig_vec: int = 0,
    num_cluster: int = 0,
    device: str | torch.device | None = None,
) -> tuple[GraphBatch, dict]:
    """Citation dict → (B=1 ``GraphBatch``, split masks ``[1, N]`` float
    padded alike), all on ``device`` (a CUDA card unless one is named).

    The node axis is padded to a multiple of ``pad_to``. ``atom_type``
    is 1 for every real node: citation nodes carry continuous features
    and the embedding is a shared bias. With ``num_eig_vec > 0`` the
    Ritz pairs of the channel-0 operator are attached, computed on
    ``device`` through the Lanczos dispatch (on the card, the CUDA
    kernel the graph's size picks).
    """
    if num_cluster > 0:
        raise NotImplementedError(
            "num_cluster > 0 attaches a GPNN partition of the citation graph; its "
            "partitioner (ritz_partition) is not ported yet (ROADMAP A9)"
        )
    device = resolve_device(device)
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
            ritz_val, ritz_vec = batched_lanczos_ritz_dispatch(ops[:, 0], mask_t, num_eig_vec)

    batch = GraphBatch(
        atom_type=torch.from_numpy(atom).to(device),
        node_feat=torch.from_numpy(feats).to(device),
        ops=ops,
        mask=mask_t,
        label=torch.zeros((1, 1), device=device),  # unused in the node task
        ritz_val=ritz_val,
        ritz_vec=ritz_vec,
        node_label=torch.from_numpy(node_label).to(device),
    )
    splits = {}
    for split in ("train", "val", "test"):
        m = np.zeros((1, n_pad), np.float32)
        m[0, :n] = graph[f"{split}_mask"].astype(np.float32)
        splits[split] = torch.from_numpy(m).to(device)
    return batch, splits
