"""QM8 molecular graphs: the synthetic generator and the reference's
pickled splits.

Copies of ``lanczosnet_tpu/data/qm8.py:synthetic_qm8_graphs`` (with its
constants: the same seed gives the same graphs in both packages) and of
``import_reference_pickles``.

Graph-dict schema: ``{"atom_type": [n] int, "adj": [E, n, n] float,
"label": [T] float}``, and optionally ``"node_feat": [n, Fc] float``.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

# 4 bond-type channels, 16 regression targets, atom types 1..7 (0 pads)
NUM_EDGE_TYPE = 4
NUM_TASK = 16
NUM_ATOM = 8
N_MAX_QM8 = 32
NUM_INVARIANTS = 7 + (NUM_ATOM - 1)


def _random_molecule(rng: np.random.Generator, n_lo: int, n_hi: int):
    """One connected multi-bond-type molecular graph."""
    n = int(rng.integers(n_lo, n_hi + 1))
    atom_type = rng.integers(1, NUM_ATOM, size=n).astype(np.int32)
    adj = np.zeros((NUM_EDGE_TYPE, n, n), np.float32)
    # a random spanning tree keeps every molecule connected
    perm = rng.permutation(n)
    for i in range(1, n):
        j = perm[int(rng.integers(0, i))]
        e = int(rng.integers(0, NUM_EDGE_TYPE))
        adj[e, perm[i], j] = adj[e, j, perm[i]] = 1.0
    # ring-closing bonds, about 20% extra edges
    for _ in range(max(1, n // 5)):
        i, j = rng.integers(0, n, size=2)
        if i != j:
            e = int(rng.integers(0, NUM_EDGE_TYPE))
            adj[e, i, j] = adj[e, j, i] = 1.0
    return atom_type, adj


def _spectral_labels(atom_type: np.ndarray, adj: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Targets as a fixed linear map ``w [T, F_inv]`` of graph
    invariants: degree statistics, low eigen-moments of the normalized
    merged adjacency and the atom-type histogram."""
    n = atom_type.shape[0]
    a = adj.sum(0)
    deg = a.sum(-1)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    s = a * inv_sqrt[:, None] * inv_sqrt[None, :]
    evals = np.linalg.eigvalsh(s)
    hist = np.bincount(atom_type, minlength=NUM_ATOM)[1:].astype(np.float64)
    feats = np.array(
        [
            n / 30.0,
            deg.mean() / 4.0,
            deg.std() / 4.0,
            evals.min(),
            evals[-2] if n > 1 else 0.0,
            float(np.mean(evals**2)),
            float(np.mean(evals**3)),
            *(hist / max(n, 1)),
        ]
    )
    return (w @ feats).astype(np.float32)


def synthetic_qm8_graphs(
    num: int,
    seed: int = 0,
    n_lo: int = 6,
    n_hi: int = 28,
    label_noise: float = 0.0,
) -> list[dict]:
    """Deterministic list of QM8-like graph dicts."""
    rng = np.random.Generator(np.random.Philox(seed))
    # one label projection for the whole dataset family
    w = np.random.Generator(np.random.Philox(1234)).normal(
        size=(NUM_TASK, NUM_INVARIANTS)
    ) / np.sqrt(NUM_INVARIANTS)
    graphs = []
    for _ in range(num):
        at, adj = _random_molecule(rng, n_lo, n_hi)
        label = _spectral_labels(at, adj, w)
        if label_noise > 0:
            label = label + rng.normal(scale=label_noise, size=label.shape).astype(np.float32)
        graphs.append({"atom_type": at, "adj": adj, "label": label})
    return graphs


def import_reference_pickles(path: str | Path) -> list[dict]:
    """Convert a reference-format pickled split into our graph dicts.

    The reference's preprocessing (SURVEY.md §3.5) pickles per-split
    lists of per-molecule records carrying atom indices, per-bond-type
    adjacency, and the QM8 target vector. Field names vary across
    pickled versions, so we accept the common spellings; anything else
    raises with the offending keys listed. Unpickling can run code:
    open only splits from a source you trust.
    """
    with open(path, "rb") as f:
        records: Iterable = pickle.load(f)

    def pick(rec: dict, names: Sequence[str]):
        for nm in names:
            if nm in rec:
                return rec[nm]
        raise KeyError(
            f"record keys {sorted(rec)} contain none of {names}; "
            "pass data through a custom adapter"
        )

    graphs = []
    for rec in records:
        raw = np.asarray(pick(rec, ("node_feat", "atom_type", "atoms")))
        node_feat = None
        if raw.ndim == 2 and raw.shape[1] > 1:
            # reference layout (see core/graph_batch.py docstring): the
            # atom-type index rides in column 0 of node_feat, remaining
            # columns are continuous per-node features — NOT one-hot.
            atom = raw[:, 0]
            node_feat = raw[:, 1:].astype(np.float32)
        else:
            atom = raw.squeeze()
        adj = np.asarray(pick(rec, ("adj", "A", "L")))
        if "adj" not in rec and "A" not in rec and "L" in rec:
            # 'L' in the reference is the *normalized* operator stack;
            # re-normalizing it in pack_dataset would corrupt values.
            raise ValueError(
                "record carries only the pre-normalized 'L' stack; export "
                "raw per-edge-type adjacency ('adj'/'A') instead, or pack "
                "with a custom adapter that skips re-normalization"
            )
        if adj.ndim == 2:
            adj = adj[None]
        # channel axis: the one whose size differs from the two equal
        # node axes (handles both [E,n,n] and the reference's [n,n,E(+1)]);
        # when all three sizes coincide (n == E), pick the layout whose
        # per-channel matrices are symmetric — adjacency always is
        if adj.ndim == 3:
            if adj.shape[0] == adj.shape[1] == adj.shape[2]:
                as_first = adj
                as_last = np.moveaxis(adj, -1, 0)
                sym_first = np.abs(as_first - as_first.transpose(0, 2, 1)).max()
                sym_last = np.abs(as_last - as_last.transpose(0, 2, 1)).max()
                adj = as_first if sym_first <= sym_last else as_last
            elif adj.shape[0] == adj.shape[1] != adj.shape[2]:
                adj = np.moveaxis(adj, -1, 0)
        if adj.shape[1] != adj.shape[2]:
            raise ValueError(f"cannot identify node axes in adj {adj.shape}")
        label = np.asarray(pick(rec, ("label", "target", "y"))).reshape(-1)
        graphs.append(
            {
                "atom_type": atom.astype(np.int32) + 1,  # our 0 = padding
                "node_feat": node_feat,
                "adj": adj.astype(np.float32),
                "label": label.astype(np.float32),
            }
        )
    return graphs
