"""The port's citation graph sources and GPNN partitions against the JAX
package, on the CPU: ``synthetic_citation_edges``, ``import_planetoid``,
``ritz_partition``, ``sparse_spectral_partition``,
``pack_citation(num_cluster>0)`` and the dense citation configs that
need them through ``CitationRunner``.

Tolerances: the generator and the importer are equal exactly (the same
numpy Philox stream, the same arithmetic); the partitions are equal up
to a relabelling of the clusters, on graphs whose clusters are
separated (the two packages' Lanczos calls sum in different orders, so
a node on the boundary of a k-means cell could tip), and on the
synthetic Pubmed stand-in, whose clusters are not separated, on at least
97% of the nodes (``chip_smoke.PUBMED_PARTITION_AGREEMENT``, which the
card is held to as well); packed operators
1e-6 and Ritz reconstructions 1e-3, as in ``test_torch_citation.py``.
"""

import collections
import json
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from lanczosnet_tpu.data.citation import (
    import_planetoid as jax_import_planetoid,
    pack_citation as jax_pack_citation,
    synthetic_citation_edges as jax_synthetic_citation_edges,
    synthetic_citation_graph as jax_synthetic_citation_graph,
)
from lanczosnet_tpu.data.partition import (
    ritz_partition as jax_ritz_partition,
    sparse_spectral_partition as jax_sparse_spectral_partition,
)
from lanczosnet_tpu.ops.sparse import sparse_sym_operator as jax_sparse_sym_operator
from lanczosnet_torch.data.citation import (
    import_planetoid,
    pack_citation,
    synthetic_citation_edges,
)
from lanczosnet_torch.data.partition import ritz_partition, sparse_spectral_partition
from lanczosnet_torch.ops.normalize import build_operator_stack
from lanczosnet_torch.ops.sparse import sparse_sym_operator
from lanczosnet_torch.train.citation_runner import CitationRunner
from lanczosnet_torch.utils.config import load_config


def assert_same_partition(got: np.ndarray, want: np.ndarray) -> None:
    """Equal up to a relabelling: the map between the labels is one to one."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    pairs = set(zip(got.tolist(), want.tolist()))
    assert len(pairs) == len(set(got.tolist())) == len(set(want.tolist())), pairs


def clustered_edges(sizes=(40, 40, 40), p_in=0.25, bridges=2, seed=0) -> np.ndarray:
    """Dense random clusters joined by a few bridge edges: ``[E, 2]``, i < j."""
    rng = np.random.default_rng(seed)
    edges, start = [], 0
    for size in sizes:
        ids = np.arange(start, start + size)
        a, b = np.triu_indices(size, 1)
        keep = rng.random(a.size) < p_in
        edges.append(np.stack([ids[a[keep]], ids[b[keep]]], 1))
        start += size
    starts = np.cumsum((0,) + tuple(sizes))
    for c in range(len(sizes) - 1):
        for t in range(bridges):
            edges.append(np.array([[starts[c] + t, starts[c + 1] + t]]))
    return np.unique(np.sort(np.concatenate(edges), 1), axis=0)


@pytest.mark.parametrize("kw", [
    dict(n=500, num_class=10, feat_dim=32, avg_degree=2.5, seed=7),
    dict(n=300, num_class=3, feat_dim=16, avg_degree=6.0, homophily=0.9, seed=1),
    dict(n=160, num_class=4, feat_dim=8, avg_degree=3.0, seed=0, feat_density=0.1),
])
def test_synthetic_citation_edges_equals_jax(kw):
    n = kw.pop("n")
    want = jax_synthetic_citation_edges(n, **kw)
    got = synthetic_citation_edges(n, **kw)
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(val).dtype, key
    assert got["test_mask"].any() and (got["edges"][:, 0] < got["edges"][:, 1]).all()


def write_planetoid(path, name, allx, ally, x, y, tx, ty, graph, test_index) -> None:
    """The ``ind.<name>.*`` files as the Planetoid release writes them:
    sparse CSR features, one-hot labels, a defaultdict adjacency list,
    the test indices in file order."""
    gd = collections.defaultdict(list)
    gd.update(graph)
    for part, obj in (("x", sp.csr_matrix(x)), ("y", np.asarray(y, np.int32)),
                      ("tx", sp.csr_matrix(tx)), ("ty", np.asarray(ty, np.int32)),
                      ("allx", sp.csr_matrix(allx)), ("ally", np.asarray(ally, np.int32)),
                      ("graph", gd)):
        with open(path / f"ind.{name}.{part}", "wb") as fh:
            pickle.dump(obj, fh, protocol=2)
    (path / f"ind.{name}.test.index").write_text("\n".join(map(str, test_index)) + "\n")


def cora_layout(path) -> str:
    """Test nodes the contiguous tail, their file order shuffled."""
    rng = np.random.default_rng(0)
    allx = (rng.random((8, 5)) < 0.3).astype(np.float32)
    ally = np.eye(3)[[0, 1, 2, 0, 1, 2, 0, 1]]
    tx = (rng.random((4, 5)) < 0.3).astype(np.float32)
    ty = np.eye(3)[[1, 2, 0, 1]]
    graph = {0: [1, 2], 1: [0], 2: [0, 3], 3: [2], 4: [5], 5: [4],
             6: [7], 7: [6, 8], 8: [7], 9: [10], 10: [9, 11], 11: [10]}
    write_planetoid(path, "tinycora", allx, ally, allx[:3], ally[:3], tx, ty, graph,
                    [10, 8, 11, 9])
    return "tinycora"


def citeseer_layout(path) -> str:
    """Ids 7 and 8 inside the test range are isolated: in no file."""
    rng = np.random.default_rng(1)
    allx = (rng.random((6, 4)) < 0.4).astype(np.float32)
    ally = np.eye(2)[[0, 1, 0, 1, 0, 1]]
    tx = (rng.random((2, 4)) < 0.4).astype(np.float32)
    ty = np.eye(2)[[1, 0]]
    graph = {0: [1], 1: [0], 2: [3], 3: [2], 4: [5], 5: [4], 6: [0], 9: [1]}
    write_planetoid(path, "tinycite", allx, ally, allx[:2], ally[:2], tx, ty, graph, [9, 6])
    return "tinycite"


@pytest.mark.parametrize("layout", [cora_layout, citeseer_layout])
def test_import_planetoid_equals_jax(tmp_path, layout):
    name = layout(tmp_path)
    want = jax_import_planetoid(tmp_path, name)
    got = import_planetoid(tmp_path, name)
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(val).dtype, key
    if name == "tinycite":
        for iso in (7, 8):
            assert got["features"][iso].sum() == 0 and got["adj"][iso].sum() == 0
            assert not (got["train_mask"][iso] or got["test_mask"][iso])


def test_citation_runner_reads_planetoid_files(tmp_path):
    name = cora_layout(tmp_path)
    cfg = {
        "exp_name": "p", "runner": "CitationRunner", "seed": 3, "save_dir": str(tmp_path / "run"),
        "dataset": {"source": "planetoid", "name": name, "data_dir": str(tmp_path)},
        "model": {"name": "GCN", "hidden_dim": [8], "dropout": 0.0},
        "train": {"lr": 1e-2, "max_epoch": 3, "display_iter": 1},
    }
    runner = CitationRunner(cfg, device="cpu")
    assert runner.batch.n_max == 12 and runner.batch.node_feat.shape[-1] == 5
    assert 0.0 <= runner.train()["test_acc"] <= 1.0


@pytest.mark.parametrize("num_cluster", [2, 3])
def test_ritz_partition_equals_jax(num_cluster):
    edges = clustered_edges()
    n, n_pad = 120, 128
    adj = np.zeros((1, 1, n_pad, n_pad), np.float32)
    adj[0, 0, edges[:, 0], edges[:, 1]] = adj[0, 0, edges[:, 1], edges[:, 0]] = 1.0
    mask = np.zeros((1, n_pad), np.float32)
    mask[0, :n] = 1.0
    op = build_operator_stack(torch.from_numpy(adj), torch.from_numpy(mask))[0, 0]
    got = ritz_partition(op, torch.from_numpy(mask[0]), num_cluster, seed=5)
    want = jax_ritz_partition(op.numpy(), mask[0], num_cluster, seed=5)
    assert got.dtype == np.int32 and (got[n:] == 0).all()
    assert_same_partition(got[:n], want[:n])
    assert (ritz_partition(op, torch.from_numpy(mask[0]), 1) == 0).all()


@pytest.mark.parametrize("num_cluster", [2, 3])
def test_sparse_spectral_partition_equals_jax(num_cluster):
    edges = clustered_edges(seed=2)
    got = sparse_spectral_partition(sparse_sym_operator(edges, 120), num_cluster, seed=1)
    want = jax_sparse_spectral_partition(jax_sparse_sym_operator(edges, 120), num_cluster,
                                         seed=1)
    assert got.dtype == np.int32
    assert_same_partition(got, np.asarray(want))


def test_pack_citation_with_clusters_equals_jax():
    edges = clustered_edges(sizes=(60, 60), seed=4)
    n = 120
    rng = np.random.default_rng(0)
    adj = np.zeros((n, n), np.float32)
    adj[edges[:, 0], edges[:, 1]] = adj[edges[:, 1], edges[:, 0]] = 1.0
    graph = {
        "features": rng.random((n, 6)).astype(np.float32), "adj": adj,
        "labels": rng.integers(0, 2, n).astype(np.int32),
        "train_mask": rng.random(n) < 0.2, "val_mask": rng.random(n) < 0.3,
        "test_mask": rng.random(n) < 0.3, "num_class": 2,
    }
    want, _ = jax_pack_citation(graph, pad_to=8, num_eig_vec=6, num_cluster=2)
    got, _ = pack_citation(graph, pad_to=8, num_eig_vec=6, num_cluster=2, device="cpu")
    np.testing.assert_allclose(got.ops.numpy(), np.asarray(want.ops), atol=1e-6)
    assert got.cluster.shape == (1, 120) and got.cluster.dtype == torch.int32
    assert_same_partition(got.cluster.numpy()[0], np.asarray(want.cluster)[0])


@pytest.mark.parametrize("config,scale", [("pubmed_gpnn", 0.06), ("citeseer_lanczos_net", 0.1)])
def test_dense_citation_configs_train_narrowed(tmp_path, config, scale):
    """The config as written but for the graph's scale, the width and the
    epochs; its pack against the JAX pack of the same graph."""
    cfg = load_config(f"configs/{config}.yaml")
    cfg = {**cfg, "save_dir": str(tmp_path / "run"),
           "dataset": {**cfg["dataset"], "scale": scale},
           "model": {**cfg["model"], "hidden_dim": [16, 16]},
           "train": {**cfg["train"], "max_epoch": 8, "display_iter": 1}}
    runner = CitationRunner(cfg, device="cpu")
    batch = runner.batch
    assert batch.ritz_val is None or batch.ritz_val.shape == (1, cfg["model"]["num_eig_vec"])
    graph = jax_synthetic_citation_graph(cfg["dataset"]["name"], seed=7, scale=scale)
    gpnn = cfg["model"]["name"] == "GPNN"
    want, _ = jax_pack_citation(
        graph, pad_to=1, num_eig_vec=0 if gpnn else cfg["model"]["num_eig_vec"],
        num_cluster=cfg["model"]["num_partition"] if gpnn else 0)
    np.testing.assert_allclose(batch.ops.numpy(), np.asarray(want.ops), atol=1e-6)
    if gpnn:
        # the synthetic graph's clusters are not separated: its Ritz
        # vectors of close Ritz values turn with the order of summation,
        # and 14 of 1183 nodes tip at this scale
        agree = chip_smoke.partition_agreement(batch.cluster.numpy()[0],
                                               np.asarray(want.cluster)[0])
        assert agree >= chip_smoke.PUBMED_PARTITION_AGREEMENT
    else:
        recon = lambda d, v: np.einsum("bnk,bk,bmk->bnm", v, d, v)  # noqa: E731
        np.testing.assert_allclose(recon(batch.ritz_val.numpy(), batch.ritz_vec.numpy()),
                                   recon(np.asarray(want.ritz_val), np.asarray(want.ritz_vec)),
                                   atol=1e-3)
    result = runner.train()
    records = [json.loads(ln) for ln in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in records if r["event"] == "train"]
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert 0.0 < result["test_acc"] <= 1.0
