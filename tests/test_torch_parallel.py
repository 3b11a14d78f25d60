"""The port's process groups, collectives and pieces, on the CPU.

The comm layer runs in real ranks (``parallel/multihost.py:launch``, D
= 2 and 4, gloo, a ``FileStore`` under ``tmp_path``, one thread a rank;
the ranks run ``tests/torch_rank_workers.py`` and import no JAX). Each
collective and its backward are held to the single-process result on
integer-valued inputs, so every sum is exact in any order: equality,
bit for bit. The bucketing functions of ``parallel/mesh.py`` give the
arrays of ``lanczosnet_tpu/parallel/mesh.py``'s element for element, at
D = 2 and 4 (numpy only on the port's side). The refusals: a group whose
size is not ``train.num_devices``, and the options that the rest of A11b
ports.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_rank_workers as workers
from lanczosnet_tpu.ops import sparse as jsp
from lanczosnet_tpu.parallel import mesh as jmesh
from lanczosnet_torch.ops import sparse as tsp
from lanczosnet_torch.parallel import mesh, multihost
from lanczosnet_torch.parallel.comm import Comm
from lanczosnet_torch.train.citation_runner import CitationRunner
from lanczosnet_torch.train.runner import QM8Runner
from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

TESTS = str(Path(__file__).resolve().parent)


def launch(tmp_path, world: int, target: str, *args) -> list[dict]:
    out = tmp_path / f"out{world}"
    out.mkdir()
    code = multihost.launch(world, f"torch_rank_workers:{target}", [str(out), *args],
                            device="cpu", store_dir=tmp_path, threads=1, pythonpath=[TESTS],
                            timeout=120)
    assert code == 0
    return workers.read_ranks(out, world)


@pytest.fixture(scope="module", params=[2, 4])
def comm_results(request, tmp_path_factory):
    world = request.param
    return world, launch(tmp_path_factory.mktemp(f"comm{world}"), world, "comm_checks", "cpu")


def test_psum_and_its_backward(comm_results):
    d, ranks = comm_results
    want = sum(workers.draw(1, r, (3, 4)) for r in range(d))
    grad = sum(workers.draw(2, r, (3, 4)) for r in range(d))
    for res in ranks:
        y, g = res["psum"]
        assert torch.equal(y, want) and torch.equal(g, grad)


def test_pmax_is_the_max_over_ranks(comm_results):
    d, ranks = comm_results
    want = torch.stack([workers.draw(3, r, (5,)) for r in range(d)]).amax(0)
    assert all(torch.equal(res["pmax"], want) for res in ranks)


def test_all_gather_rows_and_its_reduce_scatter_backward(comm_results):
    d, ranks = comm_results
    want = torch.cat([workers.draw(4, r, (2, 3)) for r in range(d)])
    cot = sum(workers.draw(5, r, (2 * d, 3)) for r in range(d))
    for r, res in enumerate(ranks):
        y, g = res["all_gather_rows"]
        assert torch.equal(y, want)
        assert torch.equal(g, cot[2 * r: 2 * r + 2])


def test_ring_hop_and_its_reverse_hop(comm_results):
    d, ranks = comm_results
    for r, res in enumerate(ranks):
        y, g = res["ring_hop"]
        assert torch.equal(y, workers.draw(6, (r - 1) % d, (4, 2)))
        assert torch.equal(g, workers.draw(7, (r + 1) % d, (4, 2)))


def test_flat_all_reduce_and_integer_gather(comm_results):
    d, ranks = comm_results
    a = sum(workers.draw(8, r, (3,)) for r in range(d))
    b = sum(workers.draw(9, r, (2, 2)) for r in range(d))
    ints = torch.cat([torch.arange(3, dtype=torch.int32) + 10 * r for r in range(d)])
    for res in ranks:
        assert torch.equal(res["all_reduce_flat"][0], a)
        assert torch.equal(res["all_reduce_flat"][1], b)
        assert torch.equal(res["gather_int"], ints)


def test_the_world_and_the_transport_on_the_cpu(comm_results):
    d, ranks = comm_results
    for r, res in enumerate(ranks):
        assert res["world"] == {"rank": r, "world_size": d, "local_rank": r, "device": "cpu",
                                "backend": "gloo", "ranks_per_card": 0}
        # CPU tensors are never staged; the comm layer counted its calls
        assert not any(res["staged"].values())
        assert res["stats"]["calls"] >= 7 and res["stats"]["staged_bytes"] == 0


def test_a_failing_rank_ends_the_launch(tmp_path):
    """A target that raises on rank 1: the launch returns its exit code,
    and rank 0, waiting in a barrier for it, is stopped."""
    t0 = time.monotonic()
    code = multihost.launch(2, "torch_rank_workers:fail_on_rank_1", [], device="cpu",
                            store_dir=tmp_path, threads=1, pythonpath=[TESTS], timeout=120)
    assert code == 1 and time.monotonic() - t0 < 60
    assert list(tmp_path.iterdir()) == []  # the rendezvous is gone


def test_staging_follows_backend_and_device():
    """gloo takes CUDA tensors for all_reduce and broadcast; the others
    are staged through the host. CPU tensors are never staged."""
    comm = object.__new__(Comm)
    comm.backend = "gloo"
    cuda_like = type("T", (), {"is_cuda": True})()
    assert [comm.stages(c, cuda_like) for c in ("all_reduce", "broadcast", "all_gather",
                                                "reduce_scatter", "ring_hop")] == [
        False, False, True, True, True]
    assert not comm.stages("all_gather", torch.zeros(1))
    comm.backend = "nccl"
    assert not comm.stages("all_gather", cuda_like)


def graph_arrays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    edges = np.unique(np.sort(np.stack([a[a != b], b[a != b]], 1), 1), axis=0)
    return edges, tsp.coo_arrays(edges, n, "sym")


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("n", [101, 96])
def test_pieces_equal_jax_element_for_element(ndev, n):
    edges, arrays = graph_arrays(n, seed=n + ndev)
    jop = jsp.sparse_sym_operator(edges, n)
    for key in ("row", "col", "val", "col_perm"):
        np.testing.assert_array_equal(arrays[key], np.asarray(getattr(jop, key)))
    jmesh_ = jmesh.make_mesh(ndev)
    rcv = (arrays["row"], arrays["col"], arrays["val"])

    got = mesh.shard_sparse_arrays(*rcv, n, ndev)
    want = jmesh.shard_sparse_op(jop, jmesh_)
    for key in ("row", "col", "val", "col_perm"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(want, key)).reshape(ndev, -1))

    got, n_pad = mesh.node_shard_arrays(*rcv, n, ndev)
    want, want_pad = jmesh.node_shard_sparse_op(jop, jmesh_)
    assert n_pad == want_pad and want.n == n_pad // ndev and want.n_true == n
    for key in ("row", "col", "val", "col_perm"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(want, key)).reshape(ndev, -1))

    got, n_pad = mesh.ring_shard_arrays(*rcv, n, ndev)
    want, want_pad = jmesh.ring_shard_sparse_op(jop, jmesh_)
    assert n_pad == want_pad
    for key in ("row", "col", "val"):
        np.testing.assert_array_equal(got[key].reshape(ndev * ndev, -1),
                                      np.asarray(getattr(want, key)))

    x = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        mesh.shard_node_array(x, n_pad, ndev).reshape(n_pad, 3),
        np.asarray(jmesh.shard_node_array(x, jmesh_, n_pad)))


def test_a_runner_outside_a_group_of_its_size_raises(tmp_path):
    cfg = {"seed": 1, "save_dir": str(tmp_path),
           "dataset": {"source": "synthetic_edges", "num_nodes": 50, "num_class": 3,
                       "feat_dim": 4},
           "model": {"name": "GCN", "hidden_dim": [4]},
           "train": {"num_devices": 2, "shard": "nodes"}}
    with pytest.raises(RuntimeError, match="not inside a process group"):
        SparseCitationRunner(cfg, "cpu")
    with pytest.raises(ValueError, match="train.shard must be one of"):
        SparseCitationRunner({**cfg, "train": {"num_devices": 2, "shard": "rows"}}, "cpu")


@pytest.mark.parametrize("runner,train", [
    (QM8Runner, {"tp": 4}), (QM8Runner, {"num_devices": 4}),
    (CitationRunner, {"num_devices": 2}), (CitationRunner, {"shard": "nodes"}),
    (SparseCitationRunner, {"tp": 2}),
])
def test_a11b_options_are_refused(tmp_path, runner, train):
    """A11b is done: ``QM8Runner`` runs ``tp`` and ``num_devices`` and
    ``CitationRunner`` ``num_devices`` (node rows), so outside a process
    group of the run's size they raise. An option the runner's JAX
    counterpart never reads raises ``ValueError``: the dense runner's
    ``shard`` (it shards node rows only) and the sparse runner's ``tp``."""
    cfg = {"seed": 1, "save_dir": str(tmp_path), "dataset": {}, "model": {"name": "GCN"},
           "train": {"batch_size": 64, **train}}
    if "num_devices" in train or runner is QM8Runner:
        with pytest.raises(RuntimeError, match="not inside a process group"):
            runner(cfg, "cpu")
        return
    with pytest.raises(ValueError, match=f"train.{next(iter(train))}.*shards"):
        runner(cfg, "cpu")


def test_remat_replays_a_runners_dropout_generator():
    """Under ``torch.utils.checkpoint`` a dropout that draws from a
    generator of its own (a sharded runner's) draws the same mask in the
    recomputation as in the forward through ``replaying``, so the
    gradient is that of no remat; without it the mask differs."""
    from torch.utils.checkpoint import checkpoint

    from lanczosnet_torch.models.base import Dropout
    from lanczosnet_torch.models.sparse_nodes import replaying

    drop = Dropout(0.5).train()
    drop.generator = torch.Generator()

    def layer(x):
        return drop(x * x)

    grads = {}
    for mode in ("none", "replaying", "plain"):
        drop.generator.manual_seed(0)
        x = torch.linspace(1.0, 2.0, 64, requires_grad=True)
        fn = {"none": layer, "replaying": replaying(layer, drop.generator), "plain": layer}[mode]
        y = fn(x) if mode == "none" else checkpoint(fn, x, use_reentrant=False)
        y.sum().backward()
        grads[mode] = x.grad
    assert torch.equal(grads["replaying"], grads["none"])
    assert not torch.equal(grads["plain"], grads["none"])
