"""The port's QM8 training slice against the JAX package, on the CPU:
packed datasets, the reference-pickle importer, the batch loader, the
train and eval steps, the resident epochs, ``QM8Runner``, the CLI and
``Predictor.from_run_dir``.

Tolerances: packed arrays, labels and stats equal (the same numpy
code), operator stacks 1e-6 (the same float32 formula); Ritz pairs
through ``V diag(D) Vᵀ`` and ``V diag(D²) Vᵀ`` 1e-3 (two eigensolvers,
as in tests/test_torch_ops.py, on QM8 graphs where no β reaches noise
level); the masked MAE and the loss 1e-6; per-task error sums 1e-4 (16
graphs of outputs that agree to 1e-5); parameters after one SGD step
1e-5; after one Adam step 1e-5 where the gradient exceeds 1e-6, and
2·lr elsewhere (there Adam's first step ``lr·g/(|g| + 1e-8)`` is decided
by the gradient's rounding). Runs of the port against each other are
held to 1e-6.

Training comparisons feed both packages one packed split (the JAX
package's ``save_packed``, the port's ``load_packed``), so their Ritz
pairs are the same arrays.
"""

import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.data.dataset import load_packed as jax_load_packed
from lanczosnet_tpu.data.dataset import pack_dataset as jax_pack_dataset
from lanczosnet_tpu.data.dataset import save_packed as jax_save_packed
from lanczosnet_tpu.data.loader import BatchLoader as JaxBatchLoader
from lanczosnet_tpu.data.partition import spectral_partition_batch as jax_spectral_partition_batch
from lanczosnet_tpu.data.qm8 import import_reference_pickles as jax_import_reference_pickles
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from lanczosnet_tpu.train.step import TrainState
from lanczosnet_tpu.train.step import make_eval_step as jax_make_eval_step
from lanczosnet_tpu.train.step import make_train_step as jax_make_train_step
from lanczosnet_tpu.train.step import weighted_mae as jax_weighted_mae
from lanczosnet_torch import cli
from lanczosnet_torch.data.dataset import (
    LabelStats,
    load_packed,
    pack_dataset,
    save_packed,
)
from lanczosnet_torch.data.loader import BatchLoader, prefetch_to_device
from lanczosnet_torch.data.qm8 import import_reference_pickles, synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.models.base import set_dropout_generator
from lanczosnet_torch.serve import MicroBatcher, Predictor
from lanczosnet_torch.train import runner as runner_mod
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.runner import QM8Runner, build_runner
from lanczosnet_torch.train.scan_epoch import (
    ResidentEval,
    batch_at,
    device_dataset,
    gather_batch,
    host_permutation,
    shuffle_epoch,
    train_epoch,
)
from lanczosnet_torch.train.step import make_eval_step, make_train_step, weighted_mae
from lanczosnet_torch.utils.config import dumps
from lanczosnet_torch.utils.logger import MetricsLogger
from lanczosnet_torch.weights import lanczos_net_state_dict

FIELDS = ("atom_type", "node_feat", "ops", "mask", "label", "ritz_val", "ritz_vec")
SMALL_MODEL = {
    "name": "LanczosNet", "hidden_dim": [16, 16], "embed_dim": 16,
    "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5], "num_eig_vec": 6,
    "spectral_filter_kind": "MLP", "filter_hidden_dim": 8, "dropout": 0.1,
}


def recon(d: np.ndarray, v: np.ndarray, power: int = 1) -> np.ndarray:
    return np.einsum("bnk,bk,bmk->bnm", v, d**power, v)


@pytest.fixture(scope="module")
def shared_split(tmp_path_factory):
    """One split packed by the JAX package (16 graphs, N=16, K=6) and
    read by both packages from its npz."""
    path = tmp_path_factory.mktemp("packed") / "train.npz"
    graphs = synthetic_qm8_graphs(16, seed=11, n_lo=5, n_hi=14)
    jax_save_packed(jax_pack_dataset(graphs, n_max=16, num_eig_vec=6, standardize=True), path)
    return jax_load_packed(path), load_packed(path)


def jax_model_and_params(ds, cfg: dict):
    model = jax_build_model({**cfg, "num_atom": 8, "num_task": ds.label.shape[-1]})
    batch = jax.tree.map(jnp.asarray, ds.slice_batch(np.arange(len(ds))))
    params = model.init(jax.random.PRNGKey(0), batch, deterministic=True)["params"]
    return model, batch, params


def port_model(cfg: dict, params, num_task: int = 16):
    model = build_model({**cfg, "num_atom": 8, "num_task": num_task})
    model.load_state_dict(lanczos_net_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return model


# ---------------------------------------------------------------- packing
@pytest.mark.parametrize("kind,k,standardize", [("sym", 20, True), ("row", 0, False)])
def test_pack_dataset_equals_jax_and_npz_files_cross(tmp_path, kind, k, standardize):
    graphs = synthetic_qm8_graphs(8, seed=0) if k else synthetic_qm8_graphs(37, seed=4)
    want = jax_pack_dataset(graphs, n_max=32, operator_kind=kind, num_eig_vec=k,
                            standardize=standardize)
    got = pack_dataset(graphs, n_max=32, operator_kind=kind, num_eig_vec=k,
                       standardize=standardize, device="cpu")
    for f in ("atom_type", "node_feat", "mask", "label"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    np.testing.assert_allclose(got.ops, want.ops, rtol=0, atol=1e-6)
    assert got.ops.dtype == np.float32
    if standardize:
        np.testing.assert_array_equal(got.stats.mean, want.stats.mean)
        np.testing.assert_array_equal(got.stats.std, want.stats.std)
    else:
        assert got.stats is None and want.stats is None
    if k:
        assert got.ritz_val.shape == (8, k) and got.ritz_vec.shape == (8, 32, k)
        for power in (1, 2):
            np.testing.assert_allclose(recon(got.ritz_val, got.ritz_vec, power),
                                       recon(want.ritz_val, want.ritz_vec, power), atol=1e-3)
    else:
        assert got.ritz_val is None and want.ritz_val is None

    save_packed(got, tmp_path / "port.npz")
    jax_save_packed(want, tmp_path / "jax.npz")
    for mine, theirs in ((jax_load_packed(tmp_path / "port.npz"), got),
                         (load_packed(tmp_path / "jax.npz"), want)):
        for f in FIELDS:
            a, b = getattr(mine, f), getattr(theirs, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert (mine.stats is None) == (theirs.stats is None)
        if mine.stats is not None:
            np.testing.assert_array_equal(mine.stats.std, theirs.stats.std)


def test_pack_reuses_stats_chunks_ritz_and_refuses_what_is_not_ported(monkeypatch):
    graphs = synthetic_qm8_graphs(9, seed=2, n_hi=12)
    stats = LabelStats.fit(np.stack([g["label"] for g in synthetic_qm8_graphs(5, seed=1)]))
    ds = pack_dataset(graphs, n_max=16, stats=stats, standardize=True, num_eig_vec=4,
                      device="cpu")
    assert ds.stats is stats
    np.testing.assert_allclose(ds.label, stats.standardize(np.stack([g["label"] for g in graphs])),
                               rtol=0, atol=1e-6)
    # chunks of 4 graphs, the tail chunk padded: the same Ritz pairs as one chunk
    from lanczosnet_torch.data import dataset

    ops0, mask = torch.from_numpy(ds.ops[:, 0]), torch.from_numpy(ds.mask)
    d4, v4 = dataset._chunked_ritz(ops0, mask, 4, chunk=4)
    np.testing.assert_allclose(recon(d4, v4), recon(ds.ritz_val, ds.ritz_vec), atol=1e-4)
    batch = ds.slice_batch(np.array([3, 0, 3]))
    assert batch.ops.shape == (3, 5, 16, 16) and torch.equal(batch.atom_type[0], batch.atom_type[2])
    # GPNN's partition: channel 0 of the packed operators through the
    # JAX package's spectral partition, exactly
    parted = pack_dataset(graphs, n_max=16, num_cluster=2, device="cpu")
    np.testing.assert_array_equal(
        parted.cluster, jax_spectral_partition_batch(parted.ops[:, 0], parted.mask, 2))
    assert parted.cluster.dtype == np.int32 and parted.slice_batch(np.arange(2)).cluster.shape == (2, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_dataset(graphs, n_max=16)


def test_import_reference_pickles_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(6):
        n = int(rng.integers(3, 9))
        adj = (rng.random((4, n, n)) < 0.3).astype(np.float32)
        adj = np.maximum(adj, adj.transpose(0, 2, 1))
        atoms = rng.integers(0, 7, n)
        if i % 3 == 0:  # atom index in column 0 of node_feat, channels last
            feat = np.concatenate([atoms[:, None], rng.standard_normal((n, 3))], 1)
            recs.append({"node_feat": feat, "adj": np.moveaxis(adj, 0, -1), "label": rng.random(16)})
        elif i % 3 == 1:
            recs.append({"atoms": atoms, "A": adj, "target": rng.random((1, 16))})
        else:
            recs.append({"atom_type": atoms, "adj": adj[0], "y": rng.random(16)})
    path = tmp_path / "split.pkl"
    path.write_bytes(pickle.dumps(recs))
    got, want = import_reference_pickles(path), jax_import_reference_pickles(path)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert g[key].dtype == w[key].dtype, key
    path.write_bytes(pickle.dumps([{"atoms": [1, 2], "L": np.zeros((2, 2)), "y": [0.0]}]))
    for fn in (import_reference_pickles, jax_import_reference_pickles):
        with pytest.raises(ValueError, match="pre-normalized"):
            fn(path)


# ---------------------------------------------------------------- loader
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_loader_order_and_ghosts_equal_jax(shared_split, drop_last):
    jds, ds = shared_split
    jl = JaxBatchLoader(jds, batch_size=6, shuffle=True, drop_last=drop_last, seed=5)
    pl = BatchLoader(ds, batch_size=6, shuffle=True, drop_last=drop_last, seed=5)
    assert len(pl) == len(jl) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: the permutation stream advances alike
        got = list(prefetch_to_device(pl.epoch(), torch.device("cpu")))
        want = list(jl.epoch())
        assert len(got) == len(want)
        for (gb, gv), (wb, wv) in zip(got, want):
            np.testing.assert_array_equal(gv.numpy(), wv)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(gb, f).numpy(), getattr(wb, f), err_msg=f)
    if not drop_last:
        tail_batch, tail_valid = got[-1]
        assert tail_valid.tolist() == [1.0] * 4 + [0.0] * 2
        assert float(tail_batch.mask[4:].abs().sum()) == 0.0


# ---------------------------------------------------------------- steps
def test_weighted_mae_and_eval_sums_equal_jax(shared_split):
    rng = np.random.default_rng(1)
    pred, label = rng.standard_normal((2, 6, 16)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    want = float(jax_weighted_mae(jnp.asarray(pred), jnp.asarray(label), jnp.asarray(valid)))
    got = weighted_mae(torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(valid))
    assert float(got) == pytest.approx(want, abs=1e-6)
    assert float(weighted_mae(torch.from_numpy(pred), torch.from_numpy(label), torch.zeros(6))) == 0.0

    jds, ds = shared_split
    cfg = dict(SMALL_MODEL)
    jmodel, jbatch, params = jax_model_and_params(jds, cfg)
    jvalid = np.ones(len(jds), np.float32)
    jvalid[-3:] = 0.0
    we, wc = jax_make_eval_step(jmodel)(params, jbatch, jnp.asarray(jvalid))
    ge, gc = make_eval_step(port_model(cfg, params))(ds.slice_batch(np.arange(len(ds))),
                                                    torch.from_numpy(jvalid))
    assert float(gc) == float(wc) == len(jds) - 3
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=0, atol=1e-4)


@pytest.mark.parametrize("tcfg", [{"optimizer": "SGD", "lr": 0.1},
                                  {"optimizer": "Adam", "lr": 1e-3, "wd": 1e-4}],
                         ids=["sgd", "adam"])
def test_one_train_step_equals_jax(shared_split, tcfg):
    """From equal parameters with dropout 0, one step of the whole train
    step (forward, backward, coupled L2, SGD or Adam)."""
    jds, ds = shared_split
    cfg = {**SMALL_MODEL, "dropout": 0.0}
    jmodel, jbatch, params = jax_model_and_params(jds, cfg)
    port = port_model(cfg, params)  # before the JAX step, which donates params
    tx, _ = jax_build_optimizer(tcfg, 1)
    valid = np.ones(len(jds), np.float32)
    valid[-2:] = 0.0  # ghosts weigh nothing in either
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    state, jloss = jax_make_train_step(jmodel, tx)(state, jbatch, jnp.asarray(valid))
    want = lanczos_net_state_dict(jax.tree.map(np.asarray, state.params))

    before = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, scheduler, clip = build_optimizer(port.parameters(), tcfg)
    loss = make_train_step(port, optimizer, scheduler, clip)(
        ds.slice_batch(np.arange(len(ds))), torch.from_numpy(valid))
    assert float(loss) == pytest.approx(float(jloss), abs=1e-6)
    grads = {name: p.grad for name, p in port.named_parameters()}
    moved = 0.0
    for name, val in port.state_dict().items():
        err = (val - want[name]).abs()
        if tcfg["optimizer"] == "SGD":
            assert float(err.max()) <= 1e-5, name
        else:
            big = grads[name].abs() > 1e-6
            assert float((err * big).max()) <= 1e-5, name
            assert float(err.max()) <= 2 * tcfg["lr"], name
        moved = max(moved, float((val - before[name]).abs().max()))
    assert moved > 1e-4


# ---------------------------------------------------------------- resident epochs
def test_resident_epochs_equal_per_step_batches_step_for_step(shared_split):
    """Two epochs over the host's shuffle stream: the resident path's
    flat-gathered batches and the loader's batches give the same losses
    step for step and the same parameters (dropout on, one seed)."""
    _, ds = shared_split
    cfg = {**SMALL_MODEL, "dropout": 0.2}
    tcfg = {"optimizer": "Adam", "lr": 1e-2}
    runs = {}
    for path in ("per_step", "resident"):
        model = build_model({**cfg, "num_atom": 8, "num_task": 16})
        model.init_weights(torch.Generator().manual_seed(3))
        set_dropout_generator(model, torch.Generator().manual_seed(4))
        optimizer, scheduler, clip = build_optimizer(model.parameters(), tcfg, 3)
        step = make_train_step(model, optimizer, scheduler, clip)
        losses = []
        if path == "per_step":
            loader = BatchLoader(ds, batch_size=5, shuffle=True, drop_last=True, seed=9)
            for _ in range(2):
                losses += [step(b, v) for b, v in prefetch_to_device(loader.epoch(), "cpu")]
        else:
            rng = np.random.Generator(np.random.Philox(9))
            data = device_dataset(ds, torch.device("cpu"))
            for _ in range(2):
                perm = host_permutation(rng, len(ds), 5, torch.device("cpu"))
                batches = shuffle_epoch(data, perm)
                for s in range(perm.shape[0]):
                    want = gather_batch(data, perm[s])
                    for f in FIELDS:
                        assert torch.equal(getattr(batch_at(batches, s), f), getattr(want, f))
                losses += list(train_epoch(step, data, perm))
        runs[path] = (torch.stack(losses), model.state_dict())
    (la, sa), (lb, sb) = runs["per_step"], runs["resident"]
    assert la.shape == (6,) and torch.isfinite(la).all()
    torch.testing.assert_close(la, lb, rtol=0, atol=1e-6)
    for name in sa:
        torch.testing.assert_close(sa[name], sb[name], rtol=0, atol=1e-6)


def test_resident_eval_equals_the_loaders_exact_mae(shared_split):
    _, ds = shared_split
    model = build_model({**SMALL_MODEL, "num_atom": 8, "num_task": 16})
    model.init_weights(torch.Generator().manual_seed(0))
    step = make_eval_step(model)
    res = ResidentEval(device_dataset(ds, torch.device("cpu")), 6)
    assert res.idx.shape == (3, 6) and float(res.valid.sum()) == len(ds)
    esum, count = res(step)
    lsum, lcount = 0.0, 0.0
    for b, v in BatchLoader(ds, 6, shuffle=False).epoch():
        e, c = step(b, v)
        lsum, lcount = lsum + e, lcount + c
    assert float(count) == float(lcount) == len(ds)
    torch.testing.assert_close(esum, lsum, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- runner and CLI
def tiny_config(save_dir, **train) -> dict:
    return {
        "exp_name": "qm8_tiny", "runner": "QM8Runner", "seed": 1234, "save_dir": str(save_dir),
        "dataset": {"source": "synthetic", "name": "qm8", "n_max": 16, "num_atom": 8,
                    "num_train": 64, "num_val": 20, "num_test": 20, "standardize": True,
                    "operator_kind": "sym"},
        "train": {"optimizer": "Adam", "lr": 1e-3, "wd": 0.0, "batch_size": 16,
                  "max_epoch": 2, "lr_decay": 0.3, "lr_decay_epoch": [1], "valid_epoch": 1,
                  "display_iter": 2, "is_resume": False, **train},
        "test": {"test_model": None},
        "model": dict(SMALL_MODEL),
    }


@pytest.fixture
def pack_cache(tmp_path, monkeypatch):
    root = tmp_path / "pack_cache"
    monkeypatch.setenv("LANCZOSNET_TORCH_CACHE", str(root))
    return root


def events(run_dir: Path, name: str) -> list[dict]:
    recs = [json.loads(ln) for ln in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [r for r in recs if r["event"] == name]


def test_runner_trains_resumes_and_tests(tmp_path, pack_cache):
    run = tmp_path / "run"
    runner = QM8Runner(tiny_config(run, is_resume=True, snapshot_epoch=1), device="cpu")
    assert runner._scan_mode() and runner.model.num_eig_vec == 6
    assert [r["split"] for r in events(run, "pack")] == ["train", "val", "test"]
    res = runner.train()
    assert set(res) == {"best_val_mae", "test_mae"} and np.isfinite(res["test_mae"])
    epochs = events(run, "epoch")
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["graphs_per_sec"] > 0 for r in epochs)
    assert [r["epoch"] for r in events(run, "val")] == [0, 1]
    assert len(events(run, "val")[0]["per_task"]) == 16
    for tag in ("best", "latest", "epoch_0", "epoch_1"):
        assert runner.ckpt.exists(tag), tag
    meta = runner.ckpt.meta("latest")
    assert meta["epoch"] == 1 and meta["num_task"] == 16 and len(meta["label_std"]) == 16
    assert runner.ckpt.meta("best")["val_mae"] == pytest.approx(res["best_val_mae"])
    assert runner.test()["test_mae"] == pytest.approx(res["test_mae"], abs=1e-6)

    again = QM8Runner(tiny_config(run, is_resume=True, snapshot_epoch=1, max_epoch=3),
                      device="cpu")
    assert len(events(run, "pack")) == 3  # the second runner's packs came from the cache
    second = again.train()
    assert [r["epoch"] for r in events(run, "epoch")] == [0, 1, 2]  # resumed after epoch 1
    assert again.ckpt.meta("latest")["epoch"] == 2
    assert second["best_val_mae"] <= res["best_val_mae"] + 1e-12
    assert again.test()["test_mae"] == pytest.approx(second["test_mae"], abs=1e-6)

    other = QM8Runner({**tiny_config(tmp_path / "other"),
                       "test": {"test_model": str(run / "checkpoints" / "best.pt")}}, device="cpu")
    assert other.test()["test_mae"] == pytest.approx(second["test_mae"], abs=1e-6)
    warm = QM8Runner(tiny_config(tmp_path / "warm", max_epoch=1,
                                 resume_model=str(run / "checkpoints" / "best.pt")), device="cpu")
    assert np.isfinite(warm.train()["test_mae"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        QM8Runner(tiny_config(tmp_path / "empty"), device="cpu").test()


def test_runner_paths_agree_and_device_shuffle_trains(tmp_path, pack_cache):
    """Resident epochs on the host's shuffle stream and the per-step
    path give the same validation MAE every epoch (1e-6)."""
    vals = {}
    for name, train in {"resident": {"scan_epoch": True, "device_shuffle": False},
                        "per_step": {"scan_epoch": False},
                        "device_shuffle": {"scan_epoch": "auto"}}.items():
        res = QM8Runner(tiny_config(tmp_path / name, **train), device="cpu").train()
        vals[name] = [r["mae"] for r in events(tmp_path / name, "val")]
        assert len(vals[name]) == 2 and np.isfinite(res["test_mae"])
    np.testing.assert_allclose(vals["resident"], vals["per_step"], rtol=0, atol=1e-6)
    assert [r["step"] for r in events(tmp_path / "per_step", "train")] == [2, 4, 6, 8]


@pytest.mark.parametrize(
    "section,key,value,item",
    [("dataset", "buckets", [8, 16], "A12"), ("train", "bucket_pair", True, "A12"),
     ("train", "tp", 2, "A11"), ("train", "num_devices", 4, "A11"),
     ("train", "profile", True, "A12"), ("train", "tensorboard", True, "A12")],
)
def test_refused_options_name_their_roadmap_item(tmp_path, section, key, value, item):
    """``train.tp`` and ``train.num_devices`` run since A11b's first half
    (``tests/test_torch_tensor_parallel.py``): outside a process group of
    the mesh's size they raise. The A12 options raised naming their item
    until they were ported; each builds and trains now (``bucket_pair``
    over buckets [8, 16]), and leaves what it makes in the run
    directory."""
    cfg = tiny_config(tmp_path / "run")
    cfg[section] = {**cfg[section], key: value}
    if key in ("tp", "num_devices"):
        with pytest.raises(RuntimeError, match="not inside a process group"):
            QM8Runner(cfg, device="cpu")
        return
    assert item == "A12"
    if key == "bucket_pair":
        cfg["dataset"] = {**cfg["dataset"], "buckets": [8, 16]}
    runner = QM8Runner(cfg, device="cpu")
    assert np.isfinite(runner.train()["test_mae"])
    run = tmp_path / "run"
    if section == "dataset" or key == "bucket_pair":
        assert runner.bucketed and sorted(runner.buckets("train")) == [8, 16]
    if key == "profile":
        assert (run / "trace" / "trace.json").exists()
    if key == "tensorboard":
        assert runner.metrics.tensorboard and any((run / "tb").iterdir())


def test_refused_runners_and_sources(tmp_path):
    cfg = tiny_config(tmp_path / "run")
    with pytest.raises(RuntimeError, match="not inside a process group"):
        build_runner({**cfg, "runner": "SparseCitationRunner",
                      "train": {**cfg["train"], "num_devices": 2}}, "cpu")
    with pytest.raises(KeyError, match="unknown runner"):
        build_runner({**cfg, "runner": "Nope"}, "cpu")
    with pytest.raises(ValueError, match="unknown dataset source"):
        QM8Runner({**cfg, "dataset": {**cfg["dataset"], "source": "rdkit"}}, device="cpu")


def test_runner_reads_packed_and_reference_pickle_sources(tmp_path, pack_cache):
    graphs = {s: synthetic_qm8_graphs(n, seed=20 + i, n_hi=14)
              for i, (s, n) in enumerate((("train", 32), ("val", 16), ("test", 16)))}
    dcfg = {"n_max": 16, "num_atom": 8}
    stats = None
    for s, gs in graphs.items():
        ds = pack_dataset(gs, n_max=16, num_eig_vec=6, stats=stats, standardize=True,
                          device="cpu")
        stats = ds.stats
        save_packed(ds, tmp_path / f"{s}.npz")
        dcfg[f"{s}_path"] = str(tmp_path / f"{s}.npz")
        (tmp_path / f"{s}.pkl").write_bytes(pickle.dumps(
            [{"atoms": g["atom_type"] - 1, "adj": g["adj"], "label": g["label"]} for g in gs]))
    packed = QM8Runner({**tiny_config(tmp_path / "a"), "dataset": {**dcfg, "source": "packed"}},
                       device="cpu")
    pickled = QM8Runner({**tiny_config(tmp_path / "b"), "dataset": {
        "source": "reference_pickle", "n_max": 16, "num_atom": 8,
        **{f"{s}_path": str(tmp_path / f"{s}.pkl") for s in graphs}}}, device="cpu")
    for s in graphs:
        a, b = packed.datasets[s], pickled.datasets[s]
        np.testing.assert_array_equal(a.ops, b.ops)
        np.testing.assert_allclose(a.label, b.label, rtol=0, atol=1e-6)
    assert len(list(pack_cache.glob("packs/*/*.npz"))) == 3
    assert np.isfinite(packed.train()["test_mae"])


def write_yaml(path: Path, cfg: dict) -> Path:
    cfg = {k: v for k, v in cfg.items() if k != "save_dir"}
    path.write_text(dumps(cfg))
    return path


@pytest.fixture
def cpu_runners(monkeypatch):
    """The CLI has no device flag (nor has the JAX CLI): runs here get
    the CPU by patching the registry."""
    monkeypatch.setitem(runner_mod.RUNNER_REGISTRY, "QM8Runner",
                        lambda config, device=None: QM8Runner(config, "cpu"))


def test_cli_trains_then_tests_a_checkpoint(tmp_path, pack_cache, cpu_runners):
    exp = tmp_path / "exp"
    cfg = {**tiny_config("unused"), "exp_dir": str(exp)}
    assert cli.main(["-c", str(write_yaml(tmp_path / "qm8_tiny.yaml", cfg))]) == 0
    (run,) = exp.glob("qm8_tiny/*_train")
    assert (run / "config.yaml").exists() and "best val" in (run / "run.log").read_text()
    (trained,) = events(run, "test")
    cfg["test"] = {"test_model": str(run / "checkpoints" / "best.pt")}
    assert cli.main(["-c", str(write_yaml(tmp_path / "qm8_tiny_t.yaml", cfg)), "-t", "-m",
                     "retest"]) == 0
    (test_run,) = exp.glob("qm8_tiny/*_test")
    (tested,) = events(test_run, "test")
    assert tested["mae"] == pytest.approx(trained["mae"], abs=1e-6)


def test_cli_runs_the_citation_runner_of_a_cora_config(tmp_path, monkeypatch):
    from lanczosnet_torch.train.citation_runner import CitationRunner
    from lanczosnet_torch.utils.config import loads

    monkeypatch.setitem(runner_mod.RUNNER_REGISTRY, "CitationRunner",
                        lambda config, device=None: CitationRunner(config, "cpu"))
    cfg = loads((Path(__file__).resolve().parents[1] / "configs" / "cora_lanczos_net.yaml")
                .read_text())
    cfg["exp_dir"] = str(tmp_path / "exp")
    cfg["dataset"]["scale"] = 0.1
    cfg["train"]["max_epoch"] = 2
    assert cli.main(["-c", str(write_yaml(tmp_path / "cora.yaml", cfg))]) == 0
    (run,) = (tmp_path / "exp").glob("*/*_train")
    (rec,) = events(run, "test")
    assert 0.0 <= rec["acc"] <= 1.0


def test_cli_without_a_card_fails_and_says_why(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = tmp_path / "exp"
    cfg = {**tiny_config("unused"), "exp_dir": str(exp)}
    assert cli.main(["-c", str(write_yaml(tmp_path / "qm8_tiny.yaml", cfg))]) == 1
    (run,) = exp.glob("qm8_tiny/*_train")
    log = (run / "run.log").read_text()
    assert "run failed" in log and "no CUDA device" in log
    assert not (run / "checkpoints" / "best.pt").exists()


def test_predictor_from_run_dir_serves_the_trained_run(tmp_path, pack_cache, cpu_runners):
    exp = tmp_path / "exp"
    cfg = {**tiny_config("unused"), "exp_dir": str(exp)}
    assert cli.main(["-c", str(write_yaml(tmp_path / "qm8_tiny.yaml", cfg))]) == 0
    (run,) = exp.glob("qm8_tiny/*_train")
    pred = Predictor.from_run_dir(run, batch_size=8, device="cpu")
    meta = json.loads((run / "checkpoints" / "best.meta.json").read_text())
    np.testing.assert_array_equal(pred.stats.std, np.asarray(meta["label_std"]))
    assert pred.num_eig_vec == 6 and pred.num_task == 16

    graphs = synthetic_qm8_graphs(20, seed=9, n_hi=14)  # the tiny config's test split
    ds = pack_dataset(graphs, n_max=16, num_eig_vec=6, device="cpu")
    with torch.inference_mode():
        want = pred.model(ds.slice_batch(np.arange(20))).numpy() * pred.stats.std + pred.stats.mean
    np.testing.assert_allclose(pred.predict(graphs), want, rtol=0, atol=1e-4)
    mb = MicroBatcher(pred, max_delay_ms=2.0)
    try:
        served = np.stack([f.result(timeout=60) for f in [mb.submit(g) for g in graphs]])
        metrics = MetricsLogger(tmp_path / "serve" / "metrics.jsonl")
        stats = mb.log_stats(metrics)
        metrics.close()
    finally:
        mb.close()
    np.testing.assert_allclose(served, want, rtol=0, atol=1e-4)
    (rec,) = events(tmp_path / "serve", "serving_latency")
    assert rec["count"] == stats["count"] == 20


# the configs that train on the card since the dense models, the bf16 knob
# and QM8 AdaLanczosNet were ported (the flagship is trained above)
QM8_CONFIGS = ("qm8_gcn", "qm8_graph_sage", "qm8_dcnn", "qm8_chebynet", "qm8_gat", "qm8_mpnn",
               "qm8_gpnn", "qm8_lanczos_net_bf16", "qm8_ada_lanczos_net")


def narrowed(name: str, save_dir: Path) -> dict:
    """``configs/<name>.yaml`` with hidden 16 wide, 96/20/20 graphs of at
    most 16 nodes, batch 16, two epochs and no pack cache."""
    from lanczosnet_torch.utils.config import loads

    cfg = loads((Path(__file__).resolve().parents[1] / "configs" / f"{name}.yaml").read_text())
    m = cfg["model"]
    m["hidden_dim"] = [16] * min(len(m["hidden_dim"]), 2)
    if "embed_dim" in m:
        m["embed_dim"] = 16
    if "num_eig_vec" in m:
        m.update(num_eig_vec=6, long_diffusion_dist=[3, 5], filter_hidden_dim=8)
    cfg["dataset"].update(n_max=16, num_train=96, num_val=20, num_test=20, pack_cache=False)
    cfg["train"].update(batch_size=16, max_epoch=2, lr_decay_epoch=[5])
    cfg["save_dir"] = str(save_dir)
    return cfg


@pytest.mark.parametrize("name", QM8_CONFIGS)
def test_every_qm8_config_trains_and_serves_narrowed(tmp_path, name):
    from lanczosnet_torch.utils.config import save_config

    run = tmp_path / "run"
    cfg = narrowed(name, run)
    runner = QM8Runner(cfg, device="cpu")
    save_config(cfg, run / "config.yaml")  # as load_config does for the CLI
    res = runner.train()
    losses = [r["loss"] for r in events(run, "epoch")]
    assert len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0], losses
    assert all(np.isfinite(r["mae"]) for r in events(run, "val")) and np.isfinite(res["test_mae"])
    test = runner.datasets["test"]
    assert (test.cluster is not None) == (name == "qm8_gpnn")

    # served through the float32 wire (GPNN: with the partition it was
    # packed with) or the compact one, against the restored model on the pack
    pred = Predictor.from_run_dir(run, batch_size=8, device="cpu")
    assert pred.num_cluster == (2 if name == "qm8_gpnn" else 0)
    graphs = synthetic_qm8_graphs(20, seed=9, n_hi=16)  # the test split
    with torch.inference_mode():
        want = pred.model(test.slice_batch(np.arange(20))).numpy() * pred.stats.std + pred.stats.mean
    np.testing.assert_allclose(pred.predict(graphs), want, rtol=0, atol=1e-4)
