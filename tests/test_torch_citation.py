"""The port's citation data, node steps, optimizer, checkpoints and
``CitationRunner`` against the JAX package, on the CPU.

Tolerances: generated graphs are equal (the same numpy Philox stream);
packed operators 1e-6 (the same float32 formula); Ritz reconstructions
1e-3 (two eigensolvers); the cross-entropy 1e-6; parameters after one
Adam step with weight decay 1e-5; learning rates 1e-9 relative.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import chip_smoke
from lanczosnet_tpu.data.citation import (
    PRESETS as JAX_PRESETS,
    pack_citation as jax_pack_citation,
    synthetic_citation_graph as jax_synthetic_citation_graph,
)
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.train.node_step import masked_ce_loss as jax_masked_ce_loss
from lanczosnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from lanczosnet_torch.data.citation import PRESETS, pack_citation, synthetic_citation_graph
from lanczosnet_torch.models import build_model
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.citation_runner import CitationRunner
from lanczosnet_torch.train.node_step import (
    make_node_eval_step,
    make_node_train_step,
    masked_ce_loss,
)
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.utils.logger import MetricsLogger
from lanczosnet_torch.weights import ada_lanczos_net_state_dict

REPO = Path(__file__).resolve().parents[1]

SMALL_ADA = {
    "name": "AdaLanczosNet", "hidden_dim": [16, 16], "embed_dim": 16, "kernel_dim": 8,
    "use_graph_support": True, "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5],
    "num_eig_vec": 8, "spectral_filter_kind": "MLP", "lanczos_impl": "auto",
    "dropout": 0.5, "task": "node",
}


def runner_config(save_dir, model=None, **train) -> dict:
    return {
        "exp_name": "cit", "runner": "CitationRunner", "seed": 1234, "save_dir": str(save_dir),
        "dataset": {"source": "synthetic", "name": "cora", "scale": 0.1, "operator_kind": "sym"},
        "model": dict(model or SMALL_ADA),
        "train": {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4, "max_epoch": 5,
                  "patience": 40, "display_iter": 1, **train},
        "test": {"test_model": None},
    }


@pytest.mark.parametrize("name,scale", [("cora", 0.1), ("citeseer", 0.05), ("pubmed", 0.01)])
def test_synthetic_citation_graph_equals_jax(name, scale):
    assert PRESETS == JAX_PRESETS
    want = jax_synthetic_citation_graph(name, seed=7, scale=scale)
    got = synthetic_citation_graph(name, seed=7, scale=scale)
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(val).dtype, key


@pytest.mark.parametrize("pad_to,kind", [(1, "sym"), (8, "row")])
def test_pack_citation_equals_jax(pad_to, kind):
    graph = synthetic_citation_graph("cora", seed=7, scale=0.1)
    want, want_splits = jax_pack_citation(graph, pad_to=pad_to, operator_kind=kind, num_eig_vec=6)
    got, got_splits = pack_citation(
        graph, pad_to=pad_to, operator_kind=kind, num_eig_vec=6, device="cpu"
    )
    for field in ("atom_type", "node_feat", "mask", "label", "node_label"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )
    np.testing.assert_allclose(got.ops.numpy(), np.asarray(want.ops), atol=1e-6)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got_splits[split].numpy(), want_splits[split])
    assert got.cluster is None and got.mask.shape[1] % pad_to == 0
    assert got.ritz_val.shape == (1, 6) and got.ritz_vec.shape == (1, got.n_max, 6)
    if kind == "sym":  # Lanczos is defined for a symmetric operator only
        recon = lambda d, v: np.einsum("bnk,bk,bmk->bnm", v, d, v)
        np.testing.assert_allclose(
            recon(got.ritz_val.numpy(), got.ritz_vec.numpy()),
            recon(np.asarray(want.ritz_val), np.asarray(want.ritz_vec)), atol=1e-3,
        )
    # GPNN's partition rides along (held to the JAX package in
    # tests/test_torch_citation_import.py)
    clustered, _ = pack_citation(graph, num_cluster=4, device="cpu")
    assert clustered.cluster.shape == clustered.mask.shape
    assert set(clustered.cluster.unique().tolist()) <= {0, 1, 2, 3}


def test_masked_ce_loss_and_eval_step_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((1, 40, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (1, 40)).astype(np.int32)
    sup = (rng.random((1, 40)) < 0.3).astype(np.float32)
    want = float(jax_masked_ce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(sup)))
    got = masked_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(sup))
    assert float(got) == pytest.approx(want, abs=1e-6)
    none = masked_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.zeros(1, 40))
    assert float(none) == 0.0

    class Fixed(torch.nn.Module):
        def forward(self, batch):
            return torch.from_numpy(logits)

    batch = type("B", (), {"node_label": torch.from_numpy(labels)})()
    correct, count, ce = make_node_eval_step(Fixed())(batch, torch.from_numpy(sup))
    assert float(count) == sup.sum() and float(ce) == pytest.approx(want, abs=1e-6)
    assert float(correct) == float(((logits.argmax(-1) == labels) * sup).sum())


def test_one_adam_step_with_weight_decay_matches_optax():
    """From equal parameters, with dropout 0, one step of the whole train
    step (forward, adjoint backward, coupled L2, Adam) gives equal
    parameters to 1e-5. Adam's first step is ``lr·g/(|g| + 1e-8)``, so
    where the gradient itself is below 1e-6 its rounding decides the
    step; those entries (under 5% of them) are held to ``lr`` only."""
    graph = synthetic_citation_graph("cora", seed=7, scale=0.1)
    jbatch, jsplits = jax_pack_citation(graph, pad_to=1)
    cfg = {**SMALL_ADA, "dropout": 0.0, "num_atom": 2, "num_task": 7}
    tcfg = {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4}
    flax_model = jax_build_model(cfg)
    params = flax_model.init(jax.random.PRNGKey(0), jbatch, deterministic=True)["params"]
    tx, _ = jax_build_optimizer(tcfg, 1)
    grads = jax.grad(lambda p: jax_masked_ce_loss(
        flax_model.apply({"params": p}, jbatch, deterministic=True),
        jbatch.node_label, jsplits["train"],
    ))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    l2_grads = jax.tree.map(lambda g, p: np.asarray(g + tcfg["wd"] * p), grads, params)
    tiny = {k: v.abs() < 1e-6 for k, v in ada_lanczos_net_state_dict(l2_grads).items()}
    want = ada_lanczos_net_state_dict(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))

    batch, splits = pack_citation(graph, pad_to=1, device="cpu")
    port = build_model({**cfg, "num_edge_type": 1, "node_feat_dim": batch.node_feat.shape[-1]})
    port.load_state_dict(ada_lanczos_net_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, scheduler, clip = build_optimizer(port.parameters(), tcfg)
    loss = make_node_train_step(port, optimizer, scheduler, clip)(batch, splits["train"])
    assert torch.isfinite(loss) and clip is None
    moved = 0.0
    for name, val in port.state_dict().items():
        err = (val - want[name]).abs()
        assert float((err * ~tiny[name]).max()) <= 1e-5, name
        assert float(err.max()) <= tcfg["lr"], name
        moved = max(moved, float((val - before[name]).abs().max()))
    assert moved > 5e-3  # Adam's first step is about lr in every entry with a gradient
    assert sum(int(t.sum()) for t in tiny.values()) < 0.05 * sum(t.numel() for t in tiny.values())


@pytest.mark.parametrize(
    "tcfg,steps_per_epoch",
    [
        ({"lr": 0.1, "lr_decay": 0.5, "lr_decay_epoch": [2, 2, 5]}, 1),
        ({"lr": 0.1, "lr_decay": 0.1, "lr_decay_epoch": [1, 3]}, 3),
        ({"lr": 0.2, "lr_decay": 0.3, "lr_decay_steps": [4, 4, 4, 6], "optimizer": "SGD",
          "momentum": 0.9, "wd": 1e-3, "grad_clip": 2.0}, 7),
        ({"lr": 0.05}, 1),
    ],
    ids=["compounding", "per-epoch-steps", "sgd-steps", "constant"],
)
def test_lr_schedule_matches_optax(tcfg, steps_per_epoch):
    _, schedule = jax_build_optimizer(tcfg, steps_per_epoch)
    w = torch.nn.Parameter(torch.ones(3))
    optimizer, scheduler, clip = build_optimizer([w], tcfg, steps_per_epoch)
    assert clip == tcfg.get("grad_clip")
    assert type(optimizer).__name__.lower() == tcfg.get("optimizer", "Adam").lower()
    for step in range(12):
        assert scheduler.get_last_lr()[0] == pytest.approx(float(schedule(step)), rel=1e-6), step
        w.grad = torch.ones(3)
        optimizer.step()
        scheduler.step()
    with pytest.raises(ValueError, match="optimizer"):
        build_optimizer([w], {"optimizer": "LBFGS"})


def test_sgd_momentum_with_weight_decay_and_clip_matches_optax():
    tcfg = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9, "wd": 1e-2, "grad_clip": 0.5}
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(5).astype(np.float32)
    gs = rng.standard_normal((3, 5)).astype(np.float32)
    tx, _ = jax_build_optimizer(tcfg, 1)
    params, state = jnp.asarray(w0), None
    state = tx.init(params)
    for g in gs:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer, scheduler, clip = build_optimizer([w], tcfg)
    for g in gs:
        w.grad = torch.from_numpy(g.copy())
        torch.nn.utils.clip_grad_norm_([w], clip)
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), atol=1e-5)


def test_checkpointer_round_trip(tmp_path):
    ckpt = Checkpointer(tmp_path)
    assert not ckpt.exists("best") and ckpt.meta("best") is None
    state = {"model": {"w": torch.arange(4.0)}, "optimizer": {"state": {}, "step": 3}}
    path = ckpt.save("best", state, {"epoch": 2, "val_acc": 0.5})
    assert path == tmp_path / "checkpoints" / "best.pt" and ckpt.exists("best")
    assert not list((tmp_path / "checkpoints").glob("*.tmp"))
    assert ckpt.meta("best") == {"epoch": 2, "val_acc": 0.5}
    back = ckpt.restore("best")
    assert torch.equal(back["model"]["w"], state["model"]["w"]) and back["optimizer"]["step"] == 3
    assert torch.equal(Checkpointer.restore_file(path)["model"]["w"], state["model"]["w"])
    ckpt.save("best", {"model": {"w": torch.zeros(4)}})
    assert float(ckpt.restore("best")["model"]["w"].sum()) == 0.0


def test_metrics_logger_appends_jsonl(tmp_path):
    log = MetricsLogger(tmp_path / "run" / "metrics.jsonl")
    log.log("train", epoch=0, loss=1.5)
    log.log("test", acc=0.25)
    log.close()
    recs = [json.loads(ln) for ln in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["event"] for r in recs] == ["train", "test"]
    assert recs[0]["loss"] == 1.5 and recs[1]["acc"] == 0.25 and "time" in recs[0]


def test_citation_runner_trains_checkpoints_resumes_and_tests(tmp_path):
    run = tmp_path / "run"
    runner = CitationRunner(runner_config(run, snapshot_epoch=2, is_resume=True), device="cpu")
    assert runner.n_pad == 270 and runner.model.lanczos_impl == "auto"
    res = runner.train()
    assert set(res) == {"best_val_acc", "test_acc"}
    assert 0.0 <= res["test_acc"] <= 1.0 and 0.0 <= res["best_val_acc"] <= 1.0
    assert runner.ckpt.exists("best") and runner.ckpt.exists("latest")
    assert runner.ckpt.meta("latest") == {"epoch": 3}
    recs = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if r["event"] == "train"]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert runner.test()["test_acc"] == pytest.approx(res["test_acc"], abs=1e-6)

    again = CitationRunner(runner_config(run, snapshot_epoch=2, is_resume=True, max_epoch=8),
                           device="cpu")
    second = again.train()
    recs = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    epochs = [r["epoch"] for r in recs if r["event"] == "train"]
    assert epochs == [0, 1, 2, 3, 4, 4, 5, 6, 7]  # resumed after the snapshot of epoch 3
    assert second["best_val_acc"] >= res["best_val_acc"] - 1e-6
    assert again.ckpt.meta("latest") == {"epoch": 7}

    best = run / "checkpoints" / "best.pt"
    other = CitationRunner(
        {**runner_config(tmp_path / "other"), "test": {"test_model": str(best)}}, device="cpu"
    )
    assert other.test()["test_acc"] == pytest.approx(second["test_acc"], abs=1e-6)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CitationRunner(runner_config(tmp_path / "empty"), device="cpu").test()


def test_citation_runner_learns_and_runs_lanczos_net(tmp_path):
    """30 epochs beat the class prior on validation (the bar of
    tests/test_citation.py), and ``cora_lanczos_net`` in small runs
    through the same runner with precomputed Ritz pairs."""
    cfg = runner_config(tmp_path / "ada", max_epoch=30, display_iter=10)
    res = CitationRunner(cfg, device="cpu").train()
    assert res["best_val_acc"] > 1.0 / 7 + 0.05
    lnet = {k: v for k, v in SMALL_ADA.items()
            if k not in ("kernel_dim", "use_graph_support", "lanczos_impl")}
    runner = CitationRunner(runner_config(tmp_path / "lnet", {**lnet, "name": "LanczosNet"}),
                            device="cpu")
    assert runner.batch.ritz_val.shape == (1, 8) and runner.batch.ritz_vec.shape == (1, 270, 8)
    assert 0.0 <= runner.train()["test_acc"] <= 1.0


def test_citation_runner_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CitationRunner(runner_config(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_citation(synthetic_citation_graph("cora", seed=7, scale=0.1))
    with pytest.raises(ValueError, match="synthetic or planetoid"):
        cfg = runner_config(tmp_path / "run")
        CitationRunner({**cfg, "dataset": {**cfg["dataset"], "source": "rdkit"}}, device="cpu")


@pytest.mark.parametrize(
    "section,key,value,item",
    [("dataset", "buckets", [8, 16], "A12"), ("train", "bucket_pair", True, "A12"),
     ("train", "tp", 2, "A11"), ("train", "num_devices", 2, "A11"),
     ("train", "profile", True, "A12"), ("train", "tensorboard", True, "A12")],
)
def test_refused_options_name_their_roadmap_item(tmp_path, section, key, value, item):
    """Options raise before anything is built, as in ``QM8Runner``. Since
    A11b ``train.num_devices`` runs (outside a process group of its size
    it raises), and ``train.tp``, which the JAX runner never reads,
    raises ``ValueError``: the dense runner shards node rows only. Of
    A12, the JAX citation runner never reads ``dataset.buckets``,
    ``train.bucket_pair`` or ``train.profile``, which raise ``ValueError``
    now (``train/unported.py:NOT_READ``); it mirrors its metrics into
    TensorBoard, and so does the port."""
    cfg = runner_config(tmp_path / "run")
    cfg[section] = {**cfg.get(section, {}), key: value}
    if key == "num_devices":
        with pytest.raises(RuntimeError, match="not inside a process group"):
            CitationRunner(cfg, device="cpu")
        return
    if key == "tp":
        with pytest.raises(ValueError, match="train.tp.*shards node rows only"):
            CitationRunner(cfg, device="cpu")
        return
    assert item == "A12"
    if key == "tensorboard":
        runner = CitationRunner(cfg, device="cpu")
        runner.metrics.log("epoch", epoch=0, loss=1.0)
        assert runner.metrics.tensorboard and any((tmp_path / "run" / "tb").iterdir())
        return
    with pytest.raises(ValueError, match=f"{section}.{key}.*only the QM8 runner reads it"):
        CitationRunner(cfg, device="cpu")


def test_jax_only_and_off_options_are_accepted(tmp_path):
    cfg = runner_config(tmp_path / "run", max_epoch=1, prng_impl="threefry2x32", num_devices=1,
                        tensorboard=False, profile=False, tp=1)
    assert 0.0 <= CitationRunner(cfg, device="cpu").train()["test_acc"] <= 1.0


def test_chip_smoke_literals_equal_the_cora_yaml():
    cfg = yaml.safe_load((REPO / "configs" / "cora_ada_lanczos_net.yaml").read_text())
    assert chip_smoke.CORA_ADA_MODEL == cfg["model"]
    assert chip_smoke.CORA_ADA_DATASET == cfg["dataset"]
    assert chip_smoke.CORA_ADA_TRAIN == cfg["train"]
    assert chip_smoke.CORA_ADA_SEED == cfg["seed"]
    smoke = chip_smoke.citation_config("unused")
    assert smoke["model"] == cfg["model"] and smoke["dataset"] == cfg["dataset"]
    cut = {k: v for k, v in smoke["train"].items() if cfg["train"].get(k) != v}
    assert set(cut) == {"max_epoch", "display_iter"}  # depth cut, every epoch logged
