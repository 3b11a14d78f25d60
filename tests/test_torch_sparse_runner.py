"""The port's ``SparseCitationRunner`` on the CPU: remat, refusals,
training narrowed Pubmed configs, resume, ``-t``, the CLI, and a run
the JAX package's sparse runner trained.

Tolerances: gradients under each ``train.remat`` mode equal those
without remat exactly (the backward recomputes the same operations in
the same order, the dropout masks replayed from the saved RNG state);
the test accuracy of ``-t`` equals the run's own exactly (the same
checkpoint, the same eval); a JAX run's test accuracy is repeated by
the port on its ``best.msgpack`` within 1e-6, with its eval-mode logits
within 1e-4.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lanczosnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from lanczosnet_tpu.train.runner import build_runner as jax_build_runner
from lanczosnet_tpu.utils.config import AttrDict
from lanczosnet_torch import cli
from lanczosnet_torch.train import runner as runner_mod
from lanczosnet_torch.train.runner import build_runner
from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner
from lanczosnet_torch.utils.config import dumps, load_config

REPO = Path(__file__).resolve().parents[1]


def small_config(save_dir, name="GCN", **train) -> dict:
    model = {"name": name, "hidden_dim": [16, 16], "dropout": 0.5, "num_eig_vec": 6,
             "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5],
             "filter_hidden_dim": 8}
    return {
        "exp_name": "sparse", "runner": "SparseCitationRunner", "seed": 11,
        "save_dir": str(save_dir),
        "dataset": {"source": "synthetic_edges", "num_nodes": 300, "num_class": 4,
                    "feat_dim": 12, "avg_degree": 4.0},
        "model": model,
        "train": {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4, "max_epoch": 4,
                  "patience": 40, "display_iter": 1, **train},
        "test": {"test_model": None},
    }


def events(run_dir: Path, event: str) -> list[dict]:
    recs = [json.loads(ln) for ln in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [r for r in recs if r["event"] == event]


def one_step_grads(runner: SparseCitationRunner) -> dict:
    """The loss and parameter gradients of one training step (dropout on,
    the runner's generator seeded), through ``make_train_step``'s forward."""
    opt = torch.optim.SGD(runner.model.parameters(), lr=0.0)
    runner.dropout_generator.manual_seed(5)
    loss = runner.make_train_step(opt)()
    grads = {k: p.grad.clone() for k, p in runner.model.named_parameters()}
    return {"loss": loss, **grads}


@pytest.mark.parametrize("name,modes", [("GCN", ["full", "dots", "layers"]),
                                        ("LanczosNet", ["full", "dots", "layers"]),
                                        ("GAT", ["full", "dots"]),
                                        ("AdaLanczosNet", ["full"])])
def test_remat_modes_give_the_gradients_of_no_remat(tmp_path, name, modes):
    want = one_step_grads(SparseCitationRunner(small_config(tmp_path / "none", name), "cpu"))
    for mode in modes:
        runner = SparseCitationRunner(small_config(tmp_path / mode, name, remat=mode), "cpu")
        assert runner.model.remat_layers == (mode == "layers")
        got = one_step_grads(runner)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (mode, key)


@pytest.mark.parametrize("train,error,match", [
    ({"remat": "everything"}, ValueError, "train.remat must be"),
    ({"remat": "layers"}, ValueError, "no per-layer remat"),
    ({"num_devices": 2}, RuntimeError, "not inside a process group"),
    ({"num_devices": 2, "shard": "rows"}, ValueError, "train.shard must be one of"),
    ({"tensorboard": True}, None, None),
])
def test_refused_options(tmp_path, train, error, match):
    """``train.tensorboard`` was refused (A12) until the mirror was ported;
    it is accepted now and the runner's metrics reach TensorBoard."""
    if error is None:
        runner = SparseCitationRunner(small_config(tmp_path, "GAT", **train), "cpu")
        runner.metrics.log("epoch", epoch=0, loss=1.0)
        assert runner.metrics.tensorboard and any((tmp_path / "tb").iterdir())
        return
    with pytest.raises(error, match=match):
        SparseCitationRunner(small_config(tmp_path, "GAT", **train), "cpu")


def test_jax_only_and_off_options_are_accepted(tmp_path):
    cfg = small_config(tmp_path, num_devices=1, prng_impl="rbg", remat="none", max_epoch=1)
    assert SparseCitationRunner(cfg, "cpu").remat is None


def test_the_runner_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseCitationRunner(small_config(tmp_path))


def pubmed_config(tmp_path, config: str, **train) -> dict:
    """``configs/<config>.yaml`` with the graph at 5% of Pubmed's nodes,
    hidden [16, 16] and a few epochs."""
    cfg = load_config(str(REPO / "configs" / f"{config}.yaml"))
    return {**cfg, "save_dir": str(tmp_path / "run"),
            "dataset": {**cfg["dataset"], "scale": 0.05},
            "model": {**cfg["model"], "hidden_dim": [16, 16]},
            "train": {**cfg["train"], "display_iter": 1, **train}}


@pytest.mark.parametrize("config", ["pubmed_sparse_gcn", "pubmed_sparse_lanczos_net"])
def test_runner_trains_resumes_and_tests_a_pubmed_config(tmp_path, config):
    cfg = pubmed_config(tmp_path, config, max_epoch=6, snapshot_epoch=3)
    runner = SparseCitationRunner(cfg, "cpu")
    assert runner.op.n == 985 and runner.op.rows_sorted
    if config.endswith("lanczos_net"):
        vals, vecs = runner.extras
        assert vals.shape == (20,) and vecs.shape == (985, 20) and torch.isfinite(vecs).all()
    trained = runner.train()
    losses = [r["loss"] for r in events(runner.run_dir, "train")]
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0]
    ckpt = runner.run_dir / "checkpoints"
    best = json.loads((ckpt / "best.meta.json").read_text())
    assert best["val_acc"] == trained["best_val_acc"] and (ckpt / "latest.pt").exists()
    assert json.loads((ckpt / "latest.meta.json").read_text())["epoch"] == 5
    # -t on the best checkpoint repeats the run's test accuracy
    assert SparseCitationRunner(cfg, "cpu").test()["test_acc"] == trained["test_acc"]
    # resume: the run goes on from epoch 6 to 8
    resumed = SparseCitationRunner({**cfg, "train": {**cfg["train"], "is_resume": True,
                                                      "max_epoch": 8}}, "cpu")
    resumed.train()
    assert [r["epoch"] for r in events(runner.run_dir, "train")][-2:] == [6, 7]


def test_cli_routes_the_sparse_runner(tmp_path, monkeypatch):
    monkeypatch.setitem(runner_mod.RUNNER_REGISTRY, "SparseCitationRunner",
                        lambda config, device=None: SparseCitationRunner(config, "cpu"))
    cfg = {k: v for k, v in small_config("unused").items() if k != "save_dir"}
    cfg["exp_dir"] = str(tmp_path / "exp")
    path = tmp_path / "sparse.yaml"
    path.write_text(dumps(cfg))
    assert cli.main(["-c", str(path)]) == 0
    (run,) = (tmp_path / "exp").glob("sparse/*_train")
    (trained,) = events(run, "test")
    cfg["test"] = {"test_model": str(run / "checkpoints" / "best.pt")}
    path.write_text(dumps(cfg))
    assert cli.main(["-c", str(path), "-t"]) == 0
    (test_run,) = (tmp_path / "exp").glob("sparse/*_test")
    (tested,) = events(test_run, "test")
    assert tested["acc"] == trained["acc"]
    runner = build_runner({**small_config(tmp_path / "b")}, "cpu")
    assert isinstance(runner, SparseCitationRunner)


@pytest.mark.parametrize("name", ["GCN", "LanczosNet"])
def test_a_jax_sparse_run_restores_into_the_port(tmp_path, name):
    cfg = small_config(tmp_path / "jax", name, max_epoch=2)
    jax_runner = jax_build_runner(AttrDict.convert(cfg))
    jax_result = jax_runner.train()
    msgpack = tmp_path / "jax" / "checkpoints" / "best.msgpack"
    assert msgpack.exists()
    port_cfg = {**cfg, "save_dir": str(tmp_path / "port"), "test": {"test_model": str(msgpack)}}
    port = SparseCitationRunner(port_cfg, "cpu")
    assert port.test()["test_acc"] == pytest.approx(jax_result["test_acc"], abs=1e-6)
    # the restored weights give the JAX model's logits
    tx, _ = jax_build_optimizer(AttrDict.convert(cfg["train"]), 1)
    state = jax_runner.ckpt.restore("best", jax_runner.init_train_state(tx))
    want = np.asarray(jax_runner._apply(state.params, jax_runner.x, jax_runner.op,
                                        jax_runner.extras, True))
    with torch.no_grad():
        port.model.eval()
        got = port.forward().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # warm start from the same file
    warm = {**port_cfg, "save_dir": str(tmp_path / "warm"),
            "train": {**cfg["train"], "resume_model": str(msgpack), "max_epoch": 1}}
    assert 0.0 <= SparseCitationRunner(warm, "cpu").train()["test_acc"] <= 1.0


def test_the_tensor_parallel_config_raises_naming_a11b(tmp_path):
    """``qm8_lanczos_net_tp4`` runs on 4 ranks since A11b's first half
    (``tests/test_torch_tensor_parallel.py`` runs it narrowed through the
    CLI); outside a group of 4 it raises before anything is built."""
    cfg = {**load_config(str(REPO / "configs" / "qm8_lanczos_net_tp4.yaml")),
           "save_dir": str(tmp_path)}
    with pytest.raises(RuntimeError, match="not inside a process group"):
        build_runner(cfg, "cpu")


SHARDED_CONFIGS = ("million_sparse_gcn_sharded", "million_sparse_gcn_node_sharded",
                   "million_sparse_gcn_ring", "ten_million_sparse_lanczos_net_ring")


@pytest.fixture(scope="module")
def built_on_two_ranks(tmp_path_factory):
    """The four sharded sparse configs as written but for two ranks (of
    8) and 3000 nodes (of 1M and 10M), each built by both ranks of one
    group, one step taken."""
    from lanczosnet_torch.parallel import multihost
    from torch_rank_workers import read_ranks

    tmp = tmp_path_factory.mktemp("sharded_configs")
    cfgs = []
    for name in SHARDED_CONFIGS:
        cfg = load_config(str(REPO / "configs" / f"{name}.yaml"), make_run_dir=False)
        cfgs.append({**cfg, "save_dir": str(tmp / name),
                     "dataset": {**cfg["dataset"], "num_nodes": 3000},
                     "train": {**cfg["train"], "num_devices": 2}})
    (tmp / "spec.json").write_text(json.dumps(cfgs))
    code = multihost.launch(2, "torch_rank_workers:build_configs",
                            [str(tmp / "spec.json"), str(tmp)], device="cpu", store_dir=tmp,
                            threads=1, pythonpath=[str(REPO / "tests")], timeout=300)
    assert code == 0
    return read_ranks(tmp, 2)


@pytest.mark.parametrize("config", SHARDED_CONFIGS)
def test_the_sharded_sparse_configs_build_on_two_ranks(built_on_two_ranks, config):
    """Each rank holds its piece of the graph in the config's form and
    takes a finite step; LanczosNet's sharded Ritz values are the same on
    both ranks."""
    rank0, rank1 = (res[config] for res in built_on_two_ranks)
    shard = {"million_sparse_gcn_sharded": "edges", "million_sparse_gcn_node_sharded": "nodes"
             }.get(config, "nodes_ring")
    for r, res in enumerate((rank0, rank1)):
        assert res["shard"] == shard and res["world"]["rank"] == r
        assert res["kind"] == ("RingOp" if shard == "nodes_ring" else "SparseOp")
        assert res["rows"] == (3000 if shard == "edges" else 1500)
        assert res["n"] == res["rows"] and np.isfinite(res["loss"])
    assert rank0["loss"] == rank1["loss"]
    if config.startswith("ten_million"):
        assert rank0["dtype"] == "torch.bfloat16" and len(rank0["ritz_val"]) == 20
        assert rank0["ritz_val"] == rank1["ritz_val"]
