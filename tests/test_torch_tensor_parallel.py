"""``QM8Runner``'s data and tensor parallelism, on the CPU.

The rule: through ``weights.py``'s maps the port cuts exactly the leaves
that ``lanczosnet_tpu/parallel/mesh.py:tp_state_sharding`` cuts on the
2 × 4 CPU mesh, each of the nine models, and rank t's block equals the
JAX shard of mesh column t element for element (no processes).

Then real ranks (``parallel/multihost.py:launch``, gloo, one thread a
rank; ``tests/torch_rank_workers.py:mesh_cases``), two launches:

- eight ranks at dp=2 × tp=4: two Adam steps of GCN and LanczosNet
  (dropout 0) against the port's one-device steps and the JAX step on
  the 8-device CPU mesh, losses 1e-5 relative and parameters rtol 1e-4 /
  atol 1e-6 (the JAX test's tolerances); each rank's replicated leaves
  bit-equal across its tp group; each rank's parameter and Adam-moment
  bytes those the rule predicts; the seven other models (and
  LanczosNet's ``sum_dense``) one SGD step against one device; LanczosNet
  with dropout 0.1, which matches only if the ranks draw one device's
  masks; the global-norm clip (SGD at lr 0, so the gradients after the
  step are the clipped ones); bfloat16 (finite, 1e-2 relative); the
  column-parallel ``FusedChannelDense``; and the runner through
  ``cli.run`` in each rank (train, ``-t``, resume);
- four ranks: resident epochs with the device shuffle at dp=4 against
  one device (the counterpart of ``tests/test_parallel.py:79``),
  bfloat16 at dp=4 (loss 1e-4 relative), the runner at tp=4, and the
  runner over size buckets with paired steps at dp=2 × tp=2.

A run's checkpoint is the one-device format: a one-device ``QM8Runner``
and ``Predictor.from_run_dir`` test it to the ranks' test MAE (1e-6).
Last ``python -m lanczosnet_torch.cli`` on ``qm8_lanczos_net_tp4``
narrowed starts its 4 ranks itself.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_workers as workers
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.parallel.mesh import (
    MODEL_AXIS,
    make_mesh2d,
    shard_batch,
    batch_sharding,
    tp_state_sharding,
)
from lanczosnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from lanczosnet_tpu.train.step import TrainState
from lanczosnet_tpu.train.step import make_train_step as jax_make_train_step
from lanczosnet_torch import cli
from lanczosnet_torch.data.dataset import pack_dataset
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.parallel import multihost
from lanczosnet_torch.parallel.mesh import mesh_shape
from lanczosnet_torch.parallel.tensor import predicted_state_bytes, shard_state_dict, state_plan
from lanczosnet_torch.serve import Predictor
from lanczosnet_torch.train.runner import QM8Runner
from lanczosnet_torch.utils.config import dumps, loads
from lanczosnet_torch.weights import STATE_DICT_MAPS
from test_torch_dense_models import CONFIGS, batch_for, flax_params, jax_batch, model_config

TESTS = str(Path(__file__).resolve().parent)
REPO = Path(__file__).resolve().parents[1]
MODELS = tuple(CONFIGS)
NUM, N_MAX = 16, 12


def port_weights(name: str, **overrides) -> tuple[dict, dict, dict, dict]:
    """(the port's model config, its weights, the batch arrays, the flax
    params) of ``name`` at narrow width, the weights drawn for flax."""
    cfg, kind = model_config(name, "narrow", **overrides)
    b = batch_for(cfg, kind, NUM, N_MAX)
    params = flax_params(jax_build_model(cfg), jax_batch(b))
    port_cfg = {**cfg, "num_edge_type": b["ops"].shape[1] - 1,
                "node_feat_dim": b["node_feat"].shape[-1]}
    arrays = {k: b[k] for k in ("atom_type", "node_feat", "ops", "mask", "label", "ritz_val",
                                "ritz_vec", "cluster")}
    return port_cfg, STATE_DICT_MAPS[name](params), arrays, params


# ---------------------------------------------------------------- the rule
@pytest.mark.parametrize("name", MODELS)
def test_the_rule_cuts_the_leaves_jax_shards(name):
    cfg, weights, _, params = port_weights(name)
    mesh = make_mesh2d(4, 8)
    placed = jax.device_put(params, tp_state_sharding(params, mesh))
    model = build_model(cfg)
    model.load_state_dict(weights)
    plan = state_plan(model, 4)
    cut = sum(leaf.axis is not None for leaf in plan)
    specs = jax.tree.leaves(jax.tree.map(lambda x: x.sharding.spec, placed),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert cut == sum(MODEL_AXIS in spec for spec in specs) > 0
    assert cut < len(plan)  # some leaf of every model stays whole
    jax_bytes = 0
    for t in range(4):
        device = mesh.devices[0, t]
        shards = jax.tree.map(lambda x: next(np.asarray(s.data) for s in x.addressable_shards
                                             if s.device == device), placed)
        want = STATE_DICT_MAPS[name](shards)
        got = shard_state_dict(plan, weights, 4, t)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (key, t)
        if t == 0:
            jax_bytes = sum(a.nbytes for a in jax.tree.leaves(shards))
    # params, Adam's mu and nu: one shape, one sharding
    assert predicted_state_bytes(plan, 4) == 3 * jax_bytes


def test_mesh_shape_is_the_jax_runners():
    assert mesh_shape(64, 0, 4) == (1, 4)  # the tp4 config as written
    assert mesh_shape(64, 8, 4) == (2, 4)
    assert mesh_shape(64, 6, 4) == (1, 4)  # two devices left out
    assert mesh_shape(64, 4) == (4, 1)
    assert mesh_shape(64, 0) == (1, 1)  # one device unless asked
    assert mesh_shape(12, 8) == (6, 1)  # the largest divisor of the batch
    with pytest.raises(ValueError, match="train.tp=4 needs at least 4 devices"):
        mesh_shape(64, 2, 4)


# ---------------------------------------------------------------- the ranks
def adam(lr=1e-3, **kw) -> dict:
    return {"optimizer": "Adam", "lr": lr, **kw}


# Adam's first step is lr·g/(|g| + 1e-8): where a gradient is rounding
# noise (AdaLanczosNet's kernel-embedding bias, which the Gaussian kernel
# cancels) the noise decides it; an SGD step is linear in the gradient
SGD = {"optimizer": "SGD", "lr": 0.1}


def case(key, name, mesh, steps=1, train=None, seed=3, **overrides) -> dict:
    cfg, weights, arrays, params = port_weights(name, **{"dropout": 0.0, **overrides})
    valid = np.ones(NUM, np.float32)
    return {"key": key, "kind": "train", "mesh": mesh, "model": cfg, "weights": weights,
            "batch": arrays, "valid": valid, "train": train or adam(), "steps": steps,
            "seed": seed, "flax": params}


def fused_case(mesh) -> dict:
    rng = np.random.default_rng(5)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dims = (4, 3, 8)  # in_dim, channels, out
    return {"key": "fused", "kind": "fused", "mesh": mesh, "dims": dims,
            "weights": {"weight": torch.from_numpy(draw(8, 16)), "bias": torch.from_numpy(draw(8))},
            "h": draw(2, 5, 4), "stack": draw(2, 3, 5, 5), "cotangent": draw(2, 5, 8)}


def resident_split():
    graphs = synthetic_qm8_graphs(36, seed=4, n_lo=4, n_hi=10)
    return pack_dataset(graphs, n_max=12, num_eig_vec=8, standardize=True, device="cpu")


def qm8_config(exp_dir, name: str, **train) -> dict:
    """``configs/qm8_lanczos_net_tp4.yaml`` narrowed: 48/16/16 graphs of at
    most 12 nodes, hidden [16, 16], K=6, batch 16, 2 epochs."""
    cfg = loads((REPO / "configs" / "qm8_lanczos_net_tp4.yaml").read_text())
    cfg["exp_name"], cfg["exp_dir"] = name, str(exp_dir)
    cfg["dataset"].update(num_train=48, num_val=16, num_test=16, n_max=12, pack_cache=False)
    cfg["model"].update(hidden_dim=[16, 16], embed_dim=16, num_eig_vec=6,
                        long_diffusion_dist=[3, 5], filter_hidden_dim=8)
    cfg["train"].update({"batch_size": 16, "max_epoch": 2, "display_iter": 1,
                         "snapshot_epoch": 1, **train})
    return cfg


def cycle_spec(tmp, name: str, **train) -> str:
    cfg = {**qm8_config(tmp / "exp", name, **train), "save_dir": str(tmp / name),
           "run_id": "r", "is_test": False}
    (tmp / name).mkdir()
    path = tmp / f"{name}.yaml"
    path.write_text(dumps(cfg))
    (tmp / name / "config.yaml").write_text(dumps(cfg))
    return str(path)


def bucketed_spec(tmp, name: str, **train) -> str:
    """``qm8_config`` in size buckets [8, 12], paired steps at batch 6."""
    cfg = {**qm8_config(tmp / "exp", name, bucket_pair=True, batch_size=6, **train),
           "save_dir": str(tmp / name)}
    cfg["dataset"]["buckets"] = [8, 12]
    path = tmp / f"{name}.yaml"
    path.write_text(dumps(cfg))
    return str(path)


def launch(tmp, world: int, cases: list, cycle: str, bucketed: str | None = None) -> list[dict]:
    spec = tmp / f"spec{world}.pt"
    torch.save({"cases": [{k: v for k, v in c.items() if k != "flax"} for c in cases],
                "cycle": cycle, "bucketed": bucketed}, spec)
    out = tmp / f"out{world}"
    out.mkdir()
    code = multihost.launch(world, "torch_rank_workers:mesh_cases", [str(spec), str(out)],
                            device="cpu", store_dir=tmp, threads=1, pythonpath=[TESTS],
                            timeout=300)
    assert code == 0
    return workers.read_ranks(out, world)


EIGHT = (2, 4)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """The dp=2 × tp=4 cases on eight ranks and on one device."""
    tmp = tmp_path_factory.mktemp("eight")
    cases = [case("GCN", "GCN", EIGHT, steps=2), case("LanczosNet", "LanczosNet", EIGHT, steps=2),
             *[case(m, m, EIGHT, train=SGD) for m in MODELS if m not in ("GCN", "LanczosNet")],
             case("sum_dense", "LanczosNet", EIGHT, train=SGD, sum_dense=True),
             case("dropout", "LanczosNet", EIGHT, steps=2, dropout=0.1),
             case("clip", "LanczosNet", EIGHT, train={"optimizer": "SGD", "lr": 0.0,
                                                      "grad_clip": 0.05}),
             case("bf16", "LanczosNet", EIGHT, dtype="bfloat16"),
             fused_case(EIGHT)]
    ranks = launch(tmp, 8, cases, cycle_spec(tmp, "dp2_tp4", num_devices=8))
    one = {c["key"]: workers.CASES[c["kind"]](c) for c in cases}
    return {c["key"]: c for c in cases}, ranks, one, tmp


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """Resident epochs and bfloat16 at dp=4, the runner at tp=4."""
    tmp = tmp_path_factory.mktemp("four")
    cfg, weights, _, _ = port_weights("LanczosNet")
    resident = {"key": "resident", "kind": "resident", "mesh": (4, 1), "model": cfg,
                "weights": weights, "split": resident_split(), "batch_size": 8, "epochs": 2,
                "train": adam(1e-2), "seed": 7}
    resident["model"] = {**cfg, "dropout": 0.1}
    cases = [resident, case("bf16_dp", "LanczosNet", (4, 1), steps=2, dtype="bfloat16")]
    ranks = launch(tmp, 4, cases, cycle_spec(tmp, "tp4"),
                   bucketed_spec(tmp, "bucketed", num_devices=4, tp=2))
    one = {c["key"]: workers.CASES[c["kind"]](c) for c in cases}
    return {c["key"]: c for c in cases}, ranks, one, tmp


def assert_params_close(got: dict, want: dict, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(workers.as_numpy(got[k]), workers.as_numpy(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def jax_mesh_steps(c: dict) -> tuple[list, dict]:
    """The JAX train step on the 2 × 4 CPU mesh, from the case's flax
    params: (losses, parameters in the port's names)."""
    model = jax_build_model({k: v for k, v in c["model"].items()
                             if k not in ("num_edge_type", "node_feat_dim")})
    tx, _ = jax_build_optimizer(c["train"], 1)
    params = jax.tree.map(jnp.asarray, c["flax"])
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    mesh = make_mesh2d(4, 8)
    state = jax.device_put(state, tp_state_sharding(state, mesh))
    batch = shard_batch(jax.tree.map(jnp.asarray, jax_batch(c["batch"])), mesh)
    valid = jax.device_put(jnp.asarray(c["valid"]), batch_sharding(mesh))
    step = jax_make_train_step(model, tx)
    losses = []
    for _ in range(c["steps"]):
        state, loss = step(state, batch, valid)
        losses.append(float(loss))
    got = STATE_DICT_MAPS[c["model"]["name"]](jax.tree.map(np.asarray, state.params))
    return losses, got


@pytest.mark.parametrize("key", ["GCN", "LanczosNet"])
def test_two_steps_at_dp2_tp4_match_one_device_and_the_jax_mesh(eight, key):
    cases, ranks, one, _ = eight
    want_losses, want_params = jax_mesh_steps(cases[key])
    for res in ranks:
        got = res[key]
        assert len(got["losses"]) == 2
        for a, b, c in zip(got["losses"], one[key]["losses"], want_losses):
            assert a == pytest.approx(b, rel=1e-5) and a == pytest.approx(c, rel=1e-5)
        assert_params_close(got["params"], one[key]["params"])
        assert_params_close(got["params"], want_params)


@pytest.mark.parametrize("key", [m for m in MODELS if m not in ("GCN", "LanczosNet")]
                         + ["sum_dense", "dropout"])
def test_a_step_at_dp2_tp4_matches_one_device(eight, key):
    _, ranks, one, _ = eight
    for res in ranks:
        for a, b in zip(res[key]["losses"], one[key]["losses"]):
            assert a == pytest.approx(b, rel=1e-5)
        assert_params_close(res[key]["params"], one[key]["params"])


def test_replicated_leaves_stay_bit_equal_across_the_tp_ranks(eight):
    cases, ranks, _, _ = eight
    for key in cases:
        if cases[key]["kind"] != "train":
            continue
        for d in range(2):
            group = [ranks[d * 4 + t][key] for t in range(4)]
            assert group[0]["replicated"], key  # every model keeps some leaf whole
            for other in group[1:]:
                for name, value in group[0]["replicated"].items():
                    assert torch.equal(other["replicated"][name], value), (key, name)


def test_each_rank_holds_the_rules_share_of_the_state(eight):
    cases, ranks, one, _ = eight
    for key in ("GCN", "LanczosNet", "dropout"):
        whole = one[key]["state_bytes"]
        for res in ranks:
            assert res[key]["state_bytes"] == res[key]["predicted_state_bytes"] < whole / 2
        assert one[key]["state_bytes"] == one[key]["predicted_state_bytes"]


def test_the_clip_takes_the_global_norm_over_the_tp_ranks(eight):
    _, ranks, one, _ = eight
    want = one["clip"]["grads"]
    norm = float(torch.sqrt(sum(g.pow(2).sum() for g in want.values())))
    assert norm == pytest.approx(0.05, rel=1e-4)  # the clip bound, so the clip acted
    for res in ranks:
        assert_params_close(res["clip"]["grads"], want, rtol=1e-4, atol=1e-7)


def test_bfloat16_under_tp_stays_near_one_device(eight):
    _, ranks, one, _ = eight
    for res in ranks:
        loss = res["bf16"]["losses"][0]
        assert np.isfinite(loss) and loss == pytest.approx(one["bf16"]["losses"][0], rel=1e-2)


def test_the_column_parallel_fused_channel_dense(eight):
    _, ranks, one, _ = eight
    want = one["fused"]
    for res in ranks:
        got = res["fused"]
        for k in ("out", "h_grad", "stack_grad"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5)
        assert_params_close(got["grads"], want["grads"], rtol=0, atol=1e-5)


def test_resident_epochs_with_device_shuffle_at_dp4_match_one_device(four):
    _, ranks, one, _ = four
    want = one["resident"]
    for res in ranks:
        got = res["resident"]
        assert got["losses"].shape == (8,)  # 36 graphs: 4 batches of 8 an epoch
        torch.testing.assert_close(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
        assert_params_close(got["params"], want["params"])
        assert got["count"] == want["count"] == 36.0
        torch.testing.assert_close(got["esum"], want["esum"], rtol=1e-5, atol=1e-5)


def test_bfloat16_under_dp_matches_one_device(four):
    _, ranks, one, _ = four
    for res in ranks:
        for a, b in zip(res["bf16_dp"]["losses"], one["bf16_dp"]["losses"]):
            assert np.isfinite(a) and a == pytest.approx(b, rel=1e-4)


def test_bucketed_paired_runner_at_dp2_tp2_matches_one_device(four):
    """Size buckets with paired steps at dp=2 × tp=2, batch 6: the half-
    batches of 3 do not divide over dp, so every dp rank takes each half
    whole and its loss is its share (the JAX runner replicates them).
    Every epoch's loss 1e-5 relative, the test MAE and ``-t`` 1e-6 from
    one device's run of the same config."""
    _, ranks, _, tmp = four
    cfg = loads((tmp / "bucketed.yaml").read_text())
    one_dir = tmp / "bucketed_one"
    one = QM8Runner({**cfg, "save_dir": str(one_dir),
                     "train": {**cfg["train"], "tp": 1, "num_devices": 1}}, "cpu")
    assert len(one.buckets("train")) == 2
    want = one.train()
    setup = events(tmp / "bucketed" / "metrics.rank1.jsonl", "setup")[0]
    assert (setup["dp"], setup["tp"]) == (2, 2)
    got = [r["loss"] for r in events(tmp / "bucketed" / "metrics.jsonl", "epoch")]
    np.testing.assert_allclose(got, [r["loss"] for r in events(one_dir / "metrics.jsonl", "epoch")],
                               rtol=1e-5)
    for res in ranks:
        assert res["bucketed"]["train"]["test_mae"] == pytest.approx(want["test_mae"], abs=1e-6)
        assert res["bucketed"]["test"]["test_mae"] == pytest.approx(want["test_mae"], abs=1e-6)


def events(path: Path, name: str) -> list[dict]:
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["event"] == name]


@pytest.mark.parametrize("fixture,mesh", [("four", (1, 4)), ("eight", (2, 4))],
                         ids=["tp4", "dp2_tp4"])
def test_the_runner_trains_tests_resumes_and_its_checkpoint_is_one_devices(
        request, fixture, mesh):
    cases, ranks, _, tmp = request.getfixturevalue(fixture)
    name = {"four": "tp4", "eight": "dp2_tp4"}[fixture]
    run = tmp / name
    for res in ranks:
        assert res["cycle"]["codes"] == {"train": 0, "test": 0, "resume": 0}
    epochs = events(run / "metrics.jsonl", "epoch")
    assert [r["epoch"] for r in epochs] == [0, 1, 2]  # 2 epochs, then 1 resumed
    assert all(np.isfinite(r["loss"]) for r in epochs)
    setup = events(run / "metrics.rank1.jsonl", "setup")[0]
    assert (setup["dp"], setup["tp"], setup["world_size"]) == (*mesh, mesh[0] * mesh[1])
    assert "(dp=%d tp=%d)" % mesh in (run / "run.log").read_text()
    tested = events(run / "metrics.jsonl", "test")
    train_end, retest = tested[0], tested[1]
    assert retest["mae"] == pytest.approx(train_end["mae"], abs=1e-6)
    assert train_end["state_bytes"] == train_end["predicted_state_bytes"]
    ckpt = str(run / "checkpoints")
    assert any(p.startswith(ckpt) for p in ranks[0]["cycle"]["writes"])
    assert not any(p.startswith(ckpt) for res in ranks[1:] for p in res["cycle"]["writes"])

    # the last best: the one-device format, for one device and the Predictor
    best = run / "checkpoints" / "best.pt"
    state = torch.load(best, weights_only=True)
    cfg = loads((tmp / f"{name}.yaml").read_text())
    one_cfg = {**cfg, "save_dir": str(tmp / f"{name}_one"),
               "train": {**cfg["train"], "tp": 1, "num_devices": 1},
               "test": {"test_model": str(best)}}
    runner = QM8Runner(one_cfg, "cpu")
    assert [n for n, _ in runner.model.named_parameters()] == list(state["model"])
    runner.model.load_state_dict(state["model"], strict=True)
    final = events(run / "metrics.jsonl", "test")[-1]["mae"]
    assert runner.test()["test_mae"] == pytest.approx(final, abs=1e-6)
    pred = Predictor.from_run_dir(run, batch_size=8, device="cpu")
    test = runner.datasets["test"]
    with torch.inference_mode():
        out = pred.model(test.slice_batch(np.arange(len(test)))).numpy()
    mae = np.abs(out - test.label).mean(0) * pred.stats.std
    assert float(mae.mean()) == pytest.approx(final, abs=1e-6)
    graphs = synthetic_qm8_graphs(16, seed=9, n_hi=12)  # the test split
    np.testing.assert_allclose(pred.predict(graphs), out * pred.stats.std + pred.stats.mean,
                               rtol=0, atol=1e-4)
    # the optimizer's state is one device's too: a one-device resume takes it
    resumed = QM8Runner({**one_cfg, "save_dir": str(run),
                         "train": {**one_cfg["train"], "is_resume": True, "max_epoch": 4}},
                        "cpu")
    assert np.isfinite(resumed.train()["test_mae"])


def test_the_cli_starts_the_tp4_configs_four_ranks(tmp_path):
    path = tmp_path / "tp4.yaml"
    path.write_text(dumps(qm8_config(tmp_path / "exp", "tp4_cli", max_epoch=1)))
    assert cli.num_ranks(loads(path.read_text())) == 4
    assert cli.main(["-c", str(path), "--device", "cpu"]) == 0
    (run,) = (tmp_path / "exp").glob("tp4_cli/*_train")
    log = (run / "run.log").read_text()
    assert "starting 4 ranks" in log and "(dp=1 tp=4)" in log and "4 ranks exited 0" in log
    assert sorted(p.name for p in run.glob("metrics.rank*.jsonl")) == [
        f"metrics.rank{r}.jsonl" for r in (1, 2, 3)]
