"""``CitationRunner``'s node-sharding, on the CPU.

The cut: ``parallel/mesh.py:shard_full_graph`` gives rank r exactly the
shard that ``lanczosnet_tpu/parallel/mesh.py:shard_full_graph`` places
on device r of a 4-device mesh, array for array (no processes).

Then one launch of 4 gloo ranks (``parallel/multihost.py:launch``, one
thread a rank; ``tests/torch_rank_workers.py:node_sharded_cases``), each
case also run on one device in this process:

- the nine models on synthetic Cora at scale 0.08 (N=216, 54 rows a
  rank), hidden [16], K=4, dropout 0.5, weights drawn for flax and
  carried by ``weights.py``: the eval logits within 1e-5 of the port on
  one device and of the JAX model on one device; the first
  Adam step's gradients within 1e-4 of each parameter's largest, and
  two steps' losses 1e-5 relative, which holds only if the ranks draw
  one device's dropout masks. AdaLanczosNet's ``kernel_embed.bias`` has
  an exact gradient of zero (a shift of every embedding leaves the
  distances as they were): both sides' must be rounding noise;
- the same on synthetic Citeseer at scale 0.08 (N=266, padded to 268:
  not a multiple of 4), dropout 0, the one device packed as the ranks
  pack (``pad_to`` 4) so that both take the same Ritz pairs;
- AdaLanczosNet's learned operator, gathered, within 1e-7 of one
  device's on both graphs;
- GCN and LanczosNet at dropout 0: the first step's loss within 1e-5
  (relative) of the JAX step on the 8-device CPU mesh
  (``shard_full_graph``), as ``tests/test_citation.py:113`` holds JAX
  to one device;
- LanczosNet in bfloat16 against one device's bfloat16, 2e-2;
- the runner through ``cli.run`` in each rank: AdaLanczosNet trains 3
  epochs with dropout on, its losses within 1e-5 of one device's; ``-t``
  and a resumed epoch; only rank 0 writes checkpoints, in the one-device
  format, which a one-device ``CitationRunner.test`` reads to the run's
  test accuracy (1e-6).

Last ``python -m lanczosnet_torch.cli`` on a citation config with
``train.num_devices: 4`` starts its 4 ranks itself.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_workers as workers
from lanczosnet_tpu.core.graph_batch import GraphBatch as JaxGraphBatch
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.parallel.mesh import make_mesh, replicate_sharding
from lanczosnet_tpu.parallel.mesh import shard_full_graph as jax_shard_full_graph
from lanczosnet_tpu.train.node_step import make_node_train_step as jax_make_node_train_step
from lanczosnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from lanczosnet_tpu.train.step import TrainState
from lanczosnet_torch import cli
from lanczosnet_torch.core.graph_batch import GraphBatch, NodeShard, row_eye
from lanczosnet_torch.parallel import mesh, multihost
from lanczosnet_torch.train.citation_runner import BATCH_FIELDS, CitationRunner
from lanczosnet_torch.utils.config import dumps, loads
from lanczosnet_torch.weights import STATE_DICT_MAPS
from test_torch_dense_models import flax_params

TESTS = str(Path(__file__).resolve().parent)
REPO = Path(__file__).resolve().parents[1]
WORLD = 4
MODELS = {
    "GCN": {}, "GraphSAGE": {}, "ChebyNet": {"poly_order": 2}, "DCNN": {"max_hop": 2},
    "GAT": {"num_heads": 2}, "MPNN": {"num_prop": 2}, "GPNN": {"num_partition": 2, "num_prop": 1},
    "LanczosNet": {"num_eig_vec": 4, "short_diffusion_dist": [1, 2],
                   "long_diffusion_dist": [3, 5], "filter_hidden_dim": 8},
    "AdaLanczosNet": {"num_eig_vec": 4, "kernel_dim": 8, "short_diffusion_dist": [1, 2],
                      "long_diffusion_dist": [3, 5], "filter_hidden_dim": 8},
}
CORA = {"source": "synthetic", "name": "cora", "scale": 0.08}  # N=216
CITESEER = {"source": "synthetic", "name": "citeseer", "scale": 0.08}  # N=266 → 268
# gradients whose exact value is zero: rounding noise on either side
ZERO_GRADS = {("AdaLanczosNet", "kernel_embed.bias")}


def model_cfg(name: str, **overrides) -> dict:
    return {"name": name, "hidden_dim": [16], "embed_dim": 16, "dropout": 0.5, **MODELS[name],
            **overrides}


def config(name: str, dataset=CORA, **model) -> dict:
    return {"exp_name": "node_sharded", "runner": "CitationRunner", "seed": 3,
            "dataset": dict(dataset), "model": model_cfg(name, **model),
            "train": {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4}, "test": {}}


def one_device_arrays(cfg: dict, tmp: Path) -> dict:
    """The one-device runner's packed batch as numpy."""
    runner = CitationRunner({**cfg, "save_dir": str(tmp)}, "cpu")
    return {f: None if getattr(runner.batch, f) is None else getattr(runner.batch, f).numpy()
            for f in BATCH_FIELDS} | {"train": runner.splits["train"].numpy()}


def jax_model(cfg: dict, num_class: int):
    return jax_build_model({**cfg["model"], "num_atom": 2, "num_task": num_class, "task": "node"})


def jax_batch(a: dict) -> JaxGraphBatch:
    return JaxGraphBatch(**{f: a[f] for f in BATCH_FIELDS})


def case(key: str, cfg: dict, tmp: Path, steps: int = 2, pad_to: int = 1) -> dict:
    """A case with weights drawn for the flax model and carried by
    ``weights.py``; the flax params and the batch ride along for the JAX
    side (they stay in this process)."""
    arrays = one_device_arrays(cfg, tmp / f"pack_{key}")
    num_class = int(arrays["node_label"].max()) + 1
    params = flax_params(jax_model(cfg, num_class), jax_batch(arrays))
    weights = STATE_DICT_MAPS[cfg["model"]["name"]](params)
    return {"key": key, "config": cfg, "weights": weights, "steps": steps, "pad_to": pad_to,
            "flax": params, "arrays": arrays, "num_class": num_class}


def cycle_config(tmp: Path) -> str:
    """AdaLanczosNet on Cora at scale 0.08, dropout 0.5, 3 epochs, with
    ``train.num_devices: 4``; written where ``cli.run`` reads it."""
    cfg = config("AdaLanczosNet")
    cfg.update(save_dir=str(tmp / "cycle"), run_id="r", is_test=False)
    cfg["train"].update(num_devices=WORLD, max_epoch=3, patience=10, display_iter=1,
                        snapshot_epoch=1)
    (tmp / "cycle").mkdir()
    path = tmp / "cycle.yaml"
    path.write_text(dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case on 4 ranks (one launch) and on one device."""
    tmp = tmp_path_factory.mktemp("node_sharded")
    cases = [case(f"cora_{m}", config(m), tmp) for m in MODELS]
    cases += [case(f"citeseer_{m}", config(m, CITESEER, dropout=0.0), tmp, pad_to=WORLD)
              for m in MODELS]
    cases += [case(f"jax_{m}", config(m, dropout=0.0), tmp, steps=1)
              for m in ("GCN", "LanczosNet")]
    cases.append(case("bf16", config("LanczosNet", dtype="bfloat16"), tmp))
    spec, out = tmp / "spec.pt", tmp / "out"
    keep = ("key", "config", "weights", "steps", "pad_to")
    torch.save({"cases": [{k: c[k] for k in keep} for c in cases],
                "cycle": cycle_config(tmp)}, spec)
    out.mkdir()
    code = multihost.launch(WORLD, "torch_rank_workers:node_sharded_cases", [str(spec), str(out)],
                            device="cpu", store_dir=tmp, threads=1, pythonpath=[TESTS],
                            timeout=300)
    assert code == 0
    ranks = workers.read_ranks(out, WORLD)
    one = {c["key"]: workers.node_case(c, tmp / f"one_{c['key']}") for c in cases}
    return {c["key"]: c for c in cases}, ranks, one, tmp


# ---------------------------------------------------------------- no processes
def test_shard_full_graph_gives_each_rank_the_jax_shard(tmp_path):
    """Rank r's piece is the shard JAX places on device r, for every
    array of a packed LanczosNet and GPNN graph, and the column vectors
    are whole."""
    dev_mesh = make_mesh(WORLD)
    for name in ("LanczosNet", "GPNN"):
        arrays = one_device_arrays(config(name), tmp_path / name)
        arrays = {k: v for k, v in arrays.items() if v is not None}
        n_pad = arrays["mask"].shape[1]
        placed = jax_shard_full_graph({k: jnp.asarray(v) for k, v in arrays.items()}, dev_mesh,
                                      n_pad)
        for r, device in enumerate(dev_mesh.devices.flat):
            piece = mesh.shard_full_graph(arrays, WORLD, r)
            assert piece["ops"].shape == (1, 2, n_pad // WORLD, n_pad)
            np.testing.assert_array_equal(piece["col.mask"], arrays["mask"])
            if name == "GPNN":
                np.testing.assert_array_equal(piece["col.cluster"], arrays["cluster"])
            for key, x in placed.items():
                (shard,) = [s.data for s in x.addressable_shards if s.device == device]
                np.testing.assert_array_equal(piece[key], np.asarray(shard), err_msg=key)
    with pytest.raises(ValueError, match="do not split over 4 ranks"):
        mesh.shard_full_graph({"mask": np.ones((1, 6), np.float32)}, WORLD, 0)


def test_row_eye_and_pair_mask_of_a_row_block():
    mask = torch.tensor([[1.0, 1.0, 1.0, 1.0, 1.0, 0.0]])
    whole = GraphBatch(atom_type=None, node_feat=None, ops=None, mask=mask)
    assert torch.equal(row_eye(whole), torch.eye(6))
    for r in range(3):
        rows = slice(2 * r, 2 * r + 2)
        block = GraphBatch(atom_type=None, node_feat=None, ops=None, mask=mask[:, rows],
                           shard=NodeShard(None, 2 * r, mask))
        assert block.n_max == 2 and block.n_nodes == 6
        assert torch.equal(row_eye(block), torch.eye(6)[rows])
        assert torch.equal(block.pair_mask(), whole.pair_mask()[:, rows])


# ---------------------------------------------------------------- the ranks
def assert_grads_close(name: str, got: dict, want: dict, rel: float = 1e-4):
    assert set(got) == set(want)
    for k, g in want.items():
        if (name, k) in ZERO_GRADS:
            noise = 1e-6 * max(float(v.abs().max()) for v in want.values())
            assert float(g.abs().max()) < noise and float(got[k].abs().max()) < noise, k
            continue
        scale = max(float(g.abs().max()), 1e-12)
        np.testing.assert_allclose(workers.as_numpy(got[k]) / scale, workers.as_numpy(g) / scale,
                                   rtol=0, atol=rel, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_sharded_logits_match_one_device_and_the_jax_model(run, name):
    cases, ranks, one, _ = run
    c = cases[f"cora_{name}"]
    want = one[c["key"]]["logits"]
    jax_logits = np.asarray(jax_model(c["config"], c["num_class"]).apply(
        {"params": c["flax"]}, jax_batch(c["arrays"]), deterministic=True))[0, :want.shape[0]]
    np.testing.assert_allclose(want.numpy(), jax_logits,
                               atol=1e-5)
    for res in ranks:
        got = res[c["key"]]["logits"]
        assert got.shape == want.shape == (216, c["num_class"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), jax_logits,
                                   atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_sharded_steps_with_dropout_match_one_device(run, name):
    _, ranks, one, _ = run
    key = f"cora_{name}"
    for r, res in enumerate(ranks):
        got = res[key]
        assert got["ops_shape"] == (1, 2, 216 // WORLD, 216)  # its rows only
        assert_grads_close(name, got["grads"], one[key]["grads"])
        assert got["losses"] == pytest.approx(one[key]["losses"], rel=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_a_graph_whose_nodes_do_not_split_evenly(run, name):
    """N=266 pads to 268 rows, 67 a rank: the diagonal's offset and the
    whole column vectors show here if they are wrong."""
    _, ranks, one, _ = run
    key = f"citeseer_{name}"
    want = one[key]
    for res in ranks:
        got = res[key]
        assert got["ops_shape"] == (1, 2, 67, 268) and got["logits"].shape[0] == 266
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), rtol=0,
                                   atol=1e-5)
        assert_grads_close(name, got["grads"], want["grads"])
        assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)


@pytest.mark.parametrize("graph", ["cora", "citeseer"])
def test_the_learned_operator_rows_equal_one_devices(run, graph):
    _, ranks, one, _ = run
    want = one[f"{graph}_AdaLanczosNet"]["learned_operator"]
    for res in ranks:
        got = res[f"{graph}_AdaLanczosNet"]["learned_operator"]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-7)


def jax_mesh_loss(c: dict) -> float:
    """The first loss of the JAX node step on the 8-device CPU mesh,
    from the case's flax params, on the graph the port packed."""
    model = jax_model(c["config"], c["num_class"])
    tx, _ = jax_build_optimizer(c["config"]["train"], 1)
    dev_mesh = make_mesh(8)
    params = jax.tree.map(jnp.asarray, c["flax"])
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    state = jax.tree.map(lambda x: jax.device_put(x, replicate_sharding(dev_mesh)), state)
    arrays = c["arrays"]
    batch = jax_shard_full_graph(jax.tree.map(jnp.asarray, jax_batch(arrays)), dev_mesh,
                                 arrays["mask"].shape[1])
    sup = jax.device_put(jnp.asarray(arrays["train"]), jax.sharding.NamedSharding(
        dev_mesh, jax.sharding.PartitionSpec(None, "data")))
    _, loss = jax_make_node_train_step(model, tx)(state, batch, sup)
    return float(loss)


@pytest.mark.parametrize("name", ["GCN", "LanczosNet"])
def test_the_first_step_matches_the_jax_mesh(run, name):
    cases, ranks, one, _ = run
    key = f"jax_{name}"
    want = jax_mesh_loss(cases[key])
    for res in ranks:
        assert res[key]["losses"][0] == pytest.approx(want, rel=1e-5)
    assert one[key]["losses"][0] == pytest.approx(want, rel=1e-5)


def test_bfloat16_matches_one_devices_bfloat16(run):
    _, ranks, one, _ = run
    want = one["bf16"]
    for res in ranks:
        got = res["bf16"]
        assert np.isfinite(got["losses"]).all()
        assert got["losses"] == pytest.approx(want["losses"], rel=2e-2)
        scale = float(want["logits"].abs().max())
        np.testing.assert_allclose(got["logits"].float().numpy() / scale,
                                   want["logits"].float().numpy() / scale, rtol=0, atol=2e-2)


def events(path: Path, name: str) -> list[dict]:
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["event"] == name]


def test_the_runner_trains_tests_resumes_and_its_checkpoint_is_one_devices(run):
    _, ranks, _, tmp = run
    run_dir = tmp / "cycle"
    for res in ranks:
        assert res["cycle"]["codes"] == {"train": 0, "test": 0, "resume": 0}
    ckpt = str(run_dir / "checkpoints")
    assert any(p.startswith(ckpt) for p in ranks[0]["cycle"]["writes"])
    assert not any(p.startswith(ckpt) for res in ranks[1:] for p in res["cycle"]["writes"])
    epochs = events(run_dir / "metrics.jsonl", "epoch")
    assert [e["epoch"] for e in epochs] == [0, 1, 2, 3]  # 3 epochs, then 1 resumed
    assert "devices=4" in (run_dir / "run.log").read_text()
    for r in range(1, WORLD):
        setup = events(run_dir / f"metrics.rank{r}.jsonl", "setup")[0]
        assert (setup["rank"], setup["world_size"], setup["rows"]) == (r, WORLD, 54)

    # one device, the same config: the same losses, dropout on
    cfg = loads((tmp / "cycle.yaml").read_text())
    one_cfg = {**cfg, "save_dir": str(tmp / "cycle_one"),
               "train": {**cfg["train"], "num_devices": 1}}
    runner = CitationRunner(one_cfg, "cpu")
    trained = runner.train()
    want = [e["loss"] for e in events(tmp / "cycle_one" / "metrics.jsonl", "epoch")]
    assert [e["loss"] for e in epochs[:3]] == pytest.approx(want, rel=1e-5)

    # the ranks' checkpoint, tested on one device
    tests = events(run_dir / "metrics.jsonl", "test")
    best = run_dir / "checkpoints" / "best.pt"
    state = torch.load(best, weights_only=True)
    assert list(state["model"]) == list(runner.model.state_dict())
    one_test = CitationRunner({**one_cfg, "save_dir": str(tmp / "cycle_one_t"),
                               "test": {"test_model": str(best)}}, "cpu").test()
    assert one_test["test_acc"] == pytest.approx(tests[-1]["acc"], abs=1e-6)
    assert tests[0]["acc"] == pytest.approx(trained["test_acc"], abs=1e-6)


def test_the_cli_starts_a_citation_configs_four_ranks(tmp_path):
    cfg = loads((REPO / "configs" / "cora_gcn.yaml").read_text())
    cfg["exp_dir"] = str(tmp_path / "exp")
    cfg["dataset"]["scale"] = 0.08
    cfg["model"].update(hidden_dim=[16], embed_dim=16)
    cfg["train"].update(num_devices=WORLD, max_epoch=2)
    path = tmp_path / "cora_gcn.yaml"
    path.write_text(dumps(cfg))
    assert cli.num_ranks(loads(path.read_text())) == WORLD
    assert cli.main(["-c", str(path), "--device", "cpu"]) == 0
    (run_dir,) = (tmp_path / "exp").glob("cora_gcn/*_train")
    log = (run_dir / "run.log").read_text()
    assert "starting 4 ranks" in log and "devices=4" in log and "4 ranks exited 0" in log
    assert sorted(p.name for p in run_dir.glob("metrics.rank*.jsonl")) == [
        f"metrics.rank{r}.jsonl" for r in (1, 2, 3)]
