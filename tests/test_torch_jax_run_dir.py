"""Runs the JAX package trained, served and tested by the port, on the CPU.

A narrow GCN and a narrow LanczosNet are trained by the JAX runner for
one epoch (as ``tests/test_serve_http.py`` trains its models); the port
reads their ``config.yaml`` with its own YAML-subset reader and their
flax msgpack checkpoints with its own decoder. The port's ``Predictor.from_run_dir``
answers as the JAX package's within 1e-4 on both wires, ``ModelServer``
takes the run directory, and ``python -m lanczosnet_torch.cli -t`` with
``test.test_model`` at a ``.msgpack`` repeats the JAX run's test MAE
(1e-4). The decoder equals ``msgpack.unpackb`` and flax's
``msgpack_restore`` on flax's bytes.
"""

import json
import pathlib

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from lanczosnet_tpu.serve import Predictor as JaxPredictor
from lanczosnet_tpu.train.runner import build_runner as jax_build_runner
from lanczosnet_tpu.utils.config import AttrDict
from lanczosnet_tpu.utils.config import save_config as jax_save_config
from lanczosnet_torch import cli
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.serve import Predictor
from lanczosnet_torch.serve_http import ModelServer
from lanczosnet_torch.train import runner as runner_mod
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.flax_msgpack import msgpack_restore, unpackb
from lanczosnet_torch.train.runner import QM8Runner
from lanczosnet_torch.utils.config import dumps, loads
from tests.test_train import _runner_config

MODELS = {
    "GCN": {},
    "LanczosNet": {"num_eig_vec": 6, "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5]},
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{model name: run directory of the JAX runner}."""
    tmp = tmp_path_factory.mktemp("jax_runs")
    runs = {}
    for name, kw in MODELS.items():
        cfg = _runner_config(tmp, name, **kw)
        cfg.train.max_epoch = 1
        runs[name] = pathlib.Path(cfg.save_dir)
        runs[name].mkdir(parents=True)
        jax_save_config(cfg, runs[name] / "config.yaml")
        jax_build_runner(cfg).train()
    return runs


@pytest.fixture(scope="module")
def jax_predictors(jax_runs):
    return {name: JaxPredictor.from_run_dir(run, batch_size=8) for name, run in jax_runs.items()}


@pytest.mark.parametrize("scale", [1.0, 0.5], ids=["compact-wire", "float32-wire"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_serves_a_jax_run_as_the_jax_package_does(jax_runs, jax_predictors, name, scale):
    run = jax_runs[name]
    assert not list((run / "checkpoints").glob("*.pt"))
    port = Predictor.from_run_dir(run, batch_size=8, device="cpu")
    graphs = [{**g, "adj": g["adj"] * scale} for g in synthetic_qm8_graphs(11, seed=3, n_hi=10)]
    want = jax_predictors[name].predict(graphs)
    got = port.predict(graphs)
    assert got.shape == want.shape == (11, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_model_server_takes_a_jax_run(jax_runs, jax_predictors):
    srv = ModelServer.from_run_dirs({"gcn": jax_runs["GCN"]}, batch_size=8, device="cpu")
    try:
        graphs = synthetic_qm8_graphs(3, seed=4, n_hi=10)
        want = jax_predictors["GCN"].predict(graphs)
        np.testing.assert_allclose(srv.predict("gcn", graphs), want, atol=1e-4)
    finally:
        srv.close()


def test_cli_tests_a_jax_checkpoint(jax_runs, tmp_path, monkeypatch):
    monkeypatch.setenv("LANCZOSNET_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setitem(runner_mod.RUNNER_REGISTRY, "QM8Runner",
                        lambda config, device=None: QM8Runner(config, "cpu"))
    run = jax_runs["LanczosNet"]
    recs = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    (jax_test,) = [r for r in recs if r.get("event") == "test"]
    cfg = loads((run / "config.yaml").read_text())
    cfg = {k: v for k, v in cfg.items() if k != "save_dir"}
    cfg["exp_dir"] = str(tmp_path / "exp")
    cfg["test"] = {"test_model": str(run / "checkpoints" / "best.msgpack")}
    path = tmp_path / "jax_run_test.yaml"
    path.write_text(dumps(cfg))
    assert cli.main(["-c", str(path), "-t"]) == 0
    (test_run,) = (tmp_path / "exp").glob("*/*_test")
    recs = [json.loads(ln) for ln in (test_run / "metrics.jsonl").read_text().splitlines()]
    (tested,) = [r for r in recs if r["event"] == "test"]
    assert tested["mae"] == pytest.approx(jax_test["mae"], abs=1e-4)


def test_a_jax_checkpoint_needs_its_model_name(jax_runs):
    with pytest.raises(ValueError, match="model's name"):
        Checkpointer.restore_file(jax_runs["GCN"] / "checkpoints" / "best.msgpack")
    state = Checkpointer(jax_runs["GCN"]).restore("best", model_name="GCN")
    assert set(state) == {"model"} and "encoder.atom_embed.weight" in state["model"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decoder_equals_msgpack_and_flax_on_a_checkpoint(jax_runs, name):
    data = (jax_runs[name] / "checkpoints" / "best.msgpack").read_bytes()
    assert unpackb(data, ext_hook=msgpack.ExtType) == msgpack.unpackb(data)
    got, want = msgpack_restore(data), serialization.msgpack_restore(data)
    assert set(got) == set(want) >= {"params", "opt_state", "step"}
    flat_got = _leaves(got)
    flat_want = _leaves(want)
    assert flat_got.keys() == flat_want.keys()
    for key, w in flat_want.items():
        g = flat_got[key]
        assert np.asarray(g).dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)


def _leaves(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def test_decoder_covers_what_flax_writes():
    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3), "i64": np.array([-5, 2**40]),
        "u32": np.array([1, 2**32 - 1], np.uint32), "bf16": jnp.asarray([1.5, -2.0], jnp.bfloat16),
        "empty": np.zeros((0, 4), np.float32), "scalar": np.float32(2.5), "int_scalar": np.int32(-7),
        "c": complex(1.5, -2.0), "py": {"int": 3, "neg": -40000, "big": 2**63 - 1, "f": 0.25,
                                        "s": "x" * 40, "t": True, "n": None, "list": [1, "a", 2.0]},
        "long_list": list(range(40)), "many": {str(i): i for i in range(20)},
        "bytes": b"\x00\x01" * 200,
    }
    data = serialization.msgpack_serialize(tree)
    assert unpackb(data, ext_hook=msgpack.ExtType) == msgpack.unpackb(data)
    got, want = msgpack_restore(data), serialization.msgpack_restore(data)
    np.testing.assert_array_equal(got["bf16"], np.asarray(want["bf16"], np.float32))
    assert got["bf16"].dtype == np.float32
    for key in ("f32", "i64", "u32", "empty"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        np.testing.assert_array_equal(got[key], want[key])
    assert got["scalar"] == want["scalar"] == 2.5 and type(got["scalar"]) is np.float32
    assert got["int_scalar"] == -7 and got["c"] == want["c"] == complex(1.5, -2.0)
    assert got["py"] == want["py"] and got["long_list"] == want["long_list"]
    assert got["many"] == want["many"] and got["bytes"] == want["bytes"]


def test_decoder_refuses_chunked_arrays_unknown_ext_and_garbage():
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": [2],
                                   "chunks": {"0": 1}}})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        msgpack_restore(chunked)
    with pytest.raises(ValueError, match="ext type 9"):
        msgpack_restore(msgpack.packb({"w": msgpack.ExtType(9, b"xy")}))
    with pytest.raises(ValueError, match="after the msgpack object"):
        unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        unpackb(msgpack.packb("abcdef")[:-2])


def test_reader_takes_what_jax_save_config_writes(tmp_path):
    cfg = AttrDict.convert({
        "exp_name": "qm8_lanczos_net", "seed": 1234, "run_id": "20261017_013045_4242_train",
        "save_dir": "exp/qm8_lanczos_net/20261017_013045_4242_train", "is_test": False,
        "comment": "a note, with: punctuation", "dataset": {"n_max": 32, "source": "synthetic"},
        "model": {"hidden_dim": [128, 128], "name": "LanczosNet", "dropout": 0.1},
        "train": {"lr": 1.0e-3, "wd": 0.0, "lr_decay_epoch": [15, 25], "momentum": 0.9,
                  "resume_model": None, "tiny": 1e-8},
        "test": {"test_model": None},
    })
    jax_save_config(cfg, tmp_path / "config.yaml")
    text = (tmp_path / "config.yaml").read_text()
    assert "run_id: 20261017_013045_4242_train" in text  # safe_dump leaves it bare
    got, want = loads(text), yaml.safe_load(text)
    assert got == want == cfg.to_plain() and repr(got) == repr(want)


def test_checkpoints_map_to_a_model_that_runs(jax_runs):
    state = Checkpointer(jax_runs["LanczosNet"]).restore("best", model_name="LanczosNet")
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in state["model"].values())
