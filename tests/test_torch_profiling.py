"""``utils/profiling.py``, the runner's profile hooks and the TensorBoard
mirror of ``MetricsLogger``, on the CPU.

The mirror is held to the JAX package's ``MetricsLogger``: the same
``log`` calls to both, read back with TensorBoard's
``EventAccumulator``, give the same tags, steps and values (float32
scalars, compared exactly). About 20 s on one worker.
"""

import json

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from torch.utils.flop_counter import FlopCounterMode

from lanczosnet_tpu.utils.logger import MetricsLogger as JaxMetricsLogger
from lanczosnet_torch.data.dataset import pack_dataset
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.runner import QM8Runner
from lanczosnet_torch.train.step import make_train_step
from lanczosnet_torch.utils import profiling
from lanczosnet_torch.utils.logger import MetricsLogger
from test_torch_qm8_train import SMALL_MODEL, events, pack_cache, tiny_config  # noqa: F401


def test_trace_writes_and_nests(tmp_path):
    assert profiling.trace(None).__enter__() is None  # a no-op
    with profiling.trace(tmp_path / "outer"):
        with profiling.trace(tmp_path / "inner"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "outer" / profiling.TRACE_FILE).read_text())["traceEvents"]}
    assert f"trace:{tmp_path / 'inner'}" in names and "aten::mm" in names
    assert (tmp_path / "inner").is_dir() and not any((tmp_path / "inner").iterdir())
    with profiling.trace(tmp_path / "again"):  # the outer one closed
        torch.zeros(3).sum()
    assert (tmp_path / "again" / profiling.TRACE_FILE).exists()


def test_device_busy_seconds(tmp_path):
    """None on a trace of the CPU; on a card's trace the union of its
    kernels, copies and memsets (overlaps counted once)."""
    with profiling.trace(tmp_path / "cpu"):
        torch.ones(8).sum()
    assert profiling.device_busy_seconds(tmp_path / "cpu") is None
    assert profiling.device_busy_seconds(tmp_path / "missing") is None
    card = tmp_path / "card"
    card.mkdir()
    spans = [("kernel", 0, 10), ("kernel", 5, 10), ("gpu_memcpy", 30, 5), ("cpu_op", 0, 100),
             ("gpu_memset", 34, 2)]
    (card / profiling.TRACE_FILE).write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": "x", "ts": t, "dur": d} for c, t, d in spans]}))
    assert profiling.device_busy_seconds(card) == pytest.approx(21e-6)


def test_program_cost_counts_the_steps_flops():
    ds = pack_dataset(synthetic_qm8_graphs(8, seed=1, n_hi=12), n_max=12, num_eig_vec=6,
                      standardize=True, device="cpu")
    batch, valid = ds.slice_batch(np.arange(8)), torch.ones(8)
    steps = []
    for _ in range(2):
        model = build_model({**SMALL_MODEL, "num_atom": 8, "num_task": 16})
        model.init_weights(torch.Generator().manual_seed(0))
        optimizer, scheduler, clip = build_optimizer(model.parameters(),
                                                     {"optimizer": "Adam", "lr": 1e-3})
        steps.append(make_train_step(model, optimizer, scheduler, clip))
    cost = profiling.program_cost(steps[0], batch, valid)
    counter = FlopCounterMode(display=False)
    with counter:
        steps[1](batch, valid)
    assert set(cost) == {"flops"} and cost["flops"] == counter.get_total_flops() > 0


def test_debug_nans_and_step_timer():
    before = torch.is_anomaly_enabled()
    with profiling.debug_nans():
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    assert torch.is_anomaly_enabled() == before


def test_the_runner_profiles_both_paths(tmp_path, pack_cache):
    """Resident epochs trace the first validation group; the per-step path
    traces epoch start+1 and logs the first step's ``program_cost``."""
    for name, train in {"resident": {"scan_epoch": True},
                        "per_step": {"scan_epoch": False}}.items():
        run = tmp_path / name
        QM8Runner(tiny_config(run, profile=True, **train), device="cpu").train()
        assert (run / "trace" / profiling.TRACE_FILE).exists()
        costs = events(run, "program_cost")
        if name == "per_step":
            assert len(costs) == 1 and costs[0]["program"] == "train_step"
            assert costs[0]["flops"] > 0
        else:
            assert costs == []


def test_tensorboard_mirror_equals_the_jax_loggers(tmp_path):
    calls = [("epoch", {"epoch": 0, "loss": 0.5, "graphs_per_sec": 1234.5}),
             ("epoch", {"epoch": 1, "loss": 0.25, "flag": True, "bad": float("nan")}),
             ("pack", {"split": "train", "seconds": 1.5, "graphs": 64}),
             ("pack", {"split": "val", "seconds": 0.5, "graphs": 16}),
             ("train", {"step": 7, "loss": 0.125, "per_task": [1.0, 2.0]})]
    loggers = {"jax": JaxMetricsLogger(tmp_path / "jax.jsonl", tensorboard_dir=tmp_path / "jtb"),
               "port": MetricsLogger(tmp_path / "port.jsonl", tensorboard_dir=tmp_path / "ptb")}
    assert loggers["port"].tensorboard
    for logger in loggers.values():
        for event, fields in calls:
            logger.log(event, **fields)
        logger.close()
    read = {}
    for name, tb in (("jax", "jtb"), ("port", "ptb")):
        acc = EventAccumulator(str(tmp_path / tb))
        acc.Reload()
        read[name] = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                      for tag in acc.Tags()["scalars"]}
    assert read["port"] == read["jax"]
    assert read["port"]["epoch/loss"] == [(0, 0.5), (1, 0.25)]
    assert read["port"]["pack/seconds"] == [(0, 1.5), (1, 0.5)]
    assert "epoch/flag" not in read["port"] and "epoch/bad" not in read["port"]
    no_writer = MetricsLogger(tmp_path / "plain.jsonl")
    assert not no_writer.tensorboard
