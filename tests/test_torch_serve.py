"""The port's serving path against the JAX package, on the CPU.

The port ``Predictor`` (``device="cpu"``, so the plain Lanczos version)
and the JAX ``Predictor`` hold the same flax parameters and label stats
and answer the same QM8-like graphs; their un-standardized predictions
agree to 1e-4 (float32, two eigensolvers for the Ritz pairs, whose
reconstructions the models consume).
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from lanczosnet_tpu.data.dataset import LabelStats as JaxLabelStats
from lanczosnet_tpu.data.qm8 import synthetic_qm8_graphs as jax_synthetic_qm8_graphs
from lanczosnet_tpu.serve import Predictor as JaxPredictor
from lanczosnet_torch.data.dataset import LabelStats
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.serve import MicroBatcher, Predictor
from lanczosnet_torch.weights import lanczos_net_state_dict
from tests.test_torch_models import NARROW, flax_model_and_params, model_cfg, numpy_batch

REPO = Path(__file__).resolve().parents[1]
N_MAX, BATCH = 16, 8


@pytest.fixture(scope="module")
def predictors():
    cfg = model_cfg(NARROW)
    model, params = flax_model_and_params(cfg, numpy_batch(2, N_MAX, cfg["num_eig_vec"]))
    labels = np.stack([g["label"] for g in synthetic_qm8_graphs(64, seed=9, n_hi=N_MAX)])
    fit = LabelStats.fit(labels)
    common = dict(n_max=N_MAX, batch_size=BATCH, num_eig_vec=cfg["num_eig_vec"], num_task=16)
    jax_pred = JaxPredictor(
        model, params, stats=JaxLabelStats(mean=fit.mean, std=fit.std), **common
    )
    port = Predictor(
        build_model(cfg), lanczos_net_state_dict(params), stats=fit, device="cpu", **common
    )
    return jax_pred, port


@pytest.mark.parametrize("wire", ["compact", "float32"])
def test_predictor_matches_jax(predictors, wire):
    jax_pred, port = predictors
    graphs = synthetic_qm8_graphs(11, seed=5, n_hi=N_MAX)  # not a multiple of the batch
    if wire == "float32":
        graphs[0] = {**graphs[0], "adj": graphs[0]["adj"] * 0.5}
    assert port._compact_ok(graphs) == (wire == "compact")
    want = jax_pred.predict(graphs)
    got = port.predict(graphs)
    assert got.shape == want.shape == (11, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_microbatcher_matches_predict(predictors):
    _, port = predictors
    graphs = synthetic_qm8_graphs(24, seed=11, n_hi=N_MAX)
    direct = port.predict(graphs)
    mb = MicroBatcher(port, max_delay_ms=5.0)
    try:
        futs = [None] * len(graphs)

        def client(lo):
            for i in range(lo, len(graphs), 3):
                futs[i] = mb.submit(graphs[i])

        threads = [threading.Thread(target=client, args=(lo,)) for lo in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        served = np.stack([f.result(timeout=60) for f in futs])
        np.testing.assert_allclose(served, direct, atol=1e-5)
        stats = mb.latency_stats()
        assert stats["count"] == len(graphs) and stats["max_batch_size"] <= BATCH
    finally:
        mb.close()


def test_microbatcher_close_drains_queued_futures(predictors):
    _, port = predictors
    mb = MicroBatcher(port, max_delay_ms=5.0)
    mb._stop.set()  # stop the worker first, so the request is never served
    mb._worker.join(timeout=10.0)
    fut = mb.submit(synthetic_qm8_graphs(1, seed=3, n_hi=10)[0])
    mb.close()
    with pytest.raises(RuntimeError, match="batcher closed"):
        fut.result(timeout=5)


def test_oversize_graph_raises(predictors):
    _, port = predictors
    big = synthetic_qm8_graphs(1, seed=2, n_lo=N_MAX + 1, n_hi=N_MAX + 4)
    with pytest.raises(ValueError, match=f"n_max={N_MAX}"):
        port.predict(big)


def test_predictor_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = model_cfg(NARROW)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model, model.state_dict(), n_max=N_MAX)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_qm8_graphs_match_jax(seed):
    ours = synthetic_qm8_graphs(20, seed=seed, label_noise=0.1)
    theirs = jax_synthetic_qm8_graphs(20, seed=seed, label_noise=0.1)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_chip_smoke_flagship_is_the_yaml_config():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    cfg = yaml.safe_load((REPO / "configs" / "qm8_lanczos_net.yaml").read_text())
    assert chip_smoke.FLAGSHIP_MODEL == cfg["model"]
    assert chip_smoke.FLAGSHIP_DATASET == cfg["dataset"]
    assert chip_smoke.SERVE_BATCH == cfg["train"]["batch_size"]


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
