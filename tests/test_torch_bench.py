"""The port's measuring tools, ``scripts/torch_bench*.py``, on the CPU at
small sizes, against their JAX counterparts (``bench.py``,
``scripts/bench_serve.py``, ``scripts/bench_sparse.py``), and the
``Predictor``'s ``compact_wire`` switch against the JAX ``Predictor``'s.

Tolerances: the FLOP count equal; the bench's packed first batch (8
graphs, as in ROADMAP C1) and its eval-mode loss 1e-5, with the JAX
bench's model and parameters carried across by ``weights.py``; the
predictions of a ``Predictor`` with the compact wire off 1e-4 from the
JAX one's (the tolerance of tests/test_torch_serve.py), its exported
artifact's 1e-5 from it; the sparse sweep's remat modes 1e-6 from its
no-remat losses. The output lines hold the keys of the JAX tools' lines,
read from their sources.
"""

import ast
import functools
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.core.graph_batch import GraphBatch as JaxGraphBatch
from lanczosnet_tpu.data.citation import synthetic_citation_edges as jax_citation_edges
from lanczosnet_tpu.data.dataset import pack_dataset as jax_pack_dataset
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.ops.sparse import sparse_sym_operator as jax_sparse_sym_operator
from lanczosnet_tpu.serve import Predictor as JaxPredictor
from lanczosnet_tpu.train.step import make_eval_step as jax_make_eval_step
from lanczosnet_torch.data.citation import synthetic_citation_edges
from lanczosnet_torch.data.dataset import pack_dataset
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.export import PROGRAM_COMPACT, PROGRAM_F32, export_predictor, load_predictor
from lanczosnet_torch.models import build_model
from lanczosnet_torch.ops.sparse import sparse_sym_operator
from lanczosnet_torch.serve import Predictor
from lanczosnet_torch.train.step import make_eval_step
from lanczosnet_torch.weights import lanczos_net_state_dict
from tests.test_torch_dense_models import flax_params
from tests.test_torch_models import NARROW, model_cfg

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
FIELDS = ("atom_type", "node_feat", "ops", "mask", "label")


def load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def tool(name: str):
    return load(SCRIPTS / f"{name}.py")


def dict_keys(path: Path, key: str) -> set[str]:
    """The string keys of the first dict literal in ``path`` that has
    ``key`` among them: a JAX tool's output row, read from its source."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if key in keys:
                return keys
    raise AssertionError(f"no dict with {key!r} in {path}")


# ---------------------------------------------------------------- torch_bench
def test_flops_per_graph_equals_bench_py():
    bench = load(REPO / "bench.py")  # its module level imports numpy and the stdlib only
    assert tool("torch_bench").flops_per_graph() == bench.analytic_train_flops_per_graph()
    assert tool("torch_bench").flops_per_graph() == 148_550_016


@pytest.mark.parametrize("dtype,batch,sum_dense,metric", [
    ("float32", 64, False, "lanczosnet_qm8_train_graphs_per_sec"),
    ("bfloat16", 16, False, "lanczosnet_qm8_train_graphs_per_sec_bf16_b16"),
    ("float32", 16, True, "lanczosnet_qm8_train_graphs_per_sec_b16_sumdense"),
])
def test_bench_line_has_bench_py_keys_and_metric_name(monkeypatch, capsys, dtype, batch,
                                                      sum_dense, metric):
    tb = tool("torch_bench")
    monkeypatch.setattr(tb, "bench_torch", functools.partial(
        tb.bench_torch, num_graphs=128, group=1, rounds=1))
    argv = ["--device", "cpu", "--dtype", dtype, "--batch", str(batch)]
    assert tb.main(argv + (["--sum-dense"] if sum_dense else [])) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == dict_keys(REPO / "bench.py", "vs_baseline") | {"peak_tflops", "device"}
    assert line["metric"] == metric
    assert line["value"] > 0 and line["baseline_graphs_per_sec"] > 0
    assert line["flops_per_graph"] == 148_550_016 and line["device"] == "cpu"
    # no peak on the CPU, so no MFU; no card in the trace, so no device time
    assert line["peak_tflops"] is None and line["mfu_pct"] is None
    assert line["device_only_graphs_per_sec"] is None and line["device_time_frac"] is None


def test_bench_peaks_are_the_cards():
    tb = tool("torch_bench")
    assert tb.PEAK_TFLOPS == {"float32": 67.0, "bfloat16": 989.4}


def test_bench_pack_and_eval_loss_match_jax():
    """The bench's pack of 8 of its graphs in both packages, and the
    eval-mode loss of the JAX bench's model on the port's pack in both.
    (Each package's loss on its own pack differs by about 1e-4: Ritz
    values 7e-6 apart, raised to the 30th power by the longest scale's
    filter.)"""
    tb = tool("torch_bench")
    graphs = tb.bench_graphs(8)
    want = jax_pack_dataset(graphs, n_max=32, num_eig_vec=20, standardize=True)
    got = tb.pack(graphs, "cpu")
    for f in (*FIELDS, "ritz_val"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0, atol=1e-5,
                                   err_msg=f)
    for power in (1, 2):
        rec = [np.einsum("bnk,bk,bmk->bnm", p.ritz_vec, p.ritz_val**power, p.ritz_vec)
               for p in (got, want)]
        np.testing.assert_allclose(rec[0], rec[1], rtol=0, atol=1e-5)

    cfg = tb.model_config()  # bench.py's model section, with its filter width made explicit
    jmodel = jax_build_model(cfg)
    batch = got.slice_batch(np.arange(8))
    jbatch = JaxGraphBatch(**{f: jnp.asarray(getattr(batch, f).numpy())
                              for f in (*FIELDS, "ritz_val", "ritz_vec")})
    params = flax_params(jmodel, jbatch)
    model = build_model(cfg)
    model.load_state_dict(lanczos_net_state_dict(params), strict=True)
    valid = np.ones(8, np.float32)
    werr, wcount = jax_make_eval_step(jmodel)(params, jbatch, jnp.asarray(valid))
    gerr, gcount = make_eval_step(model)(batch, torch.from_numpy(valid))
    want_loss = float(np.sum(werr)) / (float(wcount) * 16)
    got_loss = float(gerr.sum()) / (float(gcount) * 16)
    assert abs(got_loss - want_loss) <= 1e-5, (got_loss, want_loss)


# --------------------------------------------------------- compact_wire switch
@pytest.fixture(scope="module")
def float32_wire_predictors():
    cfg = model_cfg(NARROW)
    jmodel = jax_build_model(cfg)
    probe = pack_dataset(synthetic_qm8_graphs(2, seed=0, n_hi=16), n_max=16,
                         num_eig_vec=cfg["num_eig_vec"], device="cpu")
    batch = probe.slice_batch(np.arange(2))
    params = flax_params(jmodel, JaxGraphBatch(**{
        f: jnp.asarray(getattr(batch, f).numpy()) for f in (*FIELDS, "ritz_val", "ritz_vec")}))
    common = dict(n_max=16, batch_size=8, num_eig_vec=cfg["num_eig_vec"], num_task=16,
                  compact_wire=False)
    port = Predictor(build_model(cfg), lanczos_net_state_dict(params), device="cpu", **common)
    return JaxPredictor(jmodel, params, **common), port


def test_predictor_with_the_compact_wire_off_packs_float32_and_matches_jax(
        float32_wire_predictors, tmp_path):
    jax_pred, port = float32_wire_predictors
    graphs = synthetic_qm8_graphs(11, seed=5, n_hi=16)  # uint8-exact: compact where it is on
    assert not port.compact_wire and not port._compact_ok(graphs)
    with pytest.raises(ValueError, match="float32 wire"):
        port._pack(graphs[:8], compact=True)
    seen = []
    run = port._run
    port._run = lambda args: seen.append(args[0].dtype) or run(args)
    try:
        port.warmup()
        got = port.predict(graphs)
    finally:
        del port._run
    assert seen and set(seen) == {torch.float32}
    assert len(seen) == 3  # warmup: one request, the float32 wire only; then two chunks
    np.testing.assert_allclose(got, jax_pred.predict(graphs), rtol=0, atol=1e-4)

    export_predictor(port, tmp_path / "art")
    assert (tmp_path / "art" / PROGRAM_F32).exists()
    assert not (tmp_path / "art" / PROGRAM_COMPACT).exists()
    art = load_predictor(tmp_path / "art", device="cpu")
    assert not art.compact_wire and not art._compact_ok(graphs)
    np.testing.assert_allclose(art.predict(graphs), got, rtol=0, atol=1e-5)


def test_predictor_compact_wire_defaults_on_and_the_artifact_ships_it(tmp_path):
    cfg = model_cfg(NARROW)
    model = build_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    pred = Predictor(model, model.state_dict(), n_max=16, batch_size=8,
                     num_eig_vec=cfg["num_eig_vec"], device="cpu")
    graphs = synthetic_qm8_graphs(3, seed=5, n_hi=16)
    assert pred.compact_wire and pred._compact_ok(graphs)
    assert pred._pack(graphs)[0].dtype == np.uint8
    export_predictor(pred, tmp_path / "art")
    assert load_predictor(tmp_path / "art", device="cpu").compact_wire


# ----------------------------------------------------------- torch_bench_serve
SERVE_FORMS = {"http": [], "direct": ["--direct"], "native_binary": ["--native", "--binary"],
               "legacy_wire": ["--legacy-wire"], "inflight_sweep": ["--inflight-sweep", "1,2"]}


@pytest.mark.parametrize("form", list(SERVE_FORMS))
def test_bench_serve_rows_have_the_jax_keys_and_no_errors(capsys, form):
    if "--native" in SERVE_FORMS[form] and shutil.which("g++") is None:
        pytest.skip("the native front builds with g++, which this machine lacks")
    argv = ["--device", "cpu", "--window", "0.3", "--concurrency", "1,2", *SERVE_FORMS[form]]
    assert tool("torch_bench_serve").main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in out if line.startswith("{")]
    keys = dict_keys(SCRIPTS / "bench_serve.py", "mean_batch_occupancy")
    sweep = form == "inflight_sweep"
    assert [r["clients"] for r in rows] == ([1, 2, 1, 2] if sweep else [1, 2])
    for row in rows:
        assert set(row) == keys | ({"inflight"} if sweep else set())
        assert row["errors"] == 0 and row["req_per_sec"] > 0
        assert row["mean_batch_occupancy"] >= 1.0
    assert out[-1].startswith("best: " if sweep else "saturation: ")


# ---------------------------------------------------------- torch_bench_sparse
SPARSE_ARGS = dict(nodes=3000, degree=2.5, feat=16)


def test_bench_sparse_rows_per_dtype_and_edges_equal_jax():
    proc = subprocess.run(
        [sys.executable, str(SCRIPTS / "torch_bench_sparse.py"), "--device", "cpu",
         "--nodes", "3000", "--feat", "16", "--steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout.strip().splitlines()
    rows = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["dtype"] for r in rows] == ["float32", "bfloat16"]
    graph = jax_citation_edges(3000, num_class=10, feat_dim=16, avg_degree=2.5, seed=7)
    edges = int(jax_sparse_sym_operator(graph["edges"], 3000).row.shape[0])
    for row in rows:
        assert set(row) == {"nodes", "edges", "F", "hidden", "dtype", "ms_per_step", "loss"}
        assert (row["nodes"], row["edges"], row["F"], row["hidden"]) == (3000, edges, 16, 16)
        assert np.isfinite(row["loss"]) and row["ms_per_step"] > 0
    assert out[-1].startswith("F=16: bf16 speedup over f32 = ")


@pytest.fixture(scope="module")
def sparse_graph():
    graph = synthetic_citation_edges(3000, num_class=10, feat_dim=16, avg_degree=2.5, seed=7)
    return graph, sparse_sym_operator(graph["edges"], 3000)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["full", "dots", "layers"])
def test_bench_sparse_remat_modes_give_the_no_remat_losses(sparse_graph, remat, dtype):
    bs = tool("torch_bench_sparse")
    graph, op = sparse_graph

    def losses(mode):
        step = bs.make_step(graph, op, 16, dtype, mode, torch.device("cpu"))
        return [float(step()) for _ in range(3)]

    np.testing.assert_allclose(losses(remat), losses(""), rtol=0, atol=1e-6)
