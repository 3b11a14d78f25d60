"""The named spans of the sparse step (``utils/profiling.py:span``) on the
CPU: off, they cost nothing and call no profiler op; under
``torch.profiler`` they mark each sparse product, dense layer and
spectral scale of an epoch (``make_train_step``'s step and
``accuracy("val")``), and the benchmark's charging rule
(``portbench/spans.py``) puts every op of those layers, forward,
backward and remat's replay, on its layer's span, with the host op
standing in for the launch of a kernel; and they change no number.

The matrix products are told apart by their shapes (``record_shapes``),
not by the spans: the small model's widths are chosen so that every
product of the spectral scale has a dimension of K, every product of
the head one of the class count, and no product of a dense layer
either.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner
from lanczosnet_torch.utils import profiling
from portbench import spans, traces
from portbench.counts import gcn as gcn_counts
from portbench.counts import lanczos_net as lanczos_net_counts

K, NUM_CLASS = 6, 5
COUNTS = {"LanczosNet": lanczos_net_counts, "GCN": gcn_counts}
SPARSE_OPS = ("aten::index_select", "aten::index_add", "aten::index_add_")
PRODUCTS = ("aten::mm", "aten::linear", "aten::addmm")
# forward products an epoch: the step's, remat's replay of them and the
# validation pass's (two hops a layer in LanczosNet, one in GCN)
FORWARD_PRODUCTS = {("LanczosNet", "layers"): 12, ("LanczosNet", None): 8, ("GCN", None): 4}
CASES = list(FORWARD_PRODUCTS)


def config(save_dir, name: str, remat=None) -> dict:
    model = {"name": name, "hidden_dim": [16, 16], "dropout": 0.5, "num_eig_vec": K,
             "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5],
             "filter_hidden_dim": 8, "dtype": "bfloat16"}
    train = {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4, "max_epoch": 2, "patience": 40}
    if remat is not None:
        train["remat"] = remat
    return {"exp_name": "spans", "runner": "SparseCitationRunner", "seed": 11,
            "save_dir": str(save_dir),
            "dataset": {"source": "synthetic_edges", "num_nodes": 300, "num_class": NUM_CLASS,
                        "feat_dim": 12, "avg_degree": 4.0},
            "model": model, "train": train, "test": {"test_model": None}}


def runner_and_step(save_dir, name: str, remat=None, **model_keys):
    cfg = config(save_dir, name, remat)
    cfg["model"].update(model_keys)
    runner = SparseCitationRunner(cfg, "cpu")
    optimizer, scheduler, clip = build_optimizer(runner.model.parameters(), cfg["train"], 1)
    return runner, runner.make_train_step(optimizer, scheduler, clip)


def test_off_a_span_is_one_shared_null_context_and_calls_no_profiler_op(tmp_path, monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    off = profiling.span("sparse.spmv")
    assert off is profiling.span("model.dense") is profiling._OFF

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    runner, step = runner_and_step(tmp_path, "LanczosNet", "layers")
    assert torch.isfinite(step())
    assert 0.0 <= runner.accuracy("val") <= 1.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler recording"):
            profiling.span("model.dense")


def traced_epoch(tmp_path, name: str, remat, **model_keys):
    """One epoch after a warm one, under the profiler → (runner, events,
    t0, t1)."""
    runner, step = runner_and_step(tmp_path, name, remat, **model_keys)
    step()
    runner.accuracy("val")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        with torch.profiler.record_function("epoch"):
            step()
            runner.accuracy("val")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = traces.load_trace(path)
    return runner, events, *traces.window(events, "epoch")


def charged(events: list, ops: list, t0: float, t1: float, names=spans.SPAN_NAMES) -> dict:
    """The charging rule on ``ops`` (host ops of the trace), each given a
    1 µs kernel launched at its middle → ``{span: ops charged}`` over the
    spans ``names``."""
    extra = []
    for i, e in enumerate(ops):
        c = f"stand-in-{i}"
        mid = float(e["ts"]) + float(e.get("dur", 0.0)) / 2
        extra += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": mid,
                   "dur": 0.0, "pid": e["pid"], "tid": e["tid"], "args": {"correlation": c}},
                  {"ph": "X", "cat": "kernel", "name": "k", "ts": mid, "dur": 1.0, "pid": 0,
                   "tid": 7, "args": {"correlation": c}}]
    got = spans.device_us_by_span(events + extra, names, t0, t1)
    return {k: round(v) for k, v in got.items()}


def product_layer(e: dict) -> str:
    dims = [d for shape in (e.get("args") or {}).get("Input Dims", []) for d in (shape or [])]
    if K in dims:
        return "model.spectral"
    if NUM_CLASS in dims:
        return "head"
    return "model.dense"


@pytest.mark.parametrize("name,remat", CASES)
def test_spans_cover_the_sparse_dense_and_spectral_work_of_an_epoch(tmp_path, name, remat):
    runner, events, t0, t1 = traced_epoch(tmp_path, name, remat)
    mcfg = runner.config["model"]
    counts = COUNTS[name].epoch(mcfg, runner.op.n, runner.op.num_edges, int(runner.x.shape[1]),
                                NUM_CLASS, remat=remat == "layers")
    forward_products = counts["sparse_calls"]["aten::index_add"]
    assert forward_products == FORWARD_PRODUCTS[(name, remat)]
    assert spans.span_calls(events, "sparse.spmv", t0, t1) == forward_products
    assert traces.outermost_calls(events, SPARSE_OPS, t0, t1) == {
        op: counts["sparse_calls"][op] for op in SPARSE_OPS}

    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and t0 <= float(e["ts"]) <= t1]
    sparse = [e for e in ops if e["name"] in SPARSE_OPS]
    assert charged(events, sparse, t0, t1) == {
        "sparse.spmv": len(sparse), "model.dense": 0, "model.spectral": 0}

    products = {}
    for e in ops:
        if e["name"] in PRODUCTS:
            products.setdefault(product_layer(e), []).append(e)
    assert len(products.get("head", [])) >= 2  # forward and backward
    for layer, group in products.items():
        want = dict.fromkeys(spans.SPAN_NAMES, 0)
        if layer != "head":
            want[layer] = len(group)
        assert charged(events, group, t0, t1) == want, layer
    assert ("model.spectral" in products) == (name == "LanczosNet")
    # backward products are among them, charged through their forward op
    dense_spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == "model.dense"]
    assert any(not any(a <= float(e["ts"]) <= b for a, b in dense_spans)
               for e in products["model.dense"])


def test_gat_spans_hold_its_projections_skips_and_attention(tmp_path):
    """GAT with ``skip`` (the published ogbn-products stack, no head): one
    ``model.attention`` span a layer and forward, every sparse op of the
    epoch, forward and backward, charged to it, and every matrix product
    (the projections, the skips, their backward) to ``model.dense``."""
    runner, events, t0, t1 = traced_epoch(tmp_path, "GAT", None, skip=True, num_head=2)
    names = ("model.attention", "model.dense")
    assert spans.span_calls(events, "model.attention", t0, t1) == 3 * 2
    assert spans.span_calls(events, "model.dense", t0, t1) == 3 * 2 * 2
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and t0 <= float(e["ts"]) <= t1]
    sparse = [e for e in ops if e["name"] in SPARSE_OPS]
    products = [e for e in ops if e["name"] in PRODUCTS]
    assert charged(events, sparse, t0, t1, names) == {
        "model.attention": len(sparse), "model.dense": 0}
    assert charged(events, products, t0, t1, names) == {
        "model.attention": 0, "model.dense": len(products)}
    dense_spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == "model.dense"]
    assert any(not any(a <= float(e["ts"]) <= b for a, b in dense_spans) for e in products)


def adam_steps(tmp_path, remat, traced: bool):
    runner, step = runner_and_step(tmp_path, "LanczosNet", remat)
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            if traced else contextlib.nullcontext())
    losses, grads = [], []
    with prof:
        for _ in range(2):
            losses.append(step())
            grads.append({k: p.grad.clone() for k, p in runner.model.named_parameters()})
    return losses, grads, {k: p.detach().clone() for k, p in runner.model.named_parameters()}


@pytest.mark.parametrize("remat", [None, "layers"])
def test_tracing_changes_no_loss_gradient_or_parameter(tmp_path, remat):
    off = adam_steps(tmp_path / "off", remat, traced=False)
    on = adam_steps(tmp_path / "on", remat, traced=True)
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    for ga, gb in zip(off[1], on[1]):
        assert ga.keys() == gb.keys()
        for k in ga:
            assert torch.equal(ga[k], gb[k]), k
    for k in off[2]:
        assert torch.equal(off[2][k], on[2][k]), k
