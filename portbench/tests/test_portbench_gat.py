"""The published ogbn-products GAT (``configs/ogbn_products_gat.json``): the
port's ``SparseGAT`` in that mode against ``reference/gat.py`` on the CPU
at the configuration's ``cpu_nodes``, in float32 with random biases (the
eval logits, the first steps' losses, every gradient and the change after
three Adam steps); its parameter count and names; the counts by hand;
the control failing the cell's limits; the attention's metric readers on
a hand-made trace; and on the card, the counts' launches and spans
against the port's counters."""

from __future__ import annotations

import tempfile
from pathlib import Path

import pytest
import torch

from conftest import shrink
from portbench import bench, check
from portbench.counts import gat as counts_gat
from portbench.peaks import HBM_BYTES_PER_S
from portbench.readers import Ctx
from portbench.reference import gat as ref_gat
from portbench.reference import train as ref_train
from portbench.reference.common import CONTROL

CELL = "ogbn_products_gat-train"


def _float32(cfg):
    cfg = shrink(cfg)
    cfg["model"] = {**cfg["model"], "dtype": "float32"}
    return cfg


def _random_biases(weights: dict, seed: int) -> dict:
    """The benchmark's weights with every bias drawn (they are zero there)."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (0.1 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v)
            for k, v in weights.items()}


def test_the_port_in_float32_is_the_reference_with_biases():
    cell = bench.Cell(CELL)
    g = bench.draw(cell, 13, "cpu", _float32)
    weights = _random_biases(bench.cell_weights(cell, g, 13, "cpu"), 13)
    inputs = bench.reference_inputs(g, "cpu")
    with tempfile.TemporaryDirectory() as d:
        prog = bench.Program(cell, g, weights, bench.seeds(13)["dropout"], torch.device("cpu"),
                             Path(d))
        logits = prog.runner.gathered_logits()
        out = {"op": bench._program_op(prog.runner)}
        bench.drive_first(cell, prog, weights, out)
        del prog
    with bench.full_float32():
        want = ref_train.score(cell.family, cell.config["model"], weights, inputs)
        ref = ref_train.first_steps(cell.family, cell.config["model"], cell.config["train"],
                                    weights, inputs, 3, bench.seeds(13)["dropout"])
    assert float((logits - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert max(abs(a - b) / b for a, b in zip(out["first"]["losses"], ref["losses"])) < 1e-5
    assert set(out["first"]["grad_opt"]) == set(weights)
    for k, want_g in ref["grad_opt"].items():
        scale = float(want_g.abs().max())
        assert scale > 0, k
        assert float((out["first"]["grad_opt"][k] - want_g).abs().max()) <= 1e-4 * scale, k
    nums = check.train_numbers(out["first"], ref)
    assert nums["change_norm_gap"] < 1e-3 and nums["change_median_gap"] < 1e-4


def test_the_published_parameter_count_and_names():
    from lanczosnet_torch.models.sparse_nodes import build_sparse_model

    cfg = bench.Cell(CELL).config["model"]
    model = build_sparse_model(cfg, 100, 47)
    assert sum(p.numel() for p in model.parameters()) == 751_574
    shapes = ref_gat.param_shapes(cfg, 100, 47)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == shapes
    model.load_state_dict(bench.make_weights(shapes, 1, "cpu"), strict=True)
    # without skip: the JAX package's GAT and its names
    plain = build_sparse_model({k: v for k, v in cfg.items() if k != "skip"}, 100, 47)
    assert [k for k, _ in plain.named_parameters()] == [
        "head.weight", "head.bias", "proj.0.weight", "proj.1.weight", "att_src.0", "att_src.1",
        "att_dst.0", "att_dst.1"]


def test_counts_by_hand():
    model = {"hidden_dim": [4], "num_head": 2, "skip": True, "dtype": "bfloat16"}
    n, e, f, c = 10, 30, 3, 5
    # layer 0: 3 → 2 heads of 2; layer 1: 4 → 2 heads of 5, averaged
    fwd = (2 * n * f * 4 + 2 * (n * 2) * 2 * 2 + 2 * e * 2 + 2 * (2 * e * 2) + 2 * n * f * 4
           + 2 * n * 4 * 10 + 2 * (n * 2) * 5 * 2 + 2 * e * 2 + 2 * (2 * e * 5) + 2 * n * 4 * 5)
    assert counts_gat.infer_pass(model, n, e, f, c)["flops"] == fwd
    # the backward: layer 1's skip dW, dX; projection dW, dX; scores (2); its heads'
    # transposed sums and SDDMMs; the softmax; layer 0 the same without the dX
    bwd = (4 * n * 4 * 5 + 4 * n * 4 * 10 + 2 * 2 * (n * 2) * 5 * 2 + 2 * (2 * 2 * e * 5)
           + 2 * e * 2 + 2 * n * f * 4 * 2 + 2 * 2 * (n * 2) * 2 * 2 + 2 * (2 * 2 * e * 2)
           + 2 * e * 2)
    one = counts_gat.epoch(model, n, e, f, c)
    assert one["flops"] == 2 * fwd + bwd
    # the bytes of layer 1's forward sums: per head x in and out (2 · 10 · 5 · 2) and the
    # edges (12 · 30); its softmax: the edges, the scores in, one float32 an edge and head out
    head = 2 * n * 5 * 2 + 12 * e
    softmax = 8 * e + 2 * n * 2 * 2 + 4 * e * 2
    fwd1 = 2 * head + softmax
    fwd0 = 2 * (2 * n * 2 * 2 + 12 * e) + softmax
    assert counts_gat.infer_pass(model, n, e, f, c)["attention_bytes"] == fwd0 + fwd1
    assert counts_gat.infer_pass(model, n, e, f, c)["sparse_bytes"] == fwd0 + fwd1 - 2 * softmax
    # 2 layers of 2 heads: forward, transposed and SDDMM in the step, forward in validation
    assert one["sparse_launches"] == 16 and one["attention_spans"] == 4
    assert one["sparse_calls"] == {"aten::index_select": 2 * (4 + 2 + 2 + 2 + 4),
                                   "aten::index_add": 2 * 4, "aten::index_add_": 2 * 3}
    # the cell: 3 layers of 4 heads, 48 launches an epoch
    cfg = bench.Cell(CELL).config["model"]
    assert counts_gat.epoch(cfg, 100, 1000, 100, 47)["sparse_launches"] == 48


def test_the_reference_attention_s_backward_is_its_gradient():
    """``reference/gat.py:_Attention``'s hand-written backward against
    finite differences (``torch.autograd.gradcheck``, float64) on a small
    graph with a node of no in-edge, a dead edge and a hub."""
    gen = torch.Generator().manual_seed(4)
    n, heads, width = 9, 2, 3
    row = torch.tensor([1, 1, 1, 1, 2, 2, 3, 4, 5, 6, 7, 8, 8])
    col = torch.tensor([2, 3, 4, 5, 1, 6, 1, 1, 2, 7, 8, 7, 1])
    val = torch.ones(row.shape[0], dtype=torch.float64)
    val[5] = 0.0
    edges = ref_gat.Edges(row, col, val, n)
    args = [torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
            for shape in ((n, heads), (n, heads), (n, heads, width))]
    assert torch.autograd.gradcheck(
        lambda s_dst, s_src, hp: ref_gat._Attention.apply(s_dst, s_src, hp, edges,
                                                          ref_gat.NEGATIVE_SLOPE, lambda t: t),
        args)


def test_the_control_is_not_correct():
    cell = bench.Cell(CELL)
    g = bench.draw(cell, 21, "cpu", shrink)
    weights = bench.cell_weights(cell, g, 21, "cpu")
    out = bench.reference_side(cell, g, weights, 21, torch.device("cpu"), CONTROL)
    correct, table = check.judge(bench.compare(cell, g, weights, out, 21, torch.device("cpu")),
                                 cell.limits)
    assert not correct, table


MAIN, AUTOGRAD = 101, 202


def _x(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 9, "tid": tid,
            "args": args}


EVENTS = [
    _x("measured_window", "user_annotation", 0, 1000),
    _x("model.attention", "user_annotation", 10, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 15, 1, correlation=1),
    _x("spmm_csr_kernel<bf16>", "kernel", 100, 40, tid=7, correlation=1),
    _x("model.attention", "user_annotation", 50, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 55, 1, correlation=2),
    _x("spmm_csr_kernel<bf16>", "kernel", 150, 20, tid=7, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 90, 1, correlation=3),  # under no span
    _x("gemm", "kernel", 200, 50, tid=7, correlation=3),
]


def _ctx(spans_a_unit=2, events=EVENTS, kind="train"):
    return Ctx(kind=kind, setup={}, units=1, window_s=1e-3, events=events, t0=0, t1=1000,
               counts={"flops": 1.0, "bytes": 1.0, "sparse_bytes": 1.0, "sparse_launches": 2,
                       "attention_bytes": 1e6, "attention_spans": spans_a_unit,
                       "sparse_calls": {}})


def _read(name, ctx):
    reader, kind = bench.metric_reader(name)
    return reader.read(ctx, kind)


def test_the_attention_readers_on_a_hand_made_trace(capsys):
    ctx = _ctx()
    assert _read("attention_device_ms.train", ctx) == pytest.approx(0.06)
    assert _read("attention_span_roofline_pct.train", ctx) == pytest.approx(
        100.0 * 1e6 / 60e-6 / HBM_BYTES_PER_S)
    assert _read("attention_span_roofline_pct.train", _ctx(spans_a_unit=3)) is None
    assert "2 model.attention spans in the window, expected 3" in capsys.readouterr().err
    bare = [e for e in EVENTS if e["name"] != "model.attention"]
    assert _read("attention_device_ms.train", _ctx(events=bare)) is None
    assert _read("attention_device_ms.train", _ctx(events=None)) is None
    assert _read("attention_device_ms.infer", ctx) is None
    lacking = _ctx()
    del lacking.counts["attention_spans"]
    assert _read("attention_span_roofline_pct.train", lacking) is None


@pytest.mark.cuda
def test_the_counts_launches_and_spans_are_the_port_s_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lanczosnet_torch.ops import sparse_cuda

    cell = bench.Cell(CELL)
    g = bench.draw(cell, 3, "cuda", shrink)
    with tempfile.TemporaryDirectory() as d:
        prog, weights, out = bench.build_program(cell, g, 3, torch.device("cuda"), Path(d))
        prog.make_step(cell.config["train"])
        prog.epoch()
        counters = (sparse_cuda.spmm_launches, sparse_cuda.spmm_t_launches,
                    sparse_cuda.sddmm_launches)
        before = sum(c.count for c in counters)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            prog.epoch()
        torch.cuda.synchronize()
        launched = sum(c.count for c in counters) - before
        want = cell.counts.epoch(cell.config["model"], prog.runner.op.n,
                                 prog.runner.op.num_edges, g["features"].shape[1],
                                 int(g["num_class"]))
    assert launched == want["sparse_launches"] == 48
    spans = sum(e.count for e in prof.key_averages() if e.key == "model.attention")
    assert spans == want["attention_spans"] == 6
