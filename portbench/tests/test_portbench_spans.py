"""The charging rule of ``spans.py`` on a hand-made Chrome trace: a launch
under a span; a backward charged through its node's sequence number; the
replay's own span before the sequence number; launches left uncharged;
and the readers of the span metrics and of set-up's peak memory."""

from __future__ import annotations

import pytest

from portbench import bench, spans
from portbench.peaks import HBM_BYTES_PER_S
from portbench.readers import Ctx

MAIN, AUTOGRAD = 101, 202  # the trace's tids; the profiler numbers them 1 and 2
EVAL = spans.EVALUATE


def X(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 9, "tid": tid,
            "args": args}


def op(name, ts, dur, seq=None, fwd=0, tid=MAIN):
    args = {} if seq is None else {"Sequence number": seq, "Fwd thread id": fwd}
    return X(name, "cpu_op", ts, dur, tid, **args)


def launch(ts, c, tid=MAIN):
    return X("cudaLaunchKernel", "cuda_runtime", ts, 1, tid, correlation=c)


def kernel(ts, dur, c):
    return X(f"kernel_{c}", "kernel", ts, dur, tid=7, correlation=c)


def flow(ph, fid, ts, tid):
    return {"ph": ph, "id": fid, "pid": 9, "tid": tid, "ts": ts, "cat": "fwdbwd",
            "name": "fwdbwd"}


def span(name, ts, dur, tid=MAIN):
    return X(name, "user_annotation", ts, dur, tid)


EVENTS = [
    span("measured_window", 0, 1000),
    # the forward on the step's thread
    span("sparse.spmv", 10, 20),
    op("aten::index_add", 12, 8, seq=5),
    launch(15, 1), kernel(100, 10, 1),
    launch(25, 8), kernel(990, 20, 8),  # cut to the window: 10 µs
    op("aten::empty", 35, 1, seq=7),  # peeks 7 before the span and makes no node
    span("model.dense", 40, 20),
    op("aten::mm", 42, 8, seq=7),  # makes node 7
    launch(45, 2), kernel(120, 20, 2),
    op("aten::mul", 65, 5, seq=9),  # outside every span
    # the backward on autograd's thread
    op(EVAL + "MmBackward0", 100, 30, seq=7, fwd=1, tid=AUTOGRAD),
    op("MmBackward0", 101, 29, seq=7, fwd=1, tid=AUTOGRAD),
    launch(110, 3, AUTOGRAD), kernel(200, 30, 3),
    op(EVAL + "IndexAddBackward0", 140, 20, seq=5, fwd=1, tid=AUTOGRAD),
    op("IndexAddBackward0", 141, 19, seq=5, fwd=1, tid=AUTOGRAD),
    launch(150, 4, AUTOGRAD), kernel(250, 15, 4),
    # remat's replay, run inside the node that unpacked the layer's saved tensors
    op(EVAL + "MulBackward0", 200, 100, seq=9, fwd=1, tid=AUTOGRAD),
    op("MulBackward0", 201, 99, seq=9, fwd=1, tid=AUTOGRAD),
    span("sparse.spmv", 210, 40, tid=AUTOGRAD),
    launch(220, 5, AUTOGRAD), kernel(300, 5, 5),
    launch(260, 6, AUTOGRAD), kernel(310, 7, 6),  # the replay outside its spans
    # a node whose forward thread no flow names, and a launch under nothing
    op(EVAL + "AddBackward0", 400, 20, seq=3, fwd=4, tid=AUTOGRAD),
    launch(410, 9, AUTOGRAD), kernel(420, 3, 9),
    launch(500, 7), kernel(510, 4, 7),
    flow("s", 1, 42, MAIN), flow("f", 1, 101, AUTOGRAD),
    flow("s", 2, 12, MAIN), flow("f", 2, 141, AUTOGRAD),
    flow("s", 3, 65, MAIN), flow("f", 3, 201, AUTOGRAD),
]


def test_the_profiler_s_thread_numbers_map_to_tids_by_the_flows():
    assert spans.forward_threads(EVENTS) == {1: (9, MAIN)}


def test_each_launch_is_charged_by_the_rule():
    got = spans.device_us_by_span(EVENTS, spans.SPAN_NAMES, 0, 1000)
    # sparse: its forward (10, 10 cut), its backward by sequence number (15),
    # the replay's own span (5); dense: the forward (20) and its node 7 (30),
    # not the op that peeked 7 first; the replay outside its spans, the node
    # of an unmapped thread and the bare launch go nowhere
    assert got == pytest.approx({"sparse.spmv": 40.0, "model.dense": 50.0,
                                 "model.spectral": 0.0})


def test_a_launch_under_a_span_goes_to_the_innermost():
    events = EVENTS + [span("model.spectral", 13, 5)]  # inside sparse.spmv, holds launch 1
    got = spans.device_us_by_span(events, spans.SPAN_NAMES, 0, 1000)
    assert got["model.spectral"] == pytest.approx(10.0)
    assert got["sparse.spmv"] == pytest.approx(30.0)


def test_without_flows_a_node_is_left_uncharged():
    events = [e for e in EVENTS if e["cat"] != "fwdbwd"]
    got = spans.device_us_by_span(events, spans.SPAN_NAMES, 0, 1000)
    assert got == pytest.approx({"sparse.spmv": 25.0, "model.dense": 20.0,
                                 "model.spectral": 0.0})


def test_span_calls_count_the_outermost_spans_that_start_in_the_window():
    events = EVENTS + [span("sparse.spmv", 11, 5), span("sparse.spmv", 1200, 5)]
    assert spans.span_calls(events, "sparse.spmv", 0, 1000) == 2
    assert spans.span_calls(events, "sparse.spmv", 0, 2000) == 3
    assert spans.span_calls(events, "model.spectral", 0, 1000) == 0


def _ctx(kind="train", forward_products=2, events=EVENTS, setup=None):
    return Ctx(kind=kind, setup=setup or {}, units=1, window_s=1e-3, events=events, t0=0,
               t1=1000, counts={"flops": 1.0, "bytes": 1.0, "sparse_bytes": 1e6,
                                "sparse_calls": {"aten::index_add": forward_products}})


def _read(name, ctx):
    reader, kind = bench.metric_reader(name)
    return reader.read(ctx, kind)


def test_the_span_roofline_is_left_out_on_a_span_count_mismatch(capsys):
    share = _read("sparse_span_roofline_pct.train", _ctx())
    assert share == pytest.approx(100.0 * 1e6 / 40e-6 / HBM_BYTES_PER_S)
    assert _read("sparse_span_roofline_pct.train", _ctx(forward_products=3)) is None
    assert "2 sparse.spmv spans in the window, expected 3" in capsys.readouterr().err
    assert _read("sparse_span_roofline_pct.infer", _ctx()) is None  # another kind


def test_layer_times_and_their_absence():
    ctx = _ctx()
    assert _read("dense_device_ms.train", ctx) == pytest.approx(0.05)
    assert _read("spectral_device_ms.train", ctx) is None  # no such span: nothing
    assert _read("dense_device_ms.infer", ctx) is None
    bare = [e for e in EVENTS if e["cat"] != "user_annotation" or e["name"] == "measured_window"]
    assert _read("dense_device_ms.train", _ctx(events=bare)) is None
    assert _read("sparse_span_roofline_pct.train", _ctx(events=bare)) is None
    assert _read("dense_device_ms.train", _ctx(events=None)) is None


def test_set_up_s_peak_memory():
    assert _read("setup_peak_mem_gib.setup", _ctx(setup={"peak_memory_mb": 3072.0})) == 3.0
    assert _read("setup_peak_mem_gib.setup", _ctx(setup={"operator_s": 1.0})) is None
