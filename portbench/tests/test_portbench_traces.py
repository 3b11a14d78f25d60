"""The trace arithmetic on a hand-made Chrome trace: busy time, device
time under named ATen ops, the window, idle gaps by harness span."""

from __future__ import annotations

import pytest

from portbench import bench, traces
from portbench.peaks import HBM_BYTES_PER_S


def X(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


EVENTS = [
    X("measured_window", "user_annotation", 0, 100),
    X("launch_a_train_step", "user_annotation", 0, 50),
    X("validation_pass", "user_annotation", 50, 50),
    X("aten::index_select", "cpu_op", 1, 8),
    X("aten::empty", "cpu_op", 2, 1),  # a child of index_select
    X("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
    X("aten::mul", "cpu_op", 10, 5),
    X("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=2),
    X("aten::index_add_", "cpu_op", 30, 5, tid=2),  # the autograd thread
    X("cudaLaunchKernel", "cuda_runtime", 31, 1, tid=2, correlation=3),
    X("gather_kernel", "kernel", 10, 20, tid=7, correlation=1),
    X("mul_kernel", "kernel", 30, 10, tid=7, correlation=2),
    X("index_add_kernel", "kernel", 60, 10, tid=7, correlation=3),
    X("Memcpy DtoH", "gpu_memcpy", 120, 10, tid=7, correlation=4),  # outside the window
]


def test_the_window_and_busy_time():
    t0, t1 = traces.window(EVENTS, "measured_window")
    assert (t0, t1) == (0.0, 100.0)
    assert traces.busy_seconds(traces.clip(EVENTS, t0, t1)) == pytest.approx(40e-6)
    assert traces.busy_seconds(EVENTS) == pytest.approx(50e-6)


def test_device_time_under_ops_follows_the_launching_thread():
    ops = ("aten::index_select", "aten::index_add_", "aten::index_add")
    assert traces.device_us_under_ops(EVENTS, ops, 0, 100) == pytest.approx(30.0)
    assert traces.device_us_under_ops(EVENTS, ("aten::mul",), 0, 100) == pytest.approx(10.0)
    assert traces.device_us_under_ops(EVENTS, ops, 0, 65) == pytest.approx(25.0)


def test_outermost_calls_count_each_call_once():
    ops = ("aten::index_select", "aten::index_add_", "aten::index_add")
    events = EVENTS + [
        X("aten::index_add", "cpu_op", 40, 6),
        X("aten::index_add_", "cpu_op", 41, 2),  # inside index_add: not a call of its own
        X("aten::index_select", "cpu_op", 110, 2),  # after the window
    ]
    assert traces.outermost_calls(events, ops, 0, 100) == {
        "aten::index_select": 1, "aten::index_add_": 1, "aten::index_add": 1}
    assert traces.outermost_calls(events, ops, 0, 200)["aten::index_select"] == 2


def _sparse_reader_ctx(calls_per_unit):
    from portbench.readers import Ctx

    ctx = Ctx(kind="train", setup={}, units=1, window_s=1e-4, events=EVENTS, t0=0, t1=100,
              counts={"flops": 1.0, "bytes": 1.0, "sparse_bytes": 1e6,
                      "sparse_calls": calls_per_unit})
    return bench.metric_reader("sparse_ops_roofline_pct.train")[0].read(ctx, "train")


def test_the_sparse_share_is_left_out_when_the_calls_do_not_match():
    # the trace's calls: one index_select, one index_add_ (30 µs of kernels)
    share = _sparse_reader_ctx({"aten::index_select": 1, "aten::index_add_": 1})
    assert share == pytest.approx(100.0 * 1e6 / 30e-6 / HBM_BYTES_PER_S)
    # a scatter that left the listed ops, or a product more than they carry
    assert _sparse_reader_ctx({"aten::index_select": 1, "aten::index_add_": 2}) is None
    assert _sparse_reader_ctx({"aten::index_select": 1, "aten::index_add_": 1,
                               "aten::index_add": 1}) is None


def test_idle_gaps_are_named_by_the_span_that_ended_them():
    gaps = dict(traces.idle_gaps(EVENTS, 0, 100, ("launch_a_train_step", "validation_pass")))
    # idle 0–10 (ended in launch_a_train_step), 40–60 (ended in validation_pass), 70–100
    # (the window's end, in validation_pass)
    assert gaps == pytest.approx({"launch_a_train_step": 10e-6, "validation_pass": 50e-6})


def test_top_device_ops():
    top = traces.top_device_ops(EVENTS, 0, 100)
    assert top[0] == ["gather_kernel", pytest.approx(20e-6)]
    assert [n for n, _ in top] == ["gather_kernel", "mul_kernel", "index_add_kernel"]
    name = traces.short_name("void at::native::(anon)::k<float, 2>")
    assert name == "void_at_native_anon_k_float_2_"
