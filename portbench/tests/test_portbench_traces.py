"""The trace arithmetic on a hand-made Chrome trace: busy time, kernels by
name, calls of named ATen ops, the window, idle gaps by harness span, and
the kernels' roofline share."""

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


CSR = "void (anonymous namespace)::spmm_csr_kernel<__nv_bfloat16, 8, 1, int>"
SDDMM = "void (anonymous namespace)::spmm_sddmm_kernel<__nv_bfloat16, 8, 1, int>"
PRODUCTS = EVENTS + [
    X(CSR, "kernel", 70, 4, tid=7, correlation=5),
    X(CSR, "kernel", 80, 6, tid=7, correlation=6),  # the transposed view's
    X(SDDMM, "kernel", 90, 2, tid=7, correlation=7),
    X(CSR, "kernel", 98, 4, tid=7, correlation=8),  # cut to the window: 2 µs
    X(CSR, "kernel", 140, 4, tid=7, correlation=9),  # after the window
    X("spmm_csr_kernel", "cpu_op", 72, 1),  # a host op of that name is no launch
]


def test_kernels_named_count_and_time_the_window_s_launches():
    kernels = ("spmm_csr_kernel", "spmm_sddmm_kernel")
    assert traces.kernels_named(PRODUCTS, kernels, 0, 100) == (4, pytest.approx(14.0))
    assert traces.kernels_named(PRODUCTS, ("spmm_csr_kernel",), 0, 100) == (3, 12.0)
    assert traces.kernels_named(PRODUCTS, kernels, 0, 200) == (5, pytest.approx(20.0))
    assert traces.kernels_named(EVENTS, kernels, 0, 100) == (0, 0.0)


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


def _sparse_reader_ctx(launches_per_unit, events=PRODUCTS, units=1, reader="train"):
    from portbench.readers import Ctx

    ctx = Ctx(kind="train", setup={}, units=units, window_s=1e-4, events=events, t0=0, t1=100,
              counts={"flops": 1.0, "bytes": 1.0, "sparse_bytes": 1e6,
                      "sparse_launches": launches_per_unit})
    return bench.metric_reader(f"sparse_ops_roofline_pct.{reader}")[0].read(ctx, reader)


def test_the_sparse_share_is_left_out_when_the_calls_do_not_match(capsys):
    # the window's launches: three of the product kernel and one of the edge weights' gradient,
    # 14 µs; the ATen gathers and scatters beside them are not timed
    share = _sparse_reader_ctx(4)
    assert share == pytest.approx(100.0 * 1e6 / 14e-6 / HBM_BYTES_PER_S)
    assert _sparse_reader_ctx(2, units=2) == pytest.approx(100.0 * 2e6 / 14e-6 / HBM_BYTES_PER_S)
    # a product that left the kernels, or a launch more than the products need
    assert _sparse_reader_ctx(5) is None
    assert "4 launches of spmm_csr_kernel or spmm_sddmm_kernel in the window, expected 5" in (
        capsys.readouterr().err)
    assert _sparse_reader_ctx(3) is None
    # no kernel of the products, a trace without the card, a cell of another kind
    assert _sparse_reader_ctx(0, events=EVENTS) is None
    assert _sparse_reader_ctx(4, events=None) is None
    assert _sparse_reader_ctx(4, reader="infer") is None


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
