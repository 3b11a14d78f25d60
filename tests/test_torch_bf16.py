"""The ``model.dtype: bfloat16`` and ``model.sum_dense`` knobs against the
JAX package, on the CPU.

bfloat16: every model of the registry with ``dtype: bfloat16`` gets the
flax model's parameters and the same batch in eval mode, at narrow
width, and the flagship at the full width of
``configs/qm8_lanczos_net_bf16.yaml``. The two packages round bfloat16
at other places (XLA keeps some fused elementwise chains in float32
where PyTorch rounds after each operation), so the port is held to
2e-2 absolute on outputs of order 1, and to at most twice flax's own
bfloat16-vs-float32 gap on the same batch plus 1e-3. Measured on these
batches: at most 1.6e-2 (MPNN, whose six GRU steps compound the
rounding), and 1.4× the gap (GCN). Each port model's bfloat16 output
also differs from its float32 one: the knob changes arithmetic.

sum_dense: the same parameters through ``SumDense([h, prop])`` and
through the ``Linear`` on the concat agree to 1e-5 (float32, only the
order of summation differs); ``FusedChannelDense`` against that
``Linear`` to 1e-5, relative on outputs of order 50.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from lanczosnet_tpu.models.base import compute_dtype as jax_compute_dtype
from lanczosnet_torch.models import build_model
from lanczosnet_torch.models.base import SumDense, compute_dtype
from lanczosnet_torch.models.lanczos_net import FusedChannelDense, channel_stack
from lanczosnet_torch.ops.precision import bf16_f32_accumulation

from test_torch_dense_models import (
    CONFIGS,
    batch_for,
    flax_predict,
    model_config,
    port_model,
    torch_batch,
)

TOL = 2e-2


@pytest.mark.parametrize(
    "name,width,num,n_max",
    [(name, "narrow", 4, 16) for name in CONFIGS] + [("LanczosNet", "full", 2, 32)],
    ids=[f"{name}-narrow" for name in CONFIGS] + ["LanczosNet-full"],
)
def test_bf16_model_matches_flax_bf16(name, width, num, n_max):
    cfg, kind = model_config(name, width, dtype="bfloat16")
    b = batch_for(cfg, kind, num, n_max)
    params, want = flax_predict(cfg, b)
    _, want32 = flax_predict({**cfg, "dtype": "float32"}, b)
    with torch.inference_mode():
        model = port_model(cfg, params, b)
        got = model(torch_batch(b)).numpy()
        got32 = port_model({**cfg, "dtype": "float32"}, params, b)(torch_batch(b)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert all(p.dtype == torch.float32 for p in model.parameters())
    err, gap = float(np.abs(got - want).max()), float(np.abs(want - want32).max())
    assert err <= TOL and err <= 2.0 * gap + 1e-3, (err, gap)
    assert float(np.abs(got - got32).max()) > 1e-4


def test_compute_dtype_reads_what_jax_reads():
    for name in (None, "", "float32", "f32", "bfloat16", "bf16"):
        assert str(compute_dtype(name)).split(".")[-1] == jax_compute_dtype(name).__name__
    for bad in ("float16", "fp8"):
        with pytest.raises(ValueError, match="model.dtype must be float32 or bfloat16") as got:
            compute_dtype(bad)
        with pytest.raises(ValueError) as want:
            jax_compute_dtype(bad)
        assert str(got.value) == str(want.value)


def test_bf16_accumulation_block_sets_and_restores_the_flag():
    flag = torch.backends.cuda.matmul
    before = flag.allow_bf16_reduced_precision_reduction
    try:
        flag.allow_bf16_reduced_precision_reduction = True
        with bf16_f32_accumulation():
            with bf16_f32_accumulation():
                assert flag.allow_bf16_reduced_precision_reduction is False
            assert flag.allow_bf16_reduced_precision_reduction is False
        assert flag.allow_bf16_reduced_precision_reduction is True
    finally:
        flag.allow_bf16_reduced_precision_reduction = before


def test_bf16_accumulation_block_holds_across_threads():
    """Serving threads enter and leave the block concurrently: inside it
    the flag is off for every thread, and the last one out restores it."""
    flag = torch.backends.cuda.matmul
    before, interval = flag.allow_bf16_reduced_precision_reduction, sys.getswitchinterval()
    seen_on = []

    def worker():
        for _ in range(300):
            with bf16_f32_accumulation():
                if flag.allow_bf16_reduced_precision_reduction:
                    seen_on.append(1)

    try:
        flag.allow_bf16_reduced_precision_reduction = True
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not seen_on
        assert flag.allow_bf16_reduced_precision_reduction is True
    finally:
        sys.setswitchinterval(interval)
        flag.allow_bf16_reduced_precision_reduction = before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sum_dense_matches_the_concat_form(dtype):
    cfg, kind = model_config("LanczosNet", "full", dtype=dtype)
    b = batch_for(cfg, kind, 2, 32)
    params, _ = flax_predict(cfg, b)
    with torch.inference_mode():
        concat = port_model(cfg, params, b)
        summed = port_model({**cfg, "sum_dense": True}, params, b)
        assert isinstance(summed.layers[0], SumDense)
        got = summed(torch_batch(b)).numpy()
        want = concat(torch_batch(b)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:  # one rounding of the float32 sum against the GEMM's own
        np.testing.assert_allclose(got, want, atol=TOL)
    # and against flax's SumDense with the same leaves
    flax_params, flax_want = flax_predict({**cfg, "sum_dense": True}, b)
    with torch.inference_mode():
        got = port_model({**cfg, "sum_dense": True}, flax_params, b)(torch_batch(b)).numpy()
    np.testing.assert_allclose(got, flax_want, atol=1e-4 if dtype == "float32" else TOL)


def test_sum_dense_keeps_bf16_partials_in_float32():
    """bfloat16 parts: every product exact, the sum of the parts rounded
    once. A bfloat16 product per part, summed in bfloat16, would round
    three times."""
    rng = np.random.default_rng(3)
    layer = SumDense(48, 8, act_dtype=torch.bfloat16)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rng.standard_normal((8, 48)).astype(np.float32)))
        layer.bias.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
    parts = [torch.from_numpy(rng.standard_normal((5, f)).astype(np.float32)).bfloat16()
             for f in (16, 32)]
    with torch.no_grad():
        got = layer(parts)
    w = layer.weight.detach().bfloat16().double()
    exact = (parts[0].double() @ w[:, :16].T + parts[1].double() @ w[:, 16:].T
             + layer.bias.detach().bfloat16().double())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), exact.bfloat16().float().numpy())


def test_fused_channel_dense_matches_the_dense_on_the_concat():
    rng = np.random.default_rng(4)
    b, c, n, f, d = 3, 6, 10, 8, 12
    h = torch.from_numpy(rng.standard_normal((b, n, f)).astype(np.float32))
    short = torch.from_numpy(rng.standard_normal((b, 2, n, n)).astype(np.float32))
    edge = torch.from_numpy(rng.standard_normal((b, c - 2, n, n)).astype(np.float32))
    stack = channel_stack(short, None, None, edge)
    fused = FusedChannelDense(f, c, d)
    with torch.no_grad():
        fused.weight.copy_(torch.from_numpy(rng.standard_normal((d, (1 + c) * f)).astype(np.float32)))
        fused.bias.copy_(torch.from_numpy(rng.standard_normal(d).astype(np.float32)))
        prop = torch.matmul(stack, h[:, None]).movedim(1, 2).reshape(b, n, c * f)
        want = torch.nn.functional.linear(torch.cat([h, prop], -1), fused.weight, fused.bias)
        got = fused(h, stack)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_registry_builds_the_bf16_and_sum_dense_flagship():
    cfg, _ = model_config("LanczosNet", "full", dtype="bfloat16", sum_dense=True)
    model = build_model(cfg)
    assert model.dtype == torch.bfloat16 and model.sum_dense
    assert all(layer.act_dtype == torch.bfloat16 for layer in model.layers)
