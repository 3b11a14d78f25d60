"""The CUDA Lanczos kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip, and
the skip names what is missing. The decision is made inside a fixture,
never at import, so every test process collects the same tests. Run
them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have.) Each kernel and its plain version take every
sum in the same order and round every operation alike. The
shared-memory kernel (N ≤ 128) is held to exact agreement; the streamed
kernel (N > 128) to its contract, 1e-4 on all six outputs and the same
breakdown step, and the test prints the error it found. Packing on the
card launches the shared-memory kernel once per chunk of 256 graphs and
gives the plain version's Ritz pairs exactly (bucketed too, with more
Lanczos steps than nodes at the smallest bound); ``QM8Runner``'s resident
epochs and its per-step path agree on the card (1e-6). Each dense model
of the QM8 configs, at full width, gives the CPU's outputs and
gradients on the card (1e-4, float32, gradients relative to each
parameter's largest entry); the bfloat16 flagship's card and CPU outputs
differ by no more than bfloat16 differs from float32 on the card; QM8
AdaLanczosNet's kernel and plain forwards agree in predictions and in
the ``kernel_embed`` gradient (1e-4). Past a lowered kernel limit the
wrapper runs the plain version on the card and counts the route; the
custom operator equals the wrapper and launches the kernel; an artifact
exported on the card launches it per request batch and answers as its
Predictor does with TF32 on around the call (1e-5). Each sparse model
gives the CPU's eval logits and gradients on the card (1e-4); the 16-bit
sparse scatters stay within a bfloat16 ulp of the CPU's; GPNN's dense
partition launches the streamed kernel and equals the CPU's on separated
clusters; ``remat: layers`` gives the loss of no remat (1e-5 relative).
Two steps of the full-width flagship on four ranks of the card (dp=2 ×
tp=2, gloo) give one device's losses and parameters, and each rank holds
the rule's share of the parameters and Adam moments. Two steps of a
node-sharded AdaLanczosNet on two ranks of the card (B2 in every rank's
forward) give one device's logits, losses and gradients. The Jacobi
eigensolver gives cuSOLVER's Ritz values and V tanh(D) Vᵀ on the
flagship's tridiagonals (1e-4), and both kernels over a caching
allocator poisoned with NaN blocks give a clean call's outputs bit for
bit. The CSR product kernels give the CPU's plain version bit for bit
(forward and the backward to x, which both add in edge order; the
weights' gradient within 2^-7 of its terms' magnitudes) at F = [N], 7,
32, 256, on edge- and node-sharded pieces and under remat's replay,
one launch a call and never the plain version.
"""

import copy
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lanczosnet_torch.data.dataset import pack_dataset
from lanczosnet_torch.data.loader import to_device
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.ops import _build, lanczos_cuda
from lanczosnet_torch.ops.lanczos import lanczos_tridiag_resid, lanczos_tridiag_resid_stream
from lanczosnet_torch.ops.lanczos_cuda import (
    LanczosTridiag,
    batched_lanczos_ritz_dispatch,
    lanczos_tridiag_cuda_resid,
    ritz_from_tridiag,
)
from lanczosnet_torch.models import build_model
from lanczosnet_torch.ops.precision import bf16_f32_accumulation
from lanczosnet_torch.train.runner import QM8Runner
from lanczosnet_torch.ops.eigh import eigh_dispatch
from lanczosnet_torch.ops.lanczos import tridiag_matrix
from lanczosnet_torch.utils.config import loads
from lanczosnet_torch.utils.poison import poisoned_lanczos_check

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    missing = []
    if not torch.cuda.is_available():
        missing.append("a CUDA device (torch.cuda.is_available() is false)")
    try:
        _build.nvcc()
    except RuntimeError:
        missing.append("the CUDA toolkit (no nvcc under CUDA_HOME or on PATH)")
    if missing:
        pytest.skip("missing " + " and ".join(missing))
    return torch.device("cuda")


def spd_case(seed: int, b: int, n: int, counts):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) * 0.3
    s = 0.5 * (s + s.transpose(0, 2, 1))
    mask = np.zeros((b, n), np.float32)
    for i, c in enumerate(counts):
        mask[i, :c] = 1.0
        s[i, c:, :] = 0.0
        s[i, :, c:] = 0.0
    return torch.from_numpy(s), torch.from_numpy(mask)


CASES = {
    "n12-k6": (lambda: spd_case(0, 5, 12, [12, 9, 4, 1, 12]), 6),
    "n32-k32": (lambda: spd_case(5, 3, 32, [32, 20, 2]), 32),
    "n33-k33": (lambda: spd_case(1, 3, 33, [33, 30, 2]), 33),
    "n64-k20": (lambda: spd_case(6, 2, 64, [64, 40]), 20),
    "n65-k65": (lambda: spd_case(7, 2, 65, [65, 3]), 65),
    "n128-k20": (lambda: spd_case(2, 4, 128, [128, 100, 7, 1]), 20),
    "n128-k128": (lambda: spd_case(3, 1, 128, [128]), 128),
    "zero": (lambda: (torch.zeros(2, 8, 8), torch.tensor([[1.0] * 3 + [0.0] * 5, [0.0] * 8])), 4),
    # more steps than nodes, as the JAX package runs them (a bucket bound under K)
    "n8-k9": (lambda: spd_case(8, 2, 8, [8, 5]), 9),
    "n16-k20": (lambda: spd_case(9, 4, 16, [16, 12, 3, 16]), 20),
    "n24-k20": (lambda: spd_case(10, 3, 24, [24, 17, 9]), 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(card, case):
    make, k = CASES[case]
    s, mask = (t.to(card) for t in make())
    got = lanczos_tridiag_cuda_resid(s, mask, k)
    torch.cuda.synchronize()
    want = lanczos_tridiag_resid(s, mask, k)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_dispatch_launches_the_kernel(card):
    s, mask = (t.to(card) for t in spd_case(4, 3, 16, [16, 10, 3]))
    before = lanczos_cuda.launches.count
    d, v = batched_lanczos_ritz_dispatch(s, mask, 8)
    torch.cuda.synchronize()
    assert lanczos_cuda.launches.count == before + 1
    assert d.is_cuda and d.shape == (3, 8) and v.shape == (3, 16, 8)


def test_wrapper_refuses_large_graphs_on_the_card(card):
    """Graphs past the streamed kernel's 16384 nodes are refused by name
    under ``impl="kernel"``; the check reads shapes only, so the tensor is
    a view."""
    big = torch.zeros(1, device=card).expand(1, 16385, 16385)
    with pytest.raises(ValueError, match="16384"):
        lanczos_tridiag_cuda_resid(big, torch.ones(1, 16385, device=card), 20, impl="kernel")


def test_shape_routing_on_the_card(card, monkeypatch):
    """With the streamed kernel's node limit lowered to 200, a graph of
    300 nodes on the card runs the plain version under "auto" (its bits
    exactly, no launch, one plain route) and "kernel" raises."""
    monkeypatch.setattr(lanczos_cuda, "STREAM_N_MAX", 200)
    s, mask = (t.to(card) for t in spd_case(15, 2, 300, [300, 250]))
    launches, routes = lanczos_cuda.stream_launches.count, lanczos_cuda.plain_routes.count
    got = lanczos_tridiag_cuda_resid(s, mask, 8)
    torch.cuda.synchronize()
    want = lanczos_tridiag_resid_stream(s, mask, 8)
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert lanczos_cuda.stream_launches.count == launches
    assert lanczos_cuda.plain_routes.count == routes + 1
    with pytest.raises(ValueError, match="200"):
        lanczos_tridiag_cuda_resid(s, mask, 8, impl="kernel")


def test_custom_op_on_the_card_equals_the_wrapper(card):
    s, mask = (t.to(card) for t in spd_case(16, 8, 32, [32, 20, 9, 32, 1, 30, 31, 2]))
    want = lanczos_tridiag_cuda_resid(s, mask, 12)
    before = lanczos_cuda.launches.count
    got = torch.ops.lanczosnet.lanczos_tridiag_resid(s, mask, 12, 1e-6, "auto")
    torch.cuda.synchronize()
    assert lanczos_cuda.launches.count == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_artifact_exported_on_the_card_runs_the_kernel_under_tf32(card, tmp_path):
    """A narrow LanczosNet exported on the card: the loaded artifact
    launches the kernel per request batch and answers as the Predictor
    (TF32 off) does, with TF32 switched on around the call (1e-5)."""
    from lanczosnet_torch.export import export_predictor, load_predictor
    from lanczosnet_torch.serve import Predictor

    cfg = {"name": "LanczosNet", "num_atom": 8, "num_task": 16, "hidden_dim": [32, 32],
           "embed_dim": 32, "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5],
           "num_eig_vec": 8, "filter_hidden_dim": 8}
    model = build_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    pred = Predictor(model, model.state_dict(), n_max=32, batch_size=16, num_eig_vec=8,
                     device=card)
    graphs = synthetic_qm8_graphs(40, seed=3)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = False
        want = pred.predict(graphs)
        loaded = load_predictor(export_predictor(pred, tmp_path / "artifact"), device=card)
        matmul.allow_tf32 = True
        before = lanczos_cuda.launches.count
        got = loaded.predict(graphs)
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved
    assert lanczos_cuda.launches.count == before + 3
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


STREAM_CASES = {
    "n300-k8": (lambda: spd_case(7, 2, 300, [300, 200]), 8),
    "n130-3-real-k8": (lambda: spd_case(8, 1, 130, [3]), 8),
    "n129-k64": (lambda: spd_case(9, 2, 129, [129, 70]), 64),
    "n1000-k20": (lambda: spd_case(10, 1, 1000, [1000]), 20),
    "n2708-k20": (lambda: spd_case(11, 1, 2708, [2708]), 20),
    "zero-n256": (lambda: (torch.zeros(2, 256, 256), torch.ones(2, 256)), 6),
    # more (graph, chunk) pairs than SMs: a block owns several chunks
    "b40-n520-k12": (lambda: spd_case(12, 40, 520, [520 - 13 * i for i in range(40)]), 12),
    # more pairs than the blocks' shared memory holds: two launches
    "b600-n160-k64": (lambda: spd_case(13, 600, 160, [160 - (i % 158) for i in range(600)]), 64),
    "n4096-k5": (lambda: spd_case(14, 1, 4096, [4000]), 5),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_kernel_matches_plain_version(card, case):
    make, k = STREAM_CASES[case]
    s, mask = (t.to(card) for t in make())
    before = lanczos_cuda.stream_launches.count
    got = lanczos_tridiag_cuda_resid(s, mask, k)
    torch.cuda.synchronize()
    # the counter counts launches on the device: one per group of graphs
    plan = lanczos_cuda.stream_plan(s.shape[0], s.shape[1], k, torch.cuda.current_device())
    assert lanczos_cuda.stream_launches.count == before + plan.launches
    want = lanczos_tridiag_resid_stream(s, mask, k)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    print(f"stream kernel vs plain version, {case}: max abs err {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    assert torch.equal((got[1] > 0).sum(1), (want[1] > 0).sum(1))


def test_stream_kernel_at_its_largest_graph(card):
    """N = 16384 (S is 1.07 GB, made on the card), three steps."""
    gen = torch.Generator(device=card).manual_seed(11)
    s = torch.randn(16384, 16384, device=card, generator=gen) * 0.004
    s = (0.5 * (s + s.T))[None].contiguous()
    mask = torch.ones(1, 16384, device=card)
    got = lanczos_tridiag_cuda_resid(s, mask, 3)
    torch.cuda.synchronize()
    want = lanczos_tridiag_resid_stream(s, mask, 3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    assert lanczos_cuda.stream_plan(1, 16384, 3, torch.cuda.current_device()).slots >= 2


def test_stream_plans_of_the_cases_cover_slots_and_groups(card):
    dev = torch.cuda.current_device()
    assert lanczos_cuda.stream_plan(40, 520, 12, dev).slots >= 2
    assert lanczos_cuda.stream_plan(600, 160, 64, dev).launches >= 2
    assert lanczos_cuda.stream_plan(1, 2708, 20, dev).launches == 1


# Two shapes for two threads. The second pair makes blocks own several
# chunks at K=64, so both calls need more than the 48 KB of dynamic shared
# memory a kernel gets unasked, and different amounts of it.
THREAD_CASES = {
    "two-sizes-of-one-graph": (
        [lambda i=i: spd_case(20 + i, 1, 1000 + 300 * i, [900 + 300 * i]) for i in range(2)], 10),
    "two-batches-with-opt-in-shared-memory": (
        [lambda b=b: spd_case(30 + b, b, 160, [160 - (i % 158) for i in range(b)])
         for b in (100, 200)], 64),
}


@pytest.mark.parametrize("case", sorted(THREAD_CASES))
def test_two_threads_on_two_streams_get_the_plain_versions_bits(card, case):
    """Two host threads call the streamed kernel at once, each on its own
    stream and with its own shape, many times over: the calls share no
    scratch, no barrier state and no per-launch setting of the kernel, so
    every result equals the plain version's exactly."""
    makes, k = THREAD_CASES[case]
    inputs = [tuple(t.to(card) for t in make()) for make in makes]
    smem = [lanczos_cuda.stream_plan(s.shape[0], s.shape[1], k, torch.cuda.current_device()).smem_bytes
            for s, _ in inputs]
    assert smem[0] != smem[1]
    if "opt-in" in case:
        assert min(smem) > 48 * 1024
    wants = [lanczos_tridiag_resid_stream(s, mask, k) for s, mask in inputs]
    lanczos_tridiag_cuda_resid(*inputs[0], k)  # build and load before the threads start
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in inputs]
    failures = []
    start = threading.Barrier(len(inputs))

    def worker(i):
        try:
            s, mask = inputs[i]
            start.wait(timeout=60)
            with torch.cuda.stream(streams[i]):
                for rep in range(20):
                    got = lanczos_tridiag_cuda_resid(s, mask, k)
                    streams[i].synchronize()
                    for name, g, w in zip("abqpPw", got, wants[i]):
                        if not torch.equal(g, w):
                            failures.append((i, rep, name, float((g - w).abs().max())))
        except Exception as exc:  # a thread's failure must reach the test
            failures.append((i, repr(exc)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(inputs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert failures == []


def test_wrapper_picks_the_kernel_by_shape(card):
    """N = 128 launches the shared-memory kernel, N = 129 the streamed
    one; ``impl="plain"`` launches neither."""
    for n, counter in ((128, lanczos_cuda.launches), (129, lanczos_cuda.stream_launches)):
        s, mask = (t.to(card) for t in spd_case(n, 1, n, [n]))
        counts = (lanczos_cuda.launches.count, lanczos_cuda.stream_launches.count)
        lanczos_tridiag_cuda_resid(s, mask, 4, impl="plain")
        assert counts == (lanczos_cuda.launches.count, lanczos_cuda.stream_launches.count)
        before = counter.count
        lanczos_tridiag_cuda_resid(s, mask, 4)
        assert counter.count == before + 1
        assert sum(counts) + 1 == lanczos_cuda.launches.count + lanczos_cuda.stream_launches.count


@pytest.mark.parametrize("n", [40, 300])
def test_backward_through_either_kernel_matches_plain_forward(card, n):
    """The adjoint backward on the kernel's residuals against the same
    backward on the plain version's: 1e-4 of the largest entry."""
    s, mask = (t.to(card) for t in spd_case(n, 2, n, [n, n // 2]))
    w = torch.randn(2, 6, n, generator=torch.Generator().manual_seed(0)).to(card)
    grads = []
    for impl in ("kernel", "plain"):
        st = s.clone().requires_grad_()
        a, b, q = LanczosTridiag.apply(st, mask, 6, 1e-6, impl)
        (a.sum() + (b * b).sum() + (w * torch.tanh(q)).sum()).backward()
        grads.append(st.grad)
    assert torch.isfinite(grads[0]).all()
    scale = float(grads[1].abs().max())
    torch.testing.assert_close(grads[0] / scale, grads[1] / scale, rtol=0, atol=1e-4)


def test_pack_on_the_card_runs_the_kernel_per_chunk(card):
    """300 graphs are two chunks of 256 (the tail padded): two launches.
    The operators equal the CPU pack's (1e-6, one float32 formula) and
    the Ritz pairs the plain version's on the card, chunk by chunk,
    exactly."""
    graphs = synthetic_qm8_graphs(300, seed=5)
    before = lanczos_cuda.launches.count
    got = pack_dataset(graphs, n_max=32, num_eig_vec=20, device=card)
    assert lanczos_cuda.launches.count == before + 2
    cpu = pack_dataset(graphs, n_max=32, device="cpu")
    np.testing.assert_allclose(got.ops, cpu.ops, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.mask, cpu.mask)
    np.testing.assert_array_equal(got.atom_type, cpu.atom_type)
    for lo in (0, 256):
        s = torch.from_numpy(got.ops[lo: lo + 256, 0]).to(card)
        m = torch.from_numpy(got.mask[lo: lo + 256]).to(card)
        if s.shape[0] < 256:  # the pack's padded tail chunk
            pad = 256 - s.shape[0]
            s = torch.cat([s, s.new_zeros((pad, 32, 32))])
            m = torch.cat([m, m.new_zeros((pad, 32))])
        a, b, q, *_ = lanczos_tridiag_resid(s, m, 20)
        d, v = ritz_from_tridiag(a, b[:, :19], q)
        real = min(256, 300 - lo)
        assert torch.equal(d[:real].cpu(), torch.from_numpy(got.ritz_val[lo: lo + real]))
        assert torch.equal(v[:real].cpu(), torch.from_numpy(got.ritz_vec[lo: lo + real]))


def test_bucketed_pack_on_the_card_gives_the_plain_versions_ritz_pairs(card):
    """Buckets [16, 24, 32] under K=20: one launch a bucket (each under a
    chunk), the 16 bound with more steps than nodes; each bucket's Ritz
    pairs equal the plain version's on its packed operators exactly."""
    from lanczosnet_torch.data.buckets import pack_dataset_bucketed

    graphs = synthetic_qm8_graphs(120, seed=6, n_lo=4, n_hi=28)
    before = lanczos_cuda.launches.count
    packs, _ = pack_dataset_bucketed(graphs, [16, 24, 32], standardize=True, num_eig_vec=20,
                                     device=card)
    assert sorted(packs) == [16, 24, 32] and lanczos_cuda.launches.count == before + 3
    for bound, ds in packs.items():
        s = torch.from_numpy(ds.ops[:, 0]).to(card)
        m = torch.from_numpy(ds.mask).to(card)
        a, b, q, *_ = lanczos_tridiag_resid(s, m, 20)
        d, v = ritz_from_tridiag(a, b[:, :19], q)
        assert torch.equal(d.cpu(), torch.from_numpy(ds.ritz_val)), bound
        assert torch.equal(v.cpu(), torch.from_numpy(ds.ritz_vec)), bound


def tiny_qm8_config(save_dir, **train) -> dict:
    return {
        "exp_name": "qm8_tiny", "runner": "QM8Runner", "seed": 1234, "save_dir": str(save_dir),
        "dataset": {"source": "synthetic", "n_max": 16, "num_atom": 8, "num_train": 96,
                    "num_val": 40, "num_test": 40, "standardize": True, "operator_kind": "sym",
                    "pack_cache": False},
        "train": {"optimizer": "Adam", "lr": 1e-3, "batch_size": 16, "max_epoch": 2,
                  "valid_epoch": 1, "display_iter": 2, **train},
        "test": {"test_model": None},
        "model": {"name": "LanczosNet", "hidden_dim": [16, 16], "embed_dim": 16,
                  "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5],
                  "num_eig_vec": 8, "spectral_filter_kind": "MLP", "filter_hidden_dim": 8,
                  "dropout": 0.1},
    }


def test_resident_epochs_on_the_card_equal_the_per_step_path(card, tmp_path):
    """With the host's shuffle stream both paths take the same batches,
    and the same dropout stream: equal validation MAE (1e-6). The device
    shuffle trains too. The packs launched the kernel once a split."""
    vals = {}
    for name, train in {"resident": {"scan_epoch": True, "device_shuffle": False},
                        "per-step": {"scan_epoch": False},
                        "device-shuffle": {"scan_epoch": True}}.items():
        before = lanczos_cuda.launches.count
        runner = QM8Runner(tiny_qm8_config(tmp_path / name, **train), device=card)
        assert lanczos_cuda.launches.count == before + 3
        res = runner.train()
        recs = [json.loads(ln) for ln in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
        vals[name] = [r["mae"] for r in recs if r["event"] == "val"]
        assert len(vals[name]) == 2 and np.isfinite(vals[name]).all()
        assert np.isfinite(res["test_mae"])
        assert runner.test()["test_mae"] == pytest.approx(res["test_mae"], abs=1e-6)
    np.testing.assert_allclose(vals["resident"], vals["per-step"], rtol=0, atol=1e-6)


def qm8_model_and_pack(config: str, num: int = 16, **overrides):
    """The model of ``configs/<config>.yaml`` at full width, its weights
    drawn from seed 0, and ``num`` QM8-like graphs packed on the CPU as
    the config packs them."""
    cfg = loads((Path(__file__).resolve().parents[1] / "configs" / f"{config}.yaml").read_text())
    mcfg, dcfg = {**cfg["model"], **overrides}, cfg["dataset"]
    model = build_model({**mcfg, "num_atom": 8, "num_task": 16})
    model.init_weights(torch.Generator().manual_seed(0))
    pack = pack_dataset(
        synthetic_qm8_graphs(num, seed=3), n_max=32, operator_kind=dcfg["operator_kind"],
        num_eig_vec=int(mcfg.get("num_eig_vec", 20)) if mcfg["name"] == "LanczosNet" else 0,
        num_cluster=int(mcfg.get("num_partition", 2)) if mcfg["name"] == "GPNN" else 0,
        device="cpu")
    return model, pack.slice_batch(np.arange(num))


def outputs_and_grads(model, batch, weight):
    """Eval-mode outputs and the gradient of ``Σ weight·outputs``."""
    model.eval().zero_grad(set_to_none=True)
    with bf16_f32_accumulation():
        out = model(batch)
        (out * weight).sum().backward()
    return out.detach().cpu(), {n: p.grad.cpu() for n, p in model.named_parameters()}


@pytest.mark.parametrize("config", ["qm8_gcn", "qm8_graph_sage", "qm8_dcnn", "qm8_chebynet",
                                    "qm8_gat", "qm8_mpnn", "qm8_gpnn"])
def test_dense_model_on_the_card_matches_the_cpu(card, config):
    model, batch = qm8_model_and_pack(config)
    weight = torch.randn(16, 16, generator=torch.Generator().manual_seed(1))
    want, want_g = outputs_and_grads(model, batch, weight)
    got, got_g = outputs_and_grads(copy.deepcopy(model).to(card), to_device(batch, card),
                                   weight.to(card))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    for name, g in want_g.items():
        scale = max(float(g.abs().max()), 1e-30)
        torch.testing.assert_close(got_g[name] / scale, g / scale, rtol=0, atol=1e-4, msg=name)


def test_bf16_flagship_on_the_card_stays_within_bf16_of_the_cpu(card):
    """Both round to bfloat16 at their GEMMs' outputs, summing in other
    orders: the card's and the CPU's bfloat16 outputs may differ, but by
    no more than bfloat16 differs from float32 with the same weights."""
    model, batch = qm8_model_and_pack("qm8_lanczos_net_bf16")
    f32 = copy.deepcopy(model)
    f32.dtype = torch.float32
    for layer in f32.layers:
        layer.act_dtype = torch.float32
    with torch.inference_mode(), bf16_f32_accumulation():
        cpu = model.eval()(batch)
        dev = to_device(batch, card)
        got = copy.deepcopy(model).to(card).eval()(dev).cpu()
        ref = f32.to(card).eval()(dev).cpu()
    gap = float((got - ref).abs().max())
    err = float((got - cpu).abs().max())
    print(f"bf16 flagship: card vs CPU {err}, bf16 vs float32 on the card {gap}")
    assert torch.isfinite(got).all() and 0.0 < gap and err <= gap and err <= 2e-2


def test_qm8_ada_kernel_and_plain_forwards_agree_on_the_card(card):
    model, batch = qm8_model_and_pack("qm8_ada_lanczos_net", num=64)
    model, batch = model.to(card), to_device(batch, card)
    weight = torch.randn(64, 16, generator=torch.Generator().manual_seed(2)).to(card)
    runs = {}
    for impl in ("kernel", "plain"):
        model.lanczos_impl = impl
        before = lanczos_cuda.launches.count
        out, grads = outputs_and_grads(model, batch, weight)
        assert lanczos_cuda.launches.count == before + (impl == "kernel")
        runs[impl] = out, grads["kernel_embed.weight"]
    scale = float(runs["plain"][1].abs().max())
    assert scale > 0 and torch.isfinite(runs["kernel"][1]).all()
    torch.testing.assert_close(runs["kernel"][0], runs["plain"][0], rtol=0, atol=1e-4)
    torch.testing.assert_close(runs["kernel"][1] / scale, runs["plain"][1] / scale,
                               rtol=0, atol=1e-4)


def sparse_runner_on(device, name: str, tmp_path, **model):
    """A narrow sparse runner of ``name`` on a 2000-node edge-list graph."""
    from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

    cfg = {"seed": 3, "save_dir": str(tmp_path / f"{name}_{device}"),
           "dataset": {"source": "synthetic_edges", "num_nodes": 2000, "num_class": 5,
                       "feat_dim": 24, "avg_degree": 4.0},
           "model": {"name": name, "hidden_dim": [32, 32], "num_eig_vec": 10,
                     "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5], **model},
           "train": {"lr": 1e-2, "max_epoch": 2}}
    return SparseCitationRunner(cfg, device)


@pytest.mark.parametrize("name", ["GCN", "ChebyNet", "GAT", "DCNN", "GraphSAGE", "MPNN",
                                  "GPNN", "LanczosNet", "AdaLanczosNet"])
def test_sparse_model_on_the_card_matches_the_cpu(card, tmp_path, name):
    """Eval logits and one step's gradients of each sparse model, card
    against CPU on the same weights, operator and extras (1e-4; the
    gradients relative to each parameter's largest entry, but for one
    whose true gradient is 0)."""
    runner = sparse_runner_on(card, name, tmp_path)
    cpu = sparse_runner_on("cpu", name, tmp_path)
    cpu.model.load_state_dict({k: v.cpu() for k, v in runner.model.state_dict().items()})
    cpu.extras = tuple(e.cpu() for e in runner.extras)
    got, want = {}, {}
    for r, out in ((runner, got), (cpu, want)):
        r.model.eval()
        r.model.zero_grad(set_to_none=True)
        logits = r.forward()
        r.loss(logits).backward()
        out["logits"] = logits.detach().float().cpu()
        out.update({k: p.grad.cpu() for k, p in r.model.named_parameters()})
    torch.testing.assert_close(got["logits"], want["logits"], rtol=0, atol=1e-4)
    # the learned kernel reads only differences of embeddings, so the
    # gradient of kernel_embed.bias is 0 but for rounding (3.6e-11 on the
    # CPU): it is held to that, not to its own largest entry
    bias = want.pop("kernel_embed.bias", None)
    if bias is not None:
        for g in (got.pop("kernel_embed.bias"), bias):
            assert float(g.abs().max()) <= 1e-8
    for key, g in want.items():
        scale = max(float(g.abs().max()), 1e-30)
        torch.testing.assert_close(got[key] / scale, g / scale, rtol=0, atol=1e-4, msg=key)


def test_sparse_ops_on_the_card_keep_16_bit_scatters_in_float32(card):
    """``edge_gather``'s backward and ``spmv`` in bfloat16 on the card:
    the same as on the CPU within one bfloat16 ulp, whatever the order of
    the card's float32 atomics."""
    from lanczosnet_torch.ops import sparse as tsp

    rng = np.random.default_rng(0)
    edges = np.unique(np.sort(rng.integers(0, 5000, (40000, 2)), 1), axis=0)
    edges = edges[edges[:, 0] != edges[:, 1]]
    op = tsp.sparse_sym_operator(edges, 5000)
    x = torch.from_numpy(rng.standard_normal((5000, 16)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((op.num_edges, 16)).astype(np.float32)).bfloat16()
    grads = []
    for dev in ("cpu", card):
        xd = x.to(dev).detach().requires_grad_()
        tsp.edge_gather(op.to(dev), xd).backward(g.to(dev))
        grads.append((xd.grad.float().cpu(), tsp.spmv(op.to(dev), x.to(dev)).float().cpu()))
    for want, got in zip(grads[0], grads[1]):
        torch.testing.assert_close(got, want, rtol=2**-7, atol=1e-5)


def test_ritz_partition_on_the_card_runs_the_streamed_kernel(card):
    """A 300-node graph with separated clusters: the partition on the card
    (its Lanczos call on the streamed kernel) equals the CPU's up to a
    relabelling."""
    from lanczosnet_torch.data.partition import ritz_partition
    from lanczosnet_torch.ops.normalize import build_operator_stack

    rng = np.random.default_rng(1)
    n = 300
    adj = np.zeros((1, 1, n, n), np.float32)
    for c in range(3):
        block = (rng.random((100, 100)) < 0.2).astype(np.float32)
        adj[0, 0, c * 100:(c + 1) * 100, c * 100:(c + 1) * 100] = np.triu(block, 1)
    adj[0, 0, 0, 100] = adj[0, 0, 100, 200] = 1.0
    adj = np.maximum(adj, adj.transpose(0, 1, 3, 2))
    op = build_operator_stack(torch.from_numpy(adj), torch.ones(1, n))[0, 0]
    want = ritz_partition(op, torch.ones(n), 3)
    before = lanczos_cuda.stream_launches.count
    got = ritz_partition(op.to(card), torch.ones(n, device=card), 3)
    assert lanczos_cuda.stream_launches.count == before + 1
    pairs = set(zip(got.tolist(), want.tolist()))
    assert len(pairs) == len(set(got.tolist())) == len(set(want.tolist()))


def test_sparse_remat_layers_on_the_card_gives_the_loss_of_no_remat(card, tmp_path):
    runner = sparse_runner_on(card, "LanczosNet", tmp_path, dtype="bfloat16")
    losses = []
    for remat in (True, False):
        runner.model.set_remat_layers(remat)
        runner.dropout_generator.manual_seed(0)
        losses.append(float(runner.make_train_step(torch.optim.SGD(
            runner.model.parameters(), lr=0.0))()))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)


TESTS = str(Path(__file__).resolve().parent)


def test_the_comm_layer_with_cuda_tensors_on_one_card(card, tmp_path):
    """Two ranks on the one card: gloo (NCCL refuses two ranks on a
    card); all_reduce and broadcast take the CUDA tensors as they are,
    the other collectives are staged through the host; every result and
    backward equals the single-process one exactly (integer-valued
    inputs)."""
    from lanczosnet_torch.parallel import multihost
    import torch_rank_workers as workers

    code = multihost.launch(2, "torch_rank_workers:comm_checks", [str(tmp_path), "cuda"],
                            store_dir=tmp_path, threads=1, pythonpath=[TESTS], timeout=300)
    assert code == 0
    ranks = workers.read_ranks(tmp_path, 2)
    d = 2
    shared = torch.cuda.device_count() == 1  # else each rank has a card: NCCL, no staging
    for r, res in enumerate(ranks):
        assert res["world"]["device"].startswith("cuda")
        assert res["world"]["backend"] == ("gloo" if shared else "nccl")
        assert res["world"]["ranks_per_card"] == (2 if shared else 1)
        assert res["staged"] == {"all_reduce": False, "broadcast": False, "all_gather": shared,
                                 "reduce_scatter": shared, "ring_hop": shared}
        assert (res["stats"]["staged_bytes"] > 0) == shared
        y, g = res["psum"]
        assert torch.equal(y, sum(workers.draw(1, s, (3, 4)) for s in range(d)))
        assert torch.equal(g, sum(workers.draw(2, s, (3, 4)) for s in range(d)))
        y, g = res["all_gather_rows"]
        assert torch.equal(y, torch.cat([workers.draw(4, s, (2, 3)) for s in range(d)]))
        assert torch.equal(g, sum(workers.draw(5, s, (2 * d, 3)) for s in range(d))[
            2 * r: 2 * r + 2])
        y, g = res["ring_hop"]
        assert torch.equal(y, workers.draw(6, (r - 1) % d, (4, 2)))
        assert torch.equal(g, workers.draw(7, (r + 1) % d, (4, 2)))


def test_a_ring_step_holds_less_than_a_node_sharded_one(card, tmp_path):
    """A GCN step on 400k nodes (F=64) over two ranks of the card: each
    rank's peak device memory in the ring form is below its peak in the
    node form, whose all-gather holds every rank's sources at once."""
    from lanczosnet_torch.parallel import multihost
    import torch_rank_workers as workers

    code = multihost.launch(2, "torch_rank_workers:ring_memory", [str(tmp_path), 400_000],
                            store_dir=tmp_path, threads=2, pythonpath=[TESTS], timeout=600)
    assert code == 0
    for res in workers.read_ranks(tmp_path, 2):
        print(res)
        assert res["nodes"]["device"].startswith("cuda")
        assert np.isfinite(res["nodes"]["loss"]) and np.isfinite(res["nodes_ring"]["loss"])
        assert res["nodes_ring"]["peak_mb"] < res["nodes"]["peak_mb"]


def test_a_dp2_tp2_step_on_the_card_matches_one_device(card, tmp_path):
    """Two Adam steps of the full-width flagship (dropout 0.1) on four
    ranks sharing the card over gloo, a dp=2 × tp=2 mesh, against one
    device on the same batch, weights and masks: losses 1e-5 relative,
    the second step's gradients 1e-4 of each parameter's largest (the
    parameters themselves are not compared: Adam's step divides by
    sqrt(v) + 1e-8, so where a gradient is near zero its rounding, which
    differs between the card's GEMMs of two shapes, decides the step);
    each rank's parameter and moment bytes are those the rule predicts
    (half of each cut leaf's, all of the others')."""
    from lanczosnet_torch.parallel import multihost
    import torch_rank_workers as workers

    cfg = loads((Path(TESTS).parent / "configs" / "qm8_lanczos_net.yaml").read_text())
    ds = pack_dataset(synthetic_qm8_graphs(64, seed=3), n_max=32, num_eig_vec=20,
                      standardize=True, device=card)
    model_cfg = {**cfg["model"], "num_atom": 8, "num_task": ds.label.shape[-1]}
    model = build_model(model_cfg)
    model.init_weights(torch.Generator().manual_seed(1))
    fields = ("atom_type", "node_feat", "ops", "mask", "label", "ritz_val", "ritz_vec")
    case = {"key": "step", "kind": "train", "mesh": (2, 2), "model": model_cfg,
            "weights": model.state_dict(), "batch": {f: getattr(ds, f) for f in fields},
            "valid": np.ones(64, np.float32), "train": {"optimizer": "Adam", "lr": 1e-3},
            "steps": 2, "seed": 5, "device": "cuda"}
    torch.save({"cases": [case]}, tmp_path / "spec.pt")
    out = tmp_path / "out"
    out.mkdir()
    code = multihost.launch(4, "torch_rank_workers:mesh_cases",
                            [str(tmp_path / "spec.pt"), str(out)], store_dir=tmp_path,
                            threads=2, pythonpath=[TESTS], timeout=600)
    assert code == 0
    one = workers.train_case(case)
    for res in workers.read_ranks(out, 4):
        assert res["world"]["device"].startswith("cuda")
        got = res["step"]
        for a, b in zip(got["losses"], one["losses"]):
            assert a == pytest.approx(b, rel=1e-5)
        for name, want in one["grads"].items():
            want = workers.as_numpy(want)
            np.testing.assert_allclose(workers.as_numpy(got["grads"][name]), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(), err_msg=name)
        assert got["state_bytes"] == got["predicted_state_bytes"] < one["state_bytes"]


def test_a_node_sharded_step_on_the_card_matches_one_device(card, tmp_path):
    """Synthetic Cora at scale 0.08 (N=216, past the shared-memory
    kernel's 128, so every rank's forward runs B2 on the gathered learned
    operator), AdaLanczosNet with dropout 0.5, on two ranks sharing the
    card over gloo: the eval logits 1e-5, two Adam steps' losses 1e-5
    relative, the first step's gradients 1e-4 of each parameter's largest
    (``kernel_embed.bias``, whose exact gradient is zero, only as noise)."""
    from lanczosnet_torch.parallel import multihost
    from lanczosnet_torch.train.citation_runner import CitationRunner
    import torch_rank_workers as workers

    cfg = {"exp_name": "node_sharded", "runner": "CitationRunner", "seed": 3,
           "dataset": {"source": "synthetic", "name": "cora", "scale": 0.08},
           "model": {"name": "AdaLanczosNet", "hidden_dim": [16], "embed_dim": 16,
                     "dropout": 0.5, "num_eig_vec": 8, "kernel_dim": 8},
           "train": {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4}, "test": {}}
    weights = CitationRunner({**cfg, "save_dir": str(tmp_path / "init")}, "cpu").model.state_dict()
    case = {"key": "ada", "config": cfg, "weights": weights, "steps": 2}
    torch.save({"cases": [case]}, tmp_path / "spec.pt")
    out = tmp_path / "out"
    out.mkdir()
    launches = lanczos_cuda.stream_launches.count
    code = multihost.launch(2, "torch_rank_workers:node_sharded_cases",
                            [str(tmp_path / "spec.pt"), str(out)], store_dir=tmp_path,
                            threads=2, pythonpath=[TESTS], timeout=600)
    assert code == 0
    one = workers.node_case({**case, "device": "cuda"}, tmp_path / "one")
    assert lanczos_cuda.stream_launches.count > launches  # one device's forward ran B2 too
    for res in workers.read_ranks(out, 2):
        got = res["ada"]
        assert got["device"].startswith("cuda") and got["ops_shape"] == (1, 2, 108, 216)
        torch.testing.assert_close(got["logits"], one["logits"], rtol=0, atol=1e-5)
        for a, b in zip(got["losses"], one["losses"]):
            assert a == pytest.approx(b, rel=1e-5)
        for name, want in one["grads"].items():
            scale = float(want.abs().max())
            if name == "kernel_embed.bias":
                noise = 1e-6 * max(float(g.abs().max()) for g in one["grads"].values())
                assert scale < noise and float(got["grads"][name].abs().max()) < noise
                continue
            np.testing.assert_allclose(workers.as_numpy(got["grads"][name]),
                                       workers.as_numpy(want), rtol=0, atol=1e-4 * scale,
                                       err_msg=name)


def test_jacobi_on_the_card_matches_the_default_solver(card):
    """The flagship's tridiagonals (64 QM8 graphs, N=32, K=20, from B1):
    Jacobi's Ritz values and V tanh(D) Vᵀ within 1e-4 of cuSOLVER's."""
    graphs = synthetic_qm8_graphs(64, seed=1)
    ds = pack_dataset(graphs, n_max=32, device=card)
    s = torch.from_numpy(ds.ops[:, 0]).to(card).contiguous()
    mask = torch.from_numpy(ds.mask).to(card)
    alphas, betas, q, *_ = lanczos_tridiag_cuda_resid(s, mask, 20)
    t = tridiag_matrix(alphas, betas[:, :19])
    pairs = {}
    for impl in ("auto", "jacobi"):
        vals, u = eigh_dispatch(t, impl)
        vecs = q.transpose(1, 2).double() @ u.double()
        pairs[impl] = (vals, vecs @ (torch.tanh(vals.double())[:, :, None] * vecs.transpose(1, 2)))
    assert float((pairs["jacobi"][0] - pairs["auto"][0]).abs().max()) <= 1e-4
    assert float((pairs["jacobi"][1] - pairs["auto"][1]).abs().max()) <= 1e-4


def test_both_kernels_over_a_poisoned_allocator_equal_clean_calls(card):
    check = poisoned_lanczos_check(card, np.random.default_rng(1))
    assert {name: c["bit_equal"] and c["finite"] for name, c in check.items()} == {
        "B1": True, "B2": True}, check


# The CSR product kernels (csrc/spmm_csr.cu). The plain version on the CPU
# adds in edge order (index_add), as the kernels do, so the forward and the
# backward to x are held to it bit for bit; the weights' gradient sums its
# products in another order than autograd's bfloat16 products, so it is held
# to 2^-7 of the sum of its terms' magnitudes (float32: 1e-6 of it).

def csr_graph(n: int, m: int, seed: int, hub: int = 0):
    """A sym-normalized operator on the CPU: ``m`` random pairs, nodes 0
    and n-1 isolated (empty rows), a fifth of the edges dead, and with
    ``hub`` node 1 joined to ``hub`` others."""
    from lanczosnet_torch.ops import sparse as tsp

    rng = np.random.default_rng(seed)
    a, b = rng.integers(2, n - 1, m), rng.integers(2, n - 1, m)
    pairs = [np.stack([a, b], 1)]
    if hub:
        pairs.append(np.stack([np.ones(hub, np.int64), np.arange(2, hub + 2) % (n - 1)], 1))
    pairs = np.concatenate(pairs)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    op = tsp.sparse_sym_operator(np.unique(np.sort(pairs, 1), axis=0), n)
    return tsp.masked_val_op(op, torch.from_numpy(rng.random(op.num_edges) > 0.2))


def csr_counts():
    from lanczosnet_torch.ops import sparse_cuda

    return tuple(c.count for c in (sparse_cuda.spmm_launches, sparse_cuda.spmm_t_launches,
                                   sparse_cuda.sddmm_launches))


def spmv_and_grads(fn, op, x, g, val_grad: bool):
    """``fn(op, x)``, and the gradients of ``<fn(op, x), g>`` in x and,
    with ``val_grad``, in ``op.val``."""
    xr = x.detach().clone().requires_grad_()
    val = op.val.detach().clone().requires_grad_(val_grad)
    out = fn(op.replace(val=val), xr)
    out.backward(g)
    return out.detach(), xr.grad, val.grad


def dval_bound(op, x, g, dtype):
    terms = (g.float().index_select(0, op.row) * x.float().index_select(0, op.col))
    terms = terms.reshape(op.num_edges, -1).abs().sum(1)
    return (2**-7 if dtype == torch.bfloat16 else 1e-6) * terms + 1e-30


CSR_SHAPES = {"vector": (), "f32": (32,), "f7": (7,), "f256": (256,)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(CSR_SHAPES))
def test_csr_kernels_equal_the_cpu_plain_version(card, shape, dtype):
    """Empty rows, dead edges and a row of degree 1,200; F = [N], 7, 32,
    256: forward and dx bit for bit the CPU's plain version, dval within
    its bound; one launch of each kernel a call."""
    from lanczosnet_torch.ops import sparse as tsp

    op = csr_graph(3000, 9000, 0, hub=1200)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3000,) + CSR_SHAPES[shape]).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3000,) + CSR_SHAPES[shape]).astype(np.float32))
    x, g = x.to(dtype), g.to(dtype)
    before = csr_counts()
    got = spmv_and_grads(tsp.spmv, op.to(card), x.to(card), g.to(card), True)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(csr_counts(), before)) == (1, 1, 1)
    want = spmv_and_grads(tsp._spmv_plain, op, x, g, True)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)
    err = (got[2].cpu() - want[2]).abs()
    assert bool((err <= dval_bound(op, x, g, dtype)).all()), float(err.max())


@pytest.mark.parametrize("mode", ["edges", "nodes", "ring"])
def test_csr_kernels_on_sharded_pieces_equal_the_cpu(card, mode):
    """A rank's piece of ``parallel/mesh.py`` (edge-sharded: a slice of
    the edges, padded with dead edges at the last row; node-sharded: a
    block's rows against every source, padded; ring: each hop's slice,
    padded, against its source block): the kernel on the piece, given
    the x it reads, equals the plain version bit for bit, forward and
    dx, bfloat16."""
    from lanczosnet_torch.ops import sparse as tsp
    from lanczosnet_torch.parallel import mesh

    whole = csr_graph(2002, 6000, 2)  # 2002 nodes: the node blocks are padded
    args = (whole.row.numpy(), whole.col.numpy(), whole.val.numpy(), 2002, 4)
    if mode == "ring":
        arrays, n_pad = mesh.ring_shard_arrays(*args)
        n = n_pad // 4
        one = type("OneRank", (), {"size": 1, "rank": 0})()
        rng = np.random.default_rng(4)
        for r in range(4):
            rop = mesh.ring_op_piece({k: v[r] for k, v in arrays.items()}, n, one, "cpu")
            for s in range(4):
                # the hop that brings block s: a one-slice ring
                hop = rop.replace(row=rop.row[s:s + 1], col=rop.col[s:s + 1],
                                  val=rop.val[s:s + 1], row_ptr=rop.row_ptr[s:s + 1])
                x, g = (torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32))
                        .bfloat16() for _ in range(2))
                got = spmv_and_grads(tsp.spmv, hop.to(card), x.to(card), g.to(card), False)
                want = spmv_and_grads(tsp.spmv, hop, x, g, False)
                for a, b in zip(got[:2], want[:2]):
                    assert torch.equal(a.cpu(), b), (mode, r, s)
        return
    if mode == "edges":
        arrays, n, n_src = mesh.shard_sparse_arrays(*args), 2002, 2002
    else:
        arrays, n_pad = mesh.node_shard_arrays(*args)
        n, n_src = n_pad // 4, n_pad
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n_src, 32)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32)).bfloat16()
    for r in range(4):
        piece = mesh.sparse_op_piece({k: v[r] for k, v in arrays.items()}, n, None, mode, "cpu")
        got = spmv_and_grads(tsp.spmv, piece.to(card), x.to(card), g.to(card), False)
        want = spmv_and_grads(tsp._spmv_plain, piece, x, g, False)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a.cpu(), b), (mode, r)


def test_csr_kernels_under_remat_replay(card):
    """Two products under ``torch.utils.checkpoint`` (non-reentrant, as
    ``remat: layers`` runs them): the forward, the replay in the backward
    and the two transposed products all launch kernels, and the
    gradients equal those without the checkpoint bit for bit (the sums'
    order is fixed, where atomics changed it)."""
    from torch.utils.checkpoint import checkpoint

    from lanczosnet_torch.ops import sparse as tsp

    op = csr_graph(4000, 12000, 4).to(card)
    x = torch.randn(4000, 32, generator=torch.Generator().manual_seed(0)).bfloat16().to(card)
    w = torch.randn(32, 32, generator=torch.Generator().manual_seed(1)).bfloat16().to(card)

    def layer(h):
        return tsp.spmv(op, torch.relu(tsp.spmv(op, h) @ w))

    grads = []
    for remat in (False, True):
        xr = x.detach().requires_grad_()
        before = csr_counts()
        y = checkpoint(layer, xr, use_reentrant=False) if remat else layer(xr)
        y.float().square().sum().backward()
        torch.cuda.synchronize()
        grads.append(xr.grad)
        counted = tuple(a - b for a, b in zip(csr_counts(), before))
        assert counted == ((4 if remat else 2), 2, 0), counted
    assert torch.equal(grads[0], grads[1])


def test_csr_kernels_never_reach_the_plain_version_on_the_card(card, monkeypatch):
    """A CUDA ``spmv`` and its backward, the weights' gradient too, with
    the plain version and ATen's segment sum made to raise; a CUDA op
    without ``row_ptr`` raises rather than run another path."""
    from lanczosnet_torch.ops import sparse as tsp

    def refuse(*_):
        raise AssertionError("the plain version ran on the card")

    op = csr_graph(1000, 3000, 5).to(card)
    monkeypatch.setattr(tsp, "_spmv_plain", refuse)
    monkeypatch.setattr(tsp, "_segsum", refuse)
    monkeypatch.setattr(tsp, "_EdgeGather", None)
    x = torch.randn(1000, 16, device=card)
    out, dx, dval = spmv_and_grads(tsp.spmv, op, x, torch.ones_like(x), True)
    assert out.is_cuda and dx.is_cuda and dval.is_cuda
    with pytest.raises(ValueError, match="row_ptr"):
        tsp.spmv(op.replace(row_ptr=None), x)


@pytest.mark.parametrize("name,remat,forward,backward", [
    ("LanczosNet", "layers", 12, 2), ("LanczosNet", None, 8, 2), ("GCN", None, 4, 1)])
def test_an_epoch_on_the_card_runs_every_product_through_the_kernel(card, tmp_path, name, remat,
                                                                   forward, backward):
    """One epoch (the step and ``accuracy("val")``, as the benchmark's
    unit) of the bfloat16 sparse LanczosNet and GCN: one forward kernel
    launch a ``sparse.spmv`` span (the step's products, remat's replay,
    the validation pass), one transposed launch a product whose input
    needs a gradient (layer 0's do not), no weight gradient."""
    from lanczosnet_torch.train.optim import build_optimizer

    runner = sparse_runner_on(card, name, tmp_path, dtype="bfloat16", dropout=0.5)
    runner.model.set_remat_layers(remat == "layers")
    optimizer, scheduler, clip = build_optimizer(runner.model.parameters(), runner.config["train"],
                                                 1)
    step = runner.make_train_step(optimizer, scheduler, clip)
    step()
    runner.accuracy("val")
    before = csr_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
        runner.accuracy("val")
    torch.cuda.synchronize()
    spans = sum(e.count for e in prof.key_averages() if e.key == "sparse.spmv")
    assert spans == forward
    assert tuple(a - b for a, b in zip(csr_counts(), before)) == (forward, backward, 0)
