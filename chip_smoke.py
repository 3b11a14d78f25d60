#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: a CUDA card must be visible; TF32 is switched off for
   matmuls and cuDNN, and the card's name and power limit are printed.
2. build: every kernel of the serving path is built with nvcc from
   ``lanczosnet_torch/csrc`` (seconds and ``-Xptxas -v`` report).
3. kernel: the Lanczos kernel against its plain PyTorch version on the
   card, all six outputs within 1e-4 and the same breakdown step, on
   masked random operators, an all-zero graph, QM8-like operators at
   B=64, N=32, K=20, and N=128; then both timed with CUDA events at
   B=64 and B=256.
4. serve: the flagship LanczosNet of ``configs/qm8_lanczos_net.yaml``
   at full width, weights drawn from a seeded generator, behind
   ``Predictor`` and ``MicroBatcher``, answers QM8-like requests from
   several client threads; every answer is finite and matches the same
   model fed the plain version's Ritz pairs on the card (1e-4); the
   kernel's launch count must grow during this run.
5. kernels: one line per ported kernel, its error, times and launches.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import batch_graphs
from lanczosnet_torch.data.qm8 import NUM_ATOM, NUM_TASK, synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.ops import _build, lanczos_cuda
from lanczosnet_torch.ops.lanczos import lanczos_start_vector, lanczos_tridiag_resid
from lanczosnet_torch.ops.lanczos_cuda import ritz_from_tridiag
from lanczosnet_torch.ops.normalize import build_operator_stack
from lanczosnet_torch.serve import MicroBatcher, Predictor

# configs/qm8_lanczos_net.yaml, its model and dataset sections as written
# (a test holds these literals to the file; the card has no YAML reader)
FLAGSHIP_MODEL = {
    "name": "LanczosNet",
    "hidden_dim": [128, 128, 128],
    "embed_dim": 128,
    "short_diffusion_dist": [1, 2, 3],
    "long_diffusion_dist": [5, 7, 10, 20, 30],
    "num_eig_vec": 20,
    "spectral_filter_kind": "MLP",
    "filter_hidden_dim": 16,
    "dropout": 0.1,
}
FLAGSHIP_DATASET = {
    "source": "synthetic",
    "name": "qm8",
    "n_max": 32,
    "num_atom": 8,
    "num_train": 2048,
    "num_val": 256,
    "num_test": 256,
    "standardize": True,
    "operator_kind": "sym",
}
SERVE_BATCH = 64
TOL = 1e-4  # the kernel's contract with its plain version, all six outputs
OUTPUTS = ("alphas", "betas_full", "q", "p1", "p2", "w4")
EPS = 1e-6
NUM_REQUESTS = 2048
NUM_CLIENTS = 16

# H100 SXM data sheet (at the 700 W limit): HBM rate and float32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


class SmokeFailure(SystemExit):
    def __init__(self, msg: str):
        super().__init__(f"chip_smoke: FAILED: {msg}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` on the device, by CUDA events
    around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def lanczos_bound(b: int, n: int, k: int) -> tuple[float, str, int, int]:
    """Least time in ms the card needs for the tridiagonalization of b
    graphs: each input read once (S, q0), each output written once, and
    the float32 operations of all K steps (the kernel runs every step,
    broken down or not). Returns (ms, what bounds it, bytes, flops)."""
    nbytes = 4 * b * (n * n + n + 2 * k + 2 * k * n + 2 * k * k)
    # per step: matvec 2n², α 2n, three-term update 4n, two CGS passes
    # (projection 2kn + update 2kn each), β 2n+1, normalization n
    flops = b * k * (2 * n * n + 8 * k * n + 9 * n + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def spd_case(rng, b: int, n: int, counts) -> tuple[np.ndarray, np.ndarray]:
    s = rng.standard_normal((b, n, n)).astype(np.float32) * 0.3
    s = 0.5 * (s + s.transpose(0, 2, 1))
    mask = np.zeros((b, n), np.float32)
    for i, c in enumerate(counts):
        mask[i, :c] = 1.0
        s[i, c:, :] = 0.0
        s[i, :, c:] = 0.0
    return s, mask


def qm8_operators(b: int, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    host = batch_graphs(synthetic_qm8_graphs(b, seed=seed), FLAGSHIP_DATASET["n_max"])
    mask = torch.from_numpy(host["mask"]).to(dev)
    ops = build_operator_stack(torch.from_numpy(host["adj"]).to(dev), mask)
    return ops[:, 0].contiguous(), mask


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false; this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit(
        "device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    return smi


def phase_build() -> None:
    built = _build.build_all(["lanczos_tridiag"])
    for b in built:
        log = [ln.strip() for ln in b.log.splitlines() if ln.strip()]
        emit("build", kernel=b.name, seconds=b.seconds, library=b.path.name, nvcc_log=log)


def phase_kernel(dev) -> dict:
    rng = np.random.default_rng(0)
    cases = {}
    for name, (b, n, counts, k) in {
        "spd-n12-k6": (5, 12, [12, 9, 4, 1, 12], 6),
        "spd-n12-k12": (5, 12, [12, 9, 4, 1, 12], 12),
        "spd-n128-k20": (8, 128, [128, 125, 100, 64, 33, 4, 1, 128], 20),
        "spd-n128-k128": (2, 128, [128, 90], 128),
    }.items():
        s, mask = spd_case(rng, b, n, counts)
        cases[name] = (torch.from_numpy(s).to(dev), torch.from_numpy(mask).to(dev), k)
    zero_mask = torch.zeros(2, 8, device=dev)
    zero_mask[0, :3] = 1.0
    cases["zero-graph-k4"] = (torch.zeros(2, 8, 8, device=dev), zero_mask, 4)
    s64, m64 = qm8_operators(SERVE_BATCH, 0, dev)
    cases["qm8-b64-n32-k20"] = (s64, m64, FLAGSHIP_MODEL["num_eig_vec"])

    worst = 0.0
    for name, (s, mask, k) in cases.items():
        got = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, k, EPS)
        torch.cuda.synchronize()
        want = lanczos_tridiag_resid(s, mask, k, EPS)
        torch.cuda.synchronize()
        errs = {}
        for out, g, w in zip(OUTPUTS, got, want):
            if not torch.isfinite(g).all():
                raise SmokeFailure(f"{name}: kernel output {out} is not finite")
            errs[out] = float((g - w).abs().max())
        steps_kernel = (got[1] > 0).sum(1)
        steps_plain = (want[1] > 0).sum(1)
        same_breakdown = bool(torch.equal(steps_kernel, steps_plain))
        err = max(errs.values())
        worst = max(worst, err)
        emit("kernel", case=name, shape=list(s.shape), k=k, max_abs_err=errs,
             valid_steps=steps_kernel.tolist(), same_breakdown=same_breakdown, tol=TOL)
        if err > TOL:
            raise SmokeFailure(f"{name}: kernel differs from its plain version by {err} > {TOL}")
        if not same_breakdown:
            raise SmokeFailure(f"{name}: kernel and plain version break down at different steps")

    k = FLAGSHIP_MODEL["num_eig_vec"]
    timing = {}
    for b in (SERVE_BATCH, 256):
        s, mask = qm8_operators(b, 1, dev)
        n = s.shape[-1]
        q0 = lanczos_start_vector(mask, EPS).contiguous()
        outs = tuple(torch.empty(shape, device=dev) for shape in
                     ((b, k), (b, k), (b, k, n), (b, k, k), (b, k, k), (b, k, n)))
        kernel_ms = cuda_ms(lambda: lanczos_cuda.launch(s, q0, outs, k, EPS), 200, 20)
        plain_ms = cuda_ms(lambda: lanczos_tridiag_resid(s, mask, k, EPS), 20, 3)
        bound_ms, bound_by, nbytes, flops = lanczos_bound(b, n, k)
        timing[b] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops)
        emit("kernel_time", batch=b, n=n, k=k, **timing[b])
    return {"max_abs_err": worst, "timing": timing}


def plain_reference(pred: Predictor, chunk: list) -> np.ndarray:
    """The Predictor's model on the same packed chunk, fed the plain
    version's Ritz pairs on the card."""
    k = pred.num_eig_vec
    with torch.inference_mode():
        batch = pred.graph_batch(*pred._pack(chunk))
        alphas, betas, q, *_ = lanczos_tridiag_resid(batch.ops[:, 0], batch.mask, k, EPS)
        batch.ritz_val, batch.ritz_vec = ritz_from_tridiag(alphas, betas[:, : k - 1], q)
        return pred.model(batch).cpu().numpy()[: len(chunk)]


def stage_breakdown(pred: Predictor, chunk: list, reps: int = 20) -> dict:
    """Host-clock milliseconds of each stage of one request batch, each
    stage ended by a device synchronize (so they add up to more than an
    overlapped request)."""
    k = pred.num_eig_vec
    times = {"pack": [], "to_device_and_operators": [], "lanczos_kernel": [],
             "eigh_and_rotation": [], "model_forward": [], "fetch": []}

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name].append((t1 - t0) * 1e3)
        return t1

    with torch.inference_mode():
        for _ in range(reps):
            t = time.perf_counter()
            packed = pred._pack(chunk)
            t = mark("pack", t)
            batch = pred.graph_batch(*packed)
            t = mark("to_device_and_operators", t)
            alphas, betas, q, *_ = lanczos_cuda.lanczos_tridiag_cuda_resid(
                batch.ops[:, 0], batch.mask, k, EPS)
            t = mark("lanczos_kernel", t)
            batch.ritz_val, batch.ritz_vec = ritz_from_tridiag(alphas, betas[:, : k - 1], q)
            t = mark("eigh_and_rotation", t)
            out = pred.model(batch)
            t = mark("model_forward", t)
            out.cpu().numpy()
            mark("fetch", t)
    return {name: float(np.median(v)) for name, v in times.items()}


def phase_serve(dev, smi: str) -> int:
    cfg = {**FLAGSHIP_MODEL, "num_atom": NUM_ATOM, "num_task": NUM_TASK}
    model = build_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    k = cfg["num_eig_vec"]
    pred = Predictor(
        model, model.state_dict(), n_max=FLAGSHIP_DATASET["n_max"], batch_size=SERVE_BATCH,
        num_eig_vec=k, operator_kind=FLAGSHIP_DATASET["operator_kind"], num_task=NUM_TASK,
        device=dev,
    )
    pred.warmup()
    graphs = synthetic_qm8_graphs(NUM_REQUESTS, seed=2)
    want = np.concatenate([
        plain_reference(pred, graphs[lo: lo + SERVE_BATCH])
        for lo in range(0, NUM_REQUESTS, SERVE_BATCH)
    ])
    breakdown = stage_breakdown(pred, graphs[:SERVE_BATCH])

    futs = [None] * NUM_REQUESTS

    def client(c: int) -> None:
        mine = range(c, NUM_REQUESTS, NUM_CLIENTS)
        for i in mine:
            futs[i] = mb.submit(graphs[i])
        for i in mine:
            futs[i].result(timeout=300)

    lanczos_cuda.launches.reset()
    mb = MicroBatcher(pred, max_delay_ms=5.0)
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(NUM_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = lanczos_cuda.launches.count
        if any(t.is_alive() for t in clients):
            raise SmokeFailure("serving clients did not finish")
        got = np.stack([f.result(timeout=0) for f in futs])
        stats = mb.latency_stats()
    finally:
        mb.close()

    if got.shape != (NUM_REQUESTS, NUM_TASK) or not np.isfinite(got).all():
        raise SmokeFailure(f"served predictions are not finite [{NUM_REQUESTS}, {NUM_TASK}]")
    err = float(np.abs(got - want).max())
    emit(
        "serve", requests=NUM_REQUESTS, clients=NUM_CLIENTS, batch=SERVE_BATCH,
        seconds=wall, requests_per_s=NUM_REQUESTS / wall, latency=stats,
        max_abs_err_vs_plain_ritz=err, tol=TOL, output_abs_max=float(np.abs(got).max()),
        lanczos_launches=launches, stage_ms=breakdown, nvidia_smi=smi,
    )
    if err > TOL:
        raise SmokeFailure(f"served predictions differ from the plain-Ritz model by {err} > {TOL}")
    if launches < 1:
        raise SmokeFailure("the serving run never launched the Lanczos kernel")
    return launches


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kern = phase_kernel(dev)
    launches = phase_serve(dev, smi)
    t64, t256 = kern["timing"][SERVE_BATCH], kern["timing"][256]
    print(json.dumps({"kernels": [{
        "name": "lanczos_tridiag",
        "route": "cuda",
        "source": "lanczosnet_torch/csrc/lanczos_tridiag.cu",
        "replaces": "lanczosnet_tpu/ops/lanczos_pallas.py:81",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": t64["kernel_ms"],
        "kernel_ms": t64["kernel_ms"],
        "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"],
        "bound_by": t64["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes K-step Lanczos",
        "shape": f"B={SERVE_BATCH} N=32 K=20",
        "b256": t256,
    }]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
