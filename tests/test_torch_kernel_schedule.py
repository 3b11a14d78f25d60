"""The schedules of the two CUDA Lanczos kernels, held to their plain
versions on the CPU, where no kernel runs.

The kernels keep the plain versions' order of summation and change only
who walks each sum and where its operands live. Three claims carry that,
and each is pinned here without a card:

(a) the streamed kernel's owner decomposition: every chunk of 64 node
    indices is owned by one block, which computes the chunk's partial of
    every sum from its own slice of Q and w; the partials cross the grid
    and every owner adds them in chunk order for itself, six phases a
    step. ``owner_schedule`` below is that schedule in plain PyTorch and
    equals ``lanczos_tridiag_resid_stream`` bit for bit;
(b) the shared-memory kernel's cut and padding: the CGS combine over rows
    0..j only, p1/p2 zero beyond j, every sum zero-padded to 32, 64 or
    128 terms, equal ``lanczos_tridiag_resid`` bit for bit;
(c) ``plan_stream``, the pure function that lays a call of the streamed
    kernel on a device, on a table of shapes and devices.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lanczosnet_torch.core.graph_batch import batch_graphs
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.ops import lanczos_cuda
from lanczosnet_torch.ops.lanczos import (
    STREAM_CHUNK,
    lanczos_start_vector,
    lanczos_tridiag_resid,
    lanczos_tridiag_resid_stream,
)
from lanczosnet_torch.ops.lanczos_cuda import (
    STREAM_SMEM_LIMIT,
    plan_stream,
    stream_smem_bytes,
    tridiag_padded_n,
)
from lanczosnet_torch.ops.normalize import build_operator_stack

OUTPUTS = ("alphas", "betas_full", "q", "p1", "p2", "w4")
CSRC = Path(lanczos_cuda.__file__).resolve().parents[1] / "csrc"


def chain(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension term by term in index order from zero."""
    acc = torch.zeros_like(x[..., 0])
    for t in range(x.shape[-1]):
        acc = acc + x[..., t]
    return acc


def owner_schedule(s, mask, k, eps=1e-6, grid=1 << 30):
    """The streamed kernel's schedule on the CPU. ``grid`` blocks; block
    ``bid`` owns the (graph, chunk) pairs ``slot * grid + bid``. A block's
    state is what the kernel keeps in shared memory: its 64 columns of Q,
    its chunk of w, the previous beta. ``part`` and ``scratch`` are what
    crosses the grid; every phase ends in a barrier, so a phase reads only
    what an earlier phase wrote."""
    s = s.to(torch.float32)
    b, n, _ = s.shape
    ch = STREAM_CHUNK
    nchunk = -(-n // ch)
    pad = nchunk * ch - n
    s = F.pad(s, (0, pad, 0, pad))
    q = torch.zeros(b, k, n + pad)
    q[:, 0] = F.pad(lanczos_start_vector(mask.to(torch.float32), eps), (0, pad))
    alphas, betas = torch.zeros(b, k), torch.zeros(b, k)
    p_out = [torch.zeros(b, k, k), torch.zeros(b, k, k)]
    w4 = torch.zeros(b, k, n + pad)
    part = torch.full((b, nchunk, n + pad), math.nan)
    scratch = torch.full((b, 2 + 2 * k, nchunk), math.nan)

    pairs = b * nchunk
    grid = min(grid, pairs)
    blocks = [[] for _ in range(grid)]
    for p in range(pairs):
        g, c = divmod(p, nchunk)
        sl = slice(c * ch, (c + 1) * ch)
        blocks[p % grid].append({
            "g": g, "c": c, "cols": sl, "beta_prev": torch.zeros(()),
            "Q": torch.zeros(k, ch), "W": torch.full((ch,), math.nan),
        })
        blocks[p % grid][-1]["Q"][0] = q[g, 0, sl]
    owners = [o for block in blocks for o in block]

    for j in range(k):
        rows = j + 1
        # A: every (graph, row chunk): the partial of q_j^T S over its rows
        for g in range(b):
            for c in range(nchunk):
                lo = c * ch
                acc = torch.zeros(n + pad)
                for t in range(ch):
                    acc = acc + q[g, j, lo + t] * s[g, lo + t]
                part[g, c] = acc
        # B: w from the partials in chunk order; alpha's partial
        for o in owners:
            w = torch.zeros(ch)
            for r in range(nchunk):
                w = w + part[o["g"], r, o["cols"]]
            o["W"] = w
            scratch[o["g"], 0, o["c"]] = chain(o["Q"][j] * w)
        # C: alpha, the three-term update, partials of pass 1
        for o in owners:
            alpha = chain(scratch[o["g"], 0])
            q_j = o["Q"][j]
            q_prev = q_j if j > 0 else torch.zeros(ch)  # the carry quirk
            o["W"] = o["W"] - alpha * q_j - o["beta_prev"] * q_prev
            scratch[o["g"], 2: 2 + rows, o["c"]] = chain(o["Q"][:rows] * o["W"])
            if o["c"] == 0:
                alphas[o["g"], j] = alpha
        # D, E: the coefficients of a pass, the subtraction, the next partials
        for pas in range(2):
            for o in owners:
                g, c = o["g"], o["c"]
                base = 2 + pas * k
                coef = chain(scratch[g, base: base + rows])
                acc = torch.zeros(ch)
                for r in range(rows):
                    acc = acc + o["Q"][r] * coef[r]
                o["W"] = o["W"] - acc
                if c == 0:
                    p_out[pas][g, j, :rows] = coef
                if pas == 0:
                    scratch[g, 2 + k: 2 + k + rows, c] = chain(o["Q"][:rows] * o["W"])
                else:
                    w4[g, j, o["cols"]] = o["W"]
                    scratch[g, 1, c] = chain(o["W"] * o["W"])
        # F: beta, the breakdown gate, q_{j+1}
        for o in owners:
            g = o["g"]
            beta = torch.sqrt(torch.clamp_min(chain(scratch[g, 1]), eps * eps))
            valid = bool(beta > eps)
            if j + 1 < k:
                q_next = o["W"] / beta if valid else torch.zeros(ch)
                o["Q"][j + 1] = q_next
                q[g, j + 1, o["cols"]] = q_next
            o["beta_prev"] = beta if valid else torch.zeros(())
            if o["c"] == 0:
                betas[g, j] = o["beta_prev"]
    return alphas, betas, q[:, :, :n], p_out[0], p_out[1], w4[:, :, :n]


def sym_case(seed, b, n, counts, scale=0.1):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) * scale
    s = 0.5 * (s + s.transpose(0, 2, 1))
    mask = np.zeros((b, n), np.float32)
    for i, c in enumerate(counts):
        mask[i, :c] = 1.0
        s[i, c:, :] = 0.0
        s[i, :, c:] = 0.0
    return torch.from_numpy(s), torch.from_numpy(mask)


STREAM_CASES = {
    "n300-k8-one-graph-cut": (lambda: sym_case(7, 2, 300, [300, 200]), 8),
    "n130-3-real-nodes": (lambda: sym_case(130, 1, 130, [3], 0.4), 8),
    "zero-graph-n256": (lambda: (torch.zeros(1, 256, 256), torch.zeros(1, 256)), 6),
    "zero-operator-n256": (lambda: (torch.zeros(2, 256, 256), torch.ones(2, 256)), 6),
    "n200-k1": (lambda: sym_case(200, 1, 200, [200], 0.4), 1),
    "n129-k40": (lambda: sym_case(9, 1, 129, [70]), 40),
}


@pytest.mark.parametrize("grid", [1 << 30, 3], ids=["one-pair-a-block", "three-blocks"])
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_owner_schedule_equals_stream_plain_version_bitwise(case, grid):
    make, k = STREAM_CASES[case]
    s, mask = make()
    want = lanczos_tridiag_resid_stream(s, mask, k)
    got = owner_schedule(s, mask, k, grid=grid)
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, w), f"{name}: max abs diff {float((g - w).abs().max())}"


def test_owner_schedule_breaks_down_where_the_plain_version_does():
    s, mask = STREAM_CASES["n130-3-real-nodes"][0]()
    betas = owner_schedule(s, mask, 8)[1]
    assert 0 < int((betas > 0).sum()) <= 2


def tridiag_as_kernel(s, mask, k, eps=1e-6):
    """``lanczos_tridiag_resid`` as the shared-memory kernel walks it: N
    zero-padded to the kernel's 32, 64 or 128, the CGS coefficients and
    their combine over rows 0..j only."""
    s = s.to(torch.float32)
    b, n, _ = s.shape
    pad = tridiag_padded_n(n) - n
    s = F.pad(s, (0, pad, 0, pad))
    q_buf = s.new_zeros((b, k, n + pad))
    q_buf[:, 0] = F.pad(lanczos_start_vector(mask.to(torch.float32), eps), (0, pad))
    alphas, betas = s.new_zeros((b, k)), s.new_zeros((b, k))
    p_out = [s.new_zeros((b, k, k)), s.new_zeros((b, k, k))]
    w4s = s.new_zeros((b, k, n + pad))
    beta_prev = s.new_zeros((b, 1))
    for j in range(k):
        q_j = q_buf[:, j].clone()
        rows = q_buf[:, : j + 1]
        w = chain(s * q_j[:, None, :])
        alpha = chain(q_j * w)[:, None]
        q_prev = q_j if j > 0 else torch.zeros_like(q_j)
        w = w - alpha * q_j - beta_prev * q_prev
        for pas in range(2):
            p = chain(rows * w[:, None, :])
            acc = torch.zeros_like(w)
            for r in range(j + 1):
                acc = acc + rows[:, r] * p[:, r, None]
            w = w - acc
            p_out[pas][:, j, : j + 1] = p
        beta = torch.sqrt(torch.clamp_min(chain(w * w)[:, None], eps * eps))
        valid = (beta > eps).to(torch.float32)
        alphas[:, j] = alpha[:, 0]
        betas[:, j] = (beta * valid)[:, 0]
        w4s[:, j] = w
        if j + 1 < k:
            q_buf[:, j + 1] = valid * w / beta
        beta_prev = beta * valid
    return alphas, betas, q_buf[:, :, :n], p_out[0], p_out[1], w4s[:, :, :n]


def qm8_case(b, seed):
    host = batch_graphs(synthetic_qm8_graphs(b, seed=seed), 32)
    mask = torch.from_numpy(host["mask"])
    return build_operator_stack(torch.from_numpy(host["adj"]), mask)[:, 0].contiguous(), mask


TRIDIAG_CASES = {
    "qm8-b16-seed0": (lambda: qm8_case(16, 0), 20),
    "qm8-b16-seed1": (lambda: qm8_case(16, 1), 20),
    "zero-graph": (lambda: (torch.zeros(2, 8, 8),
                            torch.tensor([[1.0] * 3 + [0.0] * 5, [0.0] * 8])), 4),
    "n12-k12-masked": (lambda: sym_case(0, 4, 12, [12, 9, 4, 1], 0.3), 12),
    "n33-k33": (lambda: sym_case(1, 2, 33, [33, 2], 0.3), 33),
    "n65-k10": (lambda: sym_case(2, 1, 65, [40], 0.3), 10),
}


@pytest.mark.parametrize("case", sorted(TRIDIAG_CASES))
def test_cut_combine_and_padded_sums_equal_plain_version_bitwise(case):
    make, k = TRIDIAG_CASES[case]
    s, mask = make()
    want = lanczos_tridiag_resid(s, mask, k)
    got = tridiag_as_kernel(s, mask, k)
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: max abs diff {float((g - w).abs().max())}"


def test_qm8_cases_do_break_down():
    """The bitwise claim is only worth its name on graphs that break down."""
    s, mask = qm8_case(16, 0)
    steps = (lanczos_tridiag_resid(s, mask, 20)[1] > 0).sum(1)
    assert int(steps.min()) < 19


@pytest.mark.parametrize("n,want", [(1, 32), (32, 32), (33, 64), (64, 64), (65, 128), (128, 128)])
def test_tridiag_padded_n(n, want):
    assert tridiag_padded_n(n) == want


H100 = dict(sm_count=132, blocks_per_sm=1)
# (b, n, k, device) -> grid, slots, graphs a launch, launches
PLAN_TABLE = {
    "cora": ((1, 2708, 20, H100), (119, 1, 1, 1)),
    "least-n-least-k": ((1, 129, 1, H100), (3, 1, 1, 1)),
    "least-n-most-k": ((1, 129, 64, H100), (3, 1, 1, 1)),
    "most-n-most-k": ((1, 16384, 64, H100), (132, 2, 1, 1)),
    "most-n-least-k": ((1, 16384, 1, H100), (132, 2, 1, 1)),
    "two-mid-graphs": ((2, 300, 8, H100), (10, 1, 2, 1)),
    "batch-beyond-one-grid": ((16, 2708, 20, H100), (132, 6, 16, 1)),
    "batch-beyond-shared-memory": ((200, 1000, 64, H100), (132, 13, 100, 2)),
    "two-blocks-an-sm": ((1, 2708, 20, dict(sm_count=132, blocks_per_sm=2)), (119, 1, 1, 1)),
    "small-device": ((1, 2708, 20, dict(sm_count=16, blocks_per_sm=1)), (16, 3, 1, 1)),
    "uneven-groups": ((7, 16384, 64, dict(sm_count=132, blocks_per_sm=1)), (132, 8, 4, 2)),
}


@pytest.mark.parametrize("case", sorted(PLAN_TABLE))
def test_plan_stream_table(case):
    (b, n, k, device), (grid, slots, graphs, launches) = PLAN_TABLE[case]
    plan = plan_stream(b, n, k, **device)
    assert (plan.grid, plan.slots, plan.graphs_per_launch, plan.launches) == (
        grid, slots, graphs, launches)
    nchunk = -(-n // STREAM_CHUNK)
    assert plan.grid <= device["sm_count"] * device["blocks_per_sm"]  # co-resident
    assert plan.grid * plan.slots >= plan.graphs_per_launch * nchunk  # every pair an owner
    assert plan.smem_bytes == stream_smem_bytes(n, k, plan.slots) <= STREAM_SMEM_LIMIT
    assert (plan.launches - 1) * plan.graphs_per_launch < b <= plan.launches * plan.graphs_per_launch


def test_plan_stream_refuses_what_the_device_cannot_hold():
    with pytest.raises(ValueError, match="cannot hold"):
        plan_stream(1, 16384, 64, sm_count=4, blocks_per_sm=1)
    with pytest.raises(ValueError, match="positive"):
        plan_stream(0, 300, 8, sm_count=132, blocks_per_sm=1)


def test_stream_smem_bytes_counts_what_the_block_keeps():
    # one pair at the citation shape: 20 rows of 65 floats of Q, 64 of w, one
    # beta; 20 coefficients; 8 teams' chunks of q; 43 tiles of 64 partials staged
    assert stream_smem_bytes(2708, 20, 1) == 4 * (20 * 65 + 64 + 1 + 20 + 8 * 64 + 43 * 64)
    assert stream_smem_bytes(2708, 20, 2) - stream_smem_bytes(2708, 20, 1) == 4 * (20 * 65 + 65)
    # many steps on a large graph stage K rows of chunk partials instead
    assert stream_smem_bytes(16384, 64, 1) == 4 * (64 * 65 + 65 + 64 + 8 * 64 + 64 * 257)


@pytest.mark.parametrize("name", ["lanczos_tridiag.cu", "lanczos_stream.cu"])
def test_kernel_sources_keep_the_order_and_the_rounding(name):
    """Nothing that reorders a sum or fuses a rounding may enter a kernel:
    no shuffle tree, no atomic add, no FMA, no fast-math intrinsic; sums
    go through the rounded intrinsics."""
    code = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
    for banned in ("__shfl", "atomicAdd", "fmaf(", "__fmaf", "__fdividef", "__fsqrt_rz",
                   "rsqrtf", "__expf", "wmma", "mma.sync"):
        assert banned not in code, banned
    assert not re.search(r"\bacc\s*\+=", code), "a sum outside __fadd_rn"
    for needed in ("__fadd_rn", "__fmul_rn", "__fsub_rn", "__fdiv_rn", "__fsqrt_rn"):
        assert needed in code, needed
