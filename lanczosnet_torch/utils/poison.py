"""Poisoned memory: a hunt for reads of memory that nothing wrote.

Counterpart of ``scripts/repro_ada_nan.py:dirty_heap``. A value read
from memory that an op or kernel never wrote is whatever the allocator
handed back: in a clean process mostly zeros, after a long run anything.
These helpers fill freed memory with NaN first, so that such a read
shows as a NaN or as a difference from a clean call:

- ``dirty_host_heap``: NaN-filled numpy and torch blocks of many sizes on
  the host, freed again;
- ``dirty_device``: NaN-filled blocks on a device, of the sizes asked and
  of many others, freed again; on the card they go back to PyTorch's
  caching allocator, which hands them to the next ``torch.empty`` of a
  fitting size;
- ``poisoned_lanczos_check``: the Lanczos dispatch on both kernels' main
  shapes (B1: B=64 QM8 operators, N=32, K=20; B2: a Cora-sized graph,
  N=2708, K=20), once on a clean allocator and once with every output
  and scratch size poisoned: all six outputs must be equal bit for bit.
  The wrappers allocate every output with ``torch.empty``
  (``ops/lanczos_cuda.py``), so an element a kernel fails to write shows
  here.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import batch_graphs
from lanczosnet_torch.data.citation import synthetic_citation_graph
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.ops import lanczos_cuda
from lanczosnet_torch.ops.normalize import build_operator_stack

OUTPUTS = ("alphas", "betas_full", "q", "p1", "p2", "w4")
EPS = 1e-6


def dirty_host_heap(rng: np.random.Generator, blocks: int = 64) -> None:
    """Churn the host allocator's arenas with NaN-filled blocks."""
    junk = []
    for _ in range(blocks):
        a = np.empty(int(rng.integers(1 << 10, 1 << 18)), np.float32)
        a.fill(np.nan)
        junk.append(a)
    for _ in range(blocks // 8):
        junk.append(torch.full((int(rng.integers(1 << 10, 1 << 16)),), float("nan")))
    del junk


def dirty_device(device: torch.device, rng: np.random.Generator, sizes=(), copies: int = 4,
                 blocks: int = 16) -> None:
    """``copies`` NaN-filled float32 blocks of each size in ``sizes``
    (elements) and ``blocks`` of random sizes on ``device``, all freed on
    return: on the card they stay in the caching allocator for reuse."""
    junk = [torch.full((int(n),), float("nan"), device=device)
            for n in sizes for _ in range(copies)]
    junk += [torch.full((int(rng.integers(1 << 10, 1 << 18)),), float("nan"), device=device)
             for _ in range(blocks)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    del junk


def lanczos_cases(device: torch.device) -> dict[str, tuple[torch.Tensor, torch.Tensor, int]]:
    """The two kernels' main-path shapes: ``{"B1": (s [64,32,32], mask,
    20), "B2": (s [1,2708,2708], mask, 20)}``, channel 0 of the
    symmetric normalized operators of seeded graphs."""
    host = batch_graphs(synthetic_qm8_graphs(64, seed=0), 32)
    mask = torch.from_numpy(host["mask"]).to(device)
    s1 = build_operator_stack(torch.from_numpy(host["adj"]).to(device), mask)[:, 0]
    cora = synthetic_citation_graph("cora", seed=7)
    adj = torch.from_numpy(cora["adj"]).to(device)[None, None]
    mask2 = torch.ones(1, adj.shape[-1], device=device)
    s2 = build_operator_stack(adj, mask2)[:, 0]
    return {"B1": (s1.contiguous(), mask, 20), "B2": (s2.contiguous(), mask2, 20)}


def _scratch_sizes(b: int, n: int, k: int) -> list[int]:
    """Elements of every buffer the dispatch allocates for one call."""
    sizes = [b * k, b * k, b * k * n, b * k * k, b * k * k, b * k * n]
    if n > lanczos_cuda.N_MAX:
        chunks = -(-n // lanczos_cuda.STREAM_CHUNK)
        sizes += [b * chunks * n, b * (2 + 2 * k) * chunks]
    return sizes


def poisoned_lanczos_check(device: torch.device, rng: np.random.Generator,
                           cases: dict | None = None) -> dict[str, dict]:
    """Each case through ``lanczos_tridiag_cuda_resid`` on a clean
    allocator, then again after ``dirty_device`` with every buffer size
    of the call: ``{case: {"bit_equal", "finite", "max_abs_diff" (per
    output), "shape"}}``."""
    cases = lanczos_cases(device) if cases is None else cases
    out = {}
    for name, (s, mask, k) in cases.items():
        clean = [t.clone() for t in lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, k, EPS)]
        b, n, _ = s.shape
        dirty_device(device, rng, _scratch_sizes(b, n, k))
        got = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, k, EPS)
        diff = {o: float((g - c).abs().max()) for o, g, c in zip(OUTPUTS, got, clean)}
        out[name] = {"shape": [b, n, k], "max_abs_diff": diff,
                     "finite": all(bool(torch.isfinite(g).all()) for g in got),
                     "bit_equal": all(torch.equal(g, c) for g, c in zip(got, clean))}
    return out
