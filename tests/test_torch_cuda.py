"""The CUDA Lanczos kernel against its plain version, on the card.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip, and
the skip names what is missing. The decision is made inside a fixture,
never at import, so every test process collects the same tests. Run
them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have.) Kernel and plain version take every sum in the
same order and round every operation alike, so they agree exactly.
"""

import numpy as np
import pytest
import torch

from lanczosnet_torch.ops import _build, lanczos_cuda
from lanczosnet_torch.ops.lanczos import lanczos_tridiag_resid
from lanczosnet_torch.ops.lanczos_cuda import (
    batched_lanczos_ritz_dispatch,
    lanczos_tridiag_cuda_resid,
)

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
    "n33-k33": (lambda: spd_case(1, 3, 33, [33, 30, 2]), 33),
    "n128-k20": (lambda: spd_case(2, 4, 128, [128, 100, 7, 1]), 20),
    "n128-k128": (lambda: spd_case(3, 1, 128, [128]), 128),
    "zero": (lambda: (torch.zeros(2, 8, 8), torch.tensor([[1.0] * 3 + [0.0] * 5, [0.0] * 8])), 4),
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
    with pytest.raises(ValueError, match="B2"):
        lanczos_tridiag_cuda_resid(torch.zeros(1, 129, 129, device=card),
                                   torch.ones(1, 129, device=card), 20)
