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
breakdown step, and the test prints the error it found.
"""

import numpy as np
import pytest
import torch

from lanczosnet_torch.ops import _build, lanczos_cuda
from lanczosnet_torch.ops.lanczos import lanczos_tridiag_resid, lanczos_tridiag_resid_stream
from lanczosnet_torch.ops.lanczos_cuda import (
    LanczosTridiag,
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
    """Graphs past the streamed kernel's 16384 nodes are refused by
    name; the check reads shapes only, so the tensor is a view."""
    big = torch.zeros(1, device=card).expand(1, 16385, 16385)
    with pytest.raises(ValueError, match="16384"):
        lanczos_tridiag_cuda_resid(big, torch.ones(1, 16385, device=card), 20)


STREAM_CASES = {
    "n300-k8": (lambda: spd_case(7, 2, 300, [300, 200]), 8),
    "n130-3-real-k8": (lambda: spd_case(8, 1, 130, [3]), 8),
    "n129-k64": (lambda: spd_case(9, 2, 129, [129, 70]), 64),
    "n1000-k20": (lambda: spd_case(10, 1, 1000, [1000]), 20),
    "n2708-k20": (lambda: spd_case(11, 1, 2708, [2708]), 20),
    "zero-n256": (lambda: (torch.zeros(2, 256, 256), torch.ones(2, 256)), 6),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_kernel_matches_plain_version(card, case):
    make, k = STREAM_CASES[case]
    s, mask = (t.to(card) for t in make())
    before = lanczos_cuda.stream_launches.count
    got = lanczos_tridiag_cuda_resid(s, mask, k)
    torch.cuda.synchronize()
    assert lanczos_cuda.stream_launches.count == before + 1
    want = lanczos_tridiag_resid_stream(s, mask, k)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    print(f"stream kernel vs plain version, {case}: max abs err {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    assert torch.equal((got[1] > 0).sum(1), (want[1] > 0).sum(1))


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
