"""The port's operators and Lanczos recursion against the JAX package, on
the CPU.

The JAX side runs as its own tests run it here: the ``lax.scan``
recursion, and the Pallas kernel in interpret mode. Tolerances:
operator stacks 1e-6 and start vectors 1e-7 (the same float32 formula);
the six tridiagonalization outputs 1e-4 (the contract of
tests/test_lanczos_pallas.py); Ritz reconstructions ``V diag(D) Vᵀ``
1e-3 (two eigensolvers, as tests/test_lanczos_pallas.py compares them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.data.qm8 import synthetic_qm8_graphs
from lanczosnet_tpu.ops.lanczos import (
    _lanczos_fwd_resid,
    batched_lanczos_ritz,
    lanczos_start_vector as jax_start_vector,
)
from lanczosnet_tpu.ops.lanczos_pallas import lanczos_tridiag_pallas_resid
from lanczosnet_tpu.ops.normalize import build_operator_stack as jax_build_operator_stack
from lanczosnet_torch.core.graph_batch import batch_graphs
from lanczosnet_torch.ops import _build, lanczos_cuda
from lanczosnet_torch.ops.lanczos import lanczos_start_vector, lanczos_tridiag_resid
from lanczosnet_torch.ops.lanczos_cuda import (
    batched_lanczos_ritz_dispatch,
    lanczos_tridiag_cuda_resid,
)
from lanczosnet_torch.ops.normalize import build_operator_stack

OUTPUTS = ("alphas", "betas_full", "q", "p1", "p2", "w4")


def spd_batch(seed: int, b: int = 5, n: int = 12, counts=None):
    """Random symmetric operators masked to ``counts`` real nodes each
    (the cases of tests/test_lanczos_pallas.py:random_spd_batch)."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) * 0.3
    s = 0.5 * (s + s.transpose(0, 2, 1))
    mask = np.zeros((b, n), np.float32)
    for i, c in enumerate((counts or [n, n - 3, 4, 1, n])[:b]):
        mask[i, :c] = 1.0
        s[i, c:, :] = 0.0
        s[i, :, c:] = 0.0
    return s, mask


def qm8_operators(b: int, n_max: int = 32, seed: int = 0):
    host = batch_graphs(synthetic_qm8_graphs(b, seed=seed), n_max)
    ops = np.asarray(jax_build_operator_stack(host["adj"], host["mask"]))
    return np.ascontiguousarray(ops[:, 0]), host["mask"]


def zero_graphs():
    mask = np.zeros((2, 8), np.float32)
    mask[0, :3] = 1.0
    return np.zeros((2, 8, 8), np.float32), mask


CASES = {
    "spd-k6": (lambda: spd_batch(0), 6),
    "spd-k12": (lambda: spd_batch(1, b=4, n=12, counts=[12, 10, 7, 12]), 12),
    "qm8-k20": (lambda: qm8_operators(8), 20),
    "zero-graph": (zero_graphs, 4),
}


@pytest.mark.parametrize("kind", ["sym", "row"])
@pytest.mark.parametrize("self_loop", [False, True])
def test_build_operator_stack_matches_jax(kind, self_loop):
    host = batch_graphs(synthetic_qm8_graphs(6, seed=3, n_hi=20), 24)
    want = np.asarray(
        jax_build_operator_stack(host["adj"], host["mask"], kind=kind, add_self_loop=self_loop)
    )
    got = build_operator_stack(
        torch.from_numpy(host["adj"]), torch.from_numpy(host["mask"]),
        kind=kind, add_self_loop=self_loop,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_start_vector_matches_jax():
    mask = np.zeros((4, 40), np.float32)
    for i, c in enumerate((40, 17, 1, 0)):
        mask[i, :c] = 1.0
    want = np.asarray(jax_start_vector(jnp.asarray(mask)))
    got = lanczos_start_vector(torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tridiag_resid_matches_scan_and_pallas(case):
    make, k = CASES[case]
    s, mask = make()
    got = lanczos_tridiag_resid(torch.from_numpy(s), torch.from_numpy(mask), k)
    scan = jax.vmap(lambda si, mi: _lanczos_fwd_resid(si, mi, k, 1e-6))(
        jnp.asarray(s), jnp.asarray(mask)
    )
    pallas = lanczos_tridiag_pallas_resid(jnp.asarray(s), jnp.asarray(mask), k, interpret=True)
    for name, g, a, p in zip(OUTPUTS, got, scan, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=1e-4, err_msg=f"{name} vs scan")
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-4, err_msg=f"{name} vs pallas")
    assert all(np.isfinite(g.numpy()).all() for g in got)


@pytest.mark.parametrize("case", ["spd-k6", "qm8-k20"])
def test_ritz_reconstruction_matches_jax(case):
    make, k = CASES[case]
    s, mask = make()
    d_j, v_j = batched_lanczos_ritz(jnp.asarray(s), jnp.asarray(mask), k)
    d_t, v_t = batched_lanczos_ritz_dispatch(torch.from_numpy(s), torch.from_numpy(mask), k)
    want = np.einsum("bnk,bk,bmk->bnm", np.asarray(v_j), np.asarray(d_j), np.asarray(v_j))
    got = torch.einsum("bnk,bk,bmk->bnm", v_t, d_t, v_t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_dispatch_sends_cpu_tensors_to_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU tensor reached the CUDA build of {name}")

    monkeypatch.setattr(_build, "load", no_build)
    s, mask = qm8_operators(4)
    before = lanczos_cuda.launches.count
    d, v = batched_lanczos_ritz_dispatch(torch.from_numpy(s), torch.from_numpy(mask), 20)
    assert lanczos_cuda.launches.count == before
    assert d.shape == (4, 20) and v.shape == (4, 32, 20)
    # the wrapper itself takes a CPU tensor to the plain version
    got = lanczos_tridiag_cuda_resid(torch.from_numpy(s), torch.from_numpy(mask), 20)
    want = lanczos_tridiag_resid(torch.from_numpy(s), torch.from_numpy(mask), 20)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize(
    "s_shape,mask_shape,k,match",
    [
        ((4, 8), (4, 8), 2, r"\[B, N, N\]"),
        ((2, 8, 7), (2, 8), 2, r"\[B, N, N\]"),
        ((2, 8, 8), (2, 7), 2, "mask"),
        ((0, 8, 8), (0, 8), 2, "empty"),
        ((1, 129, 129), (1, 129), 65, "k=65 > 64"),
        ((2, 8, 8), (2, 8), 0, "k=0"),
    ],
)
def test_wrapper_rejects_shapes_the_kernel_does_not_take(s_shape, mask_shape, k, match):
    """Shapes no path takes raise whatever ``impl`` asks; a shape past the
    kernels' limits (K > 64 at N > 128) raises where the kernel is asked
    for by name (under "auto" it routes to the plain version:
    ``tests/test_torch_adjoint.py:test_shape_routing_past_the_kernel_limits``)."""
    with pytest.raises(ValueError, match=match):
        lanczos_tridiag_cuda_resid(torch.zeros(s_shape), torch.zeros(mask_shape), k,
                                   impl="kernel")


@pytest.mark.parametrize("n,k", [(8, 9)], ids=["k=9"])
def test_more_steps_than_nodes_match_the_scan(n, k):
    """K > N runs as in the JAX package: once the basis spans the graph,
    CGS2 leaves w at rounding level, the step breaks down and every later
    row is zero. All six outputs against the scan (1e-4); under "auto" a
    K within the shared-memory kernel's padded N is no plain route, and a
    K above it is one, named where the kernel is asked for."""
    s, mask = spd_batch(0, b=2, n=n, counts=[n, 5])
    got = lanczos_tridiag_cuda_resid(torch.from_numpy(s), torch.from_numpy(mask), k)
    scan = jax.vmap(lambda si, mi: _lanczos_fwd_resid(si, mi, k, 1e-6))(
        jnp.asarray(s), jnp.asarray(mask)
    )
    for name, g, a in zip(OUTPUTS, got, scan):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=1e-4, err_msg=name)
    assert (got[1][:, n:] == 0).all() and (got[2][:, n:] == 0).all()
    # the repeated zero Ritz values keep the eigh backward finite
    st = torch.from_numpy(s).requires_grad_()
    vals, vecs = batched_lanczos_ritz_dispatch(st, torch.from_numpy(mask), k)
    assert (vals[1].abs() < 1e-6).sum() >= k - 5
    (vals.sum() + torch.tanh(vecs).sum()).backward()
    assert torch.isfinite(st.grad).all()
    assert lanczos_cuda.kernel_limit(n, k) is None
    assert "k=33 > 32" in lanczos_cuda.kernel_limit(n, 33)
    with pytest.raises(ValueError, match="k=33 > 32"):
        lanczos_tridiag_cuda_resid(torch.from_numpy(s), torch.from_numpy(mask), 33,
                                   impl="kernel")


def _scan_w4_in_c1_band(s, mask, k):
    """Per graph: does the JAX scan reach a step whose ‖w₄‖ lies in
    (1e-7, 1e-5), where the breakdown decision is rounding noise (C1)?"""
    scan = jax.vmap(lambda si, mi: _lanczos_fwd_resid(si, mi, k, 1e-6))(
        jnp.asarray(s), jnp.asarray(mask)
    )
    w_norm = np.linalg.norm(np.asarray(scan[5]), axis=-1)
    return ((w_norm > 1e-7) & (w_norm < 1e-5)).any(-1)


def test_k_above_n_ritz_pairs_and_pack_match_jax():
    """QM8-like graphs of 4–16 nodes packed at n_max=16 with K=20 (a
    bucket bound under the flagship's K): Ritz values sorted within 1e-5
    of the JAX package's; V tanh(D) Vᵀ within 1e-4 on the graphs whose
    scan has no ‖w₄‖ in (1e-7, 1e-5) (C1: there the result depends on
    the order of summation), at least 6 of the 8 kept; and the whole
    ``pack_dataset`` against JAX's pack of the same graphs."""
    from lanczosnet_tpu.data.dataset import pack_dataset as jax_pack_dataset
    from lanczosnet_torch.data.dataset import pack_dataset

    graphs = synthetic_qm8_graphs(8, seed=0, n_lo=4, n_hi=16)
    want = jax_pack_dataset(graphs, n_max=16, num_eig_vec=20, standardize=True)
    got = pack_dataset(graphs, n_max=16, num_eig_vec=20, standardize=True, device="cpu")
    assert got.ritz_val.shape == (8, 20) and got.ritz_vec.shape == (8, 16, 20)
    assert np.isfinite(got.ritz_val).all() and np.isfinite(got.ritz_vec).all()
    for name in ("atom_type", "mask", "label", "node_feat"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.ops, want.ops, atol=1e-6)
    np.testing.assert_allclose(np.sort(got.ritz_val, -1), np.sort(want.ritz_val, -1), atol=1e-5)
    kept = ~_scan_w4_in_c1_band(got.ops[:, 0], got.mask, 20)
    assert kept.sum() >= 6, kept

    def recon(d, v):
        return np.einsum("bnk,bk,bmk->bnm", v, np.tanh(d), v)

    np.testing.assert_allclose(recon(got.ritz_val, got.ritz_vec)[kept],
                               recon(want.ritz_val, want.ritz_vec)[kept], atol=1e-4)


def test_qm8_breakdown_depends_on_summation_order():
    """Why the QM8 cases above hold 8 graphs, and why the CUDA kernel is
    held to its plain version bit for bit rather than to a tolerance.

    Where a graph's Krylov space runs out before step K, β is rounding
    noise of the order of ε; whether the step breaks down, and the noise
    direction normalized into the next basis vector when it does not,
    depend on the order of summation. Over 64 QM8-like graphs the JAX
    package's own two implementations part by O(1) in Q, and the port's
    plain version parts from the scan as much; the first 8 graphs of
    seed 0 reach no such step and agree to 1e-4 (above)."""
    s, mask = qm8_operators(64, seed=1)
    k = 20
    scan = jax.vmap(lambda si, mi: _lanczos_fwd_resid(si, mi, k, 1e-6))(
        jnp.asarray(s), jnp.asarray(mask)
    )
    pallas = lanczos_tridiag_pallas_resid(jnp.asarray(s), jnp.asarray(mask), k, interpret=True)
    ours = lanczos_tridiag_resid(torch.from_numpy(s), torch.from_numpy(mask), k)
    q_scan = np.asarray(scan[2])
    assert np.abs(np.asarray(pallas[2]) - q_scan).max() > 0.1
    assert np.abs(ours[2].numpy() - q_scan).max() > 0.1
    # the disagreement starts at a step whose β is within a decade of ε
    w_norm = np.linalg.norm(np.asarray(scan[5]), axis=-1)
    assert ((w_norm > 1e-7) & (w_norm < 1e-5)).any()
