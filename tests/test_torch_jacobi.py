"""The port's Jacobi eigensolver and ``eigh_dispatch`` against the JAX
package's (``lanczosnet_tpu/ops/jacobi.py``, ``ops/eigh.py``).

The same symmetric matrices, drawn with numpy from a seed, go through
both solvers at the JAX dispatch's sweep count. Tolerances are those of
``tests/test_jacobi.py``: eigenvalues, reconstruction and orthonormality
5e-5 through K=32, 2e-4 above (its large-K test: the fixed sweep budget
leaves about 6e-5 of reconstruction error at K=64 in both packages);
``V tanh(D) Vᵀ`` (free of the eigenvectors' signs) 1e-4 of JAX's;
the gradient of a sign-invariant loss 1e-4 relative of the JAX Jacobi's.
Of the two angles that zero a pair, the port rotates by the inner one
(``ops/jacobi.py``); on the flagship's Lanczos tridiagonals that
converges within the JAX sweep budget where the JAX solver's outer
angle does not, which one test records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.ops.eigh import _JACOBI_MAX_K, _jacobi_sweeps
from lanczosnet_tpu.ops.jacobi import _round_robin_pairs, jacobi_eigh as jax_jacobi_eigh
from lanczosnet_torch.ops.eigh import JACOBI_MAX_K, eigh, eigh_dispatch, jacobi_sweeps
from lanczosnet_torch.ops.jacobi import jacobi_eigh, round_robin_pairs
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.core.graph_batch import batch_graphs
from lanczosnet_torch.ops.lanczos import lanczos_tridiag_resid, tridiag_matrix
from lanczosnet_torch.ops.normalize import build_operator_stack

TOL = 5e-5
LARGE_K_TOL = 2e-4  # K > 32
FN_TOL = 1e-4
GRAD_RTOL = 1e-4


def random_sym(seed: int, b: int, k: int) -> np.ndarray:
    a = np.random.default_rng(seed).standard_normal((b, k, k)).astype(np.float32)
    return 0.5 * (a + a.transpose(0, 2, 1))


def tanh_fn(w: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.einsum("bik,bk,bjk->bij", v, np.tanh(w), v)


def test_round_robin_pairs_equal_jax():
    for k in range(2, 65, 2):
        np.testing.assert_array_equal(round_robin_pairs(k).numpy(), _round_robin_pairs(k))
    with pytest.raises(ValueError):
        round_robin_pairs(5)


def test_sweeps_and_width_limit_equal_jax():
    assert JACOBI_MAX_K == _JACOBI_MAX_K
    assert [jacobi_sweeps(k) for k in range(2, 81)] == [_jacobi_sweeps(k) for k in range(2, 81)]


@pytest.mark.parametrize("k", [4, 20, 21, 48, 64])
def test_jacobi_matches_jax(k):
    a = random_sym(k, 4, k)
    w, v = eigh_dispatch(torch.from_numpy(a), impl="jacobi")
    w, v = w.numpy(), v.numpy()
    w_j, v_j = (np.asarray(x) for x in jax_jacobi_eigh(jnp.asarray(a), _jacobi_sweeps(k)))
    tol = TOL if k <= 32 else LARGE_K_TOL
    np.testing.assert_allclose(w, w_j, atol=tol)
    assert (np.diff(w, axis=-1) >= 0).all()
    eye = np.eye(k, dtype=np.float32)
    for g in range(a.shape[0]):
        np.testing.assert_allclose(v[g].T @ v[g], eye, atol=tol)
        np.testing.assert_allclose(v[g] @ np.diag(w[g]) @ v[g].T, a[g], atol=tol)
    np.testing.assert_allclose(tanh_fn(w, v), tanh_fn(w_j, v_j), atol=FN_TOL)


def test_jacobi_converges_on_the_flagships_tridiagonals():
    """64 QM8 graphs (N=32, seed 1) through the plain Lanczos recursion at
    K=20: at ``jacobi_sweeps(20)`` = 8 sweeps the port's Ritz values lie
    within 5e-5 of float64 LAPACK's on every graph; the JAX solver's
    outer rotations leave more than 1e-4 on some (1.06e-3 on 2 of 64)."""
    host = batch_graphs(synthetic_qm8_graphs(64, seed=1), 32)
    mask = torch.from_numpy(host["mask"])
    s = build_operator_stack(torch.from_numpy(host["adj"]), mask)[:, 0]
    alphas, betas, *_ = lanczos_tridiag_resid(s, mask, 20, 1e-6)
    t = tridiag_matrix(alphas, betas[:, :19])
    want = np.linalg.eigvalsh(t.double().numpy())
    got = eigh_dispatch(t, impl="jacobi")[0].numpy()
    theirs = np.asarray(jax_jacobi_eigh(jnp.asarray(t.numpy()), _jacobi_sweeps(20))[0])
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
    assert np.abs(theirs - want).max() > 1e-4, np.abs(theirs - want).max()


def test_jacobi_gradient_matches_jax():
    a = random_sym(1, 3, 6)

    def loss_t(x):
        w, v = jacobi_eigh(x)
        return (w ** 2).sum() + (v ** 4).sum()  # v⁴: free of the signs

    x = torch.from_numpy(a).requires_grad_(True)
    loss_t(x).backward()
    g_j = jax.grad(lambda x: sum(jnp.sum(t) for t in (
        jax_jacobi_eigh(x)[0] ** 2, jax_jacobi_eigh(x)[1] ** 4)))(jnp.asarray(a))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(x.grad.numpy(), g_j, atol=GRAD_RTOL * np.abs(g_j).max())


def test_broken_down_tridiagonal_gives_zero_eigenvalues():
    """A Lanczos tridiagonal whose tail broke down (α and β zero): the
    zero block's eigenvalues come out 0 (numpy's, 1e-5), nothing is NaN,
    and the gradient is finite; also at an odd K."""
    for alphas, betas in (([1.0, 2.0, 0.0, 0.0], [0.5, 0.0, 0.0]),
                          ([0.7, -0.3, 0.0, 0.0, 0.0], [0.2, 0.0, 0.0, 0.0])):
        t = tridiag_matrix(torch.tensor([alphas]), torch.tensor([betas])).requires_grad_(True)
        w, v = eigh_dispatch(t, impl="jacobi")
        assert torch.isfinite(w).all() and torch.isfinite(v).all()
        np.testing.assert_allclose(w.detach().numpy(), np.linalg.eigvalsh(t.detach().numpy()),
                                   atol=1e-5)
        assert int((w.detach().abs() < 1e-6).sum()) == len(alphas) - 2
        (w.sum() + (v ** 4).sum()).backward()
        assert torch.isfinite(t.grad).all()


def test_repeated_eigenvalues_give_finite_gradients():
    a = (2.0 * torch.eye(5)).expand(2, 5, 5).clone().requires_grad_(True)
    w, v = jacobi_eigh(a)
    np.testing.assert_allclose(w.detach().numpy(), 2.0, atol=1e-6)
    ((w ** 2).sum() + (v ** 4).sum()).backward()
    assert torch.isfinite(a.grad).all()


def test_jacobi_above_its_width_raises_naming_lapack():
    a = torch.from_numpy(random_sym(3, 2, JACOBI_MAX_K + 1))
    with pytest.raises(ValueError, match="lapack"):
        eigh_dispatch(a, impl="jacobi")
    with pytest.raises(ValueError, match="impl"):
        eigh_dispatch(a, impl="qr")


def test_auto_is_eigh_bit_for_bit_on_the_cpu():
    a = torch.from_numpy(random_sym(4, 6, 20)).requires_grad_(True)
    b = a.detach().clone().requires_grad_(True)
    w, v = eigh_dispatch(a)
    w_ref, v_ref = eigh(b)
    assert torch.equal(w, w_ref) and torch.equal(v, v_ref)
    ((w ** 2).sum() + (v ** 4).sum()).backward()
    ((w_ref ** 2).sum() + (v_ref ** 4).sum()).backward()
    assert torch.equal(a.grad, b.grad)
    w_l, v_l = eigh_dispatch(a.detach(), impl="lapack")
    assert torch.equal(w_l, w_ref) and torch.equal(v_l, v_ref)
