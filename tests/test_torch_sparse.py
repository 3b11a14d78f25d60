"""The port's sparse (COO) operators against the JAX package's, on the CPU.

Tolerances: the constructors' arrays are equal exactly (the same numpy
arithmetic); products, segment means, softmaxes and the learned
operator's values 1e-6 (float32, only the order of summation differs);
the gradients of the learned operator 1e-5 relative to their largest
entry; ``edge_gather``'s backward 1e-6 in float32 and one bfloat16 ulp
(2**-7 relative) in bfloat16, and its chunked and unchunked backward
equal exactly (both add in the same order); the Lanczos recursion and
the sparse Ritz pairs through ``V f(D) Vᵀ x`` 1e-3 (two eigensolvers,
as everywhere in the port's tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.ops import sparse as jsp
from lanczosnet_tpu.ops.lanczos import lanczos_tridiag_matvec as jax_lanczos_tridiag_matvec
from lanczosnet_torch.ops import sparse as tsp
from lanczosnet_torch.ops.lanczos import lanczos_tridiag_matvec


def random_edges(n: int, m: int, seed: int) -> np.ndarray:
    """``[E, 2]`` unique undirected pairs i < j, with node 0 isolated and
    the rest in one chain plus random chords."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(1, n - 1), np.arange(2, n)], 1)
    a, b = rng.integers(1, n, m), rng.integers(1, n, m)
    keep = a != b
    pairs = np.concatenate([chain, np.stack([a[keep], b[keep]], 1)])
    return np.unique(np.sort(pairs, 1), axis=0)


def pair(n=200, m=500, seed=0, kind="sym"):
    """(JAX op, port op) of one random edge list."""
    edges = random_edges(n, m, seed)
    if kind == "sym":
        return jsp.sparse_sym_operator(edges, n), tsp.sparse_sym_operator(edges, n)
    return (jsp.sparse_row_stochastic_operator(edges, n),
            tsp.sparse_row_stochastic_operator(edges, n))


def with_dead_edges(jop, top, seed=3):
    """Both ops with the same third of their edges set to 0."""
    keep = np.random.default_rng(seed).random(top.num_edges) > 0.33
    return jsp.masked_val_op(jop, jnp.asarray(keep)), tsp.masked_val_op(top, torch.from_numpy(keep))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("kind", ["sym", "row"])
def test_constructors_equal_jax(kind):
    jop, top = pair(kind=kind)
    for field in ("row", "col", "val", "col_perm"):
        got, want = getattr(top, field).numpy(), np.asarray(getattr(jop, field))
        np.testing.assert_array_equal(got, want, err_msg=field)
        assert got.dtype == want.dtype, field
    assert (top.n, top.rows_sorted, top.n_true) == (jop.n, jop.rows_sorted, jop.n_true)
    # node 0 is isolated: no edge, and no weight from a zero degree
    assert not (top.row == 0).any()


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("shape", [(200,), (200, 7)])
def test_spmv_mean_spmv_and_degree_equal_jax(shape, dead):
    jop, top = pair(seed=1)
    if dead:
        jop, top = with_dead_edges(jop, top)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    for jf, tf in ((jsp.spmv, tsp.spmv), (jsp.mean_spmv, tsp.mean_spmv)):
        np.testing.assert_allclose(tf(top, t(x)).numpy(), np.asarray(jf(jop, jnp.asarray(x))),
                                   atol=1e-6)
    np.testing.assert_array_equal(tsp.live_degree(top).numpy(), np.asarray(jsp.live_degree(jop)))
    feats = tsp.sparse_diffusion_features(top, t(x), (1, 3))
    want = np.asarray(jsp.sparse_diffusion_features(jop, jnp.asarray(x), (1, 3)))
    np.testing.assert_allclose(torch.stack(feats).numpy(), want, atol=1e-6)
    assert tsp.sparse_diffusion_features(top, t(x), ()) == []


@pytest.mark.parametrize("with_self", [False, True])
def test_segment_softmax_and_gat_attention_equal_jax(with_self):
    jop, top = with_dead_edges(*pair(seed=2))
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((top.num_edges, 3)) * 3).astype(np.float32)
    self_logits = rng.standard_normal((200, 3)).astype(np.float32) if with_self else None
    want = jsp.segment_softmax_coo(jnp.asarray(logits), jop,
                                   None if self_logits is None else jnp.asarray(self_logits))
    got = tsp.segment_softmax_coo(t(logits), top, None if self_logits is None else t(self_logits))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        assert torch.isfinite(g).all()
    s_dst, s_src = rng.standard_normal((2, 200, 3)).astype(np.float32)
    hp = rng.standard_normal((200, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tsp.gat_attention(top, t(s_dst), t(s_src), t(hp)).numpy(),
        np.asarray(jsp.gat_attention(jop, jnp.asarray(s_dst), jnp.asarray(s_src),
                                     jnp.asarray(hp))), atol=1e-6)


def test_partition_masks_and_spectral_project_equal_jax():
    jop, top = pair(seed=4)
    part = (np.arange(200) % 3).astype(np.int32)
    for (ji, jc), (ti, tc) in [(jsp.partition_masks(jop, jnp.asarray(part)),
                                tsp.partition_masks(top, t(part)))]:
        np.testing.assert_array_equal(ti.val.numpy(), np.asarray(ji.val))
        np.testing.assert_array_equal(tc.val.numpy(), np.asarray(jc.val))
    rng = np.random.default_rng(0)
    v = rng.standard_normal((200, 5)).astype(np.float32)
    h = rng.standard_normal((200, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tsp.spectral_project(t(v), t(h).to(torch.bfloat16)).numpy(),
        np.asarray(jsp.spectral_project(jop, jnp.asarray(v), jnp.asarray(h, jnp.bfloat16))),
        atol=1e-5)


@pytest.mark.parametrize("scatter_env", ["0", "1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_gather_backward_equals_jax_vjp(monkeypatch, dtype, scatter_env):
    monkeypatch.setenv("LANCZOSNET_BF16_SCATTER", scatter_env)
    jop, top = pair(n=150, m=900, seed=5)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((150, 8)).astype(np.float32)
    g = rng.standard_normal((top.num_edges, 8)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a: jsp.edge_gather(jop, a), jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    xt = t(x).to(tdt).requires_grad_()
    out = tsp.edge_gather(top, xt)
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jsp.edge_gather(jop, jnp.asarray(x, jdt)),
                                             np.float32))
    out.backward(t(g).to(tdt))
    assert xt.grad.dtype == tdt
    want = np.asarray(want, np.float32)
    tol = dict(atol=1e-6) if dtype == "float32" else dict(rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(xt.grad.float().numpy(), want, **tol)

    # the chunked backward (thresholds lowered so that it engages) adds
    # in the same order as the one-shot scatter
    monkeypatch.setattr(tsp, "_BWD_CHUNK_ENGAGE", 1024)
    monkeypatch.setattr(tsp, "_BWD_CHUNK_TARGET", 512)
    xc = t(x).to(tdt).requires_grad_()
    tsp.edge_gather(top, xc).backward(t(g).to(tdt))
    assert torch.equal(xc.grad, xt.grad)


def test_edge_gather_without_col_perm_and_row_gather():
    jop, top = pair(n=80, m=300, seed=6)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((80, 3)).astype(np.float32)
    g = rng.standard_normal((top.num_edges, 3)).astype(np.float32)
    bare = top.replace(col_perm=None)
    xt = t(x).to(torch.bfloat16).requires_grad_()
    tsp.edge_gather(bare, xt).backward(t(g).to(torch.bfloat16))
    _, vjp = jax.vjp(lambda a: jsp.edge_gather(jop.replace(col_perm=None), a),
                     jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(vjp(
        jnp.asarray(g, jnp.bfloat16))[0], np.float32), rtol=2**-7, atol=1e-6)
    xr = t(x).requires_grad_()
    tsp.row_gather(top, xr).backward(t(g))
    want = np.zeros_like(x)
    np.add.at(want, top.row.numpy(), g)
    np.testing.assert_allclose(xr.grad.numpy(), want, atol=1e-5)


def test_sym_normalize_and_learned_kernel_op_with_gradients():
    jop, top = with_dead_edges(*pair(seed=7))
    rng = np.random.default_rng(4)
    kernel = rng.random(top.num_edges).astype(np.float32) + 0.1
    emb = rng.standard_normal((200, 5)).astype(np.float32)
    w = rng.standard_normal(top.num_edges).astype(np.float32)

    def jax_loss(fn, arg):
        return lambda a: jnp.sum(fn(jop, a).val * jnp.asarray(w))

    for jfn, tfn, arg in ((jsp.sym_normalize_coo, tsp.sym_normalize_coo, kernel),
                          (jsp.learned_kernel_op, tsp.learned_kernel_op, emb)):
        want_val = np.asarray(jfn(jop, jnp.asarray(arg)).val)
        want_grad = np.asarray(jax.grad(jax_loss(jfn, arg))(jnp.asarray(arg)))
        a = t(arg).requires_grad_()
        op = tfn(top, a)
        np.testing.assert_allclose(op.val.detach().numpy(), want_val, atol=1e-6)
        assert (op.val[top.val == 0] == 0).all()
        (op.val * t(w)).sum().backward()
        scale = np.abs(want_grad).max()
        np.testing.assert_allclose(a.grad.numpy() / scale, want_grad / scale, atol=1e-5)


def reconstruction(vals, vecs, x, power=3):
    """``V diag(D^power) Vᵀ x`` in float64."""
    v = np.asarray(vecs, np.float64)
    return v @ (np.asarray(vals, np.float64) ** power * (v.T @ np.asarray(x, np.float64)))


@pytest.mark.parametrize("n_true", [None, 180])
def test_sparse_lanczos_ritz_equals_jax(n_true):
    jop, top = pair(n=200, m=700, seed=8)
    jop, top = jop.replace(n_true=n_true), top.replace(n_true=n_true)
    k = 12  # below the 199 connected nodes
    x = np.random.default_rng(5).standard_normal(200).astype(np.float32)
    jv, jq = jsp.sparse_lanczos_ritz(jop, k)
    tv, tq = tsp.sparse_lanczos_ritz(top, k)
    assert tv.shape == (k,) and tq.shape == (200, k)
    np.testing.assert_allclose(reconstruction(tv, tq, x), reconstruction(jv, jq, x), atol=1e-3)
    np.testing.assert_allclose(np.sort(tv.numpy()), np.sort(np.asarray(jv)), atol=1e-4)


def test_lanczos_tridiag_matvec_equals_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((60, 60)).astype(np.float32)
    s = (a + a.T) / 20
    mask = np.ones(60, np.float32)
    mask[55:] = 0.0
    s[:, 55:] = s[55:, :] = 0.0
    ja, jb, jq = jax_lanczos_tridiag_matvec(lambda v: jnp.asarray(s) @ v, jnp.asarray(mask), 10)
    ta, tb, tq = lanczos_tridiag_matvec(lambda v: t(s) @ v, t(mask), 10)
    assert (ta.shape, tb.shape, tq.shape) == ((10,), (9,), (10, 60))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    # the basis spans the same space: Q Qᵀ agrees
    qq = lambda q: np.asarray(q, np.float64).T @ np.asarray(q, np.float64)  # noqa: E731
    np.testing.assert_allclose(qq(tq), qq(jq), atol=1e-3)
    # breakdown: an operator of rank 2 stops after two steps, no NaN
    low = np.outer(mask, mask) / 55.0
    ta, tb, tq = lanczos_tridiag_matvec(lambda v: t(low).float() @ v, t(mask), 6)
    assert torch.isfinite(tq).all() and (tb[1:] == 0).all() and (tq[2:] == 0).all()
