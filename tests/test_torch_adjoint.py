"""The port's streamed Lanczos (plain version), its adjoint backward and
the clamped eigh backward against the JAX package, on the CPU.

Tolerances: the six tridiagonalization outputs 1e-4 (the contract of
tests/test_lanczos_pallas.py; the orders of summation differ); operator
cotangents 1e-4 absolute on cotangents of order 1, and 2e-4 of the
largest entry for the loss through the Ritz pairs
(tests/test_lanczos_pallas.py:test_stream_vjp_matches_scan_grad_large_n);
eigh gradients 1e-5 (the same formula on 6×6 matrices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.ops.eigh import safe_eigh
from lanczosnet_tpu.ops.lanczos import (
    _lanczos_fwd_resid,
    batched_lanczos_ritz,
    batched_lanczos_ritz_adjoint,
    lanczos_adjoint_bwd as jax_adjoint_bwd,
    lanczos_tridiag,
)
from lanczosnet_tpu.ops.lanczos_pallas import _lanczos_stream_call
from lanczosnet_torch.ops import lanczos as port_lanczos
from lanczosnet_torch.ops import lanczos_cuda
from lanczosnet_torch.ops.eigh import eigh
from lanczosnet_torch.ops.lanczos import (
    STREAM_CHUNK,
    lanczos_adjoint_bwd,
    lanczos_tridiag_resid,
    lanczos_tridiag_resid_stream,
)
from lanczosnet_torch.ops.lanczos_cuda import (
    LanczosTridiag,
    batched_lanczos_ritz_dispatch,
    lanczos_tridiag_cuda_resid,
)

OUTPUTS = ("alphas", "betas_full", "q", "p1", "p2", "w4")


def stream_case():
    """The case of tests/test_lanczos_pallas.py:test_stream_kernel_matches_scan_residuals."""
    rng = np.random.default_rng(7)
    b, n = 2, 300
    s = rng.standard_normal((b, n, n)).astype(np.float32) * 0.1
    s = 0.5 * (s + s.transpose(0, 2, 1))
    mask = np.ones((b, n), np.float32)
    mask[1, 200:] = 0.0
    s[1, 200:, :] = 0.0
    s[1, :, 200:] = 0.0
    return s, mask


def random_sym(rng, n, live):
    """The graphs of tests/test_lanczos_adjoint.py."""
    s = rng.standard_normal((n, n)).astype(np.float32) * 0.4
    s = 0.5 * (s + s.T)
    mask = np.zeros((n,), np.float32)
    mask[:live] = 1.0
    s[live:, :] = 0.0
    s[:, live:] = 0.0
    return s, mask


def test_stream_plain_version_matches_stream_kernel_and_scan():
    s, mask = stream_case()
    k = 8
    got = lanczos_tridiag_resid_stream(torch.from_numpy(s), torch.from_numpy(mask), k)
    pallas = _lanczos_stream_call(jnp.asarray(s), jnp.asarray(mask), k, 1e-6, bn=128, interpret=True)
    scan = jax.vmap(lambda si, mi: _lanczos_fwd_resid(si, mi, k, 1e-6))(
        jnp.asarray(s), jnp.asarray(mask)
    )
    for name, g, p, a in zip(OUTPUTS, got, pallas, scan):
        assert g.shape == tuple(a.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-4, err_msg=f"{name} vs pallas")
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=1e-4, err_msg=f"{name} vs scan")


def test_stream_plain_version_agrees_with_index_order_version():
    """Two orders of summation of one recursion: 1e-4 away from breakdown."""
    s, mask = stream_case()
    a = lanczos_tridiag_resid_stream(torch.from_numpy(s), torch.from_numpy(mask), 8)
    b = lanczos_tridiag_resid(torch.from_numpy(s), torch.from_numpy(mask), 8)
    for name, x, y in zip(OUTPUTS, a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("n,live,k", [(130, 3, 8), (256, 0, 6), (200, 200, 1)])
def test_stream_plain_version_breaks_down_cleanly(n, live, k):
    """Few real nodes in a large padded graph, and the all-zero graph:
    finite outputs, zero rows after the breakdown step."""
    rng = np.random.default_rng(n)
    s, mask = random_sym(rng, n, live)
    outs = lanczos_tridiag_resid_stream(torch.from_numpy(s)[None], torch.from_numpy(mask)[None], k)
    assert all(torch.isfinite(o).all() for o in outs)
    alphas, betas, q = outs[:3]
    steps = int((betas[0] > 0).sum())
    assert steps <= max(live - 1, 0)
    assert float(q[0, steps + 1:].abs().max() if steps + 1 < k else 0.0) == 0.0
    assert float(q[0, :, live:].abs().max() if live < n else 0.0) == 0.0


def test_dispatch_picks_the_plain_version_by_shape(monkeypatch):
    """N ≤ 128 takes the shared-memory kernel's plain version, N > 128
    the streamed kernel's; a CPU tensor never reaches a build."""
    monkeypatch.setattr(lanczos_cuda._build, "load", lambda name: pytest.fail(f"built {name}"))
    calls = []
    for name in ("lanczos_tridiag_resid", "lanczos_tridiag_resid_stream"):
        real = getattr(lanczos_cuda, name)
        monkeypatch.setattr(
            lanczos_cuda, name,
            lambda *a, _real=real, _name=name: (calls.append(_name), _real(*a))[1],
        )
    for n in (128, 129):
        s, mask = random_sym(np.random.default_rng(n), n, n)
        lanczos_tridiag_cuda_resid(torch.from_numpy(s)[None], torch.from_numpy(mask)[None], 4)
    assert calls == ["lanczos_tridiag_resid", "lanczos_tridiag_resid_stream"]
    assert lanczos_cuda.stream_launches.count == 0
    with pytest.raises(ValueError, match="kernel"):
        lanczos_tridiag_cuda_resid(torch.zeros(1, 8, 8), torch.ones(1, 8), 2, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        lanczos_tridiag_cuda_resid(torch.zeros(1, 8, 8), torch.ones(1, 8), 2, impl="scan")
    # past the kernels' limits "kernel" raises naming the limit, before any
    # look at the device (a view: nothing of 16385² is allocated)
    routes = lanczos_cuda.plain_routes.count
    with pytest.raises(ValueError, match="16384"):
        lanczos_tridiag_cuda_resid(torch.zeros(1).expand(1, 16385, 16385), torch.ones(1, 16385), 2,
                                   impl="kernel")
    assert lanczos_cuda.plain_routes.count == routes


@pytest.mark.parametrize("n,k,limits", [
    (300, 6, {"STREAM_N_MAX": 200}), (130, 6, {"STREAM_K_MAX": 4}),
], ids=["n-past-the-streamed-kernel", "k-past-the-streamed-kernel"])
def test_shape_routing_past_the_kernel_limits(monkeypatch, n, k, limits):
    """With the kernels' limits lowered, a shape past them runs the
    streamed plain version under "auto" (bit for bit) and counts it in
    ``plain_routes``; "kernel" raises naming the limit; a shape within
    them on the CPU is no plain route."""
    monkeypatch.setattr(lanczos_cuda._build, "load", lambda name: pytest.fail(f"built {name}"))
    for name, value in limits.items():
        monkeypatch.setattr(lanczos_cuda, name, value)
    s, mask = random_sym(np.random.default_rng(n), n, n - 20)
    s, mask = torch.from_numpy(s)[None], torch.from_numpy(mask)[None]
    lanczos_cuda.plain_routes.reset()
    got = lanczos_tridiag_cuda_resid(s, mask, k)
    want = lanczos_cuda.lanczos_tridiag_resid_stream(s, mask, k)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert lanczos_cuda.plain_routes.count == 1
    vals, _ = lanczos_cuda.batched_lanczos_ritz_dispatch(s, mask, k)  # the custom operator
    assert lanczos_cuda.plain_routes.count == 2 and vals.shape == (1, k)
    with pytest.raises(ValueError, match=str(next(iter(limits.values())))):
        lanczos_tridiag_cuda_resid(s, mask, k, impl="kernel")
    small, small_mask = random_sym(np.random.default_rng(0), 12, 12)
    lanczos_tridiag_cuda_resid(torch.from_numpy(small)[None], torch.from_numpy(small_mask)[None], 4)
    lanczos_tridiag_cuda_resid(s, mask, k, impl="plain")
    assert lanczos_cuda.plain_routes.count == 2
    assert lanczos_cuda.stream_launches.count == 0


@pytest.mark.parametrize("live", [12, 8, 4], ids=["full", "padded", "breakdown"])
def test_adjoint_bwd_matches_jax(live):
    """Same residuals and cotangents through both reverse recursions."""
    rng = np.random.default_rng(1 + live)
    n, k = 12, 6
    s, mask = random_sym(rng, n, live)
    resid = _lanczos_fwd_resid(jnp.asarray(s), jnp.asarray(mask), k, 1e-6)
    bars = (
        rng.standard_normal(k).astype(np.float32),
        rng.standard_normal(k).astype(np.float32),
        rng.standard_normal((k, n)).astype(np.float32),
    )
    want = np.asarray(jax_adjoint_bwd(jnp.asarray(s), *resid, *map(jnp.asarray, bars), eps=1e-6))
    t = lambda x: torch.from_numpy(np.array(x))[None]
    got = lanczos_adjoint_bwd(t(s), *(t(r) for r in resid), *(t(x) for x in bars), eps=1e-6)[0]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def tridiag_loss_weights(k, n):
    rng = np.random.default_rng(7)
    return (
        rng.standard_normal(k).astype(np.float32),
        rng.standard_normal(k - 1).astype(np.float32),
        rng.standard_normal((k, n)).astype(np.float32),
    )


@pytest.mark.parametrize("live", [12, 8, 4], ids=["full", "padded", "breakdown"])
def test_lanczos_tridiag_function_matches_jax_autodiff(live):
    """The loss of tests/test_lanczos_adjoint.py through ``LanczosTridiag``
    against reverse-mode autodiff of the JAX scan."""
    rng = np.random.default_rng(1)
    n, k = 12, 6
    s, mask = random_sym(rng, n, live)
    wa, wb, wq = tridiag_loss_weights(k, n)

    def jax_loss(si):
        a, b, q = lanczos_tridiag(si, jnp.asarray(mask), k)
        return jnp.sum(wa * a) + jnp.sum(wb * b) + jnp.sum(wq * jnp.tanh(q))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(s)))
    st = torch.from_numpy(s)[None].requires_grad_()
    a, b, q = LanczosTridiag.apply(st, torch.from_numpy(mask)[None], k, 1e-6, "auto")
    loss = ((torch.from_numpy(wa) * a[0]).sum() + (torch.from_numpy(wb) * b[0, : k - 1]).sum()
            + (torch.from_numpy(wq) * torch.tanh(q[0])).sum())
    loss.backward()
    assert torch.isfinite(st.grad).all()
    np.testing.assert_allclose(st.grad[0].numpy(), want, rtol=2e-3, atol=2e-4)


def test_ritz_loss_gradient_through_stream_path_matches_jax():
    """The loss of tests/test_lanczos_pallas.py:test_stream_vjp_matches_scan_grad_large_n
    at N=300: the streamed plain version forward, the adjoint backward
    and the clamped eigh backward, against the JAX package's adjoint path
    (``batched_lanczos_ritz_adjoint``) at a scaled error of 2e-4.

    Against reverse-mode autodiff of the JAX scan the bound is 1e-3:
    this loss amplifies the 1e-7 rounding differences between two
    forwards, and the JAX package's own adjoint path is 3.7e-4 from its
    scan here (the port is 1e-6 from that adjoint path)."""
    rng = np.random.default_rng(8)
    b, n, k = 1, 300, 6
    s = rng.standard_normal((b, n, n)).astype(np.float32) * 0.05
    s = 0.5 * (s + s.transpose(0, 2, 1))
    mask = np.ones((b, n), np.float32)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)

    def jax_grad(fn):
        def loss(si):
            d, v = fn(si, jnp.asarray(mask), k)
            return jnp.sum(jnp.tanh(jnp.einsum("bnk,bk,bmk,bmf->bnf", v, d, v, jnp.asarray(x))))
        return np.asarray(jax.grad(loss)(jnp.asarray(s)))

    st = torch.from_numpy(s).requires_grad_()
    d, v = batched_lanczos_ritz_dispatch(st, torch.from_numpy(mask), k)
    torch.tanh(torch.einsum("bnk,bk,bmk,bmf->bnf", v, d, v, torch.from_numpy(x))).sum().backward()
    got = st.grad.numpy()
    adjoint, scan = jax_grad(batched_lanczos_ritz_adjoint), jax_grad(batched_lanczos_ritz)
    scale = np.abs(scan).max()
    np.testing.assert_allclose(got / scale, adjoint / scale, atol=2e-4)
    np.testing.assert_allclose(got / scale, scan / scale, atol=1e-3)


def test_backward_uses_neither_eigh_backward_nor_the_plain_loop(monkeypatch):
    """Gradients through the dispatch on a padded graph at breakdown are
    finite; the graph holds the two Functions and no eigh node, and the
    forward recursion runs once (never replayed for the backward)."""
    rng = np.random.default_rng(3)
    s, mask = random_sym(rng, 16, 5)
    calls = []
    real = lanczos_cuda.lanczos_tridiag_resid
    monkeypatch.setattr(lanczos_cuda, "lanczos_tridiag_resid",
                        lambda *a: (calls.append(1), real(*a))[1])
    st = torch.from_numpy(s)[None].requires_grad_()
    d, v = batched_lanczos_ritz_dispatch(st, torch.from_numpy(mask)[None], 8)

    def node_names(fn, seen):
        if fn is None or fn in seen:
            return
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            node_names(nxt, seen)

    seen = set()
    node_names(d.grad_fn, seen)
    node_names(v.grad_fn, seen)
    names = {type(f).__name__ for f in seen}
    assert "LanczosTridiagBackward" in names and "_SafeEighBackward" in names
    assert not any("Eigh" in nm and nm != "_SafeEighBackward" for nm in names)
    x = torch.from_numpy(rng.standard_normal((1, 16, 3)).astype(np.float32))
    torch.tanh(torch.einsum("bnk,bk,bmk,bmf->bnf", v, d, v, x)).sum().backward()
    assert calls == [1]
    assert torch.isfinite(st.grad).all() and float(st.grad.abs().max()) > 0
    assert float((d[0].abs() < 1e-6).sum()) >= 3  # repeated zero Ritz values were there


def test_eigh_vjp_matches_safe_eigh_on_repeated_zero_eigenvalues():
    """Two 6×6 matrices whose last three rows and columns are zero, as
    the tridiagonal of a recursion that broke down: three exact zero
    eigenvalues. Gradients of ``sum(tanh(V f(D) Vᵀ)·C)`` agree and are
    finite; torch's own eigh backward would divide by zero here."""
    rng = np.random.default_rng(0)
    a = np.zeros((2, 6, 6), np.float32)
    for i, spectrum in enumerate(([1.0, 2.0, 3.5], [-0.7, 0.4, 1.3])):
        u, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        a[i, :3, :3] = (u * np.asarray(spectrum)) @ u.T
    c = rng.standard_normal((2, 6, 6)).astype(np.float32)

    def jax_loss(m):
        w, v = safe_eigh(m)
        return jnp.sum(jnp.tanh(jnp.einsum("bik,bk,bjk->bij", v, w ** 3 + w, v)) * c)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(a)))
    at = torch.from_numpy(a).requires_grad_()
    w, v = eigh(at)
    (torch.tanh(torch.einsum("bik,bk,bjk->bij", v, w ** 3 + w, v)) * torch.from_numpy(c)).sum().backward()
    assert torch.isfinite(at.grad).all()
    np.testing.assert_allclose(at.grad.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(w.detach().numpy(), np.linalg.eigvalsh(a), atol=1e-5)


def test_stream_chunk_is_the_documented_constant():
    assert STREAM_CHUNK == 64 and port_lanczos.STREAM_CHUNK == lanczos_cuda.STREAM_CHUNK
    src = (lanczos_cuda._build.CSRC / "lanczos_stream.cu").read_text()
    assert "constexpr int kChunk = 64;" in src
    assert "constexpr int kMaxN = 16384;" in src and "constexpr int kMaxK = 64;" in src
