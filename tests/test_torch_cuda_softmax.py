"""GAT's edge softmax on the card's kernels (``ops/gat_softmax_cuda.py``,
``csrc/gat_softmax.cu``) against the plain version on the CPU.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip, the
skip naming what is missing (decided in a fixture, never at import). Run
them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_softmax.py

The kernels round where the plain version's ATen ops round and sum in
its order, so the one difference is the card's ``expf`` against the
CPU's ``exp``: a float32 ulp, which can move a bfloat16 weight by one
ulp. Hence the limits: the weights and the self-edge's weight within
one ulp of the scores' dtype (bfloat16 2^-7 of the value, float32 1e-6:
the two exps' few float32 ulps); the denominator within two (a moved
weight moves the float32 sum by under an ulp of it, and the sum's
rounding may add one); a gradient within 2^-6 (float32: 1e-5) of the
sum of its terms' magnitudes and its own: each term is a product with
one weight, which moves by an ulp of itself where that weight moved,
and is rounded once more. The cases: H = 4, 1
and 8, bfloat16 and float32, empty rows, dead edges, a node with no live
edge, a row of degree 1,200, and edge- and node-sharded pieces (the
edge-sharded max pass, the max over the pieces, the exponential pass and
the summed denominators). Two calls give the same bits; each call
launches the forward once (twice edge-sharded) and each backward kernel
once; float16 and float64 raise before any launch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lanczosnet_torch.ops import _build
from lanczosnet_torch.ops import gat_softmax_cuda as gsc
from lanczosnet_torch.ops import sparse as tsp
from lanczosnet_torch.ops import sparse_cuda

pytestmark = pytest.mark.cuda

SLOPE = 0.2
EPS = 1e-16
RTOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-6}
GRAD_RTOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}


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


def graph(n: int, m: int, seed: int, hub: int = 0) -> tsp.SparseOp:
    """A sym-normalized operator on the CPU: ``m`` random pairs, nodes 0
    and n-1 isolated (empty rows), a fifth of the edges dead, node 2 with
    no live in-edge, and with ``hub`` node 1 joined to ``hub`` others."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(2, n - 1, m), rng.integers(2, n - 1, m)
    pairs = [np.stack([a, b], 1)]
    if hub:
        pairs.append(np.stack([np.ones(hub, np.int64), np.arange(2, hub + 2) % (n - 1)], 1))
    pairs = np.concatenate(pairs)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    op = tsp.sparse_sym_operator(np.unique(np.sort(pairs, 1), axis=0), n)
    keep = torch.from_numpy(rng.random(op.num_edges) > 0.2) & (op.row != 2)
    return tsp.masked_val_op(op, keep)


def counts():
    return tuple(c.count for c in (gsc.softmax_launches, gsc.softmax_grad_launches,
                                   gsc.softmax_src_grad_launches))


def scores(n: int, n_src: int, heads: int, dtype, seed: int):
    """``s_dst [n, H]``, ``s_src [n_src, H]`` and the self-edges' logits
    of the first n sources; a few sources' scores large, so that maxima
    stand far from the rest and weights underflow."""
    gen = torch.Generator().manual_seed(seed)
    s_dst = torch.randn(n, heads, generator=gen).to(dtype)
    s_src = torch.randn(n_src, heads, generator=gen)
    s_src[3:9] *= 40
    s_src = s_src.to(dtype)
    return s_dst, s_src, F.leaky_relu(s_dst + s_src[:n], SLOPE)


def cotangents(op, heads, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(op.num_edges, heads, generator=gen).to(dtype),
            torch.randn(op.n, heads, generator=gen).to(dtype),
            torch.randn(op.n, heads, generator=gen).to(dtype))


def plain(op, s_dst, s_src, self_logits, cot):
    """The CPU's plain version: ``segment_softmax_coo`` of GAT's logits →
    ``((p, denom, p_self), (ds_dst, ds_src, dself), (dst_terms, src_terms))``,
    the gradients of ``<p, gp> + <denom, gd> + <p_self, gs>`` and each
    score's gradient's terms' magnitudes, summed."""
    leaves = [t.detach().clone().requires_grad_() for t in (s_dst, s_src, self_logits)]
    x = tsp.row_gather(op, leaves[0]) + tsp.edge_gather(op, leaves[1])
    x.retain_grad()
    outs = tsp.segment_softmax_coo(F.leaky_relu(x, SLOPE), op, leaves[2], EPS)
    torch.autograd.backward(outs, cot)
    terms = x.grad.float().abs()
    dst_terms = torch.zeros(op.n, terms.shape[1]).index_add(0, op.row.long(), terms)
    src_terms = torch.zeros(s_src.shape[0], terms.shape[1]).index_add(0, op.col.long(), terms)
    return (tuple(o.detach() for o in outs), tuple(t.grad for t in leaves),
            (dst_terms, src_terms))


def on_card(op, s_dst, s_src, self_logits, cot, card):
    """``gat_softmax`` on the card with the ATen ops around it (the
    self-edge joined, the clamp) → the same three outputs and gradients,
    on the CPU, and the raw ``(p [H, E], den)``."""
    leaves = [t.detach().to(card).requires_grad_() for t in (s_dst, s_src, self_logits)]
    dop = op.to(card)
    p, den, p_self = gsc.gat_softmax(dop.row_ptr, dop.col, dop.val, *leaves, SLOPE)
    denom = torch.clamp_min(den + p_self, EPS)
    gp, gd, gs = (c.to(card) for c in cot)
    torch.autograd.backward((p, denom, p_self), (gp.float().t(), gd, gs))
    torch.cuda.synchronize()
    outs = (p.detach().t().cpu(), denom.detach().cpu(), p_self.detach().cpu())
    return outs, tuple(t.grad.cpu() for t in leaves), (p.detach().cpu(), den.detach().cpu())


def assert_within_an_ulp(name, got, want, dtype, ulps: int = 1):
    err = (got.float() - want.float()).abs()
    ok = err <= ulps * RTOL[dtype] * want.float().abs() + 1e-30
    assert bool(ok.all()), (name, float(err.max()))


def assert_within_terms(name, got, want, terms, dtype):
    err = (got.float() - want.float()).abs()
    ok = err <= GRAD_RTOL[dtype] * (terms + want.float().abs()) + 1e-30
    assert bool(ok.all()), (name, float(err.max()))


@pytest.mark.parametrize("heads", [4, 1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_softmax_on_the_card_is_the_plain_version(card, dtype, heads):
    """Weights, denominator and self-edge weight within an ulp; the three
    scores' gradients within their terms' limit; the weights head-major
    float32 holding values of the scores' dtype; one forward launch and
    one of each backward kernel."""
    op = graph(3000, 9000, 0, hub=1200)
    s_dst, s_src, self_logits = scores(3000, 3000, heads, dtype, 1)
    cot = cotangents(op, heads, dtype, 2)
    before = counts()
    got, got_grads, (p_raw, _) = on_card(op, s_dst, s_src, self_logits, cot, card)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1)
    want, want_grads, (dst_terms, src_terms) = plain(op, s_dst, s_src, self_logits, cot)
    assert p_raw.dtype == torch.float32 and p_raw.shape == (heads, op.num_edges)
    assert torch.equal(p_raw.to(dtype).float(), p_raw)
    assert bool((p_raw[:, op.val == 0] == 0).all())
    for name, a, b, ulps in zip(("p", "denom", "p_self"), got, want, (1, 2, 1)):
        assert a.shape == b.shape
        assert_within_an_ulp(name, a, b, dtype, ulps)
    self_terms = (cot[2].float() + cot[1].float()).abs() * want[2].float()
    for name, a, b, t in zip(("ds_dst", "ds_src", "dself"), got_grads, want_grads,
                             (dst_terms, src_terms, self_terms)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert_within_terms(name, a, b, t, dtype)


def test_two_calls_give_the_same_bits(card):
    op = graph(3000, 9000, 3, hub=1200)
    s_dst, s_src, self_logits = scores(3000, 3000, 4, torch.bfloat16, 4)
    cot = cotangents(op, 4, torch.bfloat16, 5)
    first = on_card(op, s_dst, s_src, self_logits, cot, card)
    second = on_card(op, s_dst, s_src, self_logits, cot, card)
    for a, b in zip(sum(first, ()), sum(second, ())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["edges", "nodes"])
def test_sharded_pieces_on_the_card_are_the_plain_version(card, mode):
    """Edge-sharded: each piece's max pass, the max over the pieces (the
    ``pmax``), each piece's exponential pass with it, the pieces'
    denominators summed (the ``psum``): the whole graph's softmax, within
    an ulp, and two launches a piece. Node-sharded: a block's rows
    against every source, one launch, the plain version on the piece."""
    from lanczosnet_torch.parallel import mesh

    whole = graph(2002, 6000, 6)  # 2002 nodes: the node blocks are padded
    args = (whole.row.numpy(), whole.col.numpy(), whole.val.numpy(), 2002, 4)
    dtype = torch.bfloat16
    if mode == "edges":
        arrays, n, n_src = mesh.shard_sparse_arrays(*args), 2002, 2002
    else:
        arrays, n_pad = mesh.node_shard_arrays(*args)
        n, n_src = n_pad // 4, n_pad
    s_dst_all, s_src, _ = scores(n_src, n_src, 4, dtype, 7)
    pieces = [mesh.sparse_op_piece({k: v[r] for k, v in arrays.items()}, n, None, mode, "cpu")
              for r in range(4)]
    if mode == "nodes":
        for r, piece in enumerate(pieces):
            s_dst = s_dst_all[r * n:(r + 1) * n]
            self_logits = F.leaky_relu(s_dst + s_src[r * n:(r + 1) * n], SLOPE)
            cot = cotangents(piece, 4, dtype, 8 + r)
            before = counts()
            got, got_grads, _ = on_card(piece, s_dst, s_src, self_logits, cot, card)
            assert counts()[0] - before[0] == 1
            want, want_grads, terms = plain(piece, s_dst, s_src, self_logits, cot)
            for name, a, b, ulps in zip(("p", "denom", "p_self"), got, want, (1, 2, 1)):
                assert_within_an_ulp(f"{name} piece {r}", a, b, dtype, ulps)
            for name, a, b, t in zip(("ds_dst", "ds_src"), got_grads, want_grads, terms):
                assert_within_terms(f"{name} piece {r}", a, b, t, dtype)
        return
    s_dst = s_dst_all
    self_logits = F.leaky_relu(s_dst + s_src, SLOPE)
    cards = [p.to(card) for p in pieces]
    args = [(c.row_ptr, c.col, c.val, s_dst.to(card), s_src.to(card), self_logits.to(card))
            for c in cards]
    before = counts()
    m = torch.stack([gsc.gat_softmax_max(*a, SLOPE) for a in args]).amax(0)
    outs = [gsc.gat_softmax(*a, SLOPE, m) for a in args]
    torch.cuda.synchronize()
    assert counts()[0] - before[0] == 8
    den = sum(o[1].float() for o in outs).to(dtype)  # the psum, in the scores' dtype
    p_self = outs[0][2]
    denom = torch.clamp_min(den + p_self, EPS).cpu()
    (want_p, want_denom, want_self), _, _ = plain(whole, s_dst, s_src, self_logits,
                                                  cotangents(whole, 4, dtype, 9))
    # four pieces' sums each rounded, then their sum rounded: four ulps
    assert_within_an_ulp("denom", denom, want_denom, dtype, 4)
    assert_within_an_ulp("p_self", p_self.cpu(), want_self, dtype)
    key = (whole.row.long() * n + whole.col.long()).numpy()
    order = np.argsort(key)
    for piece, (p, _, _) in zip(pieces, outs):
        live = piece.val != 0
        # each live edge of a piece is one of the whole graph's
        pk = (piece.row.long()[live] * n + piece.col.long()[live]).numpy()
        idx = torch.from_numpy(order[np.searchsorted(key[order], pk)])
        assert torch.equal(whole.row[idx], piece.row[live])
        assert_within_an_ulp("p", p.t().cpu()[live], want_p[idx], dtype)


class OneRank:
    """A ``Comm`` of one rank: what ``pmax`` and ``psum`` call, as the
    identity."""

    size, rank = 1, 0

    def all_reduce(self, x, op=None):
        return x


def test_gat_attention_edge_sharded_takes_both_passes(card):
    """``gat_attention`` on an edge-sharded whole operator (a group of one
    rank) runs the max pass, the ``pmax``, the exponential pass and the
    ``psum``: two forward launches, one of each backward kernel, and the
    output and gradients of the local form, bit for bit."""
    op = graph(2000, 8000, 10, hub=1100).to(card)
    gen = torch.Generator().manual_seed(11)
    s_dst, s_src = (torch.randn(2000, 4, generator=gen).bfloat16().to(card) for _ in range(2))
    hp, g = (torch.randn(2000, 4, 16, generator=gen).bfloat16().to(card) for _ in range(2))
    results = []
    for o, launches in ((op, 1), (op.replace(axis=OneRank()), 2)):
        leaves = [t.detach().clone().requires_grad_() for t in (s_dst, s_src, hp)]
        before = counts()
        out = tsp.gat_attention(o, *leaves)
        out.backward(g)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == (launches, 1, 1)
        results.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_a_validation_forward_builds_no_source_view(card, monkeypatch):
    """Without a gradient the forward launches the softmax once and builds
    no source-major view; with one, the view is built once and serves both
    backwards."""
    op = graph(1000, 4000, 12).to(card)
    s_dst, s_src = (torch.randn(1000, 4, device=card).bfloat16() for _ in range(2))
    hp = torch.randn(1000, 4, 8, device=card).bfloat16()
    built = []
    real = sparse_cuda.csr_source_view
    monkeypatch.setattr(tsp, "csr_source_view", lambda *a: built.append(1) or real(*a))
    monkeypatch.setattr(sparse_cuda, "csr_source_view", lambda *a: pytest.fail("built again"))
    with torch.no_grad():
        tsp.gat_attention(op, s_dst, s_src, hp)
    assert built == []
    leaves = [t.clone().requires_grad_() for t in (s_dst, s_src, hp)]
    tsp.gat_attention(op, *leaves).float().sum().backward()
    torch.cuda.synchronize()
    assert built == [1]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_a_dtype_the_kernels_do_not_take_raises_before_a_launch(card, dtype):
    op = graph(1000, 3000, 13).to(card)
    s = torch.randn(1000, 4, device=card).to(dtype)
    hp = torch.randn(1000, 4, 8, device=card).to(dtype)
    before = counts() + (sparse_cuda.spmm_launches.count,)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsp.gat_attention(op, s, s, hp)
    torch.cuda.synchronize()
    assert counts() + (sparse_cuda.spmm_launches.count,) == before
