"""What the CPU can check of GAT's edge softmax kernels
(``ops/gat_softmax_cuda.py``, ``csrc/gat_softmax.cu``): their arithmetic,
the launch plan, the source-major view they share with the weighted
sums' backward, the refusals before a launch, and that the CPU never
reaches a kernel.

The kernels run only on the card (``tests/test_torch_cuda_softmax.py``
holds them to the plain version there). Here an emulation of their
arithmetic, written from the kernel's rounding points (each op's result
rounded to the scores' dtype; the max, the denominator and ``s_dst``'s
gradient by destination row in edge order, ``s_src``'s by source in
``col_perm`` order, float32 from +0, narrowed once; the self-edge joined
and the denominator clamped by ATen after the kernel), is held to the
plain version on the CPU (``segment_softmax_coo`` and autograd) bit for
bit, forward and backward. Only ``exp`` is taken from the CPU, on a
tensor laid out as the plain version's, so that both read the same
values of it: the card's ``expf`` is the one expected difference.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lanczosnet_torch.ops import gat_softmax_cuda as gsc
from lanczosnet_torch.ops import sparse as tsp
from lanczosnet_torch.ops import sparse_cuda
from lanczosnet_torch.ops.sparse_cuda import csr_source_view, csr_transpose

SLOPE = 0.2


def graph(n: int, m: int, seed: int, hub: int = 0) -> tsp.SparseOp:
    """A sym-normalized operator: ``m`` random pairs, nodes 0 and n-1
    isolated (empty rows), a fifth of the edges dead, node 2 with every
    in-edge dead (no live edge), and with ``hub`` node 1 joined to
    ``hub`` others."""
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


def rounder(dtype):
    return (lambda t: t.to(dtype).to(torch.float32)) if dtype != torch.float32 else (lambda t: t)


def ordered_sum(values: torch.Tensor, seg: torch.Tensor, order: torch.Tensor, n: int):
    """Per segment, float32 sum from +0 of ``values [E, H]`` in ``order``
    (a permutation of the edges), one edge of every segment at a time."""
    seg_o, val_o = seg[order].long(), values[order]
    acc = torch.zeros((n, values.shape[1]), dtype=torch.float32)
    starts = torch.searchsorted(seg_o, torch.arange(n), right=False)
    deg = torch.bincount(seg_o, minlength=n)
    for k in range(int(deg.max()) if deg.numel() else 0):
        rows = torch.nonzero(deg > k).squeeze(1)
        acc[rows] = acc[rows] + val_o[starts[rows] + k]
    return acc


def emulate(op, s_dst, s_src, self_logits, eps, cot):
    """The kernels' arithmetic, and the ATen ops around them, in float32
    with the scores' dtype's rounding: forward ``(p, denom, p_self)`` as
    ``segment_softmax_coo`` returns them, and the gradients of ``<p,
    gp> + <denom, gdenom> + <p_self, gpself>`` in the three scores."""
    dtype = s_dst.dtype
    rnd = rounder(dtype)
    gp, gdenom, gpself = (t.float() for t in cot)
    row, col, n = op.row.long(), op.col.long(), op.n
    d, s, sl = s_dst.float(), s_src.float(), self_logits.float()
    live = (op.val != 0)[:, None]
    x = rnd(d[row] + s[col])
    logit = torch.where(x > 0, x, rnd(x * SLOPE))
    neg = rnd(torch.tensor(-1e30))
    mx = torch.full((n, s_dst.shape[1]), float(neg))
    mx = mx.scatter_reduce(0, row[:, None].expand_as(logit), torch.where(live, logit, neg),
                           "amax", include_self=True)
    mx = torch.maximum(mx, sl)
    z = rnd(logit - mx[row])
    w = torch.where(live, torch.exp(z.to(dtype)).float(), torch.zeros(()))
    ident = torch.arange(op.num_edges)
    den = rnd(ordered_sum(w, op.row, ident, n))
    p_self = torch.exp(rnd(sl - mx).to(dtype)).float()
    pre = rnd(den + p_self)
    denom = torch.clamp_min(pre.to(dtype), eps).float()
    # backward: ATen's part (the clamp, the self-edge's add, exp's product)
    dden = torch.where(pre.to(dtype) >= torch.tensor(eps, dtype=dtype), gdenom, 0.0)
    dself = rnd(rnd(gpself + dden) * p_self)
    # the kernels' part
    dw = rnd(gp + dden[row])
    gz = rnd(dw * w)
    gl = torch.where(live, torch.where(x > 0, gz, rnd(gz * SLOPE)), torch.zeros(()))
    ds_dst = rnd(ordered_sum(gl, op.row, ident, n))
    perm, _ = csr_source_view(op.col, op.col_perm, s_src.shape[0])
    ds_src = rnd(ordered_sum(gl, op.col, perm.long(), s_src.shape[0]))
    return (w, denom, p_self), (ds_dst, ds_src, dself)


def plain(op, s_dst, s_src, self_logits, eps, cot):
    """``segment_softmax_coo`` of GAT's logits, and its gradients in the
    three scores (leaves) under the cotangents ``cot``."""
    leaves = [t.detach().clone().requires_grad_() for t in (s_dst, s_src, self_logits)]
    logits = F.leaky_relu(tsp.row_gather(op, leaves[0]) + tsp.edge_gather(op, leaves[1]), SLOPE)
    outs = tsp.segment_softmax_coo(logits, op, leaves[2], eps)
    torch.autograd.backward(outs, cot)
    return tuple(o.detach() for o in outs), tuple(t.grad for t in leaves)


def scores(n: int, heads: int, dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    s_dst, s_src = (torch.randn(n, heads, generator=gen).to(dtype) for _ in range(2))
    # large scores on a few nodes: maxima far from the rest, weights that underflow
    s_src[3:9] = s_src[3:9] * 40
    return s_dst, s_src, F.leaky_relu(s_dst + s_src, SLOPE)


@pytest.mark.parametrize("heads", [4, 1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernels_arithmetic_is_the_plain_version_bit_for_bit(dtype, heads):
    """Forward ``(p, denom, p_self)`` and the three scores' gradients,
    with empty rows, dead edges, a node with no live edge and a row of
    degree 1,200, equal the CPU's plain version exactly."""
    op = graph(400, 900, 0, hub=1200)
    s_dst, s_src, self_logits = scores(400, heads, dtype, 1)
    gen = torch.Generator().manual_seed(2)
    live = (op.val != 0)[:, None]
    gp = (torch.randn(op.num_edges, heads, generator=gen) * live).to(dtype)
    cot = (gp, torch.randn(400, heads, generator=gen).to(dtype),
           torch.randn(400, heads, generator=gen).to(dtype))
    want_fwd, want_bwd = plain(op, s_dst, s_src, self_logits, 1e-16, cot)
    got_fwd, got_bwd = emulate(op, s_dst, s_src, self_logits, 1e-16, cot)
    for name, a, b in zip(("p", "denom", "p_self", "ds_dst", "ds_src", "dself"),
                          got_fwd + got_bwd, want_fwd + want_bwd):
        assert torch.equal(a, b.float()), (name, float((a - b.float()).abs().max()))


def test_a_zero_cotangent_leaves_the_arithmetic_the_plain_versions():
    """A missing gradient (the weights' or the denominator's) adds -0 in the
    kernel, which leaves every value as it is: the emulation with zero
    cotangents there still equals the plain version."""
    op = graph(300, 700, 3)
    s_dst, s_src, self_logits = scores(300, 4, torch.bfloat16, 4)
    gen = torch.Generator().manual_seed(5)
    for which in range(3):
        cot = [torch.randn(op.num_edges, 4, generator=gen).bfloat16(),
               torch.randn(300, 4, generator=gen).bfloat16(),
               torch.randn(300, 4, generator=gen).bfloat16()]
        cot[which] = torch.zeros_like(cot[which])
        _, want = plain(op, s_dst, s_src, self_logits, 1e-16, tuple(cot))
        _, got = emulate(op, s_dst, s_src, self_logits, 1e-16, tuple(cot))
        for a, b in zip(got, want):
            assert torch.equal(a, b.float())


@pytest.mark.parametrize("heads,itemsize,aligned,want", [
    (4, 2, 16, 4), (4, 4, 16, 4), (8, 2, 16, 8), (8, 4, 16, 4), (1, 2, 16, 1), (1, 4, 16, 1),
    (6, 2, 16, 2), (3, 2, 16, 1), (12, 2, 16, 4), (16, 4, 16, 4), (4, 2, 4, 2), (4, 2, 2, 1),
    (8, 4, 8, 2)])
def test_head_block_from_the_heads_and_the_dtype(heads, itemsize, aligned, want):
    """The widest block of heads that divides H in at most 16 bytes, and
    no wider than the operands' alignment: 4 bfloat16 heads in one 8-byte
    load at the cell's H=4."""
    hb = gsc.head_block(heads, itemsize, aligned)
    assert hb == want
    assert heads % hb == 0 and hb * itemsize <= min(16, aligned)


def test_head_block_refuses_no_heads():
    with pytest.raises(ValueError, match="at least one head"):
        gsc.head_block(0, 2)


def test_alignment_of_addresses():
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert gsc._alignment(base) == 16
    assert gsc._alignment(base[1:]) == 2
    assert gsc._alignment(base, base[4:]) == 8


@pytest.mark.parametrize("perm", ["col_perm", "none"])
def test_the_source_view_is_the_transposed_views(perm):
    """``csr_source_view``: ``perm`` int32 lists each source's edges in
    ``col_perm`` order (the stable sort of ``col`` without one) between
    ``col_ptr``'s marks; ``csr_transpose`` given that ``col_ptr`` returns
    what it builds itself."""
    op = graph(300, 700, 6)
    cp = op.col_perm if perm == "col_perm" else None
    p, col_ptr = csr_source_view(op.col, cp, 300)
    assert p.dtype == torch.int32 and col_ptr.dtype == torch.int32
    np.testing.assert_array_equal(p.numpy(), np.argsort(op.col.numpy(), kind="stable"))
    c = op.col.numpy()
    for s in range(300):
        lo, hi = int(col_ptr[s]), int(col_ptr[s + 1])
        np.testing.assert_array_equal(p[lo:hi].numpy(), np.nonzero(c == s)[0])
    w = torch.rand(3, op.num_edges)
    built = csr_transpose(op.row, op.col, w, cp, 300)
    given = csr_transpose(op.row, op.col, w, p, 300, col_ptr)
    for a, b in zip(built, given):
        assert torch.equal(a, b)


def test_gat_attention_on_the_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    counters = (gsc.softmax_launches, gsc.softmax_grad_launches, gsc.softmax_src_grad_launches,
                sparse_cuda.spmm_launches)
    before = [c.count for c in counters]
    monkeypatch.setattr(gsc, "_lib", lambda: pytest.fail("the CPU loaded the softmax kernels"))
    monkeypatch.setattr(sparse_cuda, "_lib", lambda: pytest.fail("the CPU loaded the kernel"))
    op = graph(200, 500, 7)
    s_dst, s_src, _ = scores(200, 4, torch.float32, 8)
    hp = torch.randn(200, 4, 6)
    leaves = [t.clone().requires_grad_() for t in (s_dst, s_src, hp)]
    out = tsp.gat_attention(op, *leaves)
    out.sum().backward()
    logits = F.leaky_relu(s_dst[op.row.long()] + s_src[op.col.long()], SLOPE)
    p, denom, p_self = tsp.segment_softmax_coo(logits, op, F.leaky_relu(s_dst + s_src, SLOPE))
    want = (torch.zeros(200, 4, 6).index_add(0, op.row.long(), p[..., None] * hp[op.col.long()])
            + p_self[..., None] * hp) / denom[..., None]
    torch.testing.assert_close(out.detach(), want)
    assert all(t.grad is not None for t in leaves)
    assert [c.count for c in counters] == before


def on_card(dtype, shape):
    """A stand-in for a CUDA tensor: what the checks read before a launch."""
    from types import SimpleNamespace

    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=torch.Size(shape),
                           dim=lambda: len(shape))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_a_dtype_the_kernels_do_not_take_raises_before_a_launch(monkeypatch, dtype):
    """float16 and float64 scores on the card raise, naming the dtypes the
    kernels take, in the forward and in the max pass alone."""
    monkeypatch.setattr(gsc, "_lib", lambda: pytest.fail("a launch was tried"))
    op = graph(50, 100, 9)
    s = on_card(dtype, (50, 4))
    for fn in (gsc.gat_softmax, gsc.gat_softmax_max):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(op.row_ptr, op.col, op.val, s, s, s, SLOPE)


def test_operands_that_do_not_fit_raise():
    op = graph(50, 100, 10)
    s = torch.zeros(50, 4)
    with pytest.raises(ValueError, match="runs on the card"):
        gsc.gat_softmax(op.row_ptr, op.col, op.val, s, s, s, SLOPE)
    good = on_card(torch.bfloat16, (50, 4))
    cases = [
        ((on_card(torch.bfloat16, (50, 4)), on_card(torch.float32, (50, 4)), good), "one dtype"),
        ((good, good, good), "operator or scores on cpu"),
    ]
    for (a, b, c), match in cases:
        with pytest.raises(ValueError, match=match):
            gsc.check_operands(op.row_ptr, op.col, op.val, a, b, c)
    with pytest.raises(ValueError, match="int32 col"):
        gsc.check_operands(op.row_ptr, op.col.long(), op.val, good, good, good)
    with pytest.raises(ValueError, match="float32 edge values"):
        gsc.check_operands(op.row_ptr, op.col, op.val.double(), good, good, good)


def test_the_kernel_source_keeps_the_order_and_the_rounding():
    """Nothing that reorders a sum, races or skips a rounding may enter the
    softmax kernels: no atomics, no FMA, no fast-math intrinsic, no sum
    outside the rounded intrinsics; and no kernel name that the benchmark's
    CSR product metric reads (``spmm_csr_kernel``, ``spmm_sddmm_kernel``)."""
    import re

    code = re.sub(r"//[^\n]*", "", (sparse_cuda._build.CSRC / "gat_softmax.cu").read_text())
    for banned in ("atomic", "fmaf(", "__fmaf", "__expf", "__fdividef", "__shfl_down",
                   "spmm_csr_kernel", "spmm_sddmm_kernel"):
        assert banned not in code, banned
    assert not re.search(r"\b(acc|mx)\[i\]\s*[+*]=", code), "an add outside __fadd_rn"
    for needed in ("__fadd_rn", "__fsub_rn", "__fmul_rn", "__float2bfloat16_rn", "expf(",
                   "gat_softmax_kernel", "gat_softmax_grad_kernel",
                   "gat_softmax_src_grad_kernel"):
        assert needed in code, needed
