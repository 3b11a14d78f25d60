"""GAT's attention on the card's CSR kernels, and the products the kernels
do not take, against the CPU.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip, the
skip naming what is missing (decided in a fixture, never at import). Run
them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_attention.py

``ops/sparse.py:attention_spmv`` on the card runs one launch of
``spmm_csr_kernel`` a head, and in the backward one over the transposed
view and one of ``spmm_sddmm_kernel`` a head: the forward and the
gradient of x equal the CPU's plain version bit for bit (both add in
edge order), the gradient of the weights lies within 2^-7 of its terms'
magnitudes (the kernel rounds the sum once, the plain version each
product), at head widths 128, 47 and 7, with empty rows, dead edges and
a row of degree 1,200, and on edge- and node-sharded pieces; its memory
stays under a bound from the shapes that an ``[E, H, D]`` tensor would
break. On the card a float16 or float64 ``spmv`` or attention, and an
attention of other shapes, raise before any launch.
"""

import numpy as np
import pytest
import torch

from lanczosnet_torch.ops import _build
from lanczosnet_torch.ops import sparse as tsp
from lanczosnet_torch.ops import sparse_cuda

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


def graph(n: int, m: int, seed: int, hub: int = 0) -> tsp.SparseOp:
    """A sym-normalized operator on the CPU: ``m`` random pairs, nodes 0
    and n-1 isolated (empty rows), a fifth of the edges dead, and with
    ``hub`` node 1 joined to ``hub`` others."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(2, n - 1, m), rng.integers(2, n - 1, m)
    pairs = [np.stack([a, b], 1)]
    if hub:
        pairs.append(np.stack([np.ones(hub, np.int64), np.arange(2, hub + 2) % (n - 1)], 1))
    pairs = np.concatenate(pairs)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    op = tsp.sparse_sym_operator(np.unique(np.sort(pairs, 1), axis=0), n)
    return tsp.masked_val_op(op, torch.from_numpy(rng.random(op.num_edges) > 0.2))


def counts():
    return tuple(c.count for c in (sparse_cuda.spmm_launches, sparse_cuda.spmm_t_launches,
                                   sparse_cuda.sddmm_launches))


def attention_and_grads(op, p, x, g):
    """``attention_spmv(op, p, x)`` and the gradients of ``<out, g>`` in p and x."""
    pr, xr = p.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
    out = tsp.attention_spmv(op, pr, xr)
    out.backward(g)
    return out.detach(), xr.grad, pr.grad


@pytest.mark.parametrize("heads,width", [(4, 128), (4, 47), (2, 7)])
def test_the_heads_on_the_kernel_equal_the_cpu_plain_version(card, heads, width):
    op = graph(3000, 9000, 0, hub=1200)
    rng = np.random.default_rng(1)
    live = (op.val != 0).to(torch.float32)[:, None]
    p = (torch.from_numpy(rng.random((op.num_edges, heads)).astype(np.float32)) * live).bfloat16()
    x, g = (torch.from_numpy(rng.standard_normal((3000, heads, width)).astype(np.float32))
            .bfloat16() for _ in range(2))
    before = counts()
    got = attention_and_grads(op.to(card), p.to(card), x.to(card), g.to(card))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (heads, heads, heads)
    want = attention_and_grads(op, p, x, g)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)
    terms = (g.float().index_select(0, op.row) * x.float().index_select(0, op.col)).abs().sum(-1)
    err = (got[2].cpu().float() - want[2].float()).abs()
    assert got[2].dtype == want[2].dtype and bool((err <= 2**-7 * terms + 1e-30).all()), \
        float(err.max())


def test_gat_attention_on_the_card_is_as_close_to_float64_as_the_cpu(card):
    """The whole attention (logits, softmax, the kernel's sums, the
    self-edge, the normalization) and its gradients in the scores and the
    states, in bfloat16 on the card and on the CPU, each against the
    float64 attention: the card's error, in norm, at most twice the CPU's.
    Both are bfloat16 evaluations of one function; the score gradients
    are differences of nearly equal terms, so both lie 0.4–2% off
    float64, and the card, whose SDDMM rounds each weight gradient once
    where the CPU rounds each product, is no less accurate."""
    op = graph(2000, 8000, 2, hub=1100)
    gen = torch.Generator().manual_seed(3)
    s_dst, s_src = (torch.randn(2000, 4, generator=gen).bfloat16() for _ in range(2))
    hp, g = (torch.randn(2000, 4, 32, generator=gen).bfloat16() for _ in range(2))
    outs = []
    for dev, dt in ((card, torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float64)):
        args = [t.to(dev, dt).detach().requires_grad_() for t in (s_dst, s_src, hp)]
        out = tsp.gat_attention(op.to(dev), *args)
        out.backward(g.to(dev, dt))
        outs.append([out.detach().cpu().double()] + [a.grad.cpu().double() for a in args])
    for got, cpu, exact in zip(*outs):
        err, cpu_err = (float(torch.linalg.norm(t - exact)) for t in (got, cpu))
        print(f"card {err / float(torch.linalg.norm(exact)):.3e}, "
              f"cpu {cpu_err / float(torch.linalg.norm(exact)):.3e}")
        assert err <= 2.0 * cpu_err


def test_no_edge_by_feature_tensor_is_allocated(card):
    """Forward and backward of 4 heads of 128 over 2M edges on 20k nodes:
    the card's peak over what was allocated before stays under a bound of
    node- and edge-sized tensors that a 2 GB ``[E, H, D]`` tensor would
    break."""
    n, heads, width = 20_000, 4, 128
    rng = np.random.default_rng(5)
    pairs = rng.integers(0, n, (1_200_000, 2))
    pairs = np.unique(np.sort(pairs[pairs[:, 0] != pairs[:, 1]], 1), axis=0)
    op = tsp.sparse_sym_operator(pairs, n, device=card)
    e = op.num_edges
    p = torch.rand(e, heads, device=card).bfloat16().requires_grad_()
    x = torch.randn(n, heads, width, device=card).bfloat16().requires_grad_()
    g = torch.randn(n, heads, width, device=card).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    tsp.attention_spmv(op, p, x).backward(g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    node = n * heads * width * 2  # a [N, H, D] bfloat16 tensor
    edge = e * heads * 4  # an [E, H] float32 tensor
    bound = 8 * node + 6 * edge + 4 * e * 4 + (64 << 20)
    assert bound < e * heads * width * 2
    assert peak <= bound, (peak, bound)


@pytest.mark.parametrize("mode", ["edges", "nodes"])
def test_the_heads_on_sharded_pieces_equal_the_cpu(card, mode):
    """A rank's piece of ``parallel/mesh.py`` (edge-sharded: a slice of
    the edges, padded with dead edges at the last row; node-sharded: a
    block's rows against every source, padded): the kernel a head on the
    piece, given the x it reads, equals the plain version bit for bit,
    forward and dx, and launches once a head each way."""
    from lanczosnet_torch.parallel import mesh

    whole = graph(2002, 6000, 2)  # 2002 nodes: the node blocks are padded
    args = (whole.row.numpy(), whole.col.numpy(), whole.val.numpy(), 2002, 4)
    if mode == "edges":
        arrays, n, n_src = mesh.shard_sparse_arrays(*args), 2002, 2002
    else:
        arrays, n_pad = mesh.node_shard_arrays(*args)
        n, n_src = n_pad // 4, n_pad
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n_src, 4, 47)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((n, 4, 47)).astype(np.float32)).bfloat16()
    for r in range(4):
        piece = mesh.sparse_op_piece({k: v[r] for k, v in arrays.items()}, n, None, mode, "cpu")
        p = torch.from_numpy(rng.random((piece.num_edges, 4)).astype(np.float32))
        before = counts()
        got = attention_and_grads(piece.to(card), p.to(card), x.to(card), g.to(card))
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == (4, 4, 4)
        want = attention_and_grads(piece, p, x, g)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a.cpu(), b), (mode, r)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("shape", [(), (7,)])
def test_a_dtype_the_kernels_do_not_take_raises_on_the_card(card, dtype, shape):
    """A float16 or float64 product on the card raises, naming the dtypes
    the kernels take, and so does GAT's weighted sum in that dtype or with
    other shapes than ``p [E, H]`` and ``x [N, H, D]``; nothing launches."""
    op = graph(1000, 3000, 4).to(card)
    x = torch.randn((1000,) + shape, device=card).to(dtype)
    p = torch.rand(op.num_edges, 2, device=card)
    before = counts()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsp.spmv(op, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsp.attention_spmv(op, p, torch.randn(1000, 2, 8, device=card).to(dtype))
    with pytest.raises(ValueError, match=r"p \[E, H\] and x \[N, H, D\]"):
        tsp.attention_spmv(op, p[:, 0], x.float())
    torch.cuda.synchronize()
    assert counts() == before
