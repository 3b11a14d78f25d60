"""What the CPU can check of the card's CSR product kernels
(``ops/sparse_cuda.py``, ``csrc/spmm_csr.cu``): the CSR structures they
walk, the launch plan, the plain version's order of summation, and that
the CPU never reaches a kernel.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``
holds it to the plain version bit for bit). Here a numpy emulation of
its arithmetic (each edge's message rounded to x's dtype, added to a
float32 sum in edge order, narrowed once) is held to the plain version
on the CPU bit for bit: that the CPU's ``index_add`` adds in edge order
is what makes the card's comparison exact.
"""

import numpy as np
import pytest
import torch

from lanczosnet_torch.ops import sparse as tsp
from lanczosnet_torch.ops import sparse_cuda
from lanczosnet_torch.ops.sparse_cuda import csr_row_ptr, csr_transpose, spmm_plan
from lanczosnet_torch.parallel import mesh


def graph(n: int, m: int, seed: int, hub: int = 0) -> tsp.SparseOp:
    """``sparse_sym_operator`` of ``m`` random pairs on ``n`` nodes, node
    0 and the last node isolated; with ``hub``, node 1 joined to ``hub``
    others (one row of high degree)."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(2, n - 1, m), rng.integers(2, n - 1, m)
    pairs = [np.stack([a, b], 1)]
    if hub:
        pairs.append(np.stack([np.ones(hub, np.int64), np.arange(2, hub + 2) % (n - 1)], 1))
    pairs = np.concatenate(pairs)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return tsp.sparse_sym_operator(np.unique(np.sort(pairs, 1), axis=0), n)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 (round to nearest even) → float32, in numpy."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def emulate(ptr, idx, val, x, narrow: bool) -> np.ndarray:
    """The kernel's arithmetic: per row, messages in edge order added to a
    float32 sum from +0, each message and the sum rounded to x's dtype
    (``narrow``: bfloat16)."""
    rnd = bf16_round if narrow else (lambda v: v)
    ptr, idx = ptr.astype(np.int64), idx.astype(np.int64)
    w = rnd(val.astype(np.float32))
    x2 = x.reshape(x.shape[0], -1)
    n = len(ptr) - 1
    acc = np.zeros((n, x2.shape[1]), np.float32)
    deg = np.diff(ptr)
    for k in range(int(deg.max(initial=0))):
        rows = np.nonzero(deg > k)[0]
        e = ptr[rows] + k
        acc[rows] = acc[rows] + rnd(w[e, None] * x2[idx[e]])
    return rnd(acc).reshape((n,) + x.shape[1:])


CASES = {"vector": (), "f32": (32,), "f7": (7,), "f256": (256,)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(CASES))
def test_the_plain_version_adds_in_edge_order_bit_for_bit(shape, dtype):
    """The CPU's plain forward equals the emulation of the kernel exactly,
    and its backward to x equals the emulation over the transposed view
    (``col_perm`` order): with dead edges, empty rows and a row of degree
    1,200."""
    op = graph(400, 900, 0, hub=1200)
    keep = torch.from_numpy(np.random.default_rng(1).random(op.num_edges) > 0.2)
    op = tsp.masked_val_op(op, keep)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((400,) + CASES[shape]).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((400,) + CASES[shape]).astype(np.float32)).to(dtype)
    narrow = dtype == torch.bfloat16
    xr = x.clone().requires_grad_()
    out = tsp._spmv_plain(op, xr)
    out.backward(g)
    want = emulate(op.row_ptr.numpy(), op.col.numpy(), op.val.numpy(), x.float().numpy(), narrow)
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    col_ptr, row_t, val_t = csr_transpose(op.row, op.col, op.val, op.col_perm, 400)
    want_dx = emulate(col_ptr.numpy(), row_t.numpy(), val_t.numpy(), g.float().numpy(), narrow)
    np.testing.assert_array_equal(xr.grad.float().numpy(), want_dx)


def row_ptr_cases():
    edges = graph(300, 700, 3)
    pieces = mesh.shard_sparse_arrays(edges.row.numpy(), edges.col.numpy(), edges.val.numpy(),
                                      300, 4)
    nodes, _ = mesh.node_shard_arrays(edges.row.numpy(), edges.col.numpy(), edges.val.numpy(),
                                      300, 4)
    ring, _ = mesh.ring_shard_arrays(edges.row.numpy(), edges.col.numpy(), edges.val.numpy(),
                                     300, 4)
    return {
        "whole": (edges.row, 300),
        "leading-and-trailing-empty": (torch.tensor([2, 2, 5, 5, 5, 6], dtype=torch.int32), 9),
        "no-edges": (torch.zeros(0, dtype=torch.int32), 5),
        "one-row": (torch.full((1000,), 3, dtype=torch.int32), 4),
        "edge-piece-padded": (torch.from_numpy(pieces["row"][3]), 300),
        "node-piece-padded": (torch.from_numpy(nodes["row"][1]), 75),
        "ring-slice-padded": (torch.from_numpy(ring["row"][2, 1]), 75),
    }


@pytest.mark.parametrize("case", sorted(row_ptr_cases()))
def test_csr_row_ptr_gives_each_row_its_edges(case):
    row, n = row_ptr_cases()[case]
    ptr = csr_row_ptr(row, n)
    assert ptr.dtype == torch.int32 and ptr.shape == (n + 1,)
    assert int(ptr[0]) == 0 and int(ptr[-1]) == row.numel()
    want = np.concatenate([[0], np.cumsum(np.bincount(row.numpy(), minlength=n))])
    np.testing.assert_array_equal(ptr.numpy(), want)


@pytest.mark.parametrize("perm", ["col_perm", "none"])
@pytest.mark.parametrize("case", ["whole", "node-piece"])
def test_csr_transpose_lists_each_sources_edges_in_col_perm_order(case, perm):
    """``col_ptr`` over the sources (global ones for a node-sharded
    piece) and ``row``/``val`` permuted; without ``col_perm`` the stable
    sort of ``col``, which is ``col_perm`` itself."""
    op = graph(300, 700, 4)
    row, col, val, n_src = op.row, op.col, op.val, 300
    if case == "node-piece":
        arrays, _ = mesh.node_shard_arrays(row.numpy(), col.numpy(), val.numpy(), 300, 4)
        row, col, val = (torch.from_numpy(arrays[k][2]) for k in ("row", "col", "val"))
    cp = torch.from_numpy(np.argsort(col.numpy(), kind="stable").astype(np.int32))
    col_ptr, row_t, val_t = csr_transpose(row, col, val, cp if perm == "col_perm" else None,
                                          n_src)
    assert col_ptr.dtype == torch.int32 and col_ptr.shape == (n_src + 1,)
    c = col.numpy()
    for s in range(n_src):
        edges = np.nonzero(c == s)[0]  # in edge order: the stable sort's
        lo, hi = int(col_ptr[s]), int(col_ptr[s + 1])
        np.testing.assert_array_equal(row_t[lo:hi].numpy(), row.numpy()[edges])
        np.testing.assert_array_equal(val_t[lo:hi].numpy(), val.numpy()[edges])


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("f", [1, 3, 7, 8, 16, 20, 32, 40, 64, 128, 256, 500, 512, 1024, 1433])
def test_spmm_plan_covers_every_chunk_of_a_row_once(f, itemsize):
    """Lane j of tile t holds chunks t·lanes·vpl + v·lanes + j: every
    chunk of the row exactly once, 16-byte vectors where the row is made
    of them, a group no wider than a warp."""
    for vector in (True, False):
        plan = spmm_plan(f, itemsize, vector)
        assert plan.width == (16 // itemsize if vector and f * itemsize % 16 == 0 else 1)
        assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.vpl in sparse_cuda.VPLS
        chunks = f // plan.width
        held = [t * plan.lanes * plan.vpl + v * plan.lanes + j for t in range(plan.tiles)
                for v in range(plan.vpl) for j in range(plan.lanes)]
        assert sorted(c for c in held if c < chunks) == list(range(chunks))
        assert plan.tiles == 1 or chunks > plan.lanes * plan.vpl * (plan.tiles - 1)


def test_main_path_plans():
    """64-byte rows take 4 lanes, 512-byte rows a warp, ``[N]`` one lane."""
    assert spmm_plan(32, 2) == sparse_cuda.SpmmPlan(8, 4, 1, 1)
    assert spmm_plan(256, 2) == sparse_cuda.SpmmPlan(8, 32, 1, 1)
    assert spmm_plan(1, 4) == sparse_cuda.SpmmPlan(1, 1, 1, 1)


def test_spmv_on_the_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    counters = (sparse_cuda.spmm_launches, sparse_cuda.spmm_t_launches,
                sparse_cuda.sddmm_launches)
    before = [c.count for c in counters]
    calls = []
    plain = tsp._spmv_plain
    monkeypatch.setattr(tsp, "_spmv_plain", lambda op, x: calls.append(1) or plain(op, x))
    monkeypatch.setattr(sparse_cuda, "_lib", lambda: pytest.fail("the CPU loaded the kernel"))
    op = graph(200, 500, 5)
    val = op.val.clone().requires_grad_()
    x = torch.randn(200, 8, requires_grad=True)
    tsp.spmv(op.replace(val=val), x).sum().backward()
    assert calls == [1] and x.grad is not None and val.grad is not None
    assert [c.count for c in counters] == before


def test_csr_spmm_refuses_a_cpu_tensor():
    op = graph(50, 100, 6)
    with pytest.raises(ValueError, match="runs on the card"):
        sparse_cuda.csr_spmm(op.row_ptr, op.row, op.col, op.val, op.col_perm, torch.randn(50, 4))


def test_replace_masked_val_op_and_to_carry_row_ptr():
    op = graph(100, 300, 7)
    assert op.row_ptr is not None
    masked = tsp.masked_val_op(op, op.val > op.val.median())
    assert masked.row_ptr is op.row_ptr
    assert op.replace(val=op.val * 2).row_ptr is op.row_ptr
    intra, cut = tsp.partition_masks(op, torch.arange(100) % 3)
    assert intra.row_ptr is op.row_ptr and cut.row_ptr is op.row_ptr
    moved = op.to("cpu")
    np.testing.assert_array_equal(moved.row_ptr.numpy(), op.row_ptr.numpy())
    # new rows describe other rows: their old row_ptr is dropped
    assert op.replace(row=op.row.flip(0), rows_sorted=False).row_ptr is None
    assert op.replace(n=101).row_ptr is None


@pytest.mark.parametrize("mode", ["edges", "nodes"])
def test_sparse_op_piece_builds_its_row_ptr(mode):
    op = graph(300, 700, 8)
    args = (op.row.numpy(), op.col.numpy(), op.val.numpy(), 300, 4)
    arrays = mesh.shard_sparse_arrays(*args) if mode == "edges" else mesh.node_shard_arrays(*args)[0]
    n = 300 if mode == "edges" else 75
    for r in range(4):
        piece = mesh.sparse_op_piece({k: v[r] for k, v in arrays.items()}, n, None, mode, "cpu")
        np.testing.assert_array_equal(piece.row_ptr.numpy(),
                                      csr_row_ptr(piece.row, n).numpy())
        assert int(piece.row_ptr[-1]) == piece.num_edges


def test_ring_op_piece_builds_each_slices_row_ptr():
    op = graph(300, 700, 9)
    arrays, _ = mesh.ring_shard_arrays(op.row.numpy(), op.col.numpy(), op.val.numpy(), 300, 4)
    for r in range(4):
        rop = mesh.ring_op_piece({k: v[r] for k, v in arrays.items()}, 75, None, "cpu")
        assert rop.row_ptr.dtype == torch.int32 and rop.row_ptr.shape == (4, 76)
        for s in range(4):
            assert bool((rop.row[s][1:] >= rop.row[s][:-1]).all())
            np.testing.assert_array_equal(rop.row_ptr[s].numpy(),
                                          csr_row_ptr(rop.row[s], 75).numpy())
        assert tsp.masked_val_op(rop, rop.val > 0.1).row_ptr is rop.row_ptr
        np.testing.assert_array_equal(rop.to("cpu").row_ptr.numpy(), rop.row_ptr.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_spmv_on_the_cpu_is_the_plain_version(monkeypatch, dtype):
    """A one-rank ring holds the whole operator in one slice, in edge
    order: its product is the plain version's bit for bit, and the CPU
    launches nothing."""
    counters = (sparse_cuda.spmm_launches, sparse_cuda.spmm_t_launches,
                sparse_cuda.sddmm_launches)
    before = [c.count for c in counters]
    monkeypatch.setattr(sparse_cuda, "_lib", lambda: pytest.fail("the CPU loaded the kernel"))
    op = graph(120, 300, 10)
    arrays, _ = mesh.ring_shard_arrays(op.row.numpy(), op.col.numpy(), op.val.numpy(), 120, 1)
    one = type("OneRank", (), {"size": 1, "rank": 0})()
    rop = mesh.ring_op_piece({k: v[0] for k, v in arrays.items()}, 120, one, "cpu")
    x = torch.randn(120, 16).to(dtype)
    xr = x.clone().requires_grad_()
    got = tsp.spmv(rop, xr)
    got.float().sum().backward()
    xp = x.clone().requires_grad_()
    want = tsp._spmv_plain(op, xp)
    want.float().sum().backward()
    assert torch.equal(got, want) and torch.equal(xr.grad, xp.grad)
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("dtype,route", [(torch.float32, True), (torch.bfloat16, True),
                                         (torch.float16, False), (torch.float64, False)])
def test_the_card_route_by_dtype(dtype, route):
    """On the card a product and GAT's weighted sum take the kernels for
    float32 and bfloat16 (here they go on to refuse the CPU operator) and
    raise for float16 and float64, naming the dtypes they take, before
    any launch; a product without ``row_ptr`` raises first."""
    from types import SimpleNamespace

    def on_card(dims):
        """A stand-in for a CUDA tensor: what the routes read before a launch."""
        t = SimpleNamespace(device=torch.device("cuda"), dtype=dtype, dim=lambda: dims)
        t.permute = lambda *_: t
        return t

    op = graph(50, 100, 8)
    for fn, args in ((tsp.spmv, (on_card(2),)),
                     (tsp.attention_spmv, (torch.ones(op.num_edges, 2), on_card(3)))):
        with pytest.raises(ValueError, match="operator on cpu" if route else "float32 or bf"):
            fn(op, *args)
        with pytest.raises(ValueError, match="row_ptr"):
            fn(op.replace(row_ptr=None), *args)


def test_attention_on_the_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    counters = (sparse_cuda.spmm_launches, sparse_cuda.spmm_t_launches,
                sparse_cuda.sddmm_launches)
    before = [c.count for c in counters]
    monkeypatch.setattr(sparse_cuda, "_lib", lambda: pytest.fail("the CPU loaded the kernel"))
    op = graph(200, 500, 9)
    p = torch.rand(op.num_edges, 3, requires_grad=True)
    x = torch.randn(200, 3, 5, requires_grad=True)
    out = tsp.attention_spmv(op, p, x)
    out.sum().backward()
    want = torch.zeros(200, 3, 5).index_add(0, op.row.long(),
                                            p.detach()[..., None] * x.detach()[op.col.long()])
    torch.testing.assert_close(out.detach(), want)
    assert p.grad is not None and x.grad is not None
    assert [c.count for c in counters] == before
