"""The FLOP and byte counts against hand counts at small shapes, and the
forward's dense FLOPs against ``FlopCounterMode`` on the reference."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from portbench.counts import gcn, lanczos_net
from portbench.reference import gcn as ref_gcn
from portbench.reference import lanczos_net as ref_lnet

GCN = {"hidden_dim": [3, 5], "dtype": "bfloat16"}
LNET = {"hidden_dim": [3], "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3],
        "num_eig_vec": 2, "filter_hidden_dim": 4, "dtype": "bfloat16"}


def test_gcn_by_hand():
    n, e, f, c = 10, 20, 4, 2
    # forward: S x (2·20·4), [x, Sx] W0 (2·10·8·3), S h1 (2·20·3),
    # [h1, Sh1] W1 (2·10·6·5), head (2·10·5·2)
    fwd = 160 + 480 + 120 + 600 + 200
    # backward: head dX and dW (200 each), layer 1 dW (600), its inputs' gradient (600) and
    # Sᵀ (120); layer 0 dW only (480)
    bwd = 400 + 600 + 600 + 120 + 480
    assert gcn.epoch(GCN, n, e, f, c)["flops"] == 2 * fwd + bwd
    assert gcn.infer_pass(GCN, n, e, f, c)["flops"] == fwd
    # bytes of the forward, bfloat16 activations: S x reads x (80) and the edges (240), writes
    # 80; W0 reads [x, Sx] (160), W (96), writes 60; S h1: 60 + 240 + 60; W1: 120 + 120 + 100;
    # head: 100 + 40 + 40
    fwd_bytes = 400 + 316 + 360 + 340 + 180
    assert gcn.infer_pass(GCN, n, e, f, c)["bytes"] == fwd_bytes
    assert gcn.infer_pass(GCN, n, e, f, c)["sparse_bytes"] == 400 + 360


def test_lanczos_net_by_hand():
    n, e, f, c, k, fh = 10, 20, 4, 2, 2, 4
    sparse = 2 * (2 * e * f)  # S x and S² x
    proj = 2 * k * n * f  # Vᵀ x
    filt = 2 * k * 2 * fh + 2 * k * fh * 1  # the MLP on [λ, λ³]
    recon = 2 * n * k * f  # V (φ ⊙ Vᵀx)
    layer = 2 * n * (4 * f) * 3  # [x, Sx, S²x, long] W
    head = 2 * n * 3 * c
    fwd = sparse + proj + filt + recon + layer + head
    assert lanczos_net.infer_pass(LNET, n, e, f, c)["flops"] == fwd
    # backward of the one layer: head dX, dW; the layer's dW; the long part's gradient;
    # Vᵀ g; the filter's backward (dH, dW1, dW0); nothing reaches x
    bwd = 2 * head + layer + 2 * n * 3 * f + 2 * k * n * f + (2 * k * fh + 2 * fh * k
                                                             + 2 * 2 * k * fh)
    assert lanczos_net.epoch(LNET, n, e, f, c)["flops"] == 2 * fwd + bwd
    # the sparse bytes: two products, each x in and out at 2 bytes and 12 bytes an edge
    assert lanczos_net.infer_pass(LNET, n, e, f, c)["sparse_bytes"] == 2 * (2 * n * f * 2
                                                                            + 12 * e)


def test_sparse_calls_by_hand():
    from portbench import counts

    n, e, f, c = 10, 20, 4, 2
    # GCN: forward 2 products (one index_select, one index_add each), the backward's one
    # (past layer 0) an index_select of the cotangent and, in one chunk, two index_select
    # and one index_add_; the validation forward 2 again
    assert gcn.epoch(GCN, n, e, f, c)["sparse_calls"] == {
        "aten::index_select": 2 + 3 + 2, "aten::index_add": 4, "aten::index_add_": 1}
    # remat replays the step's forward products
    assert gcn.epoch(GCN, n, e, f, c, remat=True)["sparse_calls"]["aten::index_add"] == 6
    # LanczosNet, one layer of S x and S² x: nothing runs backward through layer 0
    assert lanczos_net.epoch(LNET, n, e, f, c, remat=True)["sparse_calls"] == {
        "aten::index_select": 6, "aten::index_add": 6, "aten::index_add_": 0}
    assert lanczos_net.infer_pass(LNET, n, e, f, c)["sparse_calls"] == {
        "aten::index_select": 2, "aten::index_add": 2, "aten::index_add_": 0}
    # the sorted scatter's chunks at the cells' sizes: 25M edges of 32 and 2.5M of 256
    # float32 columns are 3.2 and 2.56 GB, over 2 GiB, in chunks of at most 1 GiB
    assert counts.scatter_chunks(25_000_000, 32) == 3
    assert counts.scatter_chunks(2_500_000, 256) == 3
    assert counts.scatter_chunks(16_000_000, 32) == 1  # 2.048 GB, under 2 GiB: whole
    assert counts.scatter_chunks(10, 7) == 1


def _cell_model(name):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    return cfg["model"], cfg["train"].get("remat") == "layers"


def test_sparse_launches_by_hand():
    """Launches of the CSR product kernels a unit, at the cells' own models
    (they depend on no size): 10M LanczosNet, two layers of S h and S² h,
    remat by layers: the step's 4 forward products, remat's replay of them
    (4), the backward's 2 past layer 0, the validation forward's 4; a
    scoring pass 4; the wide GCN, one product a layer: 2, the backward's 1,
    the validation's 2. No weight needs a gradient: no sddmm launch."""
    from portbench import counts

    n, e, f, c = 10, 20, 4, 2
    lnet, remat = _cell_model("ten_million_sparse_lanczos_net")
    assert remat
    assert lanczos_net.epoch(lnet, n, e, f, c, remat=True)["sparse_launches"] == 14
    assert lanczos_net.epoch(lnet, n, e, f, c)["sparse_launches"] == 10
    assert lanczos_net.infer_pass(lnet, n, e, f, c)["sparse_launches"] == 4
    gcn_model, remat = _cell_model("million_sparse_gcn_wide")
    assert not remat
    assert gcn.epoch(gcn_model, n, e, f, c)["sparse_launches"] == 5
    assert gcn.infer_pass(gcn_model, n, e, f, c)["sparse_launches"] == 2
    # an edge-weight gradient is one launch more and moves no other count
    t = counts.Tally()
    t.sparse(n, e, f, 2, backward=True)
    before = t.as_dict()
    t.edge_weight_grad()
    assert t.sparse_launches == 2
    assert {k: v for k, v in t.as_dict().items() if k != "sparse_launches"} == {
        k: v for k, v in before.items() if k != "sparse_launches"}


def _op(n, e, gen):
    row = torch.randint(0, n, (e,), generator=gen)
    col = torch.randint(0, n, (e,), generator=gen)
    return row, col, torch.rand(e, generator=gen, dtype=torch.float64), n


@pytest.mark.parametrize("family, counts, model", [(ref_gcn, gcn, GCN),
                                                   (ref_lnet, lanczos_net, LNET)])
def test_dense_flops_match_the_reference_s_products(family, counts, model):
    """What ``FlopCounterMode`` counts of the reference's forward (its matrix
    products; the sparse products run as index ops it does not see) is the
    count less the sparse products."""
    n, e, f, c = 50, 120, 6, 3
    gen = torch.Generator().manual_seed(0)
    shapes = family.param_shapes(model, f, c)
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    extras = (torch.rand(model.get("num_eig_vec", 1), generator=gen),
              torch.randn(n, model.get("num_eig_vec", 1), generator=gen))
    x = torch.rand(n, f, generator=gen)
    counter = FlopCounterMode(display=False)
    with counter:
        family.logits(model, params, x, _op(n, e, gen), extras)
    want = counts.infer_pass(model, n, e, f, c)
    hops = max(model.get("short_diffusion_dist", [1]))
    widths = [f, *model["hidden_dim"][:-1]]
    sparse_flops = sum(2 * e * w * hops for w in widths)
    assert counter.get_total_flops() == want["flops"] - sparse_flops
