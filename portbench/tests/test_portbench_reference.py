"""The reference against the port at a small size on the CPU: the
operator and the Ritz pairs as each side works them out, and in float32
(where the two differ only in the order of their sums) the logits, the
first steps' losses, gradients and parameter change, with dropout on."""

from __future__ import annotations

import tempfile
from pathlib import Path

import pytest
import torch

from conftest import shrink
from portbench import bench, check
from portbench.reference import coo, lanczos


def _float32(cfg):
    cfg = shrink(cfg)
    cfg["model"] = {**cfg["model"], "dtype": "float32"}
    return cfg


@pytest.fixture(scope="module")
def graph():
    cell = bench.Cell("ten_million_sparse_lanczos_net-train")
    return bench.draw(cell, 2**32 + 3, "cpu", shrink)


def test_the_operator_and_the_ritz_pairs(graph):
    from lanczosnet_torch.ops.sparse import coo_arrays, sparse_lanczos_ritz, sparse_op_from_arrays

    n = graph["features"].shape[0]
    op = sparse_op_from_arrays(coo_arrays(graph["edges"], n, "sym"), n, "cpu")
    ref = coo.sym_operator(torch.from_numpy(graph["edges"]), n)
    nums = check.operator_numbers({"row": op.row, "col": op.col, "val": op.val,
                                   "col_perm": op.col_perm, "n": n}, ref)
    assert nums["op_index_mismatch"] == 0 and nums["op_val_gap"] < 1e-7
    ritz = lanczos.ritz_pairs(*ref, n, 20)
    nums = check.ritz_numbers(sparse_lanczos_ritz(op, 20), ritz, 7)
    assert nums["ritz_val_gap"] < 1e-5 and nums["ritz_proj_gap"] < 1e-4
    # the Ritz vectors are orthonormal and the values S's Rayleigh quotients
    vals, vecs = ritz
    assert torch.allclose(vecs.T @ vecs, torch.eye(20, dtype=torch.float64), atol=1e-10)
    assert vals.min() >= -1.0 - 1e-9 and vals.max() <= 1.0 + 1e-9


@pytest.mark.parametrize("workload", ["ten_million_sparse_lanczos_net-train",
                                      "million_sparse_gcn_wide-train",
                                      "ten_million_sparse_lanczos_net-infer"])
def test_the_port_in_float32_is_the_reference(workload):
    cell = bench.Cell(workload)
    g = bench.draw(cell, 11, "cpu", _float32)
    with tempfile.TemporaryDirectory() as d:
        prog, weights, out = bench.build_program(cell, g, 11, torch.device("cpu"), Path(d))
        bench.drive_first(cell, prog, weights, out)
        del prog
    nums = bench.compare(cell, g, weights, out, 11, torch.device("cpu"))
    assert nums["op_index_mismatch"] == 0 and nums["op_val_gap"] < 1e-7
    if cell.kind == "train":
        assert nums["loss_gap"] < 1e-5
        assert nums["grad_norm_gap"] < 1e-4
        assert nums["change_norm_gap"] < 1e-3
    else:
        assert nums["logits_gap"] < 1e-5 and nums["pred_margin_gap"] < 1e-4


def test_the_reference_s_dropout_is_the_port_s_stream():
    """With dropout on and off the first gradient moves, and the reference
    moves with the port: the masks are the same draws."""
    grads = {}
    for p in (0.0, 0.5):
        cell = bench.Cell("million_sparse_gcn_wide-train")
        g = bench.draw(cell, 5, "cpu", lambda cfg: {
            **_float32(cfg), "model": {**_float32(cfg)["model"], "dropout": p}})
        with tempfile.TemporaryDirectory() as d:
            prog, weights, out = bench.build_program(cell, g, 5, torch.device("cpu"), Path(d))
            bench.drive_first(cell, prog, weights, out)
        nums = bench.compare(cell, g, weights, out, 5, torch.device("cpu"))
        assert nums["loss_gap"] < 1e-5
        grads[p] = out["first"]["grad_opt"]["layers.0.weight"]
    assert not torch.allclose(grads[0.0], grads[0.5], rtol=0.1)
