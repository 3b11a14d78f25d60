"""Nothing of the benchmark imports JAX, flax or the JAX package, and the
reference imports nothing of the program: each imported module compared
by its whole top-level name."""

from __future__ import annotations

import ast
import sys

import pytest

from conftest import ROOT
from portbench import bench

PB = ROOT / "portbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "lanczosnet_tpu"}


def imported_top_levels(path) -> set[str]:
    """The top-level names (the part before the first dot) of every module
    that ``path`` imports, at any depth of its code."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".", 1)[0])
    return names


def test_no_benchmark_module_imports_the_jax_side():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    found = {str(p.relative_to(ROOT)): imported_top_levels(p) & JAX_SIDE for p in files}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((PB / "reference").rglob("*.py")):
        names = imported_top_levels(p)
        assert "lanczosnet_torch" not in names, p
        assert names <= {"__future__", "contextlib", "dataclasses", "typing", "torch",
                         "portbench", "math"}, (p, names)


def test_top_level_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import lanczosnet_torch.ops\nfrom lanczosnet_tpu_extra import x\n"
                   "import jaxtyping\nfrom flax.linen import Dense\n")
    assert imported_top_levels(src) & JAX_SIDE == {"flax"}


@pytest.mark.parametrize("name, bad", [
    ("lanczosnet_torch", False), ("lanczosnet_torch.ops.sparse", False),
    ("lanczosnet_tpu", True), ("lanczosnet_tpu.ops", True), ("lanczosnet_tpu_x", False),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("jaxtyping", False),
    ("flax.linen", True), ("flaxen", False)])
def test_the_run_s_module_check_takes_whole_names(monkeypatch, name, bad):
    for m in [m for m in sys.modules if m.split(".", 1)[0] in bench.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in bench.forbidden_modules()) is bad


def test_a_run_loads_nothing_of_the_jax_side(tiny):
    """The port and the harness, driven through a whole tiny run in this
    process, leave no JAX module behind (the test process itself has
    not imported JAX)."""
    import time

    if bench.forbidden_modules():
        pytest.skip("this process loaded the JAX side before the test")
    bench.run_cell("million_sparse_gcn_wide-train", 5, 0.1, False, "cpu", time.perf_counter(),
                   tiny)
    assert bench.forbidden_modules() == []
