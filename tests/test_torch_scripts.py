"""The port's tools, ``scripts/torch_*.py``, on the CPU at small sizes.

Each is the counterpart of a JAX script in ``scripts/`` and imports
nothing of JAX; the QM8 ingest runs beside the JAX ingest on the stub
deepchem and rdkit of ``tests/test_qm8_ingest.py`` and packs the same
arrays (operators 1e-6; Ritz pairs through ``V D^p Vᵀ``, 1e-3, as
``tests/test_torch_qm8_train.py`` holds a pack). The trace parser's self
times are checked on a hand-made Chrome trace with nested and
overlapping events.
"""

import ast
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lanczosnet_torch.utils import config as config_io
from lanczosnet_torch.utils.profiling import (
    device_busy_seconds,
    op_category,
    op_self_times,
    self_time_table,
)
from test_qm8_ingest import STUB_DEEPCHEM, STUB_RDKIT

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
TOOLS = ("torch_profile_step", "torch_mem_probe", "torch_run_all", "torch_get_qm8_data",
         "torch_fuzz_sharded_ada", "torch_repro_ada_nan")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lanczosnet_tpu", "bench", "run_exp",
             "__graft_entry__", *(p.stem for p in SCRIPTS.glob("*.py")
                                  if not p.stem.startswith("torch_"))}


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(*args, env=None, timeout=300):
    return subprocess.run([sys.executable, *map(str, args)], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout, env=env)


# ---------------------------------------------------------------- hygiene
def test_the_tools_import_nothing_of_jax():
    """No ``scripts/torch_*.py`` imports JAX, flax, the JAX package or a
    JAX script (AST), and importing all six in a fresh interpreter loads
    none of them."""
    assert all((SCRIPTS / f"{t}.py").exists() for t in TOOLS)
    offenders = []
    for path in sorted(SCRIPTS.glob("torch_*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert not offenders
    code = ("import importlib.util, sys\n"
            f"sys.path.insert(0, {str(SCRIPTS)!r})\n"
            f"for name in {TOOLS!r}:\n"
            f"    spec = importlib.util.spec_from_file_location(name, {str(SCRIPTS)!r} + '/' + name + '.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = run("-c", code, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------- profile_step
def x(name, cat, ts, dur, **more):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **more}


NESTED_TRACE = [
    x("outer_gemm_kernel", "kernel", 0.0, 10.0, tid=7),
    x("vectorized_elementwise_kernel", "kernel", 2.0, 3.0, tid=7),  # inside the outer
    x("reduce_kernel", "kernel", 6.0, 2.0, tid=7),  # inside the outer
    x("lanczos_tridiag_kernel", "kernel", 20.0, 5.0, tid=7),
    x("ampere_sgemm_32x32", "kernel", 22.0, 6.0, tid=8),  # another stream, overlapping
    x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 30.0, 1.0, tid=7),
    x("empty_kernel", "kernel", 40.0, 0.0, tid=7),
    x("aten::mm", "cpu_op", 0.0, 100.0, tid=1),  # the host's: not in the device table
    {"ph": "s", "name": "ac2g", "cat": "ac2g", "ts": 0.0, "id": 1},
]


def test_op_self_times_excludes_children_and_sums_categories(tmp_path):
    """Each instant goes to the innermost open op: the outer GEMM keeps
    10 − 3 − 2 µs, the overlapped B1 the 2 µs before the other stream's
    GEMM starts; the self times sum to the union of the intervals, which
    ``device_busy_seconds`` reads from the same trace."""
    got = {name: rec["self_us"] for (name, _), rec in op_self_times(NESTED_TRACE).items()}
    assert got == {"outer_gemm_kernel": 5.0, "vectorized_elementwise_kernel": 3.0,
                   "reduce_kernel": 2.0, "lanczos_tridiag_kernel": 2.0,
                   "ampere_sgemm_32x32": 6.0, "Memcpy DtoD (Device -> Device)": 1.0,
                   "empty_kernel": 0.0}
    rows = {r["category"]: r for r in self_time_table(op_self_times(NESTED_TRACE))}
    assert {c: r["self_ms"] * 1e3 for c, r in rows.items()} == pytest.approx(
        {"GEMM": 11.0, "elementwise": 3.0, "reductions": 2.0, "B1 lanczos_tridiag": 2.0,
         "copies": 1.0, "other": 0.0})
    assert rows["GEMM"]["ops"] == 2 and rows["GEMM"]["kinds"] == 2
    assert sum(r["share"] for r in rows.values()) == pytest.approx(1.0)
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": NESTED_TRACE}))
    assert device_busy_seconds(tmp_path) * 1e6 == pytest.approx(sum(got.values()))
    host = {name: rec["self_us"] for (name, _), rec in
            op_self_times(NESTED_TRACE, ("cpu_op",)).items()}
    assert host == {"aten::mm": 100.0}
    assert [op_category(n) for n in ("void syevj_batch_kernel", "aten::_linalg_eigh",
                                     "lanczos_stream_kernel", "multi_tensor_apply_kernel",
                                     "indexSelectLargeIndex")] == [
        "eigh", "eigh", "B2 lanczos_stream", "optimizer (multi-tensor)",
        "gathers and scatters"]


def test_profile_step_on_the_cpu_prints_the_table(tmp_path, capsys):
    tps = load("torch_profile_step")
    tps.profile = functools.partial(tps.profile, out=tmp_path / "trace", epochs=1,
                                    num_graphs=128, hidden=[16])
    assert tps.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "| op category | self ms | % time | n ops | kinds |" in out
    report = json.loads(out.strip().splitlines()[-1])
    assert report["timeline"] == "host" and report["device_busy_s"] is None
    assert report["steps_per_epoch"] == 2 and np.isfinite(report["loss"])
    rows = {r["category"]: r for r in report["table"]}
    assert rows["GEMM"]["ops"] > 0 and rows["B1 lanczos_tridiag"]["ops"] == 1  # the pack's
    assert report["flops_per_graph"] > 0 and report["graphs_per_s"] > 0
    assert tps.main(["--parse-only", str(tmp_path / "trace" / "trace.json")]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["table"] == report["table"]


# ---------------------------------------------------------------- mem_probe
def narrowed(name: str, tmp_path: Path, **train) -> Path:
    cfg = config_io.loads((REPO / "configs" / f"{name}.yaml").read_text())
    cfg["dataset"]["scale"] = 0.05
    cfg["exp_dir"] = str(tmp_path / "exp")
    cfg["train"].update(train)
    path = tmp_path / f"{name}.yaml"
    path.write_text(config_io.dumps(cfg))
    return path


@pytest.mark.parametrize("name", ["pubmed_sparse_gcn", "pubmed_sparse_lanczos_net"])
def test_mem_probe_on_the_cpu_prints_a_row_per_program(name, tmp_path, capsys, monkeypatch):
    """One train step and one eval forward, each peak above the
    parameters' bytes; with ``--stub-precompute`` the Lanczos recursion
    never runs (LanczosNet's Ritz pairs are zeros of their shape)."""
    import lanczosnet_torch.ops.sparse as sparse

    def entered(*a, **k):
        raise AssertionError("the Lanczos recursion ran")

    monkeypatch.setattr(sparse, "lanczos_tridiag_matvec", entered)
    probe = load("torch_mem_probe")
    assert probe.main(["-c", str(narrowed(name, tmp_path)), "--device", "cpu",
                       "--stub-precompute"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["program"] for r in rows] == ["train_step", "eval"]
    for r in rows:
        assert r["config"] == name and r["device"] == "cpu" and r["stub_precompute"]
        assert r["peak_allocated_bytes"] > r["param_bytes"] > 0
        assert r["source"].startswith("MemTracker")


def test_mem_probe_refuses_a_sharded_config_by_name(tmp_path):
    probe = load("torch_mem_probe")
    path = narrowed("pubmed_sparse_gcn", tmp_path, num_devices=2, shard="nodes")
    with pytest.raises(SystemExit, match="pubmed_sparse_gcn: train.num_devices=2"):
        probe.main(["-c", str(path), "--device", "cpu"])


# ---------------------------------------------------------------- run_all
def jax_sections_and_columns(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith("## ") or line.startswith("| config |")]


def test_run_all_writes_the_jax_files_sections_and_columns(tmp_path, monkeypatch, capsys):
    ra = load("torch_run_all")
    monkeypatch.chdir(tmp_path)  # the run directory: exp/ under the working directory
    res = ra.run_config(REPO / "configs" / "qm8_gcn.yaml", {
        "train.max_epoch": 1, "dataset.num_train": 128, "dataset.num_val": 64,
        "dataset.num_test": 64, "dataset.pack_cache": False, "model.hidden_dim": [16]},
        device="cpu")
    assert len(list((tmp_path / "exp" / "qm8_gcn").iterdir())) == 1
    assert res["exp"] == "qm8_gcn" and np.isfinite(res["best_val_mae"])
    cit = {"exp": "cora_gcn", "best_val_acc": 0.5, "test_acc": 0.25, "wall_s": 1.0}
    old = "# RESULTS\n\n## Long-training flagships\n\nkept\n"
    text = ra.results_markdown([res], [cit], [dict(cit, exp="pubmed_sparse_gcn")], 1,
                               "NVIDIA H100 80GB HBM3, 700.00 W", old)
    jax = (REPO / "RESULTS.md").read_text()
    want = [line for line in jax_sections_and_columns(jax) if "Tensor-parallel" not in line]
    got = jax_sections_and_columns(text)
    assert [g.split(" (")[0] for g in got[:6]] == [w.split(" (")[0] for w in want[:6]]
    assert got[0] == "## QM8-shaped regression (1 epochs, batch 64, 2048/256/256 graphs)"
    assert "| qm8_gcn | " in text and "700.00 W" in text.splitlines()[2]
    assert text.rstrip().endswith("## Long-training flagships\n\nkept")
    # a config needing more ranks than there are devices is skipped, by name
    monkeypatch.setattr(ra.os, "cpu_count", lambda: 2)
    out = tmp_path / "R.md"
    assert ra.main(["--only", "qm8_lanczos_net_tp4", "--device", "cpu", "--out", str(out)]) == 0
    assert "skip qm8_lanczos_net_tp4: needs 4 cores (have 2)" in capsys.readouterr().out
    assert "the CPU (no card)" in out.read_text()


# ---------------------------------------------------------------- QM8 ingest
@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stubs")
    for name, text in (("deepchem", STUB_DEEPCHEM), ("rdkit", STUB_RDKIT)):
        (root / name).mkdir()
        (root / name / "__init__.py").write_text(text)
    return root


def recon(d, v, power):
    return np.einsum("bnk,bk,bmk->bnm", v, d ** power, v)


def test_qm8_ingest_packs_what_the_jax_ingest_packs(stubs, tmp_path, monkeypatch, capsys):
    """Both ingests on the stub molecules (n_max 12, K=4): the port's
    script in a process of its own, the JAX script here."""
    from lanczosnet_tpu.data.dataset import load_packed as jax_load_packed
    from lanczosnet_torch.data.dataset import load_packed

    flags = ["--n-max", "12", "--num-eig-vec", "4"]
    env = dict(os.environ, PYTHONPATH=f"{stubs}{os.pathsep}{REPO}")
    env.pop("FAKE_QM8_UNKNOWN", None)
    proc = run(SCRIPTS / "torch_get_qm8_data.py", "--out", tmp_path / "port", *flags,
               "--device", "cpu", env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "train: 24 molecules" in proc.stdout

    monkeypatch.syspath_prepend(str(stubs))
    monkeypatch.delenv("FAKE_QM8_UNKNOWN", raising=False)
    monkeypatch.setattr(sys, "argv", ["get_qm8_data.py", "--out", str(tmp_path / "jax"), *flags])
    load("get_qm8_data").main()
    assert "train: 24 molecules" in capsys.readouterr().out

    for split in ("train", "val", "test"):
        got = load_packed(tmp_path / "port" / f"{split}.npz")
        want = jax_load_packed(tmp_path / "jax" / f"{split}.npz")
        for f in ("atom_type", "node_feat", "mask", "label"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        np.testing.assert_allclose(got.ops, want.ops, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.stats.mean, want.stats.mean)
        np.testing.assert_array_equal(got.stats.std, want.stats.std)
        for power in (1, 2):
            np.testing.assert_allclose(recon(got.ritz_val, got.ritz_vec, power),
                                       recon(want.ritz_val, want.ritz_vec, power), atol=1e-3)


def test_qm8_ingest_gate_and_missing_packages():
    """The strict gate refuses the molecule the JAX gate refuses (Si and a
    DATIVE bond); aliased, both give the same graph. Without deepchem and
    rdkit the script exits 1 and names them."""
    ns = {}
    exec(STUB_DEEPCHEM, ns)
    mol = ns["_Mol"]([6, 14, 6], [(0, 1, "SINGLE"), (1, 2, "DATIVE")])
    label = np.arange(16.0)
    port, jax_script = load("torch_get_qm8_data"), load("get_qm8_data")
    for mod in (port, jax_script):
        with pytest.raises(ValueError, match="unexpected atomic numbers \\[14\\]"):
            mod.mol_to_graph(mol, label)
    got, want = port.mol_to_graph(mol, label, False), jax_script.mol_to_graph(mol, label, False)
    assert got["_aliased"] == want["_aliased"] == {"atoms": [14], "bonds": ["DATIVE"]}
    for f in ("atom_type", "adj", "label"):
        np.testing.assert_array_equal(got[f], want[f])
        assert got[f].dtype == want[f].dtype
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = run(SCRIPTS / "torch_get_qm8_data.py", "--out", "unused", env=env)
    assert proc.returncode == 1
    assert "deepchem" in proc.stderr and "rdkit" in proc.stderr


# ---------------------------------------------------------------- NaN hunts
def test_fuzz_sharded_ada_on_two_ranks_exits_0():
    proc = run(SCRIPTS / "torch_fuzz_sharded_ada.py", "2", "--ranks", "2", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RESULT: 4 draws on 2 ranks (gloo, cpu), 0 non-finite" in proc.stdout


def test_repro_ada_nan_few_iterations_exits_0():
    proc = run(SCRIPTS / "torch_repro_ada_nan.py", "3", "--ranks", "2", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RESULT: 3 iterations on 2 ranks (gloo, cpu), 0 non-finite/wrong-loss hits" \
        in proc.stdout
