"""The harness on the CPU: each cell at a tiny size gives a last line of
the contract's shape, ``BENCHMARK.json`` agrees with the files it names,
and the command refuses to run without the card."""

from __future__ import annotations

import filecmp
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from conftest import ROOT
from portbench import bench

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tiny_run_prints_the_contract_s_line(workload, trace, tiny):
    line, table, stages = bench.run_cell(workload, 2**31 + 7, 0.3, bool(trace), "cpu",
                                         time.perf_counter(), tiny)
    line = json.loads(json.dumps(line))  # it is JSON
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = bench.Cell(workload)
    names = {m["name"]: m for m in (cell.per_layer() if trace else cell.end_to_end())}
    assert set(line["metrics"]) <= set(names)
    for name, rec in line["metrics"].items():
        assert rec["unit"] == names[name]["unit"] and rec["value"] > 0
    if not trace:
        # the CPU has no device peak; every other end-to-end metric is there
        assert set(line["metrics"]) == set(names) - {"peak_mem_gib"}
    else:
        assert "window_s" in line["device"] and line["device"]["busy_s"] is None
        assert "operator_s.setup" in line["metrics"]
    assert set(table) == set(cell.limits)
    assert all(rec["value"] <= rec["limit"] for rec in table.values())
    assert set(stages) >= {"draw_s", "runner_s", "first_units_s", "check_s"}


def test_one_reader_file_serves_every_kind_of_a_metric():
    for m in BENCH["per_layer"]:
        reader, kind = bench.metric_reader(m["name"])
        assert kind == m["name"].partition(".")[2]
        assert reader.__file__.endswith(f"/metrics/{m['name'].partition('.')[0]}.py")


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_sparse_ops_carry_the_calls_the_counts_expect(workload, chunked, tiny, monkeypatch):
    """The window's outermost calls of the listed ATen ops are the units
    times ``sparse_calls`` of the family's counts (chunked: the backward
    scatter cut into chunks, as at the cells' real sizes)."""
    from lanczosnet_torch.ops import sparse as port_sparse

    from portbench import counts, traces

    if chunked:
        monkeypatch.setattr(port_sparse, "_BWD_CHUNK_ENGAGE", 4096)
        monkeypatch.setattr(port_sparse, "_BWD_CHUNK_TARGET", 1500)
        monkeypatch.setattr(counts, "CHUNK_ENGAGE", 4096)
        monkeypatch.setattr(counts, "CHUNK_TARGET", 1500)
    seen = {}
    load, traced = traces.load_trace, bench._traced
    monkeypatch.setattr(traces, "load_trace", lambda p: seen.setdefault("events", load(p)))

    def keep_ctx(cell, prof, path, ctx, info):
        seen["ctx"] = ctx
        return traced(cell, prof, path, ctx, info)

    monkeypatch.setattr(bench, "_traced", keep_ctx)
    line, _, _ = bench.run_cell(workload, 2**31 + 11, 0.3, True, "cpu", time.perf_counter(),
                                tiny)
    assert line["correct"] is True
    ctx, events = seen["ctx"], seen["events"]
    ops = ("aten::index_select", "aten::index_add_", "aten::index_add")
    t0, t1 = traces.window(events, bench.WINDOW_SPAN)
    calls = traces.outermost_calls(events, ops, t0, t1)
    per_unit = ctx.counts["sparse_calls"]
    assert calls == {op: ctx.units * per_unit[op] for op in ops}
    if chunked and bench.Cell(workload).kind == "train":
        assert per_unit["aten::index_add_"] > 2  # more than one chunk a backward product


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[part]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
        cell = bench.Cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end()}
        assert len(cell.end_to_end()) >= 2 and cell.per_layer()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES and m["moves"] in e2e
        reader, kind = bench.metric_reader(m["name"])
        assert (reader.SOURCE, reader.LAYER, reader.MOVES[kind]) == (m["source"], m["layer"],
                                                                     m["moves"])
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in bench.Cell(w).end_to_end()}


def test_every_cell_s_limits_are_the_numbers_it_compares(tiny):
    for w in WORKLOADS:
        cell = bench.Cell(w)
        want = {"op_index_mismatch", "op_val_gap"}
        if cell.family.NEEDS_RITZ:
            want |= {"ritz_val_gap", "ritz_proj_gap"}
        if cell.kind == "train":
            want |= {"loss_gap", "grad_norm_gap", "change_norm_gap"}
        else:
            want |= {"logits_gap", "logits_max_gap", "pred_margin_gap"}
        # the median leaf's change beside the worst leaf's, where that one is noisy
        assert set(cell.limits) - {"change_median_gap"} == want
        assert cell.limits["op_index_mismatch"] == 0


def test_the_command_exits_2_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_a_checkout_of_the_benchmark_alone_cannot_run(tmp_path, tiny):
    """Without the program beside it, a run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); sys.path.insert(0, 'portbench/tests');"
            "from conftest import shrink; from portbench.bench import run_cell;"
            f"print(run_cell({WORKLOADS[0]!r}, 1, 0.1, False, 'cpu', time.perf_counter(),"
            " shrink))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "lanczosnet_torch" in res.stderr


def _files(root):
    return {p.relative_to(root) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_configuration_and_a_cell_are_added_by_new_files_alone(tmp_path):
    """A configuration and its cell added as a later change adds them: a
    configuration file (with its ``cpu_nodes``) and a limits file under
    ``portbench/``, and in ``BENCHMARK.json`` new ``configs`` and
    ``workloads`` entries and the cell's name appended to each metric that
    lists the cell it is copied from. The copy runs the new cell on the
    CPU, untraced and traced, correct, and no file it had before changed."""
    src, new = "ten_million_sparse_lanczos_net", "added_sparse_lanczos_net"
    src_cell, cell = f"{src}-train", f"{new}-train"
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{src}.json").read_text())
    cfg.update(name=new, cpu_nodes=2500)
    (tmp_path / "portbench" / "configs" / f"{new}.json").write_text(json.dumps(cfg, indent=2))
    shutil.copy(ROOT / "portbench" / "limits" / f"{src_cell}.json",
                tmp_path / "portbench" / "limits" / f"{cell}.json")
    spec = json.loads(json.dumps(BENCH))
    conf = dict(next(c for c in spec["configs"] if c["name"] == src))
    spec["configs"].append({**conf, "name": new, "file": f"portbench/configs/{new}.json"})
    work = next(w for w in spec["workloads"] if w["name"] == src_cell)
    spec["workloads"].append({**work, "name": cell, "config": new})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if src_cell in m.get("workloads", []):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    # the copy's harness first on the path, the program from the repository behind it
    code = ("import json, sys, time;"
            f"sys.path[:0] = ['.', 'portbench/tests']; sys.path.append({str(ROOT)!r});"
            "from conftest import shrink; from portbench import bench;"
            "print(bench.__file__);"
            f"c = bench.Cell({cell!r});"
            "print(json.dumps([m['name'] for m in c.end_to_end() + c.per_layer()]));"
            "[print(json.dumps(bench.run_cell(c.name, 2**31 + 13, 0.3, trace, 'cpu',"
            " time.perf_counter(), shrink)[0])) for trace in (False, True)]")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    where, names, untraced, traced = res.stdout.strip().splitlines()[-4:]
    assert where.startswith(str(tmp_path / "portbench"))
    names = json.loads(names)
    src_names = [m["name"] for m in bench.Cell(src_cell).end_to_end()
                 + bench.Cell(src_cell).per_layer()]
    assert names == src_names
    untraced, traced = json.loads(untraced), json.loads(traced)
    assert untraced["correct"] is True and traced["correct"] is True, traced["checks"]
    assert set(untraced["metrics"]) == {"train_epoch_ms", "setup_s"}
    assert {"operator_s.setup", "ritz_s.setup", "mfu_pct.train"} <= set(traced["metrics"])
    assert set(traced["checks"]) == set(bench.Cell(src_cell).limits)

    assert _files(tmp_path / "portbench") - _files(ROOT / "portbench") == {
        Path("configs") / f"{new}.json", Path("limits") / f"{cell}.json"}
    for rel in _files(ROOT / "portbench"):
        assert filecmp.cmp(ROOT / "portbench" / rel, tmp_path / "portbench" / rel,
                           shallow=False), rel


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in WORKLOADS:
        line, _, _ = bench.run_cell(w, 12345, 1.0, True, "cuda", time.perf_counter(), tiny)
        assert line["correct"] is True, line["checks"]
        assert line["device"]["busy_s"] > 0 and line["device"]["platform"] == "gpu"
