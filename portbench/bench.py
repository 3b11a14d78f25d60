"""One run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (``configs/<config>.json``, which names its
reference and count modules) and a traffic mix (``traffic/<mix>.json``,
whose ``kind`` is ``train`` or ``infer``); its limits are
``limits/<workload>.json`` and its per-layer metrics' readers
``metrics/<name>.py`` (``metric_reader``). So a configuration and its
cells are added by new files alone (the configuration's file with the
node count its graph is cut to in the CPU tests, ``cpu_nodes``; a limits
file a cell) and new entries in ``BENCHMARK.json``, the cells' names
appended to the ``workloads`` of the metrics they report.

Set-up (``setup_s``, from the start of ``run.py``): the graph is drawn on
the card from the seed (``graphgen.py``), the peak memory counter is reset,
``SparseCitationRunner`` builds the operator (and the Ritz pairs), the
benchmark's weights (drawn on the card from the seed) are loaded into its
model, then the cell's own step runs: a train cell's first epochs (the
step of ``make_train_step`` and ``accuracy("val")``), whose losses,
first gradient (from Adam's first moment) and parameter change are kept
for the check; an infer cell's first passes. Then the window: epochs or
passes until ``seconds`` have passed, whole ones, each ending on the host.
After it the peak memory is read, the program freed, and the reference
works out the same things from the same graph and weights.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, graphgen, traces
from portbench.readers import Ctx
from portbench.reference import coo, lanczos
from portbench.reference import train as ref_train
from portbench.reference.common import EXACT, Precision, full_float32

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "lanczosnet_tpu")
SPANS = ("launch_a_train_step", "validation_pass", "score_all_nodes", "fetch_predictions")
WINDOW_SPAN = "measured_window"
BETA1 = 0.9  # Adam's, as the configurations leave it


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_file(path: Path, name: str):
    """A module from a file whose name may hold dots (``metrics/a.b.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``(module, kind)`` of the per-layer metric ``name``:
    ``metrics/<name>.py`` where it exists, else ``metrics/<base>.py`` for
    ``<base>.<kind>``, one reader for every kind."""
    path = HERE / "metrics" / f"{name}.py"
    base, _, kind = name.partition(".")
    if not path.is_file():
        path = HERE / "metrics" / f"{base}.py"
    return load_file(path, f"portbench_metric_{name}"), kind or None


def seeds(seed: int) -> dict:
    """The run's seed split into one per purpose."""
    return {k: (4 * int(seed) + i) % 2**63 for i, k in enumerate(
        ("graph", "weights", "dropout", "probes"))}


class Cell:
    """A workload of ``BENCHMARK.json`` and the files it names."""

    def __init__(self, workload: str):
        self.bench = load_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = entries[workload]
        conf = {c["name"]: c for c in self.bench["configs"]}[self.entry["config"]]
        self.config = load_json(ROOT / conf["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.kind = self.traffic["kind"]
        self.limits = load_json(HERE / "limits" / f"{workload}.json")
        self.family = importlib.import_module(f"portbench.reference.{self.config['reference']}")
        self.counts = importlib.import_module(f"portbench.counts.{self.config['reference']}")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in reported else [])]


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Every matrix lecun-normal (``N(0, 1/fan_in)``) from one draw on
    ``device``, every vector (a bias) zero: the models' initialization,
    from the benchmark's seed."""
    gen = torch.Generator(device).manual_seed(int(seed))
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    flat = torch.randn(sum(a * b for a, b in mats.values()), generator=gen, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        if len(s) == 2:
            out[k] = flat[off: off + s[0] * s[1]].view(s) / math.sqrt(s[1])
            off += s[0] * s[1]
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: ``lanczosnet_torch`` is not ``lanczosnet_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def _program_op(runner) -> dict:
    op = runner.op
    return {"row": op.row, "col": op.col, "val": op.val, "col_perm": op.col_perm, "n": op.n}


class Program:
    """The port under test, driven as a user drives it."""

    def __init__(self, cell: Cell, graph: dict, weights: dict, dropout_seed: int,
                 device: torch.device, run_dir: Path):
        from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

        cfg = {k: cell.config[k] for k in ("runner", "dataset", "model", "train")}
        cfg.update(exp_name=cell.name, seed=int(dropout_seed), save_dir=str(run_dir),
                   test={"test_model": None})
        self.runner = SparseCitationRunner(cfg, device, graph=graph)
        self.runner.model.load_state_dict(weights, strict=True)
        self.device = device
        self.step = self.optimizer = None
        self.host_preds = None

    def setup_event(self) -> dict:
        path = Path(self.runner.config["save_dir"]) / "metrics.jsonl"
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            if rec.get("event") == "setup":
                return rec
        return {}

    def make_step(self, train_cfg: dict) -> None:
        from lanczosnet_torch.train.optim import build_optimizer

        self.optimizer, scheduler, clip = build_optimizer(self.runner.model.parameters(),
                                                          train_cfg, 1)
        self.step = self.runner.make_train_step(self.optimizer, scheduler, clip)

    def epoch(self) -> float:
        """One epoch as ``SparseCitationRunner.train`` runs it: the step, its
        loss read on the host, the validation accuracy; → the loss."""
        with record_function("launch_a_train_step"):
            loss = float(self.step())
        with record_function("validation_pass"):
            self.runner.accuracy("val")
        return loss

    def score(self):
        """One scoring pass: every node's eval logits, their argmax, the
        predicted classes copied to the host, into one buffer (pinned on a
        card) that set-up's first pass allocates and every pass reuses."""
        with record_function("score_all_nodes"):
            logits = self.runner.gathered_logits()
            pred = logits.argmax(-1)
        with record_function("fetch_predictions"):
            if self.host_preds is None:
                self.host_preds = torch.empty(pred.shape, dtype=pred.dtype,
                                              pin_memory=self.device.type == "cuda")
            self.host_preds.copy_(pred)
            return logits, self.host_preds

    def first_moment_grads(self) -> dict:
        """The gradient Adam took in its first step, from its first moment."""
        names = {p: k for k, p in self.runner.model.named_parameters()}
        return {names[p]: st["exp_avg"].detach() / (1.0 - BETA1)
                for p, st in self.optimizer.state.items()}

    def params(self) -> dict:
        return {k: p.detach().clone() for k, p in self.runner.model.named_parameters()}


def reference_inputs(graph: dict, device) -> dict:
    n = graph["features"].shape[0]
    row, col, val = coo.sym_operator(torch.from_numpy(graph["edges"]).to(device), n)
    return {"x": torch.from_numpy(graph["features"]).to(device),
            "labels": torch.from_numpy(graph["labels"].astype(np.int64)).to(device),
            "train_mask": torch.from_numpy(graph["train_mask"]).to(device),
            "op": (row, col, val, n), "extras": ()}


def reference_ritz(cell: Cell, inputs: dict, prec: Precision = EXACT, dtype=torch.float64):
    row, col, val, n = inputs["op"]
    return lanczos.ritz_pairs(row, col, val, n, int(cell.config["model"]["num_eig_vec"]),
                              prec=prec, dtype=dtype)


def compare(cell: Cell, graph: dict, weights: dict, out: dict, seed: int, device) -> dict:
    """The check's numbers: the outputs ``out`` (``op``, ``ritz``, and
    ``first`` or ``logits`` and ``preds``) of the program, or of
    ``reference_side`` for the control and a planted fault, against the
    reference."""
    s = seeds(seed)
    with full_float32():
        inputs = reference_inputs(graph, device)
        numbers = check.operator_numbers(out["op"], inputs["op"][:3])
        if cell.family.NEEDS_RITZ:
            ritz = reference_ritz(cell, inputs)
            numbers.update(check.ritz_numbers(out["ritz"], ritz, s["probes"]))
            inputs["extras"] = tuple(t.to(torch.float32) for t in ritz)
        model = cell.config["model"]
        if cell.kind == "train":
            ref = ref_train.first_steps(cell.family, model, cell.config["train"], weights,
                                        inputs, int(cell.traffic["first_steps"]), s["dropout"])
            numbers.update(check.train_numbers(out["first"], ref))
        else:
            ref_logits = ref_train.score(cell.family, model, weights, inputs)
            numbers.update(check.infer_numbers(out["logits"], out["preds"], ref_logits))
    return numbers


def reference_side(cell: Cell, graph: dict, weights: dict, seed: int, device,
                   prec: Precision = EXACT, half_batch: bool = False) -> dict:
    """The reference put in the program's place (``prec``: the control) or
    with a fault planted (``half_batch``): the outputs ``compare`` judges."""
    s = seeds(seed)
    with full_float32():
        inputs = reference_inputs(graph, device)
        if prec is not EXACT:
            row, col, val, n = inputs["op"]
            inputs["op"] = (row, col, prec.store(val.to(torch.float32)).to(torch.float64), n)
        row, col, val, n = inputs["op"]
        out = {"op": {"row": row, "col": col, "val": val,
                      "col_perm": torch.argsort(col, stable=True), "n": n}}
        if cell.family.NEEDS_RITZ:
            out["ritz"] = reference_ritz(cell, inputs, prec, torch.float64 if prec is EXACT
                                         else torch.float32)
            inputs["extras"] = tuple(t.to(torch.float32) for t in out["ritz"])
        model = cell.config["model"]
        if cell.kind == "train":
            out["first"] = ref_train.first_steps(cell.family, model, cell.config["train"],
                                                 weights, inputs,
                                                 int(cell.traffic["first_steps"]),
                                                 s["dropout"], prec, half_batch)
        else:
            lg = ref_train.score(cell.family, model, weights, inputs, prec)
            out["logits"], out["preds"] = lg, lg.argmax(-1)
    return out


def draw(cell: Cell, seed: int, device, config_hook: Optional[Callable] = None) -> dict:
    """The graph of ``seed``; ``config_hook`` (tests: a smaller graph) first
    replaces the cell's configuration with what it returns."""
    if config_hook is not None:
        cell.config = config_hook(cell.config)
    d = cell.config["dataset"]
    return graphgen.draw_graph(int(d["num_nodes"]), int(d["num_class"]), int(d["feat_dim"]),
                               float(d["avg_degree"]), seeds(seed)["graph"], device)


def cell_weights(cell: Cell, graph: dict, seed: int, device) -> dict:
    """The weights of ``seed`` for the cell's model on ``graph``."""
    shapes = cell.family.param_shapes(cell.config["model"], graph["features"].shape[1],
                                      int(graph["num_class"]))
    return make_weights(shapes, seeds(seed)["weights"], device)


def build_program(cell: Cell, graph: dict, seed: int, device, run_dir: Path):
    """The program built on ``graph`` with the benchmark's weights →
    ``(program, weights, out)``; ``out`` gathers what the check compares."""
    weights = cell_weights(cell, graph, seed, device)
    with record_function("runner_setup"):
        prog = Program(cell, graph, weights, seeds(seed)["dropout"], device, run_dir)
    out = {"op": _program_op(prog.runner)}
    if cell.family.NEEDS_RITZ:
        out["ritz"] = prog.runner.extras
    return prog, weights, out


def drive_first(cell: Cell, prog: Program, weights: dict, out: dict) -> None:
    """The cell's first units, in set-up: a train cell's first epochs, whose
    losses, first gradient and parameter change go into ``out``; an
    infer cell's first passes, the last of which goes into ``out``."""
    if cell.kind == "train":
        prog.make_step(cell.config["train"])
        losses, grads = [], None
        for i in range(int(cell.traffic["first_steps"])):
            losses.append(prog.epoch())
            if i == 0:
                grads = {k: g.clone() for k, g in prog.first_moment_grads().items()}
        change = {k: p - weights[k] for k, p in prog.params().items()}
        out["first"] = {"losses": losses, "grad_opt": grads, "change": change}
    else:
        for _ in range(int(cell.traffic["warm_passes"])):
            out["logits"], out["preds"] = prog.score()
    sync(prog.device)


def window(prog: Program, kind: str, seconds: float):
    """Whole units until ``seconds`` have passed → (units, seconds, failed,
    the last pass's logits and predictions)."""
    units = failed = 0
    last = None
    t0 = time.perf_counter()
    with record_function(WINDOW_SPAN):
        while True:
            if kind == "train":
                failed += not math.isfinite(prog.epoch())
            else:
                last = prog.score()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
    return units, time.perf_counter() - t0, failed, last


def _device_info(device: torch.device, peak: int) -> dict:
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": 1, "memory_peak_bytes": int(peak)}


def _traced(cell: Cell, prof, path: Path, ctx: Ctx, device_info: dict):
    """The per-layer metrics and the breakdown of a traced window."""
    prof.export_chrome_trace(str(path))
    events = traces.load_trace(path)
    path.unlink()
    t0, t1 = traces.window(events, WINDOW_SPAN)
    busy = breakdown = None
    if device_info["platform"] == "gpu":
        ctx.events, ctx.t0, ctx.t1 = events, t0, t1
        busy = ctx.busy_s()
        breakdown = {"device_ops": traces.top_device_ops(events, t0, t1),
                     "idle_gaps": traces.idle_gaps(events, t0, t1, SPANS)}
    device_info.update(busy_s=busy, window_s=(t1 - t0) / 1e6)
    metrics = {}
    for m in cell.per_layer():
        reader, kind = metric_reader(m["name"])
        value = reader.read(ctx, kind)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, breakdown


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, config_hook: Optional[Callable] = None
             ) -> tuple[dict, dict, dict]:
    """One run → (the result line's object, the check's table, the seconds
    of set-up's stages and of the check)."""
    device = torch.device(device)
    cell = Cell(workload)
    run_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        stages = {"imports_s": time.perf_counter() - t_start}
        t = time.perf_counter()
        with record_function("draw_the_graph"):
            graph = draw(cell, seed, device, config_hook)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        stages["draw_s"] = time.perf_counter() - t
        t = time.perf_counter()
        prog, weights, out = build_program(cell, graph, seed, device, run_dir)
        stages["runner_s"] = time.perf_counter() - t
        t = time.perf_counter()
        drive_first(cell, prog, weights, out)
        stages["first_units_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts) if trace else contextlib.nullcontext()
        with prof:
            units, elapsed, failed, last = window(prog, cell.kind, seconds)
            sync(device)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        device_info = _device_info(device, peak)
        if cell.kind == "infer":
            out["logits"], out["preds"] = last
        breakdown = None
        if not trace:
            values = {"train_epoch_ms" if cell.kind == "train" else "infer_pass_ms":
                      elapsed / units * 1e3, "setup_s": setup_s}
            if device.type == "cuda":
                values["peak_mem_gib"] = peak / 2**30
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end() if m["name"] in values}
        else:
            shape = (cell.config["model"], prog.runner.op.n, prog.runner.op.num_edges,
                     graph["features"].shape[1], int(graph["num_class"]))
            if cell.kind == "train":
                counts = cell.counts.epoch(*shape,
                                           remat=cell.config["train"].get("remat") == "layers")
            else:
                counts = cell.counts.infer_pass(*shape)
            ctx = Ctx(kind=cell.kind, setup=prog.setup_event(), counts=counts,
                      units=units, window_s=elapsed, spectral=cell.family.NEEDS_RITZ)
            metrics, breakdown = _traced(cell, prof, run_dir / "trace.json", ctx, device_info)
            del ctx

        del prog, last
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        numbers = compare(cell, graph, weights, out, seed, device)
        stages["check_s"] = time.perf_counter() - t
        correct, table = check.judge(numbers, cell.limits)
        line = {"correct": bool(correct and failed == 0), "attempted": units, "failed": failed,
                "metrics": metrics, "device": device_info}
        if breakdown is not None:
            line["breakdown"] = breakdown
        line["checks"] = table
        return line, table, stages
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
