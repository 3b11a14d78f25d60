"""The check can fail: at a size the CPU holds, the control (the reference
put in the program's place one precision lower) and a run of the harness
with the timed path broken underneath each come out not correct under
the cells' own limits."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import shrink
from portbench import bench, check
from portbench.reference.common import CONTROL

WORKLOADS = ["ten_million_sparse_lanczos_net-train", "million_sparse_gcn_wide-train",
             "ten_million_sparse_lanczos_net-infer"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    cell = bench.Cell(workload)
    for seed in (21, 22, 23):
        g = bench.draw(cell, seed, "cpu", shrink)
        weights = bench.cell_weights(cell, g, seed, "cpu")
        out = bench.reference_side(cell, g, weights, seed, torch.device("cpu"), CONTROL)
        numbers = bench.compare(cell, g, weights, out, seed, torch.device("cpu"))
        correct, table = check.judge(numbers, cell.limits)
        assert not correct, table


def _run(workload):
    line, table, _ = bench.run_cell(workload, 31, 0.2, False, "cpu", time.perf_counter(),
                                    shrink)
    return line


def test_a_sound_run_is_correct():
    for w in WORKLOADS:
        assert _run(w)["correct"] is True


@pytest.mark.parametrize("workload", WORKLOADS[:2])
def test_a_step_that_leaves_the_state_unchanged(monkeypatch, workload):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line = _run(workload)
    assert line["correct"] is False and line["checks"]["change_norm_gap"]["value"] >= 0.99


@pytest.mark.parametrize("workload", WORKLOADS[:2])
def test_half_of_the_batch_left_out(monkeypatch, workload):
    from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

    loss = SparseCitationRunner.loss

    def half(self, logits, split="train"):
        if split == "train" and not getattr(self, "_halved", False):
            m = self.splits["train"]
            idx = torch.nonzero(m).flatten()
            m = m.clone()
            m[idx[len(idx) // 2:]] = 0.0
            self.splits = {**self.splits, "train": m}
            self.split_count = {**self.split_count, "train": float(m.sum())}
            self._halved = True
        return loss(self, logits, split)

    monkeypatch.setattr(SparseCitationRunner, "loss", half)
    assert _run(workload)["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

    logits = SparseCitationRunner.gathered_logits

    def altered(self):
        out = logits(self).clone()
        out[7] = out[7].flip(0)  # one node's scores, classes reversed
        return out

    monkeypatch.setattr(SparseCitationRunner, "gathered_logits", altered)
    assert _run("ten_million_sparse_lanczos_net-infer")["correct"] is False


def test_half_of_the_nodes_left_unscored(monkeypatch):
    from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

    logits = SparseCitationRunner.gathered_logits

    def half(self):
        out = logits(self).clone()
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(SparseCitationRunner, "gathered_logits", half)
    assert _run("ten_million_sparse_lanczos_net-infer")["correct"] is False


def test_the_readings_script_at_a_small_size():
    """``readings.py`` gives one line a side and seed, every number the
    cell's limits name among them, the control's failing them."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    res = subprocess.run([sys.executable, "portbench/readings.py", "--config",
                          "million_sparse_gcn_wide", "--seeds", "3", "--control-seeds", "3",
                          "--device", "cpu", "--nodes", "1000"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = {r["side"]: r for r in map(json.loads, res.stdout.splitlines())}
    assert set(rows) == {"program", "control", "half_batch"}
    limits = bench.Cell("million_sparse_gcn_wide-train").limits
    assert check.judge(rows["program"], limits)[0]
    assert not check.judge(rows["control"], limits)[0]
    assert not check.judge(rows["half_batch"], limits)[0]
