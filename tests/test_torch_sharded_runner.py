"""``SparseCitationRunner`` sharded over two ranks, end to end, on the CPU.

For each form (``edges``, ``nodes``, ``nodes_ring``) two ranks
(``parallel/multihost.py:launch``, gloo, a ``FileStore`` under
``tmp_path``; ``tests/torch_rank_workers.py:runner_cycle``) train a
narrow config as ``cli.run`` does in each rank, test it with ``-t``,
train on from its latest snapshot, and build it once more with a
``num_devices`` that is not the group's size. Rank 0 writes its
checkpoints half a second late. Checked: the loss falls; ``-t`` gives
the run's test accuracy exactly; the resumed run goes on from the
snapshot's epoch; only rank 0 wrote under ``checkpoints/``; rank 1 read
``best`` only after rank 0 had written it last (the barrier); the wrong
size raises. Then the CLI itself: ``python -m lanczosnet_torch.cli`` of a
two-rank config starts its ranks, and under a ``torchrun``-style
environment each rank joins the group and rank 0 mints the run
directory.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

import torch_rank_workers as workers
from lanczosnet_torch import cli
from lanczosnet_torch.parallel import multihost
from lanczosnet_torch.utils.config import dumps

TESTS = str(Path(__file__).resolve().parent)
REPO = Path(__file__).resolve().parents[1]
MODES = ("edges", "nodes", "nodes_ring")


def config(exp_dir, mode: str, max_epoch: int = 4, **train) -> dict:
    return {
        "exp_name": f"sharded_{mode}", "exp_dir": str(exp_dir), "runner": "SparseCitationRunner",
        "seed": 11,
        "dataset": {"source": "synthetic_edges", "num_nodes": 301, "num_class": 4,
                    "feat_dim": 12, "avg_degree": 4.0},
        "model": {"name": "GCN", "hidden_dim": [16, 16], "dropout": 0.5},
        "train": {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4, "max_epoch": max_epoch,
                  "patience": 40, "display_iter": 1, "snapshot_epoch": 2, "num_devices": 2,
                  "shard": mode, **train},
        "test": {"test_model": None},
    }


def events(path: Path, event: str) -> list[dict]:
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["event"] == event]


@pytest.fixture(scope="module", params=MODES)
def cycle(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    cfg = {**config(tmp, request.param), "save_dir": str(tmp / "run"), "run_id": "r",
           "is_test": False}
    (tmp / "run").mkdir()
    (tmp / "config.yaml").write_text(dumps(cfg))
    out = tmp / "out"
    out.mkdir()
    code = multihost.launch(2, "torch_rank_workers:runner_cycle",
                            [str(tmp / "config.yaml"), str(out)], device="cpu", store_dir=tmp,
                            threads=1, pythonpath=[TESTS], timeout=300)
    assert code == 0
    return tmp / "run", workers.read_ranks(out, 2)


def test_the_sharded_run_trains_tests_and_resumes(cycle):
    run, ranks = cycle
    for res in ranks:
        assert res["codes"]["train"] == res["codes"]["test"] == res["codes"]["resume"] == 0
    train = events(run / "metrics.jsonl", "train")
    losses = [r["loss"] for r in train[:4]]
    assert [r["epoch"] for r in train] == [0, 1, 2, 3, 4, 5]  # then resumed at epoch 4
    assert losses[-1] < losses[0]
    tests = events(run / "metrics.jsonl", "test")
    assert tests[1]["acc"] == tests[0]["acc"]  # -t on the best checkpoint
    # rank 1 logged the same run, to its own files
    assert [r["loss"] for r in events(run / "metrics.rank1.jsonl", "train")] == [
        r["loss"] for r in train]
    assert (run / "run.rank1.log").exists()
    (setup0, *_), (setup1, *_) = (events(run / f, "setup")
                                  for f in ("metrics.jsonl", "metrics.rank1.jsonl"))
    assert (setup0["rank"], setup1["rank"]) == (0, 1)
    assert setup0["backend"] == setup1["backend"] == "gloo"
    assert setup0["device"] == setup1["device"] == "cpu" and setup0["world_size"] == 2


def test_only_rank_0_writes_checkpoints_and_rank_1_reads_after_it(cycle):
    run, (rank0, rank1) = cycle
    ckpt = str(run / "checkpoints")
    assert any(path.startswith(ckpt) for path, _ in rank0["writes"])
    assert not any(path.startswith(ckpt) for path, _ in rank1["writes"])
    # rank 1's first read (the train run's restore of best) came after
    # rank 0's last write of best in that run, though rank 0 writes late
    last_write = max(t for path, t in rank0["writes"]
                     if path.endswith("best.tmp") and t <= rank0["codes"]["train_end"])
    path, first_read = rank1["reads"][0]
    assert path.endswith("best.pt") and first_read >= last_write


def test_a_group_of_another_size_raises(cycle):
    _, ranks = cycle
    for res in ranks:
        assert "train.num_devices=3, but the process group has 2 ranks" in \
            res["codes"]["wrong_size"]


def test_the_cli_starts_the_ranks_itself(tmp_path):
    path = tmp_path / "ring.yaml"
    path.write_text(dumps(config(tmp_path / "exp", "nodes_ring", max_epoch=2)))
    assert cli.main(["-c", str(path), "--device", "cpu"]) == 0
    (run,) = (tmp_path / "exp").glob("sharded_nodes_ring/*_train")
    assert (run / "metrics.rank1.jsonl").exists()
    assert len(events(run / "metrics.jsonl", "train")) == 2
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "best.meta.json", "best.pt", "latest.meta.json", "latest.pt"]
    assert "2 ranks exited 0" in (run / "run.log").read_text()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_under_torchrun_each_rank_joins_and_rank_0_names_the_run(tmp_path):
    path = tmp_path / "edges.yaml"
    path.write_text(dumps(config(tmp_path / "exp", "edges", max_epoch=2)))
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-m", "lanczosnet_torch.cli", "-c", str(path),
                               "--device", "cpu"], cwd=tmp_path,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(2)]
    try:
        assert [p.wait(timeout=120) for p in procs] == [0, 0]
    finally:
        for p in procs:
            p.kill()
    (run,) = (tmp_path / "exp").glob("sharded_edges/*_train")
    assert (run / "metrics.rank1.jsonl").exists() and (run / "checkpoints" / "best.pt").exists()
