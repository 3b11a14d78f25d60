"""What the ranks of the sharded tests run: torch and the port only.

``parallel/multihost.py:launch`` starts each rank as a fresh process
that imports this module (the tests put this directory on the ranks'
``PYTHONPATH``) and calls one function here; the function writes what
it found to ``out_dir/rank<r>.pt`` and the test reads it. Nothing here
imports JAX.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from lanczosnet_torch import cli
from lanczosnet_torch.parallel import multihost
from lanczosnet_torch.parallel.comm import all_gather_rows, pmax, psum, ring_hop


def draw(tag: int, rank: int, shape) -> torch.Tensor:
    """Integer-valued float32 (so that every sum is exact in any order)."""
    g = torch.Generator().manual_seed(1000 * tag + rank)
    return torch.randint(-8, 9, tuple(shape), generator=g).to(torch.float32)


def comm_checks(out_dir: str, device: str) -> int:
    """Each collective and its backward on this rank's seeded inputs."""
    comm = multihost.world().comm
    r, d = comm.rank, comm.size
    dev = torch.device(device)
    out = {}

    def leaf(tag, shape):
        return draw(tag, r, shape).to(dev).requires_grad_()

    x = leaf(1, (3, 4))
    y = psum(x, comm)
    y.backward(draw(2, r, (3, 4)).to(dev))
    out["psum"] = (y, x.grad)
    out["pmax"] = pmax(draw(3, r, (5,)).to(dev), comm)
    x = leaf(4, (2, 3))
    y = all_gather_rows(x, comm)
    y.backward(draw(5, r, (2 * d, 3)).to(dev))
    out["all_gather_rows"] = (y, x.grad)
    x = leaf(6, (4, 2))
    y = ring_hop(x, comm)
    y.backward(draw(7, r, (4, 2)).to(dev))
    out["ring_hop"] = (y, x.grad)
    out["all_reduce_flat"] = tuple(comm.all_reduce_flat([draw(8, r, (3,)).to(dev),
                                                         draw(9, r, (2, 2)).to(dev)]))
    out["gather_int"] = comm.all_gather(torch.arange(3, dtype=torch.int32, device=dev) + 10 * r)
    out = {k: tuple(t.detach().cpu() for t in v) if isinstance(v, tuple) else v.detach().cpu()
           for k, v in out.items()}
    out["stats"] = comm.stats.as_dict()
    out["staged"] = {c: comm.stages(c, x) for c in ("all_reduce", "broadcast", "all_gather",
                                                     "reduce_scatter", "ring_hop")}
    out["world"] = multihost.world().describe()
    torch.save(out, Path(out_dir) / f"rank{r}.pt")
    return 0


def fail_on_rank_1() -> int:
    """Rank 1 raises; rank 0 waits for it in a barrier."""
    comm = multihost.world().comm
    if comm.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    comm.barrier()
    return 0


def _runner(spec: dict, name: str, mode: str, save_dir: Path):
    from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

    graph = spec["graph"] if multihost.world().rank == 0 else None
    cfg = {"seed": 5, "save_dir": str(save_dir), "dataset": {"name": "spec"},
           "model": spec["models"][name],
           "train": {"optimizer": "Adam", "lr": 1e-2, "wd": 5e-4,
                     "num_devices": multihost.world().size, "shard": mode}}
    runner = SparseCitationRunner(cfg, "cpu", graph=graph)
    runner.model.load_state_dict(spec["weights"][name])
    return runner


def model_checks(spec_path: str, out_dir: str) -> int:
    """Every model of the spec in every mode: the whole graph's eval
    logits, one step's summed gradients (SGD at lr 0), the parameters
    after two Adam steps; LanczosNet's Ritz pairs, GPNN's partition."""
    spec = torch.load(spec_path, weights_only=False)
    world = multihost.world()
    out = {}
    for name in spec["models"]:
        for mode in spec["modes"]:
            runner = _runner(spec, name, mode, Path(out_dir) / f"{name}_{mode}")
            res = {"logits": runner.gathered_logits()}
            sgd = torch.optim.SGD(runner.model.parameters(), lr=0.0)
            res["loss"] = float(runner.make_train_step(sgd)())
            res["grads"] = {k: p.grad.clone() for k, p in runner.model.named_parameters()}
            adam = torch.optim.Adam(runner.model.parameters(), lr=1e-2, weight_decay=5e-4)
            step = runner.make_train_step(adam)
            step()
            step()
            res["params"] = {k: v.clone() for k, v in runner.model.state_dict().items()}
            if name == "LanczosNet":
                vals, vecs = runner.extras
                if runner.node_sharded:
                    vecs = runner.comm.all_gather(vecs)
                res["ritz"] = (vals, vecs[: runner.op.n_true] if runner.node_sharded else vecs)
            if name == "GPNN":
                (part,) = runner.extras
                if runner.node_sharded:
                    part = runner.comm.all_gather(part)[: runner.op.n_true]
                res["part"] = part
            out[(name, mode)] = res
    torch.save(out, Path(out_dir) / f"rank{world.rank}.pt")
    return 0


def _record_writes(log: list):
    """Wrap ``torch.save`` so that each call records (path, time)."""
    save = torch.save

    def recorded(obj, path, *a, **k):
        save(obj, path, *a, **k)
        log.append((str(path), time.time()))

    torch.save = recorded


def runner_cycle(config_path: str, out_dir: str) -> int:
    """Train the config, ``-t`` it, train on from its latest snapshot, as
    ``cli.run`` does in each rank, on the CPU; then build it once more
    with a ``num_devices`` that is not the group's size. Rank 0 writes
    its checkpoints slowly (0.5 s a file), and the times each rank
    wrote and read are recorded."""
    from lanczosnet_torch.train import checkpoint
    from lanczosnet_torch.train.runner import build_runner
    from lanczosnet_torch.utils.config import AttrDict, loads

    world = multihost.world()
    writes, reads = [], []
    _record_writes(writes)
    restore = checkpoint.Checkpointer.restore_file

    def timed_restore(path, *a, **k):
        reads.append((str(path), time.time()))
        return restore(path, *a, **k)

    checkpoint.Checkpointer.restore_file = staticmethod(timed_restore)
    if world.rank == 0:
        save = checkpoint.Checkpointer.save

        def slow_save(self, *a, **k):
            time.sleep(0.5)
            return save(self, *a, **k)

        checkpoint.Checkpointer.save = slow_save
    base = AttrDict.convert(loads(Path(config_path).read_text()))
    codes = {"train": cli.run(base, False, "INFO", "cpu"), "train_end": time.time()}
    best = str(Path(base.save_dir) / "checkpoints" / "best.pt")
    tested = AttrDict.convert({**base, "test": {"test_model": best}})
    codes["test"] = cli.run(tested, True, "INFO", "cpu")
    resumed = AttrDict.convert({**base, "train": {**base.train, "is_resume": True,
                                                  "max_epoch": base.train.max_epoch + 2}})
    codes["resume"] = cli.run(resumed, False, "INFO", "cpu")
    wrong = AttrDict.convert({**base, "train": {**base.train, "num_devices": world.size + 1}})
    try:
        build_runner(wrong, "cpu")
        codes["wrong_size"] = "built"
    except RuntimeError as e:
        codes["wrong_size"] = str(e)
    torch.save({"codes": codes, "writes": writes, "reads": reads},
               Path(out_dir) / f"rank{world.rank}.pt")
    return 0


def build_configs(spec_path: str, out_dir: str) -> int:
    """Build each config of the spec (a list of configs) with this
    group's ranks, on the CPU, and record what each rank holds."""
    from lanczosnet_torch.train.runner import build_runner

    world = multihost.world()
    out = {}
    for cfg in json.loads(Path(spec_path).read_text()):
        runner = build_runner(cfg, "cpu")
        op = runner.op
        out[cfg["exp_name"]] = {
            "kind": type(op).__name__, "rows": int(runner.x.shape[0]), "n": op.n,
            "edges": op.num_edges, "dtype": str(runner.model.dtype),
            "loss": float(runner.make_train_step(torch.optim.SGD(
                runner.model.parameters(), lr=0.0))()),
            "ritz_val": (runner.extras[0].tolist() if runner.extras else None),
            "world": world.describe(), "shard": runner.shard,
        }
    torch.save(out, Path(out_dir) / f"rank{world.rank}.pt")
    return 0


def read_ranks(out_dir, world: int) -> list[dict]:
    """What each rank wrote."""
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def as_numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def ring_memory(out_dir: str, num_nodes: int) -> int:
    """One training step of a GCN on the card in the node and ring forms:
    this rank's peak device memory in each."""
    from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

    world = multihost.world()
    out = {}
    for mode in ("nodes", "nodes_ring"):
        cfg = {"seed": 1, "save_dir": str(Path(out_dir) / mode),
               "dataset": {"source": "synthetic_edges", "num_nodes": num_nodes,
                           "num_class": 10, "feat_dim": 64, "avg_degree": 5.0},
               "model": {"name": "GCN", "hidden_dim": [64, 64]},
               "train": {"num_devices": world.size, "shard": mode}}
        runner = SparseCitationRunner(cfg)
        step = runner.make_train_step(torch.optim.Adam(runner.model.parameters()))
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[mode] = {"loss": float(step()), "resident_mb": base / 2**20,
                     "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
                     "device": str(runner.device), "backend": world.backend,
                     "ranks_per_card": world.ranks_per_card,
                     "staged_bytes": runner.comm.stats.staged_bytes}
        del runner, step
        torch.cuda.empty_cache()
    torch.save(out, Path(out_dir) / f"rank{world.rank}.pt")
    return 0


# ---------------------------------------------------------------- the QM8 mesh
def _mesh_parts(layout):
    """(d, dp, dp_comm) of a layout; one device where None."""
    return (0, 1, None) if layout is None else (layout.d, layout.dp, layout.dp_comm)


def _batch_rows(arrays: dict, rows: slice, device):
    """A ``GraphBatch`` of ``rows`` of the numpy ``arrays`` on ``device``."""
    from lanczosnet_torch.core.graph_batch import GraphBatch

    return GraphBatch(**{k: None if v is None else torch.from_numpy(np.array(v[rows])).to(device)
                         for k, v in arrays.items()})


def train_case(case: dict, layout=None) -> dict:
    """A case's steps (``model``, ``weights``, ``batch`` arrays, ``valid``,
    ``train``, ``steps``, dropout ``seed``; ``device``, the CPU where not
    named) on this rank's block of the batch and of the model, or on one
    device where ``layout`` is None:
    the losses, the parameters and gradients made whole, the replicated
    leaves as this rank holds them, the state bytes measured and
    predicted."""
    from lanczosnet_torch.models import build_model
    from lanczosnet_torch.models.base import set_dropout_generator
    from lanczosnet_torch.parallel import mesh
    from lanczosnet_torch.parallel.tensor import (
        TensorParallel,
        measured_state_bytes,
        predicted_state_bytes,
        state_plan,
    )
    from lanczosnet_torch.train.optim import build_optimizer
    from lanczosnet_torch.train.step import make_train_step

    d, dp, dp_comm = _mesh_parts(layout)
    tp = 1 if layout is None else layout.tp
    dev = torch.device(case.get("device", "cpu"))
    model = build_model(case["model"])
    model.load_state_dict(case["weights"], strict=True)
    model.to(dev)
    plan = state_plan(model, tp)
    parallel = TensorParallel(model, layout.tp_comm) if tp > 1 else None
    params = list(model.parameters()) if parallel is None else parallel.parameters()
    set_dropout_generator(model, torch.Generator(dev).manual_seed(case["seed"]), rows=(d, dp))
    optimizer, scheduler, clip = build_optimizer(params, case["train"], 1)
    step = make_train_step(model, optimizer, scheduler, clip, dp_comm, parallel)
    rows = mesh.batch_rows(len(case["valid"]), dp, d)
    batch = _batch_rows(case["batch"], rows, dev)
    valid = torch.from_numpy(case["valid"][rows]).to(dev)
    count = float(case["valid"].sum())
    losses = [float(step(batch, valid, count)) for _ in range(case["steps"])]
    grads = [p.grad for p in params]
    out = {"losses": losses,
           "state_bytes": measured_state_bytes(params, optimizer),
           "predicted_state_bytes": predicted_state_bytes(plan, tp)}
    if parallel is None:
        names = [n for n, _ in model.named_parameters()]
        out["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["grads"] = dict(zip(names, grads))
    else:
        out["params"] = parallel.full_state_dict()
        out["grads"] = parallel.full(grads)
        out["replicated"] = {leaf.name: p.detach().clone()
                             for leaf, p in zip(parallel.plan, params) if leaf.axis is None}
        out["cut"] = sorted(leaf.name for leaf in parallel.plan if leaf.axis is not None)
    return out


def resident_case(case: dict, layout=None) -> dict:
    """Resident epochs with the device shuffle (``epochs``, batch
    ``batch_size``) over a packed ``split``, then the resident
    validation sums, on this rank's block of each batch or on one
    device: the losses, the parameters, the sums and the count."""
    from lanczosnet_torch.models import build_model
    from lanczosnet_torch.models.base import set_dropout_generator
    from lanczosnet_torch.parallel import mesh
    from lanczosnet_torch.train.optim import build_optimizer
    from lanczosnet_torch.train.scan_epoch import (
        ResidentEval,
        device_dataset,
        device_permutation,
        train_epoch,
    )
    from lanczosnet_torch.train.step import make_eval_step, make_train_step

    d, dp, dp_comm = _mesh_parts(layout)
    cpu = torch.device("cpu")
    bs = case["batch_size"]
    rows = mesh.batch_rows(bs, dp, d)
    model = build_model(case["model"])
    model.load_state_dict(case["weights"], strict=True)
    set_dropout_generator(model, torch.Generator().manual_seed(case["seed"]), rows=(d, dp))
    optimizer, scheduler, clip = build_optimizer(model.parameters(), case["train"], 1)
    step = make_train_step(model, optimizer, scheduler, clip, dp_comm)
    data = device_dataset(case["split"], cpu)
    gen = torch.Generator().manual_seed(case["seed"] + 1)
    losses = [train_epoch(step, data, device_permutation(gen, len(case["split"]), bs, cpu), rows)
              for _ in range(case["epochs"])]
    esum, count = ResidentEval(data, bs, rows, dp_comm)(make_eval_step(model))
    return {"losses": torch.cat(losses), "params": model.state_dict(), "esum": esum,
            "count": float(count)}


def fused_channel_case(case: dict, layout=None) -> dict:
    """``FusedChannelDense`` (which no model uses) on ``h`` and ``stack``:
    its output and the gradients of both inputs and of its weight."""
    from lanczosnet_torch.models.lanczos_net import FusedChannelDense
    from lanczosnet_torch.parallel.tensor import TensorParallel

    layer = FusedChannelDense(*case["dims"])
    layer.load_state_dict(case["weights"])
    parallel = None if layout is None else TensorParallel(layer, layout.tp_comm)
    h = torch.from_numpy(case["h"]).requires_grad_()
    stack = torch.from_numpy(case["stack"]).requires_grad_()
    out = layer(h, stack)
    out.backward(torch.from_numpy(case["cotangent"]))
    params = list(layer.parameters()) if parallel is None else parallel.parameters()
    grads = [p.grad for p in params]
    return {"out": out.detach(), "h_grad": h.grad, "stack_grad": stack.grad,
            "grads": (dict(zip(["weight", "bias"], grads)) if parallel is None
                      else parallel.full(grads))}


CASES = {"train": train_case, "resident": resident_case, "fused": fused_channel_case}


def mesh_cases(spec_path: str, out_dir: str) -> int:
    """Each case of the spec (``{"dp", "tp", "cases"}``) on this rank's
    place in the mesh; then, where the spec names ``cycle`` (a config
    file), the runner's train, ``-t`` and resume as ``cli.run`` does them
    in each rank."""
    from lanczosnet_torch.parallel import multihost

    spec = torch.load(spec_path, weights_only=False)
    world = multihost.world()
    out = {}
    for case in spec["cases"]:
        layout = multihost.mesh2d(*case["mesh"])
        out[case["key"]] = CASES[case["kind"]](case, layout)
    out["world"] = world.describe()
    if spec.get("cycle"):
        out["cycle"] = run_cycle(spec["cycle"])
    if spec.get("bucketed"):
        out["bucketed"] = run_bucketed(spec["bucketed"])
    torch.save(out, Path(out_dir) / f"rank{world.rank}.pt")
    return 0


def run_cycle(config_path: str) -> dict:
    """Train the config (QM8 or citation), ``-t`` its best checkpoint,
    train one more epoch from its latest snapshot, as ``cli.run`` does in
    each rank; the exit codes and the checkpoint files each rank wrote."""
    from lanczosnet_torch.utils.config import AttrDict, loads

    writes = []
    _record_writes(writes)
    base = AttrDict.convert(loads(Path(config_path).read_text()))
    codes = {"train": cli.run(base, False, "INFO", "cpu")}
    best = str(Path(base.save_dir) / "checkpoints" / "best.pt")
    tested = AttrDict.convert({**base, "test": {"test_model": best}})
    codes["test"] = cli.run(tested, True, "INFO", "cpu")
    resumed = AttrDict.convert({**base, "train": {**base.train, "is_resume": True,
                                                  "max_epoch": base.train.max_epoch + 1}})
    codes["resume"] = cli.run(resumed, False, "INFO", "cpu")
    return {"codes": codes, "writes": [path for path, _ in writes]}


def run_bucketed(config_path: str) -> dict:
    """Train a bucketed QM8 config in each rank, then test its best
    checkpoint: the results of ``train()`` and ``test()``."""
    from lanczosnet_torch.train.runner import QM8Runner
    from lanczosnet_torch.utils.config import loads

    cfg = loads(Path(config_path).read_text())
    trained = QM8Runner(cfg, "cpu").train()
    return {"train": trained, "test": QM8Runner(cfg, "cpu").test()}


# ------------------------------------------------ the node-sharded citation runner
def node_case(case: dict, save_dir, world: int = 1) -> dict:
    """A case (``config``, ``weights``, ``steps``; ``pad_to``, how the one
    device packs the graph; ``device``, the CPU where not named) on this
    rank's rows of the graph (on the rank's device), or on one device
    where ``world`` is 1: the eval logits of the real nodes, the first
    step's gradients, the losses of ``steps`` steps, the shape of the
    operator rows held; AdaLanczosNet's learned operator on the real
    nodes."""
    from lanczosnet_torch.train.citation_runner import CitationRunner, citation_graph
    from lanczosnet_torch.train.node_step import make_node_train_step
    from lanczosnet_torch.train.optim import build_optimizer

    cfg = {**case["config"], "save_dir": str(save_dir),
           "train": {**case["config"]["train"], "num_devices": world}}
    runner = CitationRunner(cfg, case.get("device", "cpu"))
    if world == 1 and case.get("pad_to", 1) != 1:
        # the graph padded as the ranks pad it, so that both draw one dropout mask
        runner.batch, runner.splits = runner._pack(
            citation_graph(cfg["dataset"]), {**cfg["model"], "task": "node"}, case["pad_to"],
            runner.device)
    model = runner.model
    model.load_state_dict(case["weights"], strict=True)
    n = runner.n_true
    out = {"logits": runner.gathered_logits()}
    if cfg["model"]["name"] == "AdaLanczosNet":
        batch = runner.batch
        with torch.no_grad():
            h = model.encoder(batch.atom_type, batch.node_feat, batch.mask)
            s = model.learned_operator(h, batch)[0]
        s = s if runner.comm is None else runner.comm.all_gather(s)
        out["learned_operator"] = s[:n, :n]
    optimizer, scheduler, clip = build_optimizer(model.parameters(), cfg["train"], 1)
    step = make_node_train_step(model, optimizer, scheduler, clip, runner.comm)
    losses = []
    for i in range(case["steps"]):
        losses.append(float(step(runner.batch, runner.splits["train"], runner._count("train"))))
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    out.update(losses=losses, ops_shape=tuple(runner.batch.ops.shape), device=str(runner.device))
    return {k: {n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
            else v.cpu() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def node_sharded_cases(spec_path: str, out_dir: str) -> int:
    """Each case of the spec on this rank's rows; then, where the spec
    names ``cycle`` (a config file), the runner's train, ``-t`` and
    resume as ``cli.run`` does them in each rank."""
    spec = torch.load(spec_path, weights_only=False)
    world = multihost.world()
    out = {c["key"]: node_case(c, Path(out_dir) / c["key"], world.size) for c in spec["cases"]}
    out["world"] = world.describe()
    if spec.get("cycle"):
        out["cycle"] = run_cycle(spec["cycle"])
    torch.save(out, Path(out_dir) / f"rank{world.rank}.pt")
    return 0

