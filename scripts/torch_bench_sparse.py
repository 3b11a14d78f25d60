#!/usr/bin/env python3
"""Sparse-path step-time sweep of the port: dtype × feature width on one card.

Counterpart of ``scripts/bench_sparse.py``, with its options and defaults.
It times the whole SparseGCN training step (forward, backward and Adam
at lr 1e-2; masked softmax cross-entropy in float32, dropout 0.5 on) on
``data/citation.py:synthetic_citation_edges`` (``--nodes`` nodes, average
degree ``--degree``, ten classes, seed 7) under the symmetric COO
operator ``ops/sparse.py:sparse_sym_operator``, for each feature width F
of ``--feat`` and each dtype of ``--dtypes``: hidden width ``--hidden``
(F where 0), two layers, the features stored in the compute dtype. Each
(F, dtype) runs in a subprocess of its own, so each starts from an empty
caching allocator. The step runs once to warm, then ``--steps`` times;
the final loss, read on the host, waits for the device. One JSON row a
config (``nodes``, ``edges``, ``F``, ``hidden``, ``dtype``,
``ms_per_step``, ``loss``; ``remat`` and ``bf16_scatter`` where set), a row
with ``"oom": true`` where the card runs out of memory, then the
bfloat16 speedup over float32 per F. Any other failure of a config fails
the run.

``--remat`` recomputes the forward in the backward: ``full`` checkpoints
the whole forward, ``dots`` keeps only the matrix products' outputs (a
selective checkpoint), ``layers`` checkpoints each layer
(``set_remat_layers``). ``--bf16-scatter`` sets
``LANCZOSNET_BF16_SCATTER`` in each config's process: the sorted backward
scatters of bfloat16 rows accumulate in bfloat16. The JAX script's bytes
and HBM fields come from XLA's cost model; the port has no byte count of
the step and leaves them out. Run from the repository's root:

    python3 scripts/torch_bench_sparse.py                       # on the card
    python3 scripts/torch_bench_sparse.py --feat 128,256,512 --remat layers
    python3 scripts/torch_bench_sparse.py --device cpu --nodes 3000 --feat 16 --steps 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lanczosnet_torch.data.citation import synthetic_citation_edges  # noqa: E402
from lanczosnet_torch.models.base import compute_dtype, set_dropout_generator  # noqa: E402
from lanczosnet_torch.models.sparse_nodes import SparseGCN, replaying  # noqa: E402
from lanczosnet_torch.ops.precision import bf16_f32_accumulation  # noqa: E402
from lanczosnet_torch.ops.sparse import sparse_sym_operator  # noqa: E402
from lanczosnet_torch.train.sparse_citation_runner import save_products  # noqa: E402
from lanczosnet_torch.utils.device import resolve_device  # noqa: E402

NUM_CLASS = 10
GRAPH_SEED = 7
DROPOUT = 0.5
LR = 1e-2
REMAT_MODES = ("", "full", "dots", "layers")


def build_step(model, x, op, labels, mask, remat: str, generator):
    """``() → loss``: one training step of ``model`` on the whole graph,
    the forward recomputed in the backward as ``remat`` says (the dropout
    masks replayed from ``generator``)."""
    optimizer = torch.optim.Adam(model.parameters(), lr=LR)
    count = mask.sum().clamp_min(1.0)

    def forward():
        return model(x, op)

    def remat_forward():
        # replaying() reads the generator's state now: one a step
        replayed = replaying(forward, generator)
        if remat == "full":
            return checkpoint(replayed, use_reentrant=False)
        return checkpoint(replayed, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(save_products))

    fwd = remat_forward if remat in ("full", "dots") else forward

    def step() -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with bf16_f32_accumulation():
            ce = F.cross_entropy(fwd().to(torch.float32), labels, reduction="none")
            loss = (ce * mask).sum() / count
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_step(graph: dict, op, h: int, dt_name: str, remat: str, dev):
    """The SparseGCN of the sweep (hidden width ``h``, weights and dropout
    drawn from seed 0) on ``graph`` and its operator, on ``dev`` →
    ``build_step``'s step."""
    f = graph["features"].shape[1]
    model = SparseGCN(f, (h, h), num_class=NUM_CLASS, dropout=DROPOUT, dtype=dt_name)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev)
    model.set_remat_layers(remat == "layers")
    generator = torch.Generator(dev).manual_seed(0)
    set_dropout_generator(model, generator)
    # features stored in the compute dtype, as the runner stores them
    x = torch.from_numpy(graph["features"]).to(dev, model.dtype)
    labels = torch.from_numpy(graph["labels"].astype(np.int64)).to(dev)
    mask = torch.from_numpy(graph["train_mask"].astype(np.float32)).to(dev)
    return build_step(model, x, op.to(dev), labels, mask, remat, generator)


def run_one(args, f: int, dt_name: str) -> dict:
    """Measure one (F, dtype) config; called in its own subprocess."""
    dev = resolve_device(args.device)
    graph = synthetic_citation_edges(args.nodes, num_class=NUM_CLASS, feat_dim=f,
                                     avg_degree=args.degree, seed=GRAPH_SEED)
    n = graph["features"].shape[0]
    op = sparse_sym_operator(graph["edges"], n)  # built on the host, moved by make_step
    h = args.hidden or f
    dt_name = str(compute_dtype(dt_name)).removeprefix("torch.")  # validates; "bf16" → "bfloat16"
    row = {"nodes": n, "edges": int(op.row.shape[0]), "F": f, "hidden": h, "dtype": dt_name}
    try:
        step = make_step(graph, op, h, dt_name, args.remat, dev)
        float(step())  # warm
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = step()
        final = float(loss)  # waits for the device
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        row.update(ms_per_step=round(ms, 1), loss=round(final, 4))
    except torch.cuda.OutOfMemoryError:
        # the memory wall is itself a result: a row, not a crash
        row["oom"] = True
    if args.remat:
        row["remat"] = args.remat
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--degree", type=float, default=2.5)
    ap.add_argument("--feat", type=str, default="128,256")
    ap.add_argument("--hidden", type=int, default=0, help="hidden width (default: same as F)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dtypes", type=str, default="float32,bfloat16")
    ap.add_argument("--remat", type=str, default="", choices=REMAT_MODES,
                    help="recompute the forward in the backward (train.remat)")
    ap.add_argument("--bf16-scatter", action="store_true",
                    help="accumulate sorted backward scatters in bfloat16 (sets "
                         "LANCZOSNET_BF16_SCATTER for each config's process; bfloat16 rows)")
    ap.add_argument("--one", nargs=2, metavar=("F", "DTYPE"), default=None,
                    help="internal: run a single config in this process")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    if args.one is not None:
        print("ROW " + json.dumps(run_one(args, int(args.one[0]), args.one[1])), flush=True)
        return 0

    results = []
    for f in [int(s) for s in args.feat.split(",")]:
        for dt_name in args.dtypes.split(","):
            cmd = [sys.executable, "-u", os.path.abspath(__file__),
                   "--nodes", str(args.nodes), "--degree", str(args.degree),
                   "--hidden", str(args.hidden), "--steps", str(args.steps),
                   "--remat", args.remat, "--one", str(f), dt_name,
                   *(["--device", args.device] if args.device else [])]
            env = {**os.environ, "LANCZOSNET_BF16_SCATTER": "1" if args.bf16_scatter else "0"}
            res = subprocess.run(cmd, capture_output=True, text=True, env=env)
            rows = [json.loads(line[4:]) for line in res.stdout.splitlines()
                    if line.startswith("ROW ")]
            if res.returncode != 0 or len(rows) != 1:
                print(f"F={f} {dt_name}: the config's process exited {res.returncode}\n"
                      + (res.stdout + res.stderr)[-4000:], file=sys.stderr, flush=True)
                return 1
            row = rows[0]
            if args.bf16_scatter:
                row["bf16_scatter"] = True
            results.append(row)
            print(json.dumps(row), flush=True)

    # bfloat16 speedup over float32 per F
    byf: dict = {}
    for r in results:
        if "ms_per_step" in r:
            byf.setdefault(r["F"], {})[r["dtype"]] = r["ms_per_step"]
    for f, d in sorted(byf.items()):
        if "float32" in d and "bfloat16" in d:
            print(f"F={f}: bf16 speedup over f32 = {d['float32'] / d['bfloat16']:.2f}x",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
