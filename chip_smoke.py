#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line or more, then its wall seconds on a
line of its own (``{"phase": "<name>", "wall_s": s}``; the script's
total last, as ``"total"``); any failure exits non-zero:

1. device: a CUDA card must be visible; TF32 is switched off for
   matmuls and cuDNN, and the card's name and power limit are printed,
   with the bfloat16 reduced-precision flag as the process has it and
   as the train, eval and serving steps run it (off).
2. build: the three sources are built with nvcc from
   ``lanczosnet_torch/csrc``, together (seconds and ``-Xptxas -v``
   report).
3. kernel: the shared-memory Lanczos kernel (N ≤ 128) against its plain
   PyTorch version on the card, all six outputs within 1e-4 and the
   same breakdown step, on masked random operators at sizes that reach
   each of its three instantiations (sums padded to 32, 64, 128) at and
   beside their edges, more steps than nodes (N=8, K=9; N=16 and N=24,
   K=20; these 0.0 from the plain version), an all-zero graph, and QM8-like operators at
   B=64, N=32, K=20; then both timed with CUDA events at B=64 and B=256.
3b. spmm_kernel: the CSR product kernels (``csrc/spmm_csr.cu``: the
   forward, its transpose in the backward, the weights' gradient) at the
   main path's shapes, 10M nodes, 25M edges, F=32 and 1M, 2.5M, F=256,
   bfloat16, on random operators with dead edges, against the plain
   version on the card (whose atomics add in another order: forward and
   ``dx`` within a bfloat16 ulp, ``dval`` within 2^-7 of its terms'
   magnitudes); one launch of each a call; a forward launches the product
   kernel alone and a backward no ``index_add``; each timed beside the
   plain version (once), the library's one call (cuSPARSE through
   ``torch.sparse``) and two bounds at 3.35 TB/s: its compulsory bytes
   and its gathered rows' bytes. Then GAT's heads (``attention_spmv`` →
   ``sparse_cuda.csr_spmm_heads``) at the ogbn-products cell's shapes,
   2,449,029 nodes, 123.7M edges, 4 heads of 128 and of 47, bfloat16,
   against ``_attention_plain`` on the same card inputs, run in pieces of
   whole rows (the forward) and whole sources (the gradients) so that no
   ``[E, H, D]`` tensor exists, within the same two limits; one launch of
   each kernel a head; one head's kernels timed beside the two bounds.
4. serve: the flagship LanczosNet of ``configs/qm8_lanczos_net.yaml``
   at full width, weights drawn from a seeded generator, behind
   ``Predictor`` and ``MicroBatcher``, answers QM8-like requests from
   several client threads; every answer is finite and matches the same
   model fed the plain version's Ritz pairs on the card (1e-4); the
   kernel's launch count must grow during this run.
5. qm8_train: ``configs/qm8_lanczos_net.yaml``, read with the port's
   own config reader and cut to 4 epochs (``max_epoch`` 30 → 4, so the
   ``lr_decay_epoch`` milestones never fire; the run directory in a
   temporary one; ``dataset.pack_cache: false``, so the three packs run
   the kernel; their operators come from the native packer,
   ``data/native.py``, with no fallback), trains the flagship at full
   width through
   ``python -m lanczosnet_torch.cli``: every epoch's loss finite and the
   last below the first, validation and test MAE finite, the
   shared-memory kernel launched at least once per 256-graph chunk of
   the three packs; the packed Ritz pairs of the test split equal the
   plain version's (max abs error 0.0); ``-t`` on the best checkpoint
   gives the run's test MAE again (1e-6); ``Predictor.from_run_dir``
   behind ``MicroBatcher`` answers the test graphs as the restored model
   does on the packed batches (1e-4); graphs/s, MFU, a stage split of
   one training step, a profile of a few steps and the host seconds of
   the splits' operators by the native packer and by the torch path are
   printed.
5b. eigh, profile_step and bench: the Jacobi eigensolver against
   cuSOLVER; ``scripts/torch_profile_step.py`` cut to 1 epoch; then the
   three measuring tools: ``scripts/torch_bench.py`` in process at its
   working point (21,760 graphs packed on the card by B1, one warm, one
   timed and one traced epoch in place of groups of 10): the loss finite,
   graphs/s above 0, the traced device share in (0, 1], B1 launched in
   the pack; ``torch_bench_serve.py`` in a process of its own over HTTP
   (1 and 16 clients, 2 s windows) and over the native front with the
   binary wire (16 clients): no request fails, B1 launched;
   ``torch_bench_sparse.py --feat 128 --steps 3 --nodes 250000 --dtypes
   bfloat16``: a finite loss in its row. Then poisoned_alloc: B1 and B2 over
   NaN-poisoned memory, bit for bit a clean call's.
6. qm8_models: the nine other QM8 configs that train on one card
   (``configs/qm8_{gcn,graph_sage,dcnn,chebynet,gat,mpnn,gpnn}.yaml``,
   ``qm8_lanczos_net_bf16.yaml``, ``qm8_ada_lanczos_net.yaml``) at full
   width, cut to 1024/128/128 graphs and 3 epochs (``dataset.pack_cache:
   false``, the runs in a temporary directory), in-process through
   ``build_runner``, GPNN through ``lanczosnet_torch.cli`` and ``-t``.
   Per config: every epoch's loss finite and the last below the first,
   validation and test MAE finite; the eval-mode predictions of the
   trained model on one packed test batch equal the same ``state_dict``'s
   on the CPU (1e-4; bfloat16: no farther from the CPU than from the
   float32 model with the same weights on the card, and 2e-2);
   ``Predictor.from_run_dir`` behind ``MicroBatcher`` answers the test
   graphs as the restored model does on the packed batches (1e-4; GPNN
   on the float32 wire with its partition); graphs/s and a step's ms.
   QM8 AdaLanczosNet launches the shared-memory kernel in every training
   step, and its kernel and plain forwards agree in predictions and in
   the ``kernel_embed`` gradient (1e-4); a profile counts a step's
   launches. The bfloat16 flagship's packs launch the kernel, and the
   profile of one of its steps names the bfloat16 GEMM kernels.
6b. qm8_buckets: the flagship at full width in size buckets [16, 24, 32]
   (the 16 bound under K=20: more Lanczos steps than nodes) with paired
   steps (``train.bucket_pair``), ``train.profile`` and
   ``train.tensorboard``, at the qm8_models cut, through the CLI, then
   ``-t`` and one chunk-interleaved epoch without pairing. Gates: losses
   finite and falling, ``-t`` equal to the run's test MAE (1e-6), the
   first epoch's trace shows device time, each bucket's packed Ritz pairs
   0.0 from the plain version's, the first paired step's loss on the
   card within 1e-4 of the CPU's (dropout 0, the same weights and packed
   arrays), the kernel launched in the packs, no native fallback. Graphs
   a bucket, s an epoch and graphs/s beside the unbucketed flagship's,
   and whether the TensorBoard writer was made, are printed.
7. serve_fronts: the run directories of the two phases before, the
   flagship's and GPNN's, served by name through ``ModelServer``
   (``lanczosnet_torch/serve_http.py``, batch 64): first the stdlib HTTP
   front, 512 one-graph JSON requests from 16 client threads, half to
   each model (the flagship on the compact wire, GPNN on the float32
   wire with its partition), every answer finite and within 1e-4 of
   ``Predictor.from_run_dir`` on the same graphs, a body that is not a
   JSON object and a graph that does not decode each answered 400; then
   the forked native front (``lanczosnet_torch/native/servefront.cc``,
   built with g++ first), 256 graphs each sent as JSON and as the LNG1
   binary wire, within 1e-4 of the same and of each other, JSON bodies
   transcoded in C++, and four requests pipelined on one keep-alive
   connection answered in request order. Last the flagship is exported
   on the card (``lanczosnet_torch/export.py``), loaded back and held to
   the Predictor within 1e-5 with TF32 switched on around the call,
   served through a ``ModelServer`` built from the artifact directory,
   and timed in-process beside the Predictor (in turns). The
   shared-memory kernel's launch count must grow on each of the three
   paths; req/s and p50/p95 are printed for each front.
8. barrier and stream_kernel: what one grid barrier of the streamed
   kernel's cooperative launch costs (a launch of barriers and nothing
   else); then the streamed Lanczos kernel (N > 128) against its plain
   version on the card, the same contract, on masked random operators at
   N=300, a 130-node graph with 3 real nodes, an all-zero graph at
   N=256, K=64 at N=129, batches of graphs of different real sizes that
   need several chunks a block and several launches, N=16384, and the
   learned operator of the Cora-sized AdaLanczosNet (B=1, N=2708, K=20);
   then both timed at that shape, and the kernel compared once more
   after the timing loop, so that state left from call to call would
   show.
9. citation_train: ``CitationRunner`` trains the AdaLanczosNet of
   ``configs/cora_ada_lanczos_net.yaml`` at full width on a synthetic
   Cora-sized graph (N=2708, F=1433, 7 classes) for a few epochs and
   tests it; the streamed kernel's call count must grow by at least one
   per forward, every loss is finite, the last epoch's train CE is
   below the first's, and eval-mode logits and the ``kernel_embed``
   gradient agree between the kernel forward and the plain forward
   (1e-4); step times and the stage split are printed.
10. dense_citation: the eight dense citation configs
   (``configs/{cora,citeseer,pubmed}_gcn.yaml``,
   ``{cora,citeseer,pubmed}_lanczos_net.yaml``, ``cora_ada_lanczos_net.yaml``,
   ``pubmed_gpnn.yaml``) as written, cut to 12 epochs, through
   ``python -m lanczosnet_torch.cli`` and ``-t``: every loss finite and
   the last below the first, ``-t`` repeats the test accuracy; the packed
   Ritz pairs of the LanczosNets that the streamed kernel packs (Cora,
   Citeseer) equal the plain version's (0.0), Pubmed's (N=19717) take the
   plain version by shape; GPNN's partition of Pubmed on the card agrees
   with the CPU's, up to relabelling, on at least 97% of the nodes.
   Each run's peak device memory is kept for the next phase.
10b. node_sharded_citation: the dense citation runner's node-sharding,
   4 ranks sharing the card over gloo, each run through
   ``python -m lanczosnet_torch.cli`` from a copy of the config with
   ``train.num_devices: 4``: ``configs/cora_ada_lanczos_net.yaml`` at
   full width cut to 12 epochs (B2 in every forward of every rank, on the
   learned operator gathered from the ranks' rows), then in its ranks
   ``-t`` on its best checkpoint, B2 against its plain version on the
   gathered learned operator (rank 0, 0.0), and
   ``configs/cora_lanczos_net.yaml`` trained 2 epochs (rank 0's pack runs
   B2; its Ritz pairs 0.0 from the plain version's on the gathered
   operator); ``-t`` on one device from the same checkpoint (the ranks'
   test accuracy and the run's within 1e-6) and the first step on one
   device with the same weights and dropout masks (1e-5 relative); then
   ``configs/pubmed_lanczos_net.yaml`` at full width cut to 12 epochs
   (N=19717 padded to 19720, 4,930 rows a rank), whose per-rank peak
   must stay under half of the one-device run's peak of the phase
   before. Gates: every rank on ``cuda:0``, losses falling, B2 launched
   in every forward of every rank. Per run: step ms, the comm layer's
   share, per-rank peak GB and host RSS, rank 0's set-up seconds.
11. sparse_citation: the twelve single-device ``SparseCitationRunner``
   configs (``configs/pubmed_sparse_*.yaml``, ``million_sparse_gcn_wide``,
   ``ten_million_sparse_gcn``, ``ten_million_sparse_lanczos_net``) at
   full width, cut to 3 epochs, each graph made once for the configs
   that share it: every loss finite and falling; each float32 Pubmed
   model's eval logits on the card equal the CPU's on the same weights
   (1e-4, or 10 times the distance of the CPU's own logits with the
   edges summed in other orders, where that is larger); the 10M operator's product equals a float64 scipy product
   (1e-5), its Ritz values lie in [−1−1e-3, 1+1e-3] and its nonzero Ritz
   vectors are orthonormal (1e-3), the bfloat16 LanczosNet's logits lie
   within 2% of the largest logit of a float32 twin's on the same
   weights, and ``remat: layers`` gives the loss of no remat on one step
   (1e-5 relative). Per config: the graph, operator and Ritz (or
   partition) times, ms a step, s an epoch, peak memory, the test
   accuracy and a profile of a few steps.
12. sharded_citation: the four sharded sparse configs
   (``configs/million_sparse_gcn_{sharded,node_sharded,ring}.yaml``,
   ``ten_million_sparse_lanczos_net_ring.yaml``), 4 of their 8 ranks
   sharing the card over gloo, cut to 3 epochs (the ring LanczosNet to 2
   epochs and 2M of its 10M nodes), each
   trained through ``python -m lanczosnet_torch.cli`` (which starts the
   ranks), then ``-t`` on its best checkpoint in the ranks (and, for the
   ring, one more epoch resumed from the primary's snapshot): every
   rank on ``cuda`` (its ``setup`` event), the loss falls, ``-t`` repeats
   the test accuracy, the resumed run logs the next epoch, the sharded
   eval logits within 1e-4 of one device's at the same weights (the ring
   LanczosNet's bfloat16 logits within 2% of the largest), and each
   rank's peak in the ring below its peak node-sharded. Per config: step
   ms, per-rank peak GB and host peak RSS, rank 0's set-up seconds, the
   backend and the comm layer's staging and transport shares of a step.
13. qm8_parallel: ``QM8Runner``'s data and tensor parallelism through
   ``python -m lanczosnet_torch.cli``, the ranks sharing the card over
   gloo: ``configs/qm8_lanczos_net_tp4.yaml`` as written (4 ranks, dp=1 ×
   tp=4, cut to 2 epochs), then ``-t`` and one resumed epoch in its
   ranks; the same config with ``train.num_devices: 8`` (dp=2 × tp=4, 2
   epochs); ``configs/qm8_lanczos_net.yaml`` with ``train.num_devices: 4``
   (dp=4, 2 epochs), each cut to 1024/128/128 graphs. The runs share a
   pack cache in a temporary directory: the first run's rank 0 packs (B1
   on the card), the others read it. Gates: every rank on ``cuda``, the
   mesh the config asks for, losses falling, each rank's parameter and
   Adam-moment bytes equal to the rule's prediction
   (``parallel/tensor.py``), ``-t`` in the ranks,
   the run's own test and ``-t`` on one device within 1e-6,
   ``Predictor.from_run_dir`` on one device within 1e-4 of the restored
   model; the flagship's first step at dp=2 × tp=4 within 1e-5 (relative)
   of one device's loss on the same batch, weights and dropout masks; B1
   0.0 from its plain version at the batch blocks B = 64/dp. Per run: step
   ms, graphs/s, per-rank peak GB, the comm layer's share of a step,
   rank 0's set-up seconds and B1's launches.
14. dryrun: ``python -m lanczosnet_torch.dryrun --ranks 4``, the ranks
   sharing the card over gloo: one step of every parallel axis, each
   within 1e-5 relative of one device's, and the export round trip
   (0.0); it must exit 0 with its ``ok`` line, every rank on ``cuda:0``.
15. kernels: one line per ported kernel, its error, its time, its bound,
   its latency floor and its launches, all of this run (the
   shared-memory kernel's launches by path: serving, the flagship's
   packs, the eigensolver's and the profile's runs, the bench's pack and
   the serving bench's request batches, the bfloat16 flagship's run, QM8
   AdaLanczosNet's run, the bucketed flagship's packs, the HTTP front,
   the native front, the served artifact, the QM8 mesh runs' packs and
   the dry run's ranks; it
   runs behind the custom operator
   ``lanczosnet::lanczos_tridiag_resid``; the streamed kernel's by path:
   the Cora AdaLanczosNet run, the dense citation configs and the
   node-sharded ones; the three CSR kernels' launches in the
   single-device sparse configs, with their times at both shapes).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import http.client
import itertools
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

from lanczosnet_torch import cli, serve_native
from lanczosnet_torch.core.graph_batch import batch_graphs
from lanczosnet_torch.data import native
from lanczosnet_torch.data.buckets import pack_dataset_bucketed
from lanczosnet_torch.data.dataset import RITZ_CHUNK, pack_dataset
from lanczosnet_torch.data.partition import ritz_partition
from lanczosnet_torch.data.loader import to_device
from lanczosnet_torch.data.qm8 import NUM_ATOM, NUM_TASK, synthetic_qm8_graphs
from lanczosnet_torch.export import export_predictor, load_predictor
from lanczosnet_torch.models import build_model
from lanczosnet_torch.models.sparse_nodes import build_sparse_model
from lanczosnet_torch.ops.eigh import eigh_dispatch, jacobi_sweeps
from lanczosnet_torch.ops.precision import bf16_f32_accumulation, f32_matmul
from lanczosnet_torch.ops import _build, lanczos_cuda
from lanczosnet_torch.ops.lanczos import (
    lanczos_adjoint_bwd,
    lanczos_start_vector,
    lanczos_tridiag_resid,
    lanczos_tridiag_resid_stream,
    tridiag_matrix,
)
from lanczosnet_torch.ops.lanczos_cuda import (
    LanczosTridiag,
    batched_lanczos_ritz_dispatch,
    ritz_from_tridiag,
)
from lanczosnet_torch.ops.normalize import build_operator_stack
from lanczosnet_torch.ops import sparse as sparse_mod
from lanczosnet_torch.ops import sparse_cuda
from lanczosnet_torch.ops.sparse import SparseOp, spmv
from lanczosnet_torch.ops.sparse_cuda import csr_row_ptr
from lanczosnet_torch.serve import MicroBatcher, Predictor
from lanczosnet_torch.serve_http import ModelServer, make_http_server, serve_forever_in_thread
from lanczosnet_torch.train import citation_runner as citation_runner_mod
from lanczosnet_torch.train.citation_runner import CitationRunner
from lanczosnet_torch.train.node_step import (
    make_node_eval_step,
    make_node_train_step,
    masked_ce_loss,
)
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train import runner as runner_mod
from lanczosnet_torch.train.runner import build_runner
from lanczosnet_torch.train import sparse_citation_runner as sparse_runner_mod
from lanczosnet_torch.train.sparse_citation_runner import (
    SparseCitationRunner,
    sparse_citation_graph,
)
from lanczosnet_torch.train.step import make_pair_step, make_train_step, weighted_mae
from lanczosnet_torch.utils import config as config_io
from lanczosnet_torch.utils.poison import poisoned_lanczos_check
from lanczosnet_torch.utils.profiling import (
    FP32_FLOPS_PER_S,
    device_busy_seconds,
    qm8_train_flops_per_graph,
)

# configs/qm8_lanczos_net.yaml, its model and dataset sections as written
# (a test holds these literals to the file; the card has no YAML reader)
FLAGSHIP_MODEL = {
    "name": "LanczosNet",
    "hidden_dim": [128, 128, 128],
    "embed_dim": 128,
    "short_diffusion_dist": [1, 2, 3],
    "long_diffusion_dist": [5, 7, 10, 20, 30],
    "num_eig_vec": 20,
    "spectral_filter_kind": "MLP",
    "filter_hidden_dim": 16,
    "dropout": 0.1,
}
FLAGSHIP_DATASET = {
    "source": "synthetic",
    "name": "qm8",
    "n_max": 32,
    "num_atom": 8,
    "num_train": 2048,
    "num_val": 256,
    "num_test": 256,
    "standardize": True,
    "operator_kind": "sym",
}
# configs/cora_ada_lanczos_net.yaml, its model, dataset and train sections
# and its seed as written (the same test holds them to the file)
CORA_ADA_MODEL = {
    "name": "AdaLanczosNet",
    "hidden_dim": [64, 64],
    "embed_dim": 64,
    "kernel_dim": 16,
    "use_graph_support": True,
    "short_diffusion_dist": [1, 2, 3],
    "long_diffusion_dist": [5, 7, 10],
    "num_eig_vec": 20,
    "spectral_filter_kind": "MLP",
    "lanczos_impl": "auto",
    "dropout": 0.5,
    "task": "node",
}
CORA_ADA_DATASET = {
    "source": "synthetic",
    "name": "cora",
    "scale": 1.0,
    "operator_kind": "sym",
}
CORA_ADA_TRAIN = {
    "optimizer": "Adam",
    "lr": 1.0e-2,
    "wd": 5.0e-4,
    "max_epoch": 200,
    "patience": 40,
    "display_iter": 20,
}
CORA_ADA_SEED = 1234
QM8_CONFIG = Path(__file__).resolve().parent / "configs" / "qm8_lanczos_net.yaml"
QM8_EPOCHS = 4  # the depth cut: of max_epoch 30
# the qm8_models phase: its configs, the one of them trained through the
# CLI, and its cuts of each config (printed with the phase)
QM8_MODEL_CONFIGS = ("qm8_gcn", "qm8_graph_sage", "qm8_dcnn", "qm8_chebynet", "qm8_gat",
                     "qm8_mpnn", "qm8_gpnn", "qm8_lanczos_net_bf16", "qm8_ada_lanczos_net")
QM8_MODELS_CLI = "qm8_gpnn"
QM8_BF16 = "qm8_lanczos_net_bf16"
QM8_ADA = "qm8_ada_lanczos_net"
QM8_MODELS_CUT = {"dataset.num_train": 1024, "dataset.num_val": 128, "dataset.num_test": 128,
                  "train.max_epoch": 3, "dataset.pack_cache": False}
BF16_TOL = 2e-2  # bfloat16 card against CPU, beside the float32 model's gap
# the qm8_buckets phase: the flagship in size buckets (the JAX module's
# recommended bounds; 16 is under K=20), paired steps, profiled, mirrored
# to TensorBoard, at QM8_MODELS_CUT
QM8_BUCKET_BOUNDS = [16, 24, 32]
QM8_BUCKETS_SET = {"dataset.buckets": QM8_BUCKET_BOUNDS, "train.bucket_pair": True,
                   "train.profile": True, "train.tensorboard": True}
PAIR_STEP_TOL = 1e-4  # the first paired step's loss, card against CPU
CITATION_EPOCHS = 12  # the depth cut: of max_epoch 200
CORA_SHAPE = (2708, 1433, 7)  # nodes, features, classes: the real dataset's
SERVE_BATCH = 64
# the CSR product kernels' main-path shapes: (nodes, edges, F)
SPMM_SHAPES = ((10_000_000, 25_000_000, 32), (1_000_000, 2_500_000, 256))
# GAT's heads on the CSR kernels at the ogbn-products cell's shapes: (nodes,
# edges, heads, head widths); the plain version runs in pieces of about
# HEADS_PLAIN_EDGES edges, so that no [E, H, D] message exists
GAT_HEADS_SHAPE = (2_449_029, 123_718_280, 4, (128, 47))
HEADS_PLAIN_EDGES = 2_000_000
TOL = 1e-4  # the kernel's contract with its plain version, all six outputs
OUTPUTS = ("alphas", "betas_full", "q", "p1", "p2", "w4")
EPS = 1e-6
NUM_REQUESTS = 2048
NUM_CLIENTS = 16
FRONT_REQUESTS = 512  # per front, from FRONT_CLIENTS threads
FRONT_CLIENTS = 16
ARTIFACT_TOL = 1e-5  # the artifact against the Predictor it was exported from
# bfloat16 logits of a sparse model against its float32 twin on the same
# weights: max |bf16 − f32| over max |f32|; the CPU tests measure
# 0.46–1.5% for the nine models (tests/test_torch_sparse_models.py)
SPARSE_BF16_REL_DISTANCE = 0.02

# H100 SXM data sheet (at the 700 W limit): HBM rate; the float32 rate
# outside the tensor cores is utils/profiling.py's FP32_FLOPS_PER_S
HBM_BYTES_PER_S = 3.35e12
# a dependent float32 add issues 4 cycles after the one it waits for
FADD_CHAIN_CYCLES = 4
# Not of this run: the kernels' times before their redesign, as PERF.md
# section 6 records them (NVIDIA H100 80GB HBM3, 700.00 W; CUDA events, this
# script as it was then). Printed beside the ``kernel_time`` lines only, and
# named as recorded; the ``kernels`` line holds this run's numbers alone.
RECORDED_MS_BEFORE_REDESIGN = {
    "lanczos_tridiag": {64: 0.05918, 256: 0.05936},
    "lanczos_stream": 1.1302,
}


class SmokeFailure(SystemExit):
    def __init__(self, msg: str):
        super().__init__(f"chip_smoke: FAILED: {msg}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str = "name,power.limit", fmt: str = "csv,noheader") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def latency_floor_ms(links: int, launch_ms: float) -> dict:
    """The time the longest chain of dependent float32 adds of one call
    takes at the card's highest SM clock, plus one launch: what no
    schedule that keeps the order of summation can go below."""
    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    chain_ms = links * FADD_CHAIN_CYCLES / (mhz * 1e3)
    return dict(latency_floor_ms=chain_ms + launch_ms, chain_links=links,
                sm_clock_mhz=mhz, launch_ms=launch_ms)


def tridiag_links(n: int, k: int) -> int:
    """Dependent adds on the critical path of the shared-memory kernel:
    a step is five sums over the padded node index one after the other
    (matvec, alpha, p1, p2, beta^2) and two combines over rows 0..j."""
    return k * 5 * lanczos_cuda.tridiag_padded_n(n) + k * (k + 1)


def stream_links(n: int, k: int) -> int:
    """The same for the streamed kernel: each of the five sums is a chain
    of 64 inside a chunk, then one over the ceil(n/64) chunk partials."""
    return k * 5 * (64 + -(-n // 64)) + k * (k + 1)


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` on the device, by CUDA events
    around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def lanczos_bound(b: int, n: int, k: int) -> tuple[float, str, int, int]:
    """Least time in ms the card needs for the tridiagonalization of b
    graphs: each input read once (S, q0), each output written once, and
    the float32 operations of all K steps (the kernel runs every step,
    broken down or not). Returns (ms, what bounds it, bytes, flops)."""
    nbytes = 4 * b * (n * n + n + 2 * k + 2 * k * n + 2 * k * k)
    # per step: matvec 2n², α 2n, three-term update 4n, two CGS passes
    # (projection 2kn + update 2kn each), β 2n+1, normalization n
    flops = b * k * (2 * n * n + 8 * k * n + 9 * n + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def lanczos_stream_bound(b: int, n: int, k: int) -> dict:
    """``lanczos_bound`` for the streamed kernel, and beside it the time
    of reading S from device memory once per step (K times): what a
    design that does not keep S in the L2 cache is held to."""
    bound_ms, bound_by, nbytes, flops = lanczos_bound(b, n, k)
    streamed = 4 * b * n * n * k
    return dict(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                s_read_k_times_bytes=streamed,
                s_read_k_times_ms=streamed / HBM_BYTES_PER_S * 1e3)


def compare_outputs(name: str, s, k: int, got, want) -> float:
    """Hold a kernel's six outputs to its plain version's: finite, within
    TOL, the same breakdown step. Returns the largest error."""
    errs = {}
    for out, g, w in zip(OUTPUTS, got, want):
        if not torch.isfinite(g).all():
            raise SmokeFailure(f"{name}: kernel output {out} is not finite")
        errs[out] = float((g - w).abs().max())
    steps_kernel = (got[1] > 0).sum(1)
    same_breakdown = bool(torch.equal(steps_kernel, (want[1] > 0).sum(1)))
    err = max(errs.values())
    emit("kernel", case=name, shape=list(s.shape), k=k, max_abs_err=errs,
         valid_steps=steps_kernel.tolist(), same_breakdown=same_breakdown, tol=TOL)
    if err > TOL:
        raise SmokeFailure(f"{name}: kernel differs from its plain version by {err} > {TOL}")
    if not same_breakdown:
        raise SmokeFailure(f"{name}: kernel and plain version break down at different steps")
    return err


def spd_case(rng, b: int, n: int, counts) -> tuple[np.ndarray, np.ndarray]:
    s = rng.standard_normal((b, n, n)).astype(np.float32) * 0.3
    s = 0.5 * (s + s.transpose(0, 2, 1))
    mask = np.zeros((b, n), np.float32)
    for i, c in enumerate(counts):
        mask[i, :c] = 1.0
        s[i, c:, :] = 0.0
        s[i, :, c:] = 0.0
    return s, mask


def qm8_operators(b: int, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    host = batch_graphs(synthetic_qm8_graphs(b, seed=seed), FLAGSHIP_DATASET["n_max"])
    mask = torch.from_numpy(host["mask"]).to(dev)
    ops = build_operator_stack(torch.from_numpy(host["adj"]).to(dev), mask)
    return ops[:, 0].contiguous(), mask


def bf16_flag(inside: bool = False) -> bool:
    """``allow_bf16_reduced_precision_reduction`` as the process has it,
    or as a train, eval or serving step runs (``bf16_f32_accumulation``)."""
    if not inside:
        return torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    with bf16_f32_accumulation():
        return torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false; this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit(
        "device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_bf16_reduced_precision_reduction=bf16_flag(),
        in_steps_matmul_allow_bf16_reduced_precision_reduction=bf16_flag(inside=True),
    )
    return smi


def phase_build() -> None:
    built = _build.build_all(["lanczos_tridiag", "lanczos_stream", "spmm_csr"])
    for b in built:
        log = [ln.strip() for ln in b.log.splitlines() if ln.strip()]
        emit("build", kernel=b.name, seconds=b.seconds, library=b.path.name, nvcc_log=log)


def phase_kernel(dev, launch_ms: float) -> dict:
    rng = np.random.default_rng(0)
    cases = {}
    for name, (b, n, counts, k) in {
        "spd-n12-k6": (5, 12, [12, 9, 4, 1, 12], 6),
        "spd-n12-k12": (5, 12, [12, 9, 4, 1, 12], 12),
        "spd-n32-k32": (3, 32, [32, 20, 2], 32),
        "spd-n33-k33": (3, 33, [33, 30, 2], 33),
        "spd-n64-k20": (2, 64, [64, 40], 20),
        "spd-n65-k65": (2, 65, [65, 3], 65),
        "spd-n128-k20": (8, 128, [128, 125, 100, 64, 33, 4, 1, 128], 20),
        "spd-n128-k128": (2, 128, [128, 90], 128),
        # K > N, as the JAX package runs it (a bucket bound of 16 under K=20)
        "spd-n8-k9": (2, 8, [8, 5], 9),
        "spd-n16-k20": (4, 16, [16, 12, 3, 16], 20),
        "spd-n24-k20": (3, 24, [24, 17, 9], 20),
    }.items():
        s, mask = spd_case(rng, b, n, counts)
        cases[name] = (torch.from_numpy(s).to(dev), torch.from_numpy(mask).to(dev), k)
    zero_mask = torch.zeros(2, 8, device=dev)
    zero_mask[0, :3] = 1.0
    cases["zero-graph-k4"] = (torch.zeros(2, 8, 8, device=dev), zero_mask, 4)
    s64, m64 = qm8_operators(SERVE_BATCH, 0, dev)
    cases["qm8-b64-n32-k20"] = (s64, m64, FLAGSHIP_MODEL["num_eig_vec"])

    worst = 0.0
    for name, (s, mask, k) in cases.items():
        got = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, k, EPS)
        torch.cuda.synchronize()
        want = lanczos_tridiag_resid(s, mask, k, EPS)
        torch.cuda.synchronize()
        err = compare_outputs(name, s, k, got, want)
        if k > s.shape[-1] and err != 0.0:
            raise SmokeFailure(f"{name}: K > N must be bit for bit, the kernel reads {err}")
        worst = max(worst, err)

    k = FLAGSHIP_MODEL["num_eig_vec"]
    timing = {}
    for b in (SERVE_BATCH, 256):
        s, mask = qm8_operators(b, 1, dev)
        n = s.shape[-1]
        q0 = lanczos_start_vector(mask, EPS).contiguous()
        outs = tuple(torch.empty(shape, device=dev) for shape in
                     ((b, k), (b, k), (b, k, n), (b, k, k), (b, k, k), (b, k, n)))
        before = lanczos_cuda.launches.count
        lanczos_cuda.launch(s, q0, outs, k, EPS)
        device_launches = lanczos_cuda.launches.count - before
        kernel_ms = cuda_ms(lambda: lanczos_cuda.launch(s, q0, outs, k, EPS), 200, 20)
        # one step instead of K: below this the loop of launches reads the
        # host's launch rate, not the kernel
        one_step_ms = cuda_ms(lambda: lanczos_cuda.launch(s, q0, outs, 1, EPS), 200, 20)
        plain_ms = cuda_ms(lambda: lanczos_tridiag_resid(s, mask, k, EPS), 20, 3)
        bound_ms, bound_by, nbytes, flops = lanczos_bound(b, n, k)
        timing[b] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops, one_step_ms=one_step_ms,
                         device_launches_per_call=device_launches,
                         **latency_floor_ms(tridiag_links(n, k), launch_ms))
        emit("kernel_time", batch=b, n=n, k=k, **timing[b],
             recorded_ms_before_redesign=RECORDED_MS_BEFORE_REDESIGN["lanczos_tridiag"][b])
    return {"max_abs_err": worst, "timing": timing}


def spmm_case(n: int, e: int, f: int, seed: int, dev) -> tuple[SparseOp, torch.Tensor]:
    """A random operator of ``n`` nodes and ``e`` edges drawn on the card
    (uniform ends, so degrees near Poisson(e/n); a twentieth of the
    edges dead, ``val`` 0), sorted by row as the runner's are, with its
    ``row_ptr`` and ``col_perm``; and x ``[n, f]`` bfloat16."""
    gen = torch.Generator(dev).manual_seed(seed)
    row, order = torch.sort(torch.randint(0, n, (e,), generator=gen, device=dev,
                                          dtype=torch.int32), stable=True)
    col = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)[order]
    val = torch.rand(e, generator=gen, device=dev) * 0.5 + 0.1
    val = torch.where(torch.rand(e, generator=gen, device=dev) < 0.05, 0.0, val)
    op = SparseOp(row=row, col=col, val=val, n=n, rows_sorted=True,
                  col_perm=torch.argsort(col, stable=True).to(torch.int32),
                  row_ptr=csr_row_ptr(row, n))
    x = torch.randn(n, f, generator=gen, device=dev).to(torch.bfloat16)
    return op, x


def spmm_bytes(n_out: int, n_src: int, e: int, f: int, itemsize: int) -> dict:
    """Each kernel's bytes a call, two ways (``row_ptr`` counted, the
    transposed view's build not): ``compulsory``, every input row, edge
    array and output once, what the function needs; ``gathered``, every
    gathered row once an edge, what a kernel moves where the gathered
    table (640 / 512 MB at the main path's shapes) is far larger than
    the 50 MB L2 and the gathers are uniform, so a row is rarely read
    twice from L2."""
    row = f * itemsize
    fwd = 8 * e + 4 * (n_out + 1) + n_out * row  # edges, row_ptr, the output
    bwd = 8 * e + 4 * (n_src + 1) + n_src * row  # over the transposed view
    sdd = 8 * e + 4 * (n_out + 1) + n_out * row  # col and dval, row_ptr, g once
    return {"compulsory": {"spmm": fwd + n_src * row, "spmm_t": bwd + n_out * row,
                           "sddmm": sdd + n_src * row},
            "gathered": {"spmm": fwd + e * row, "spmm_t": bwd + e * row,
                         "sddmm": sdd + e * row}}


def library_ms(fn, iters: int, warmup: int):
    """``cuda_ms`` of a library call, or why the library refused it."""
    try:
        return cuda_ms(fn, iters, warmup)
    except (RuntimeError, NotImplementedError) as err:
        return f"refused: {str(err).splitlines()[0][:200]}"


def library_calls(op: SparseOp, n: int, x: torch.Tensor, g: torch.Tensor, ptr_t) -> dict:
    """The library's one-call route to each product, on x's dtype: cuSPARSE
    SpMM through ``torch.sparse.mm`` on ``torch.sparse_csr_tensor`` over
    ``row_ptr`` (``spmm``), over the transposed view the kernel reads
    (``spmm_t``) and on the transposed CSR tensor as PyTorch takes it
    (``spmm_t_transposed_tensor``); cuSPARSE SDDMM through
    ``torch.sparse.sampled_addmm`` (``sddmm``)."""
    dt = x.dtype
    s_csr = torch.sparse_csr_tensor(op.row_ptr, op.col, op.val.to(dt), size=(n, n))
    col_ptr, row_t, val_t = ptr_t
    t_csr = torch.sparse_csr_tensor(col_ptr, row_t, val_t.to(dt), size=(n, n))
    x_t = x.t()
    return {"spmm": lambda: torch.sparse.mm(s_csr, x),
            "spmm_t": lambda: torch.sparse.mm(t_csr, g),
            "spmm_t_transposed_tensor": lambda: torch.sparse.mm(s_csr.t(), g),
            "sddmm": lambda: torch.sparse.sampled_addmm(s_csr, g, x_t, beta=0.0)}


def spmm_shape_check(n: int, e: int, f: int, dev) -> dict:
    """The three CSR kernels at one main-path shape against the plain
    version on the card (whose float32 atomics add in another order: the
    forward and ``dx`` within one bfloat16 ulp, ``dval`` within 2^-7 of
    the sum of its terms' magnitudes), timed beside it, with the launches
    of one call and the device kernels of a forward and a backward."""
    op, x = spmm_case(n, e, f, 0, dev)
    g = torch.randn(n, f, generator=torch.Generator(dev).manual_seed(1), device=dev).to(x.dtype)
    out, fails = {"shape": f"N={n} E={e} F={f} bfloat16"}, []

    def grads(fn):
        xr = x.detach().requires_grad_()
        vr = op.val.detach().requires_grad_()
        y = fn(op.replace(val=vr), xr)
        y.backward(g)
        return y.detach(), xr.grad, vr.grad

    counts = [c.count for c in CSR_COUNTERS]
    got = grads(spmv)
    out["launches_per_call"] = dict(zip(("spmm", "spmm_t", "sddmm"), (
        c.count - before for c, before in zip(CSR_COUNTERS, counts))))
    want = grads(sparse_mod._spmv_plain)
    for name, a, b in zip(("out", "dx"), got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        out[f"{name}_max_abs_err"] = float(err.max())
        if not bool((err <= 2**-7 * b.abs() + 1e-5).all()):
            fails.append(f"{name} beyond one bfloat16 ulp of the plain version's")
    terms = (g.float().index_select(0, op.row) * x.float().index_select(0, op.col)).abs().sum(1)
    derr = (got[2] - want[2]).abs()
    out["dval_max_abs_err"] = float(derr.max())
    if not bool((derr <= 2**-7 * terms + 1e-6).all()):
        fails.append("dval beyond 2^-7 of its terms' magnitudes")
    del got, want, terms, derr
    if out["launches_per_call"] != {"spmm": 1, "spmm_t": 1, "sddmm": 1}:
        fails.append(f"launches of one call: {out['launches_per_call']}")
    fwd = device_kernels(lambda: spmv(op, x))
    xr = x.detach().requires_grad_()
    y = spmv(op, xr)
    bwd = device_kernels(lambda: y.backward(g))
    out["forward_kernels"], out["backward_kernels"] = fwd, bwd
    if len(fwd) != 1 or "spmm_csr_kernel" not in next(iter(fwd)):
        fails.append(f"a forward launched {fwd}, not the product kernel alone")
    if any("indexFunc" in k or "index_add" in k for k in bwd):
        fails.append(f"the backward ran an index_add: {bwd}")

    ptr_t = sparse_cuda.csr_transpose(op.row, op.col, op.val, op.col_perm, n)
    library = library_calls(op, n, x, g, ptr_t)
    timing = {
        "spmm": (lambda: sparse_cuda._launch_spmm(op.row_ptr, op.col, op.val, x,
                                                  sparse_cuda.spmm_launches),
                 lambda: sparse_mod._spmv_plain(op, x)),
        "spmm_t": (lambda: sparse_cuda._launch_spmm(*ptr_t, g, sparse_cuda.spmm_t_launches),
                   lambda: sparse_mod._EdgeGather.backward(
                       types.SimpleNamespace(saved_tensors=(op.col, op.col_perm), n=n),
                       sparse_mod._edge_scale(op.val.to(g.dtype),
                                              g.index_select(0, op.row)))),
        "sddmm": (lambda: sparse_cuda._launch_sddmm(op.row_ptr, op.col, g, x),
                  lambda: (g.index_select(0, op.row) * x.index_select(0, op.col)).sum(1)),
    }
    nbytes = spmm_bytes(n, n, e, f, x.element_size())
    for name, (kernel, plain) in timing.items():
        k_ms = cuda_ms(kernel, 20, 3)
        out[name] = {"kernel_ms": k_ms, "plain_ms": cuda_ms(plain, 1, 1),
                     "library_ms": library_ms(library[name], 5, 1)}
        for way in ("compulsory", "gathered"):
            bound = nbytes[way][name] / HBM_BYTES_PER_S * 1e3
            out[name].update({f"bound_ms_{way}": bound, f"bound_bytes_{way}": nbytes[way][name],
                              f"share_of_{way}_bound_pct": 100.0 * bound / k_ms})
    out["spmm_t"]["library_ms_transposed_tensor"] = library_ms(
        library["spmm_t_transposed_tensor"], 5, 1)
    for name, kernel in (("spmm", timing["spmm"][0]), ("spmm_t", timing["spmm_t"][0])):
        if isinstance(out[name]["library_ms"], float):  # the two answers' distance
            out[name]["library_max_abs_diff"] = float(
                (library[name]().float() - kernel().float()).abs().max())
    del library
    out["transpose_view_ms"] = cuda_ms(
        lambda: sparse_cuda.csr_transpose(op.row, op.col, op.val, op.col_perm, n), 10, 2)
    if fails:
        raise SmokeFailure(f"spmm_csr at {out['shape']}: " + "; ".join(fails))
    return out


CSR_COUNTERS = (sparse_cuda.spmm_launches, sparse_cuda.spmm_t_launches,
                sparse_cuda.sddmm_launches)
# the library's one-call route to each product, timed as library_ms
LIBRARY_ROUTES = {
    "spmm": "cuSPARSE SpMM: torch.sparse.mm on torch.sparse_csr_tensor(row_ptr, col, val)",
    "spmm_t": "cuSPARSE SpMM over the same transposed view (library_ms); on the CSR "
              "tensor's .t() (library_ms_transposed_tensor)",
    "sddmm": "cuSPARSE SDDMM: torch.sparse.sampled_addmm(csr, g, x.T, beta=0)",
}


def row_ranges(ptr: np.ndarray, chunk: int):
    """Consecutive ``(r0, r1)`` covering the rows of the CSR pointer
    ``ptr``, each of about ``chunk`` edges or one row."""
    n, r0 = len(ptr) - 1, 0
    while r0 < n:
        r1 = int(np.searchsorted(ptr, ptr[r0] + chunk, side="right")) - 1
        r1 = min(n, max(r1, r0 + 1))
        yield r0, r1
        r0 = r1


def heads_plain(op: SparseOp, p: torch.Tensor, x: torch.Tensor, g: torch.Tensor) -> tuple:
    """``ops/sparse.py:_attention_plain`` on the card, its output and the
    gradients of ``<out, g>`` in x and p, with each ``dval``'s terms'
    magnitudes ``Σ_d |g[row_e, h, d] x[col_e, h, d]|``, in pieces of
    about ``HEADS_PLAIN_EDGES`` edges: the forward over whole destination
    rows, the gradients over whole sources (``col_perm``'s order), so that
    every sum is the plain version's over all its edges."""
    n = op.n
    out, dx = torch.empty_like(x), torch.empty_like(x)
    dval, terms = torch.empty_like(p), torch.empty_like(p)
    ptr = op.row_ptr.cpu().numpy().astype(np.int64)
    with torch.no_grad():
        for r0, r1 in row_ranges(ptr, HEADS_PLAIN_EDGES):
            e0, e1 = int(ptr[r0]), int(ptr[r1])
            piece = SparseOp(row=op.row[e0:e1] - r0, col=op.col[e0:e1], val=op.val[e0:e1],
                             n=r1 - r0, rows_sorted=True)
            out[r0:r1] = sparse_mod._attention_plain(piece, p[e0:e1], x)
    perm = op.col_perm.long()
    cptr = csr_row_ptr(op.col.index_select(0, op.col_perm), n).cpu().numpy().astype(np.int64)
    for c0, c1 in row_ranges(cptr, HEADS_PLAIN_EDGES):
        ids = perm[int(cptr[c0]):int(cptr[c1])]
        row, col = op.row.index_select(0, ids), op.col.index_select(0, ids)
        piece = SparseOp(row=row, col=col - c0, val=op.val.index_select(0, ids), n=n)
        xs = x[c0:c1].detach().requires_grad_()
        ps = p.index_select(0, ids).requires_grad_()
        sparse_mod._attention_plain(piece, ps, xs).backward(g)
        dx[c0:c1], dval[ids] = xs.grad, ps.grad
        terms[ids] = (g.index_select(0, row).float() * x.index_select(0, col).float()
                      ).abs().sum(-1)
        del xs, ps, piece
    return out, dx, dval, terms


def heads_check(n: int, e: int, heads: int, d: int, dev) -> dict:
    """GAT's weighted sum ``attention_spmv`` (``sparse_cuda.csr_spmm_heads``:
    one launch of each kernel a head) at one head width of the cell, on a
    random operator of ``spmm_case`` with attention weights ``p [E, H]``
    (0 on dead edges), against its plain version on the same card inputs
    (``heads_plain``: the forward and ``dx`` within one bfloat16 ulp,
    ``dval`` within 2^-7 of its terms' magnitudes); the launches of one
    call; one head's kernels timed beside their two bounds, and the
    whole call forward and forward with backward."""
    op, x = spmm_case(n, e, heads * d, 0, dev)
    x = x.reshape(n, heads, d)
    gen = torch.Generator(dev).manual_seed(1)
    g = torch.randn(n, heads, d, generator=gen, device=dev).to(x.dtype)
    p = torch.rand(e, heads, generator=gen, device=dev) * (op.val != 0)[:, None]
    out, fails = {"shape": f"N={n} E={e} H={heads} D={d} bfloat16"}, []

    counts = [c.count for c in CSR_COUNTERS]
    pr, xr = p.detach().requires_grad_(), x.detach().requires_grad_()
    y = sparse_mod.attention_spmv(op, pr, xr)
    y.backward(g)
    got = (y.detach(), xr.grad, pr.grad)
    del y, pr, xr
    torch.cuda.synchronize()
    out["launches_per_call"] = dict(zip(("spmm", "spmm_t", "sddmm"), (
        c.count - before for c, before in zip(CSR_COUNTERS, counts))))
    if out["launches_per_call"] != {"spmm": heads, "spmm_t": heads, "sddmm": heads}:
        fails.append(f"launches of one call: {out['launches_per_call']}, not {heads} each")
    t0 = time.perf_counter()
    want = heads_plain(op, p, x, g)
    torch.cuda.synchronize()
    out["plain_pieces_s"] = time.perf_counter() - t0
    for name, a, b in zip(("out", "dx"), got, want):
        err = (a.float() - b.float()).abs()
        out[f"{name}_max_abs_err"] = float(err.max())
        if not bool((err <= 2**-7 * b.float().abs() + 1e-5).all()):
            fails.append(f"{name} beyond one bfloat16 ulp of the plain version's")
        del err
    derr = (got[2] - want[2]).abs()
    out["dval_max_abs_err"] = float(derr.max())
    if not bool((derr <= 2**-7 * want[3] + 1e-6).all()):
        fails.append("dval beyond 2^-7 of its terms' magnitudes")
    del got, want, derr
    torch.cuda.empty_cache()

    xh, gh = x.permute(1, 0, 2).contiguous(), g.permute(1, 0, 2).contiguous()
    w = p.to(x.dtype).to(torch.float32).t().contiguous()
    ptr_t = sparse_cuda.csr_transpose(op.row, op.col, w, op.col_perm, n)
    one_head = {
        "spmm": lambda: sparse_cuda._launch_spmm(op.row_ptr, op.col, w[0], xh[0],
                                                 sparse_cuda.spmm_launches),
        "spmm_t": lambda: sparse_cuda._launch_spmm(ptr_t[0], ptr_t[1], ptr_t[2][0], gh[0],
                                                   sparse_cuda.spmm_t_launches),
        "sddmm": lambda: sparse_cuda._launch_sddmm(op.row_ptr, op.col, gh[0], xh[0]),
    }
    nbytes = spmm_bytes(n, n, e, d, x.element_size())
    for name, kernel in one_head.items():
        k_ms = cuda_ms(kernel, 10, 2)
        out[name] = {"kernel_ms_a_head": k_ms}
        for way in ("compulsory", "gathered"):
            bound = nbytes[way][name] / HBM_BYTES_PER_S * 1e3
            out[name].update({f"bound_ms_{way}": bound, f"bound_bytes_{way}": nbytes[way][name],
                              f"share_of_{way}_bound_pct": 100.0 * bound / k_ms})
    del xh, gh, w, ptr_t, one_head
    pr, xr = p.detach().requires_grad_(), x.detach().requires_grad_()
    out["call_forward_ms"] = cuda_ms(lambda: sparse_mod.attention_spmv(op, p, x), 5, 1)
    out["call_forward_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
        sparse_mod.attention_spmv(op, pr, xr), (pr, xr), g), 3, 1)
    fwd = device_kernels(lambda: sparse_mod.attention_spmv(op, p, x))
    bwd = device_kernels(lambda: torch.autograd.grad(
        sparse_mod.attention_spmv(op, pr, xr), (pr, xr), g))
    out["forward_kernels"], out["forward_backward_kernels"] = fwd, bwd
    if sum(c for k, c in fwd.items() if "spmm_csr_kernel" in k) != heads:
        fails.append(f"a forward launched {fwd}, not the product kernel once a head")
    if any("indexFunc" in k or "index_add" in k for k in bwd):
        fails.append(f"the backward ran an index_add: {bwd}")
    if fails:
        raise SmokeFailure(f"csr_spmm_heads at {out['shape']}: " + "; ".join(fails))
    return out


def phase_spmm_kernel(dev, smi: str) -> tuple[dict, dict]:
    """The CSR product kernels at the main path's two shapes: the 10M
    LanczosNet's (10M nodes, 25M edges, F=32, 64-byte rows) and the wide
    GCN's (1M, 2.5M, F=256, 512-byte rows), both bfloat16; then GAT's
    heads at the ogbn-products cell's (2.45M nodes, 123.7M edges, 4
    heads of 128 and of 47: 256- and 94-byte rows). → (by F, by D)."""
    res, heads = {}, {}
    for n, e, f in SPMM_SHAPES:
        res[f] = spmm_shape_check(n, e, f, dev)
        emit("spmm_kernel", **res[f], nvidia_smi=smi)
        torch.cuda.empty_cache()
    n, e, h, widths = GAT_HEADS_SHAPE
    for d in widths:
        heads[d] = heads_check(n, e, h, d, dev)
        emit("spmm_heads", **heads[d], nvidia_smi=smi)
        torch.cuda.empty_cache()
    return res, heads


def plain_reference(pred: Predictor, chunk: list) -> np.ndarray:
    """The Predictor's model on the same packed chunk, fed the plain
    version's Ritz pairs on the card."""
    k = pred.num_eig_vec
    with torch.inference_mode():
        batch = pred.graph_batch(*pred._pack(chunk))
        alphas, betas, q, *_ = lanczos_tridiag_resid(batch.ops[:, 0], batch.mask, k, EPS)
        batch.ritz_val, batch.ritz_vec = ritz_from_tridiag(alphas, betas[:, : k - 1], q)
        return pred.model(batch).cpu().numpy()[: len(chunk)]


def stage_breakdown(pred: Predictor, chunk: list, reps: int = 20) -> dict:
    """Host-clock milliseconds of each stage of one request batch, each
    stage ended by a device synchronize (so they add up to more than an
    overlapped request)."""
    k = pred.num_eig_vec
    times = {"pack": [], "to_device_and_operators": [], "lanczos_kernel": [],
             "eigh_and_rotation": [], "model_forward": [], "fetch": []}

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name].append((t1 - t0) * 1e3)
        return t1

    with torch.inference_mode():
        for _ in range(reps):
            t = time.perf_counter()
            packed = pred._pack(chunk)
            t = mark("pack", t)
            batch = pred.graph_batch(*packed)
            t = mark("to_device_and_operators", t)
            alphas, betas, q, *_ = lanczos_cuda.lanczos_tridiag_cuda_resid(
                batch.ops[:, 0], batch.mask, k, EPS)
            t = mark("lanczos_kernel", t)
            batch.ritz_val, batch.ritz_vec = ritz_from_tridiag(alphas, betas[:, : k - 1], q)
            t = mark("eigh_and_rotation", t)
            out = pred.model(batch)
            t = mark("model_forward", t)
            out.cpu().numpy()
            mark("fetch", t)
    return {name: float(np.median(v)) for name, v in times.items()}


def phase_serve(dev, smi: str) -> int:
    cfg = {**FLAGSHIP_MODEL, "num_atom": NUM_ATOM, "num_task": NUM_TASK}
    model = build_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    k = cfg["num_eig_vec"]
    pred = Predictor(
        model, model.state_dict(), n_max=FLAGSHIP_DATASET["n_max"], batch_size=SERVE_BATCH,
        num_eig_vec=k, operator_kind=FLAGSHIP_DATASET["operator_kind"], num_task=NUM_TASK,
        device=dev,
    )
    pred.warmup()
    graphs = synthetic_qm8_graphs(NUM_REQUESTS, seed=2)
    want = np.concatenate([
        plain_reference(pred, graphs[lo: lo + SERVE_BATCH])
        for lo in range(0, NUM_REQUESTS, SERVE_BATCH)
    ])
    breakdown = stage_breakdown(pred, graphs[:SERVE_BATCH])

    futs = [None] * NUM_REQUESTS

    def client(c: int) -> None:
        mine = range(c, NUM_REQUESTS, NUM_CLIENTS)
        for i in mine:
            futs[i] = mb.submit(graphs[i])
        for i in mine:
            futs[i].result(timeout=300)

    lanczos_cuda.launches.reset()
    lanczos_cuda.stream_launches.reset()
    mb = MicroBatcher(pred, max_delay_ms=5.0)
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(NUM_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = lanczos_cuda.launches.count
        if any(t.is_alive() for t in clients):
            raise SmokeFailure("serving clients did not finish")
        got = np.stack([f.result(timeout=0) for f in futs])
        stats = mb.latency_stats()
    finally:
        mb.close()

    if got.shape != (NUM_REQUESTS, NUM_TASK) or not np.isfinite(got).all():
        raise SmokeFailure(f"served predictions are not finite [{NUM_REQUESTS}, {NUM_TASK}]")
    err = float(np.abs(got - want).max())
    emit(
        "serve", requests=NUM_REQUESTS, clients=NUM_CLIENTS, batch=SERVE_BATCH,
        seconds=wall, requests_per_s=NUM_REQUESTS / wall, latency=stats,
        max_abs_err_vs_plain_ritz=err, tol=TOL, output_abs_max=float(np.abs(got).max()),
        lanczos_launches=launches, stage_ms=breakdown, nvidia_smi=smi,
    )
    if err > TOL:
        raise SmokeFailure(f"served predictions differ from the plain-Ritz model by {err} > {TOL}")
    if launches < 1:
        raise SmokeFailure("the serving run never launched the Lanczos kernel")
    return launches


def qm8_stage_breakdown(model, optimizer, batch, valid, reps: int = 20) -> dict:
    """Host-clock milliseconds of each stage of one training step
    (dropout on), each stage ended by a device synchronize; medians."""
    times = {"forward": [], "loss": [], "backward": [], "optimizer": []}

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name].append((t1 - t0) * 1e3)
        return t1

    model.train()
    for _ in range(reps):
        optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred = model(batch)
        t = mark("forward", t)
        loss = weighted_mae(pred, batch.label, valid)
        t = mark("loss", t)
        loss.backward()
        t = mark("backward", t)
        optimizer.step()
        mark("optimizer", t)
    return {name: float(np.median(v)) for name, v in times.items()}


def read_metrics(run_dir: Path, rank: int = 0) -> list[dict]:
    """The events of ``metrics.jsonl`` (rank r > 0 of a sharded run:
    ``metrics.rank<r>.jsonl``)."""
    name = "metrics.jsonl" if rank == 0 else f"metrics.rank{rank}.jsonl"
    return [json.loads(ln) for ln in (run_dir / name).read_text().splitlines()]


def only_run_dir(exp_dir: Path, suffix: str) -> Path:
    runs = sorted(p for p in exp_dir.glob(f"*/*{suffix}") if p.is_dir())
    if len(runs) != 1:
        raise SmokeFailure(f"expected one run directory ending in {suffix}, found {runs}")
    return runs[0]


def phase_qm8_train(dev, smi: str, tmp: Path) -> tuple[int, Path, float]:
    """Train the flagship through the CLI in ``tmp``, test it with ``-t``,
    serve it with ``Predictor.from_run_dir``. Returns the shared-memory
    kernel's launches in the training run (the three packs, through the
    native packer), the run directory and the steady graphs/s."""
    cfg = config_io.loads(QM8_CONFIG.read_text())
    mcfg, dcfg, tcfg = cfg["model"], cfg["dataset"], cfg["train"]
    k, bs = int(mcfg["num_eig_vec"]), int(tcfg["batch_size"])
    tmp.mkdir(parents=True)
    cut = {"train.max_epoch": (tcfg["max_epoch"], QM8_EPOCHS),
           "exp_dir": (cfg.get("exp_dir"), str(tmp / "exp")),
           "dataset.pack_cache": (dcfg.get("pack_cache"), False)}
    tcfg["max_epoch"], cfg["exp_dir"], dcfg["pack_cache"] = (new for _, new in cut.values())
    copy = tmp / "qm8_lanczos_net.yaml"
    copy.write_text(config_io.dumps(cfg))

    lanczos_cuda.launches.reset()
    lanczos_cuda.stream_launches.reset()
    native.fallbacks.reset()
    t0 = time.perf_counter()
    rc = cli.main(["-c", str(copy)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lanczos_cuda.launches.count
    fallbacks = native.fallbacks.count
    if rc != 0:
        raise SmokeFailure(f"lanczosnet_torch.cli -c {copy} exited {rc}")
    if fallbacks or not native.available():
        raise SmokeFailure(f"the packs fell back from the native packer {fallbacks} times")
    run_dir = only_run_dir(tmp / "exp", "_train")
    recs = read_metrics(run_dir)
    losses = [r["loss"] for r in recs if r["event"] == "epoch"]
    gps = [r["graphs_per_sec"] for r in recs if r["event"] == "epoch"]
    val = [r["mae"] for r in recs if r["event"] == "val"]
    test_mae = [r["mae"] for r in recs if r["event"] == "test"]
    packs = {r["split"]: r for r in recs if r["event"] == "pack"}
    setup = [r for r in recs if r["event"] == "setup"]
    chunks = sum(-(-r["graphs"] // RITZ_CHUNK) for r in packs.values())

    # the packed test split's Ritz pairs against the plain version, in
    # the pack's own chunk (the split is one chunk of 256 graphs)
    test_graphs = synthetic_qm8_graphs(
        int(dcfg["num_test"]), seed=int(dcfg.get("seed", 7)) + 2,
        n_hi=min(int(dcfg["n_max"]), 28))
    lanczos_cuda.launches.reset()
    pack = pack_dataset(test_graphs, n_max=int(dcfg["n_max"]),
                        operator_kind=dcfg["operator_kind"], num_eig_vec=k, device=dev)
    pack_launches = lanczos_cuda.launches.count
    ritz_err = {"ritz_val": 0.0, "ritz_vec": 0.0}
    for lo in range(0, len(pack), RITZ_CHUNK):
        s = torch.from_numpy(pack.ops[lo: lo + RITZ_CHUNK, 0]).to(dev).contiguous()
        m = torch.from_numpy(pack.mask[lo: lo + RITZ_CHUNK]).to(dev)
        alphas, betas, q, *_ = lanczos_tridiag_resid(s, m, k, EPS)
        vals, vecs = ritz_from_tridiag(alphas, betas[:, : k - 1], q)
        for name, got in (("ritz_val", vals), ("ritz_vec", vecs)):
            want = torch.from_numpy(getattr(pack, name)[lo: lo + RITZ_CHUNK]).to(dev)
            ritz_err[name] = max(ritz_err[name], float((got - want).abs().max()))
        if max(ritz_err.values()) != 0.0:
            kern = lanczos_cuda.lanczos_tridiag_cuda_resid(s, m, k, EPS)
            tri = {o: float((a - b).abs().max()) for o, a, b in
                   zip(OUTPUTS[:3], kern[:3], (alphas, betas, q))}
            raise SmokeFailure(
                f"packed Ritz pairs differ from the plain version's: {ritz_err}; "
                f"kernel against plain version in alpha, beta, Q: {tri}")

    host_pack_s = host_pack_seconds(dcfg, dev)

    # -t on the best checkpoint
    best = run_dir / "checkpoints" / "best.pt"
    cfg["test"] = {**(cfg.get("test") or {}), "test_model": str(best)}
    copy_t = tmp / "qm8_lanczos_net_test.yaml"
    copy_t.write_text(config_io.dumps(cfg))
    rc_t = cli.main(["-c", str(copy_t), "-t"])
    if rc_t != 0:
        raise SmokeFailure(f"lanczosnet_torch.cli -c {copy_t} -t exited {rc_t}")
    retest = [r["mae"] for r in read_metrics(only_run_dir(tmp / "exp", "_test"))
              if r["event"] == "test"]

    # serve the run, against the restored model on the packed batches
    pred = Predictor.from_run_dir(run_dir, device=dev)
    mb = MicroBatcher(pred, max_delay_ms=5.0)
    try:
        futs = [mb.submit(g) for g in test_graphs]
        served = np.stack([f.result(timeout=300) for f in futs])
        serve_stats = mb.latency_stats()
    finally:
        mb.close()
    model = pred.model
    stats = pred.stats
    restored = []
    with torch.inference_mode():
        for lo in range(0, len(pack), bs):
            batch = pack.slice_batch(np.arange(lo, min(lo + bs, len(pack))))
            batch = to_device(batch, dev)
            restored.append(model(batch).cpu().numpy())
    restored = np.concatenate(restored) * stats.std + stats.mean
    serve_err = float(np.abs(served - restored).max())

    # one training step at batch 64, by stage, and a profile of 5 steps
    step_model = build_model({**mcfg, "num_atom": NUM_ATOM, "num_task": NUM_TASK})
    step_model.load_state_dict(Checkpointer.restore_file(best)["model"])
    step_model.to(dev)
    batch = to_device(pack.slice_batch(np.arange(bs)), dev)
    valid = torch.ones(bs, device=dev)
    optimizer, scheduler, clip = build_optimizer(
        step_model.parameters(), tcfg, int(dcfg["num_train"]) // bs)
    train_step = make_train_step(step_model, optimizer, scheduler, clip)
    step_ms = host_ms(lambda: train_step(batch, valid), 20, 3)
    stages = qm8_stage_breakdown(step_model, optimizer, batch, valid)
    trace = profile_train_steps(train_step, batch, valid, step_ms)

    flops = qm8_train_flops_per_graph(
        mcfg["hidden_dim"], int(dcfg["n_max"]), k, mcfg["short_diffusion_dist"],
        mcfg["long_diffusion_dist"], 4, NUM_TASK, int(mcfg["filter_hidden_dim"]))
    steady = float(np.median(gps[1:])) if len(gps) > 1 else float("nan")
    emit(
        "qm8_train", config=str(QM8_CONFIG.name), cut={k_: list(v) for k_, v in cut.items()},
        epochs=len(losses), seconds=wall, epoch_loss=losses, val_mae=val, test_mae=test_mae,
        retest_mae=retest, graphs_per_sec=gps, graphs_per_sec_steady=steady,
        flops_per_graph=flops, mfu=steady * flops / FP32_FLOPS_PER_S,
        mfu_peak="67 TFLOP/s, H100 SXM float32 outside the tensor cores (TF32 off)",
        pack_seconds={s_: r["seconds"] for s_, r in packs.items()}, setup_seconds=setup,
        native_fallbacks=fallbacks, host_pack_seconds=host_pack_s,
        lanczos_tridiag_launches=launches, ritz_chunks=chunks, test_pack_launches=pack_launches,
        packed_ritz_max_abs_err_vs_plain=ritz_err, served_max_abs_err_vs_restored=serve_err,
        serve_latency=serve_stats, tol=TOL, train_step_ms=step_ms, stage_ms=stages,
        profiler=trace, nvidia_smi=smi,
    )
    if len(losses) != QM8_EPOCHS or not np.isfinite(losses).all():
        raise SmokeFailure(f"epoch losses are not {QM8_EPOCHS} finite numbers: {losses}")
    if not losses[-1] < losses[0]:
        raise SmokeFailure(f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    if len(val) != QM8_EPOCHS or not np.isfinite(val).all() or len(test_mae) != 1 \
            or not np.isfinite(test_mae[0]):
        raise SmokeFailure(f"validation {val} or test MAE {test_mae} is not finite")
    if launches < chunks:
        raise SmokeFailure(
            f"the three packs ({chunks} chunks of {RITZ_CHUNK}) launched the kernel {launches} times")
    if len(retest) != 1 or abs(retest[0] - test_mae[0]) > 1e-6:
        raise SmokeFailure(f"-t gave test MAE {retest}, the training run {test_mae}")
    if served.shape != restored.shape or not (np.isfinite(served).all() and serve_err <= TOL):
        raise SmokeFailure(f"served answers differ from the restored model by {serve_err} > {TOL}")
    return launches, run_dir, steady


def host_pack_seconds(dcfg: dict, dev) -> dict:
    """The padding and operators of the flagship's three splits, by the
    native packer on the host and by the torch path on the card (each
    split's graphs drawn first, the card synchronized): seconds a split."""
    out = {}
    for i, split in enumerate(("train", "val", "test")):
        graphs = synthetic_qm8_graphs(int(dcfg[f"num_{split}"]), seed=int(dcfg.get("seed", 7)) + i,
                                      n_hi=min(int(dcfg["n_max"]), 28))
        t0 = time.perf_counter()
        native.pack_arrays(graphs, int(dcfg["n_max"]), kind=dcfg["operator_kind"])
        t1 = time.perf_counter()
        host = batch_graphs(graphs, int(dcfg["n_max"]))
        mask = torch.from_numpy(host["mask"]).to(dev)
        build_operator_stack(torch.from_numpy(host["adj"]).to(dev), mask,
                             kind=dcfg["operator_kind"]).cpu()
        out[split] = {"graphs": len(graphs), "native_s": t1 - t0,
                      "torch_s": time.perf_counter() - t1}
    return out


def qm8_config_copy(name: str, tmp: Path, extra: dict | None = None,
                    copy_name: str | None = None) -> tuple[Path, dict, dict]:
    """``configs/<name>.yaml`` with the phase's cuts (and ``extra`` keys
    set), written to ``tmp`` → (its path, the cut config, the cuts as
    {key: [was, now]})."""
    cfg = config_io.loads((QM8_CONFIG.parent / f"{name}.yaml").read_text())
    cut = {}
    for key, new in {**QM8_MODELS_CUT, "exp_dir": str(tmp / "exp"), **(extra or {})}.items():
        section, _, field = key.rpartition(".")
        where = cfg[section] if section else cfg
        cut[key] = [where.get(field), new]
        where[field] = new
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f"{copy_name or name}.yaml"
    path.write_text(config_io.dumps(cfg))
    return path, cfg, cut


def device_kernels(fn) -> dict[str, int]:
    """Launches by kernel name of one call of ``fn`` on the device, from a
    ``torch.profiler`` trace (user annotations left out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))}


def bf16_gemm_kernels(model, train_step, batch, valid, probe_calls: int = 8,
                      probe_traces: int = 3) -> dict:
    """The bfloat16 GEMM kernels of one training step: the kernels that a
    bfloat16 ``F.linear`` at the first layer's shape launches alone (with
    its cast operands made before the trace), found again in the trace
    of the step. Beside them, the step's ten most launched kernels.

    The probe traces ``probe_calls`` calls after one untraced call. A
    trace of a few microseconds of device work can come back from the
    profiler with no device event at all, although a bfloat16 GEMM
    always launches a kernel; such an empty trace is taken again, at
    most ``probe_traces`` times in all, and the number taken is kept."""
    layer = model.layers[0]
    rows = batch.mask.numel()
    x = torch.randn(rows, layer.in_features, device=batch.mask.device, dtype=torch.bfloat16)
    w, b = layer.weight.detach().bfloat16(), layer.bias.detach().bfloat16()

    def linear_calls():
        for _ in range(probe_calls):
            torch.nn.functional.linear(x, w, b)

    with bf16_f32_accumulation():
        torch.nn.functional.linear(x, w, b)
        for traces in range(1, probe_traces + 1):
            probe = device_kernels(linear_calls)
            if probe:
                break
    step = device_kernels(lambda: train_step(batch, valid))
    found = {name[:100]: step[name] for name in probe if name in step}
    top = sorted(step.items(), key=lambda kv: -kv[1])[:10]
    return {"bf16_gemm_kernels": found, "bf16_linear_probe_kernels": [k[:100] for k in probe],
            "bf16_linear_probe_traces": traces,
            "step_kernel_launches": sum(step.values()),
            "step_top_kernels": {k[:100]: v for k, v in top}}


def qm8_run(name: str, tmp: Path, dev, smi: str) -> dict:
    """Train one config of the qm8_models phase, check it, time it and
    serve it → its record (emitted as a ``qm8_model`` line)."""
    path, cfg, cut = qm8_config_copy(name, tmp)
    mcfg, dcfg, tcfg = cfg["model"], cfg["dataset"], cfg["train"]
    bs = int(tcfg["batch_size"])
    lanczos_cuda.launches.reset()
    lanczos_cuda.stream_launches.reset()
    t0 = time.perf_counter()
    if name == QM8_MODELS_CLI:
        rc = cli.main(["-c", str(path)])
        if rc != 0:
            raise SmokeFailure(f"lanczosnet_torch.cli -c {path} exited {rc}")
        run_dir = only_run_dir(tmp / "exp", "_train")
        pack_launches = None
    else:
        config = config_io.load_config(path)
        runner = build_runner(config, device=dev)
        pack_launches = lanczos_cuda.launches.count
        runner.train()
        run_dir = Path(config.save_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lanczos_cuda.launches.count
    stream_launches = lanczos_cuda.stream_launches.count
    recs = read_metrics(run_dir)
    losses = [r["loss"] for r in recs if r["event"] == "epoch"]
    gps = [r["graphs_per_sec"] for r in recs if r["event"] == "epoch"]
    val = [r["mae"] for r in recs if r["event"] == "val"]
    test_mae = [r["mae"] for r in recs if r["event"] == "test"]
    out = dict(config=f"{name}.yaml", run_dir=str(run_dir), cut=cut, epochs=len(losses),
               seconds=wall,
               epoch_loss=losses, val_mae=val, test_mae=test_mae, graphs_per_sec=gps,
               graphs_per_sec_median_epochs_1_2=float(np.median(gps[1:3])),
               lanczos_tridiag_launches=launches, lanczos_stream_launches=stream_launches,
               pack_launches=pack_launches)
    epochs = QM8_MODELS_CUT["train.max_epoch"]
    if len(losses) != epochs or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SmokeFailure(f"{name}: epoch losses {losses} are not {epochs} finite, falling numbers")
    if len(val) != epochs or not np.isfinite(val).all() or len(test_mae) != 1 \
            or not np.isfinite(test_mae[0]):
        raise SmokeFailure(f"{name}: validation {val} or test MAE {test_mae} is not finite")

    if name == QM8_MODELS_CLI:  # -t on the best checkpoint repeats the test MAE
        cfg_t = {**cfg, "test": {**(cfg.get("test") or {}),
                                 "test_model": str(run_dir / "checkpoints" / "best.pt")}}
        path_t = tmp / f"{name}_test.yaml"
        path_t.write_text(config_io.dumps(cfg_t))
        if cli.main(["-c", str(path_t), "-t"]) != 0:
            raise SmokeFailure(f"lanczosnet_torch.cli -c {path_t} -t failed")
        retest = [r["mae"] for r in read_metrics(only_run_dir(tmp / "exp", "_test"))
                  if r["event"] == "test"]
        out["retest_mae"] = retest
        if len(retest) != 1 or abs(retest[0] - test_mae[0]) > 1e-6:
            raise SmokeFailure(f"{name}: -t gave test MAE {retest}, the training run {test_mae}")

    # the packed test split, as the run packed it
    n_max = int(dcfg["n_max"])
    test_graphs = synthetic_qm8_graphs(int(dcfg["num_test"]), seed=int(dcfg.get("seed", 7)) + 2,
                                       n_hi=min(n_max, 28))
    pred = Predictor.from_run_dir(run_dir, device=dev)
    pack = pack_dataset(test_graphs, n_max=n_max, operator_kind=dcfg["operator_kind"],
                        num_eig_vec=pred.num_eig_vec, num_cluster=pred.num_cluster, device=dev)
    model = pred.model
    full = {**mcfg, "num_atom": NUM_ATOM, "num_task": NUM_TASK}

    # the trained model on the card against its state_dict on the CPU
    batch = pack.slice_batch(np.arange(bs))
    cpu_model = build_model(full)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode(), bf16_f32_accumulation():
        on_card = model.eval()(to_device(batch, dev)).cpu()
        on_cpu = cpu_model.eval()(batch)
        cpu_err = float((on_card - on_cpu).abs().max())
        if model.dtype == torch.float32:
            tol = TOL
        else:  # held against the float32 model with the same weights
            f32 = build_model({**full, "dtype": "float32"}).to(dev)
            f32.load_state_dict(model.state_dict())
            gap = float((on_card - f32.eval()(to_device(batch, dev)).cpu()).abs().max())
            out["bf16_vs_float32_on_card"] = gap
            tol = min(gap, BF16_TOL)
    out.update(card_vs_cpu_max_abs_err=cpu_err, card_vs_cpu_tol=tol)
    if not torch.isfinite(on_card).all() or cpu_err > tol:
        raise SmokeFailure(f"{name}: the card's predictions differ from the CPU's by {cpu_err} > {tol}")

    # served through MicroBatcher against the restored model on the packed batches
    if name == QM8_MODELS_CLI:
        clusters = np.concatenate([
            pred.graph_batch(*pred._pack(test_graphs[lo: lo + pred.batch_size])).cluster.cpu().numpy()
            for lo in range(0, len(test_graphs), pred.batch_size)])[: len(test_graphs)]
        out["served_partition_equals_packed"] = bool(np.array_equal(clusters, pack.cluster))
    launches_before = lanczos_cuda.launches.count
    mb = MicroBatcher(pred, max_delay_ms=5.0)
    try:
        served = np.stack([f.result(timeout=300) for f in [mb.submit(g) for g in test_graphs]])
        out["serve_latency"] = mb.latency_stats()
    finally:
        mb.close()
    out["serve_lanczos_tridiag_launches"] = lanczos_cuda.launches.count - launches_before
    with torch.inference_mode(), bf16_f32_accumulation():
        restored = np.concatenate([
            model(to_device(pack.slice_batch(np.arange(lo, min(lo + bs, len(pack)))), dev)).cpu().numpy()
            for lo in range(0, len(pack), bs)])
    restored = restored * pred.stats.std + pred.stats.mean
    serve_err = float(np.abs(served - restored).max())
    out["served_max_abs_err_vs_restored"] = serve_err
    if served.shape != restored.shape or not np.isfinite(served).all() or serve_err > TOL:
        raise SmokeFailure(f"{name}: served answers differ from the restored model by {serve_err} > {TOL}")

    # a training step at batch 64
    dev_batch = to_device(batch, dev)
    valid = torch.ones(bs, device=dev)
    if name == QM8_ADA:
        out.update(ada_kernel_vs_plain(model, dev_batch, valid))
    optimizer, scheduler, clip = build_optimizer(
        model.parameters(), tcfg, int(dcfg["num_train"]) // bs)
    train_step = make_train_step(model, optimizer, scheduler, clip)
    out["train_step_ms"] = host_ms(lambda: train_step(dev_batch, valid), 20, 3)
    out["profiler"] = profile_train_steps(train_step, dev_batch, valid, out["train_step_ms"],
                                          watch="lanczos" if name == QM8_ADA else None)
    if name == QM8_ADA:
        before = lanczos_cuda.launches.count
        train_step(dev_batch, valid)
        torch.cuda.synchronize()
        out["lanczos_tridiag_launches_one_step"] = lanczos_cuda.launches.count - before
        steps = epochs * (int(dcfg["num_train"]) // bs)
        out["train_steps"] = steps
        if out["lanczos_tridiag_launches_one_step"] < 1 or launches < steps:
            raise SmokeFailure(f"{name}: {steps} training steps launched the kernel {launches} times, "
                               f"one step {out['lanczos_tridiag_launches_one_step']}")
    if name == QM8_BF16:
        chunks = sum(-(-int(dcfg[f"num_{s_}"]) // RITZ_CHUNK) for s_ in ("train", "val", "test"))
        out["ritz_chunks"] = chunks
        out.update(bf16_gemm_kernels(model, train_step, dev_batch, valid))
        if pack_launches < chunks:
            raise SmokeFailure(f"{name}: {chunks} pack chunks launched the kernel {pack_launches} times")
        if not out["bf16_linear_probe_kernels"]:
            raise SmokeFailure(
                f"{name}: the profiler recorded no device kernel of a bfloat16 F.linear in "
                f"{out['bf16_linear_probe_traces']} traces")
        if not out["bf16_gemm_kernels"]:
            raise SmokeFailure(
                f"{name}: none of the bfloat16 GEMM's kernels {out['bf16_linear_probe_kernels']} "
                f"is in the profile of a step: {out['step_top_kernels']}")
    emit("qm8_model", **out, nvidia_smi=smi)
    return out


def ada_kernel_vs_plain(model, batch, valid) -> dict:
    """QM8 AdaLanczosNet on one 64-graph batch: eval-mode predictions and
    the ``kernel_embed`` gradient of the loss through the kernel and
    through the plain version on the card."""
    runs = {}
    try:
        for impl in ("kernel", "plain"):
            model.lanczos_impl = impl
            model.eval().zero_grad(set_to_none=True)
            pred = model(batch)
            weighted_mae(pred, batch.label, valid).backward()
            runs[impl] = pred.detach(), model.kernel_embed.weight.grad.clone()
    finally:
        model.lanczos_impl = "auto"
        model.zero_grad(set_to_none=True)
    pred_err = float((runs["kernel"][0] - runs["plain"][0]).abs().max())
    scale = float(runs["plain"][1].abs().max())
    grad_err = float((runs["kernel"][1] - runs["plain"][1]).abs().max()) / max(scale, 1e-30)
    if not (torch.isfinite(runs["kernel"][0]).all() and pred_err <= TOL):
        raise SmokeFailure(f"QM8 AdaLanczosNet: kernel and plain predictions differ by {pred_err}")
    if not (scale > 0 and grad_err <= TOL):
        raise SmokeFailure(f"QM8 AdaLanczosNet: kernel_embed gradients differ by {grad_err} of {scale}")
    return {"kernel_vs_plain_pred_max_abs_err": pred_err,
            "kernel_vs_plain_kernel_embed_grad_scaled_err": grad_err,
            "kernel_embed_grad_abs_max": scale}


def phase_qm8_models(dev, smi: str, tmp: Path) -> tuple[dict, dict]:
    """Every config of ``QM8_MODEL_CONFIGS`` trained in ``tmp``, checked
    and served → the shared-memory kernel's launches in each config's run,
    and each config's run directory, by config."""
    records = {}
    for name in QM8_MODEL_CONFIGS:
        (tmp / name).mkdir(parents=True)
        records[name] = qm8_run(name, tmp / name, dev, smi)
    emit("qm8_models", configs=list(records),
         graphs_per_sec={n: r["graphs_per_sec_median_epochs_1_2"] for n, r in records.items()},
         train_step_ms={n: r["train_step_ms"] for n, r in records.items()},
         launches_per_step={n: r["profiler"].get("kernel_launches_per_step")
                            for n, r in records.items()},
         device_busy_ms_per_step={n: r["profiler"].get("device_busy_ms_per_step")
                                  for n, r in records.items()},
         test_mae={n: r["test_mae"][0] for n, r in records.items()}, nvidia_smi=smi)
    return ({n: r["lanczos_tridiag_launches"] for n, r in records.items()},
            {n: Path(r["run_dir"]) for n, r in records.items()})


def bucketed_ritz_vs_plain(cfg: dict, dev) -> tuple[dict, dict]:
    """The run's test split packed in its buckets on the card, each
    bucket's Ritz pairs against the plain version's on its packed
    operators (one chunk a bucket) → ({bound: [graphs, max abs error]},
    the packs)."""
    dcfg, k = cfg["dataset"], int(cfg["model"]["num_eig_vec"])
    graphs = synthetic_qm8_graphs(int(dcfg["num_test"]), seed=int(dcfg.get("seed", 7)) + 2,
                                  n_hi=min(int(dcfg["n_max"]), 28))
    packs, _ = pack_dataset_bucketed(graphs, dcfg["buckets"], standardize=True, num_eig_vec=k,
                                     device=dev)
    out = {}
    for bound, ds in packs.items():
        s = torch.from_numpy(ds.ops[:, 0]).to(dev).contiguous()
        m = torch.from_numpy(ds.mask).to(dev)
        alphas, betas, q, *_ = lanczos_tridiag_resid(s, m, k, EPS)
        vals, vecs = ritz_from_tridiag(alphas, betas[:, : k - 1], q)
        err = max(float((vals.cpu() - torch.from_numpy(ds.ritz_val)).abs().max()),
                  float((vecs.cpu() - torch.from_numpy(ds.ritz_vec)).abs().max()))
        out[bound] = [len(ds), err]
    return out, packs


def first_pair_step(cfg: dict, packs: dict, dev) -> dict:
    """One paired step of the flagship at full width (dropout 0, weights
    from the run's seed) on half-batches of the two smallest buckets, on
    the card and on the CPU from the same packed arrays → both losses."""
    mcfg = {**cfg["model"], "dropout": 0.0, "num_atom": NUM_ATOM, "num_task": NUM_TASK}
    half = int(cfg["train"]["batch_size"]) // 2
    (ba, da), (bb, db) = list(packs.items())[:2]
    losses = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(mcfg)
        model.init_weights(torch.Generator().manual_seed(int(cfg["seed"])))
        model.to(where)
        optimizer, scheduler, clip = build_optimizer(model.parameters(), cfg["train"], 1)
        step = make_pair_step(model, optimizer, scheduler, clip)
        rows_a, rows_b = np.arange(min(half, len(da))), np.arange(min(half, len(db)))
        loss = step(to_device(da.slice_batch(rows_a), where), len(rows_a),
                    to_device(db.slice_batch(rows_b), where), len(rows_b))
        losses[name] = float(loss)
    return {"buckets": [ba, bb], "half": half, **losses,
            "abs_diff": abs(losses["card"] - losses["cpu"])}


def phase_qm8_buckets(dev, smi: str, tmp: Path, unbucketed_gps: float) -> int:
    """The flagship at full width in size buckets [16, 24, 32] with paired
    steps, ``train.profile`` and ``train.tensorboard``, at the qm8_models
    cut, through the CLI; ``-t``; one chunk-interleaved epoch without
    pairing. Returns the shared-memory kernel's launches of the run (its
    nine bucket packs)."""
    path, cfg, cut = qm8_config_copy("qm8_lanczos_net", tmp, QM8_BUCKETS_SET)
    lanczos_cuda.launches.reset()
    native.fallbacks.reset()
    t0 = time.perf_counter()
    rc = cli.main(["-c", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lanczos_cuda.launches.count
    fallbacks = native.fallbacks.count
    if rc != 0:
        raise SmokeFailure(f"lanczosnet_torch.cli -c {path} exited {rc}")
    run_dir = only_run_dir(tmp / "exp", "_train")
    recs = read_metrics(run_dir)
    epochs = [r for r in recs if r["event"] == "epoch"]
    losses = [r["loss"] for r in epochs]
    test_mae = [r["mae"] for r in recs if r["event"] == "test"]
    buckets = {r["split"]: r["buckets"] for r in recs if r["event"] == "pack"}

    # -t on the best checkpoint
    cfg_t = {**cfg, "test": {**(cfg.get("test") or {}),
                             "test_model": str(run_dir / "checkpoints" / "best.pt")}}
    path_t = tmp / "qm8_lanczos_net_buckets_test.yaml"
    path_t.write_text(config_io.dumps(cfg_t))
    if cli.main(["-c", str(path_t), "-t"]) != 0:
        raise SmokeFailure(f"lanczosnet_torch.cli -c {path_t} -t failed")
    retest = [r["mae"] for r in read_metrics(only_run_dir(tmp / "exp", "_test"))
              if r["event"] == "test"]

    # one chunk-interleaved epoch, without pairing, profiling or the mirror
    path_c, _, _ = qm8_config_copy(
        "qm8_lanczos_net", tmp / "chunked",
        {**QM8_BUCKETS_SET, "train.bucket_pair": False, "train.profile": False,
         "train.tensorboard": False, "train.max_epoch": 1})
    if cli.main(["-c", str(path_c)]) != 0:
        raise SmokeFailure(f"lanczosnet_torch.cli -c {path_c} exited non-zero")
    chunked = [r for r in read_metrics(only_run_dir(tmp / "chunked" / "exp", "_train"))
               if r["event"] == "epoch"]

    busy = device_busy_seconds(run_dir / "trace")
    tb_files = sorted(p.name for p in (run_dir / "tb").glob("*")) if (run_dir / "tb").exists() \
        else []
    ritz, packs = bucketed_ritz_vs_plain(cfg, dev)
    pair = first_pair_step(cfg, packs, dev)
    emit("qm8_buckets", config="qm8_lanczos_net.yaml", cut=cut, seconds=wall,
         graphs_per_bucket=buckets, epoch_loss=losses, test_mae=test_mae, retest_mae=retest,
         epoch_time_s=[r["epoch_time_s"] for r in epochs],
         graphs_per_sec=[r["graphs_per_sec"] for r in epochs],
         chunked_epoch_time_s=[r["epoch_time_s"] for r in chunked],
         chunked_graphs_per_sec=[r["graphs_per_sec"] for r in chunked],
         unbucketed_flagship_graphs_per_sec=unbucketed_gps, lanczos_tridiag_launches=launches,
         native_fallbacks=fallbacks, trace_device_busy_s=busy,
         tensorboard_writer_made=bool(tb_files), tensorboard_files=tb_files,
         packed_ritz_vs_plain=ritz, first_pair_step=pair, pair_step_tol=PAIR_STEP_TOL,
         nvidia_smi=smi)
    n = QM8_MODELS_CUT["train.max_epoch"]
    if len(losses) != n or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SmokeFailure(f"qm8_buckets: epoch losses {losses} are not {n} finite, falling "
                           "numbers")
    if len(buckets.get("train", {})) < 2 or len(test_mae) != 1 or not np.isfinite(test_mae[0]):
        raise SmokeFailure(f"qm8_buckets: buckets {buckets} or test MAE {test_mae}")
    if len(retest) != 1 or abs(retest[0] - test_mae[0]) > 1e-6:
        raise SmokeFailure(f"qm8_buckets: -t gave test MAE {retest}, the run {test_mae}")
    if len(chunked) != 1 or not np.isfinite(chunked[0]["loss"]):
        raise SmokeFailure(f"qm8_buckets: the chunk-interleaved epoch gave {chunked}")
    if not (run_dir / "trace").is_dir() or not busy:
        raise SmokeFailure(f"qm8_buckets: the trace of the first epoch shows no device time "
                           f"({busy})")
    if any(err != 0.0 for _, err in ritz.values()) or 16 not in ritz:
        raise SmokeFailure(f"qm8_buckets: packed Ritz pairs against the plain version: {ritz}")
    if not pair["abs_diff"] <= PAIR_STEP_TOL:
        raise SmokeFailure(f"qm8_buckets: the first paired step, card against CPU: {pair}")
    if fallbacks or launches < 3 * len(QM8_BUCKET_BOUNDS):
        raise SmokeFailure(f"qm8_buckets: {launches} kernel launches for the bucket packs, "
                           f"{fallbacks} native fallbacks")
    return launches


DRYRUN_RANKS = 4


def phase_dryrun(smi: str) -> int:
    """``python -m lanczosnet_torch.dryrun --ranks 4``, the ranks sharing
    the card over gloo. Returns the shared-memory kernel's launches over
    its ranks (their packs and the export round trip)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lanczosnet_torch.dryrun", "--ranks",
                           str(DRYRUN_RANKS)], capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    found = [json.loads(ln)["dryrun"] for ln in lines if ln.startswith('{"dryrun"')]
    ok = [ln for ln in lines if ln.startswith(f"dryrun({DRYRUN_RANKS}): ok")]
    result = found[-1] if found else {}
    emit("dryrun", ranks=DRYRUN_RANKS, exit_code=proc.returncode, seconds=wall, result=result,
         ok_line=ok[-1] if ok else None, nvidia_smi=smi)
    if proc.returncode != 0 or not ok or not result:
        raise SmokeFailure(f"lanczosnet_torch.dryrun --ranks {DRYRUN_RANKS} exited "
                           f"{proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    if result["devices"] != ["cuda:0"] * DRYRUN_RANKS:
        raise SmokeFailure(f"dryrun: the ranks ran on {result['devices']}, not all on cuda:0")
    if result["export_roundtrip_max_err"] != 0.0:
        raise SmokeFailure(f"dryrun: the artifact reads {result['export_roundtrip_max_err']}")
    return int(result["lanczos_launches"])


def client_calls(port: int, jobs: list[tuple[str, bytes]], clients: int) -> tuple[float, list, list]:
    """``jobs`` (path, body) POSTed to ``127.0.0.1:port`` by ``clients``
    threads, each on one keep-alive connection, job i by thread i mod
    ``clients`` → (wall seconds, [(status, body)] by job, client-side
    latencies in ms)."""
    out, lat, errors = [None] * len(jobs), [None] * len(jobs), []

    def client(c: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i in range(c, len(jobs), clients):
                t0 = time.perf_counter()
                conn.request("POST", jobs[i][0], body=jobs[i][1])
                resp = conn.getresponse()
                out[i] = (resp.status, resp.read())
                lat[i] = (time.perf_counter() - t0) * 1e3
        except Exception as exc:  # reported below, as the phase's failure
            errors.append(repr(exc))
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads) or any(o is None for o in out):
        raise SmokeFailure(f"front clients failed: {errors[:3]}")
    return wall, out, lat


def latency_summary(lat: list) -> dict:
    lat = np.asarray(lat, np.float64)
    return {"p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "mean_ms": float(lat.mean())}


def json_body(graphs: list) -> bytes:
    return json.dumps({"graphs": [{"atom_type": np.asarray(g["atom_type"]).tolist(),
                                   "adj": np.asarray(g["adj"]).tolist()} for g in graphs]}).encode()


def read_http_responses(sock, count: int) -> list[tuple[int, bytes]]:
    """``count`` HTTP responses read in order from ``sock``."""
    buf, out = b"", []
    for _ in range(count):
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise SmokeFailure(f"the native front closed after {len(out)} of {count} answers")
            buf += chunk
        head, buf = buf.split(b"\r\n\r\n", 1)
        lines = head.split(b"\r\n")
        length = int(next(h for h in lines if h.lower().startswith(b"content-length"))
                     .split(b":")[1])
        while len(buf) < length:
            chunk = sock.recv(65536)
            if not chunk:
                raise SmokeFailure("the native front closed inside an answer")
            buf += chunk
        out.append((int(lines[0].split()[1]), buf[:length]))
        buf = buf[length:]
    return out


def front_answers(out: list, wires: list) -> np.ndarray:
    """The predictions of a front's answers, each decoded by its wire."""
    bad = [(i, st, body[:120]) for i, (st, body) in enumerate(out) if st != 200]
    if bad:
        raise SmokeFailure(f"{len(bad)} front requests failed, e.g. {bad[:2]}")
    return np.concatenate([serve_native.decode_predictions_binary(body) if wire == "lng1"
                           else np.asarray(json.loads(body)["predictions"], np.float32)
                           for (_, body), wire in zip(out, wires)])


def phase_serve_fronts(dev, smi: str, flagship_run: Path, gpnn_run: Path, tmp: Path) -> dict:
    """Serve the flagship's and GPNN's trained runs by name through the
    stdlib HTTP front and the native front, then export the flagship and
    serve the artifact. Returns the shared-memory kernel's launches of
    each path."""
    built = serve_native.build_front()
    emit("build", front="lanczosnet_torch/native/servefront.cc", seconds=built.seconds,
         library=built.path.name, log=built.log.splitlines())
    runs = {"lnet": flagship_run, "gpnn": gpnn_run}
    refs = {name: Predictor.from_run_dir(run, batch_size=SERVE_BATCH, device=dev)
            for name, run in runs.items()}
    graphs = synthetic_qm8_graphs(FRONT_REQUESTS, seed=5)
    names = ["lnet" if i % 2 == 0 else "gpnn" for i in range(FRONT_REQUESTS)]

    def reference(idx) -> np.ndarray:
        out = np.zeros((len(idx), NUM_TASK), np.float32)
        for name, pred in refs.items():
            mine = [j for j, i in enumerate(idx) if names[i] == name]
            if mine:
                out[mine] = pred.predict([graphs[idx[j]] for j in mine])
        return out

    want = reference(range(FRONT_REQUESTS))
    srv = ModelServer.from_run_dirs(runs, batch_size=SERVE_BATCH, device=dev)
    record, launches = {}, {}
    try:
        # the stdlib HTTP front, JSON
        httpd = make_http_server(srv)
        serve_forever_in_thread(httpd)
        port = httpd.server_address[1]
        try:
            jobs = [(f"/v1/models/{names[i]}:predict", json_body([g])) for i, g in enumerate(graphs)]
            lanczos_cuda.launches.reset()
            wall, out, lat = client_calls(port, jobs, FRONT_CLIENTS)
            launches["serve_http"] = lanczos_cuda.launches.count
            got = front_answers(out, ["json"] * len(jobs))
            bad = {label: client_calls(port, [("/v1/models/lnet:predict", body)], 1)[1][0]
                   for label, body in (("non_object_body", b"[1, 2]"),
                                       ("bad_graph", b'{"graphs": [{"adj": [[0, 1], [1, 0]]}]}'))}
        finally:
            httpd.shutdown()
            httpd.server_close()
        err = float(np.abs(got - want).max())
        record["http"] = dict(requests=len(jobs), clients=FRONT_CLIENTS, seconds=wall,
                              requests_per_s=len(jobs) / wall, client_latency=latency_summary(lat),
                              server_latency={n: srv.stats(n) for n in runs},
                              max_abs_err_vs_from_run_dir=err,
                              lanczos_tridiag_launches=launches["serve_http"],
                              status_of_bad_bodies={k: v[0] for k, v in bad.items()})
        emit("serve_fronts_http", **record["http"], tol=TOL, nvidia_smi=smi)
        if not np.isfinite(got).all() or err > TOL:
            raise SmokeFailure(f"HTTP front answers differ from Predictor.from_run_dir by {err} > {TOL}")
        if launches["serve_http"] < 1:
            raise SmokeFailure("the HTTP front's requests never launched the Lanczos kernel")
        if any(v[0] != 400 for v in bad.values()):
            raise SmokeFailure(f"bad bodies were not answered 400: {bad}")

        # the native front, each of half the graphs on both wires
        front = serve_native.NativeFront(srv)
        try:
            half = FRONT_REQUESTS // 2
            idx = [i // 2 for i in range(FRONT_REQUESTS)]
            wires = ["json" if i % 2 == 0 else "lng1" for i in range(FRONT_REQUESTS)]
            jobs = [(f"/v1/models/{names[j]}:predict",
                     json_body([graphs[j]]) if w == "json"
                     else serve_native.encode_graphs_binary([graphs[j]]))
                    for j, w in zip(idx, wires)]
            lanczos_cuda.launches.reset()
            wall, out, lat = client_calls(front.port, jobs, FRONT_CLIENTS)
            launches["serve_native"] = lanczos_cuda.launches.count
            got = front_answers(out, wires)
            transcoded = front.transcoded()
            # pipelined on one keep-alive connection: a two-batch request,
            # an inline GET, a 400 and a small request, answered in order
            lnet_idx = [i for i in range(FRONT_REQUESTS) if names[i] == "lnet"][:100]
            body = serve_native.encode_graphs_binary([graphs[i] for i in lnet_idx])
            sock = socket.create_connection(("127.0.0.1", front.port), timeout=300)
            try:
                sock.sendall(b"".join(
                    b"%s %s HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n%s"
                    % (method, path, len(b), b) for method, path, b in (
                        (b"POST", b"/v1/models/lnet:predict", body),
                        (b"GET", b"/healthz", b""),
                        (b"POST", b"/v1/models/lnet:predict", b"[]"),
                        (b"POST", b"/v1/models/lnet:predict", json_body([graphs[lnet_idx[0]]])))))
                piped = read_http_responses(sock, 4)
            finally:
                sock.close()
        finally:
            front.close()
        want_native = want[idx]
        err = float(np.abs(got - want_native).max())
        wire_gap = float(np.abs(got[0::2] - got[1::2]).max())
        piped_status = [st for st, _ in piped]
        piped_err = float(np.abs(serve_native.decode_predictions_binary(piped[0][1])
                                 - want[lnet_idx]).max()) if piped_status[0] == 200 else None
        record["native"] = dict(requests=len(jobs), graphs=half, clients=FRONT_CLIENTS,
                                seconds=wall, requests_per_s=len(jobs) / wall,
                                client_latency=latency_summary(lat), transcoded=transcoded,
                                max_abs_err_vs_from_run_dir=err, json_vs_lng1_max_abs_gap=wire_gap,
                                pipelined_status=piped_status, pipelined_max_abs_err=piped_err,
                                lanczos_tridiag_launches=launches["serve_native"])
        emit("serve_fronts_native", **record["native"], tol=TOL, nvidia_smi=smi)
        if not np.isfinite(got).all() or err > TOL or wire_gap > TOL:
            raise SmokeFailure(f"native front answers differ: {err} from Predictor.from_run_dir, "
                               f"{wire_gap} between the wires (> {TOL})")
        if transcoded < 1 or launches["serve_native"] < 1:
            raise SmokeFailure(f"native front: {transcoded} bodies transcoded, "
                               f"{launches['serve_native']} kernel launches")
        if piped_status != [200, 200, 400, 200] or piped_err is None or piped_err > TOL:
            raise SmokeFailure(f"pipelined answers out of order or wrong: {piped_status}, {piped_err}")
    finally:
        srv.close()

    # export the flagship on the card and serve the artifact
    pred = refs["lnet"]
    t0 = time.perf_counter()
    art = export_predictor(pred, tmp / "artifact")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_predictor(art, device=dev)
    load_s = time.perf_counter() - t0
    lnet_graphs = [graphs[i] for i in range(FRONT_REQUESTS) if names[i] == "lnet"]
    want_lnet = pred.predict(lnet_graphs)
    torch.backends.cuda.matmul.allow_tf32 = True  # the artifact pins float32 itself
    try:
        got = loaded.predict(lnet_graphs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = float(np.abs(got - want_lnet).max())
    srv = ModelServer.from_run_dirs({"artifact": art}, batch_size=SERVE_BATCH, device=dev)
    try:
        lanczos_cuda.launches.reset()
        served = srv.predict("artifact", lnet_graphs)
        launches["artifact"] = lanczos_cuda.launches.count
        art_stats = srv.stats("artifact")
    finally:
        srv.close()
    served_err = float(np.abs(served - want_lnet).max())
    # in-process request rate of the two predictors, in turns, on one card
    bench = synthetic_qm8_graphs(NUM_REQUESTS, seed=6)
    rates = {"predictor": [], "artifact": []}
    for who in ("predictor", "artifact", "artifact", "predictor"):
        p_ = pred if who == "predictor" else loaded
        t0 = time.perf_counter()
        p_.predict(bench)
        rates[who].append(NUM_REQUESTS / (time.perf_counter() - t0))
    record["artifact"] = dict(export_seconds=export_s, load_seconds=load_s,
                              files=sorted(f.name for f in art.iterdir()),
                              max_abs_err_vs_predictor_tf32_on=tf32_err,
                              served_max_abs_err_vs_predictor=served_err,
                              served_latency=art_stats,
                              lanczos_tridiag_launches=launches["artifact"],
                              in_process_requests_per_s=rates, in_process_requests=NUM_REQUESTS)
    emit("serve_fronts_artifact", **record["artifact"], tol=ARTIFACT_TOL, nvidia_smi=smi)
    if not np.isfinite(got).all() or tf32_err > ARTIFACT_TOL or served_err > ARTIFACT_TOL:
        raise SmokeFailure(f"the artifact's answers differ from the Predictor's by {tf32_err} "
                           f"(TF32 on) and {served_err} (served) > {ARTIFACT_TOL}")
    if launches["artifact"] < 1:
        raise SmokeFailure("the served artifact never launched the Lanczos kernel")
    return launches


def citation_config(save_dir: str) -> dict:
    """The whole of ``configs/cora_ada_lanczos_net.yaml`` as a mapping,
    with the depth cut to ``CITATION_EPOCHS`` and every epoch logged."""
    return {
        "exp_name": "cora_ada_lanczos_net",
        "runner": "CitationRunner",
        "seed": CORA_ADA_SEED,
        "save_dir": save_dir,
        "dataset": dict(CORA_ADA_DATASET),
        "model": dict(CORA_ADA_MODEL),
        "train": {**CORA_ADA_TRAIN, "max_epoch": CITATION_EPOCHS, "display_iter": 1},
        "test": {"test_model": None},
    }


def phase_barrier(dev) -> dict:
    """What a grid barrier of the streamed kernel's cooperative launch
    costs: launches of 1200 barriers against launches of none, back to
    back as the kernels are timed, on the grid the citation shape gets
    and on one block for every SM; and what an empty launch of the
    serving kernel's shape (64 blocks of one warp) costs."""
    k = CORA_ADA_MODEL["num_eig_vec"]
    plan = lanczos_cuda.stream_plan(1, CORA_SHAPE[0], k, dev.index)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    count = 1200
    threads = lanczos_cuda.STREAM_THREADS

    def probe_ms(grid, threads, barriers):
        return cuda_ms(lambda: lanczos_cuda.launch_barrier_probe(grid, threads, barriers, dev), 100, 10)

    out = {}
    for grid in sorted({plan.grid, sms}):
        empty = probe_ms(grid, threads, 0)
        full = probe_ms(grid, threads, count)
        out[grid] = dict(grid=grid, threads=threads, barriers=count,
                         empty_launch_ms=empty, barrier_us=(full - empty) / count * 1e3)
        emit("barrier", **out[grid])
    small = dict(grid=SERVE_BATCH, threads=32, empty_launch_ms=probe_ms(SERVE_BATCH, 32, 0))
    emit("empty_launch", **small)
    return {**out[plan.grid], "small_launch_ms": small["empty_launch_ms"]}


def stream_cases(dev, runner: CitationRunner) -> dict:
    rng = np.random.default_rng(7)
    cases = {}

    def put(name, s, mask, k):
        cases[name] = (torch.as_tensor(s).to(dev), torch.as_tensor(mask).to(dev), k)

    s, mask = spd_case(rng, 2, 300, [300, 200])
    put("spd-n300-k8", s * (1.0 / 3.0), mask, 8)
    s, mask = spd_case(rng, 1, 130, [3])
    put("n130-3-real-nodes-k8", s, mask, 8)
    put("zero-graph-n256-k6", torch.zeros(2, 256, 256), torch.ones(2, 256), 6)
    s, mask = spd_case(rng, 2, 129, [129, 70])
    put("spd-n129-k64", s * 0.5, mask, 64)
    # 40 graphs of 9 chunks each and of different real sizes: more (graph,
    # chunk) pairs than the card has SMs, so a block owns several
    s, mask = spd_case(rng, 40, 520, [520 - 13 * i for i in range(40)])
    put("b40-n520-k12-several-chunks-a-block", s * 0.2, mask, 12)
    # 600 graphs at K=64: more pairs than fit the blocks' shared memory, so
    # the graphs go in two launches
    s, mask = spd_case(rng, 600, 160, [160 - (i % 158) for i in range(600)])
    put("b600-n160-k64-two-launches", s * 0.4, mask, 64)
    # the largest graph the kernel takes; S is 1.07 GB, made on the card
    gen = torch.Generator(device=dev).manual_seed(11)
    big = torch.randn(16384, 16384, device=dev, generator=gen) * 0.004
    big = (0.5 * (big + big.T))[None].contiguous()
    cases["spd-n16384-k3"] = (big, torch.ones(1, 16384, device=dev), 3)
    k = CORA_ADA_MODEL["num_eig_vec"]
    model, batch = runner.model.eval(), runner.batch
    with torch.no_grad():
        h = model.encoder(batch.atom_type, batch.node_feat, batch.mask)
        s_cora = model.learned_operator(h, batch).contiguous()
    cases["cora-learned-operator-n2708-k20"] = (s_cora, batch.mask, k)
    return cases


def phase_stream_kernel(dev, runner: CitationRunner, barrier: dict) -> dict:
    cases = stream_cases(dev, runner)
    worst = 0.0
    plans = {}
    for name in list(cases):
        s, mask, kk = cases[name]
        before = lanczos_cuda.stream_launches.count
        got = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, kk, EPS)
        torch.cuda.synchronize()
        plans[name] = lanczos_cuda.stream_plan(s.shape[0], s.shape[1], kk, dev.index)
        if lanczos_cuda.stream_launches.count != before + plans[name].launches:
            raise SmokeFailure(f"{name}: the wrapper did not launch the streamed kernel "
                               f"{plans[name].launches} time(s)")
        want = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, kk, EPS, impl="plain")
        torch.cuda.synchronize()
        emit("stream_plan", case=name, **vars(plans[name]))
        worst = max(worst, compare_outputs(name, s, kk, got, want))
        if not name.startswith("cora"):
            del cases[name], got, want  # the large cases give their memory back
    if plans["b40-n520-k12-several-chunks-a-block"].slots < 2:
        raise SmokeFailure("no case made a block own several chunks")
    if plans["b600-n160-k64-two-launches"].launches < 2:
        raise SmokeFailure("no case needed more than one launch")

    s_cora, mask, k = cases["cora-learned-operator-n2708-k20"]
    b, n, _ = s_cora.shape
    q, part, *outs = lanczos_cuda.stream_buffers(b, n, k, dev)
    q[:, 0] = lanczos_start_vector(mask, EPS)
    before = lanczos_cuda.stream_launches.count
    lanczos_cuda.launch_stream(s_cora, q, part, tuple(outs), k, EPS)
    device_launches = lanczos_cuda.stream_launches.count - before
    kernel_ms = cuda_ms(lambda: lanczos_cuda.launch_stream(s_cora, q, part, tuple(outs), k, EPS), 50, 5)
    # what the 56 calls back to back left in the buffers, against the plain
    # version: a barrier or scratch whose state leaked from call to call
    # would show here
    torch.cuda.synchronize()
    alphas, betas, p1, p2, w4 = outs
    want = lanczos_tridiag_resid_stream(s_cora, mask, k, EPS)
    worst = max(worst, compare_outputs("cora-after-the-timing-loop", s_cora, k,
                                       (alphas, betas, q, p1, p2, w4), want))
    # the same with the 50 MB L2 cache overwritten before each call
    flush = torch.empty(64 * 1024 * 1024, device=dev)
    cold = []
    for _ in range(10):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lanczos_cuda.launch_stream(s_cora, q, part, tuple(outs), k, EPS)
        end.record()
        end.synchronize()
        cold.append(start.elapsed_time(end))
    plain_ms = cuda_ms(lambda: lanczos_tridiag_resid_stream(s_cora, mask, k, EPS), 3, 1)
    plan = plans["cora-learned-operator-n2708-k20"]
    barriers = 6 * k - 1  # the kernel's schedule: six a step, none after the last
    timing = dict(kernel_ms=kernel_ms, kernel_ms_l2_flushed=float(np.median(cold)),
                  plain_ms=plain_ms, device_launches_per_call=device_launches,
                  grid=plan.grid, threads=lanczos_cuda.STREAM_THREADS,
                  barriers_per_call=barriers, barrier_us=barrier["barrier_us"],
                  barriers_ms=barriers * barrier["barrier_us"] * 1e-3,
                  **latency_floor_ms(stream_links(n, k), barrier["empty_launch_ms"]),
                  **lanczos_stream_bound(b, n, k))
    emit("kernel_time", kernel="lanczos_stream", batch=b, n=n, k=k, **timing,
         recorded_ms_before_redesign=RECORDED_MS_BEFORE_REDESIGN["lanczos_stream"])
    return {"max_abs_err": worst, "timing": timing}


def citation_stage_breakdown(runner: CitationRunner, reps: int = 7) -> dict:
    """Host-clock milliseconds of each stage of one training step
    (dropout on), each stage ended by a device synchronize; medians."""
    model, batch, sup = runner.model.train(), runner.batch, runner.splits["train"]
    k = model.num_eig_vec
    times = {"learned_operator": [], "lanczos_call": [], "eigh_and_rotation": [],
             "layers_and_loss": [], "backward": []}

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name].append((t1 - t0) * 1e3)
        return t1

    for _ in range(reps):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        h = model.encoder(batch.atom_type, batch.node_feat, batch.mask)
        s_op = model.learned_operator(h, batch)
        t = mark("learned_operator", t)
        alphas, betas, q = LanczosTridiag.apply(s_op, batch.mask, k, EPS, "auto")
        t = mark("lanczos_call", t)
        ritz_val, ritz_vec = ritz_from_tridiag(alphas, betas[:, : k - 1], q)
        t = mark("eigh_and_rotation", t)
        loss = masked_ce_loss(model.propagate(batch, h, s_op, ritz_val, ritz_vec),
                              batch.node_label, sup)
        t = mark("layers_and_loss", t)
        loss.backward()
        mark("backward", t)
    model.zero_grad(set_to_none=True)
    out = {name: float(np.median(v)) for name, v in times.items()}
    # the adjoint recursion alone, the part of the backward that is the
    # Lanczos call's own, on this step's residuals and random cotangents
    resid = lanczos_cuda.lanczos_tridiag_cuda_resid(s_op.detach(), batch.mask, k, EPS)
    bars = [torch.randn_like(o) for o in resid[:3]]
    out["backward_adjoint_recursion_alone"] = host_ms(
        lambda: lanczos_adjoint_bwd(s_op.detach(), *resid, *bars, eps=EPS), reps, 1)
    return out


def profile_train_steps(train_step, batch, sup_mask, step_ms: float, steps: int = 5,
                        watch: str | None = None) -> dict:
    """A ``torch.profiler`` trace of a few training steps: the device
    time of all kernels of a step, its share of ``step_ms`` (the step's
    time without the profiler, whose own overhead stretches the traced
    steps several times over), and the kernels that took most of it;
    with ``watch``, the launches and device time a step of the kernels
    whose name holds it, and their share of the busy time. ``None``
    values where the trace holds no device time (then it was not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            train_step(batch, sup_mask)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side events that are kernels or copies: the optimizer's user
    # annotation ("Optimizer.step#Adam.step") is mirrored on the device's
    # timeline too and would count its kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    busy_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    if busy_ms <= 0:
        return {"device_busy_share": None, "top_kernels": None, "profiled_steps": steps}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    watched = {}
    if watch is not None:
        mine = [e for e in kernels if watch in e.key]
        ms = sum(e.self_device_time_total for e in mine) / steps / 1e3
        watched = {"watched": watch, "watched_launches_per_step": sum(e.count for e in mine) / steps,
                   "watched_ms_per_step": ms, "watched_share_of_busy": ms / busy_ms}
    return {
        **watched,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / step_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "step_ms_under_profiler": traced_ms,
        "profiled_steps": steps,
        "top_kernels": [
            {"name": e.key[:60], "launches_per_step": e.count / steps,
             "ms_per_step": e.self_device_time_total / steps / 1e3} for e in top
        ],
    }


def host_ms(fn, reps: int, warmup: int) -> float:
    """Median host-clock milliseconds of ``fn`` between device synchronizes."""
    out = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def phase_citation_train(runner: CitationRunner, smi: str) -> int:
    model, batch, splits = runner.model, runner.batch, runner.splits
    shape = (batch.n_max, batch.node_feat.shape[-1], model.readout.node_proj.out_features)
    if shape != CORA_SHAPE:
        raise SmokeFailure(f"the citation graph is {shape}, not Cora-sized {CORA_SHAPE}")

    torch.cuda.reset_peak_memory_stats()  # the kernel cases before held a 1 GB operator
    lanczos_cuda.launches.reset()
    lanczos_cuda.stream_launches.reset()
    t0 = time.perf_counter()
    trained = runner.train()
    tested = runner.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lanczos_cuda.stream_launches.count
    small_launches = lanczos_cuda.launches.count

    recs = [json.loads(ln) for ln in (runner.run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if r["event"] == "train"]
    # a forward for the train step and one for validation every epoch,
    # one for the test inside train() and one for test()
    forwards = 2 * len(losses) + 2

    # the kernel forward against the plain forward, same weights, eval mode
    def logits_and_grad(impl: str):
        model.lanczos_impl = impl
        model.eval()
        model.zero_grad(set_to_none=True)
        logits = model(batch)
        masked_ce_loss(logits, batch.node_label, splits["train"]).backward()
        return logits.detach(), model.kernel_embed.weight.grad.clone()

    try:
        logits_k, grad_k = logits_and_grad("kernel")
        logits_p, grad_p = logits_and_grad("plain")
    finally:
        model.lanczos_impl = CORA_ADA_MODEL["lanczos_impl"]
        model.zero_grad(set_to_none=True)
    logit_err = float((logits_k - logits_p).abs().max())
    grad_scale = float(grad_p.abs().max())
    grad_err = float((grad_k - grad_p).abs().max()) / max(grad_scale, 1e-30)

    optimizer, scheduler, clip = build_optimizer(model.parameters(), CORA_ADA_TRAIN)
    train_step = make_node_train_step(model, optimizer, scheduler, clip)
    eval_step = make_node_eval_step(model)
    train_ms = host_ms(lambda: train_step(batch, splits["train"]), 10, 2)
    eval_ms = host_ms(lambda: eval_step(batch, splits["val"]), 10, 2)
    stages = citation_stage_breakdown(runner)
    trace = profile_train_steps(train_step, batch, splits["train"], train_ms)

    emit(
        "citation_train", epochs=len(losses), seconds=wall, train_ce=losses,
        best_val_acc=trained["best_val_acc"], test_acc=tested["test_acc"],
        lanczos_stream_calls=launches, forwards=forwards, lanczos_tridiag_launches=small_launches,
        logits_max_abs_err_kernel_vs_plain=logit_err, kernel_embed_grad_scaled_err=grad_err,
        kernel_embed_grad_abs_max=grad_scale, tol=TOL,
        train_step_ms=train_ms, eval_step_ms=eval_ms, stage_ms=stages, profiler=trace,
        peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20, nvidia_smi=smi,
    )
    if len(losses) != CITATION_EPOCHS or not np.isfinite(losses).all():
        raise SmokeFailure(f"training losses are not {CITATION_EPOCHS} finite numbers: {losses}")
    if not losses[-1] < losses[0]:
        raise SmokeFailure(f"train CE did not fall: first {losses[0]}, last {losses[-1]}")
    if not (0.0 <= tested["test_acc"] <= 1.0 and trained["test_acc"] == tested["test_acc"]):
        raise SmokeFailure(f"test accuracy is off: {trained} then {tested}")
    if launches < forwards:
        raise SmokeFailure(
            f"{forwards} forwards launched the streamed Lanczos kernel only {launches} times")
    if not (torch.isfinite(logits_k).all() and logit_err <= TOL):
        raise SmokeFailure(f"kernel and plain forward differ in the logits by {logit_err} > {TOL}")
    if not (torch.isfinite(grad_k).all() and grad_scale > 0 and grad_err <= TOL):
        raise SmokeFailure(
            f"kernel and plain forward differ in the kernel_embed gradient by {grad_err} "
            f"of its largest entry > {TOL}")
    return launches


DENSE_CITATION_CONFIGS = ("cora_gcn", "cora_lanczos_net", "cora_ada_lanczos_net", "citeseer_gcn",
                          "citeseer_lanczos_net", "pubmed_gcn", "pubmed_lanczos_net", "pubmed_gpnn")
SPARSE_CITATION_CONFIGS = tuple(f"pubmed_sparse_{m}" for m in (
    "gcn", "chebynet", "gat", "dcnn", "graph_sage", "mpnn", "gpnn", "lanczos_net",
    "ada_lanczos_net")) + ("million_sparse_gcn_wide", "ten_million_sparse_gcn",
                           "ten_million_sparse_lanczos_net")
# the depth cuts of the two citation phases (of max_epoch 20–400): the
# dense configs' dropout-noisy CE needs about ten epochs to fall (on the
# CPU cora_lanczos_net goes 1.946, 2.061, 1.952 in its first three)
DENSE_CITATION_EPOCHS = CITATION_EPOCHS
SPARSE_CITATION_EPOCHS = 3
# the share of nodes on which GPNN's partition of the synthetic Pubmed
# graph on the card and on the CPU must agree, up to relabelling: its
# clusters are not separated, so nodes near a k-means boundary tip with
# the order of summation (tests/test_torch_citation_import.py)
PUBMED_PARTITION_AGREEMENT = 0.97
# the card against the CPU, float32 Pubmed logits: within TOL, or within
# this factor of the farthest of CARD_VS_CPU_CONTROLS reorderings of the
# edges on the CPU from the CPU's own logits. About twice the largest
# ratio of the two that scripts/torch_sparse_gate_readings.py read on an
# H100 (4.8 of AdaLanczosNet, 6 seeds; the card's cuBLAS products and
# atomics differ from the CPU in more places than a reordering does)
CARD_VS_CPU_CONTROL_FACTOR = 10.0
CARD_VS_CPU_CONTROLS = 3
SPMV_F64_TOL = 1e-5  # the 10M operator's float32 product against float64 scipy
RITZ_ORTHO_TOL = 1e-3  # |VᵀV − I| of the 10M Ritz vectors, computed in float64
REMAT_LOSS_RTOL = 1e-5  # remat: layers against no remat, one step, atomics' order aside


@contextlib.contextmanager
def kept_runners(name: str):
    """Inside, every runner that ``build_runner`` makes under ``name`` (as
    the CLI calls it) is appended to the yielded list."""
    made, build = [], runner_mod.RUNNER_REGISTRY[name]

    def keep(config, device=None):
        made.append(build(config, device))
        return made[-1]

    runner_mod.RUNNER_REGISTRY[name] = keep
    try:
        yield made
    finally:
        runner_mod.RUNNER_REGISTRY[name] = build


def citation_config_cut(name: str, epochs: int) -> tuple[dict, dict]:
    """``configs/<name>.yaml`` cut to ``epochs``, every epoch logged →
    (the config, the cuts as {key: [was, now]})."""
    cfg = config_io.loads((QM8_CONFIG.parent / f"{name}.yaml").read_text())
    cut = {"train.max_epoch": [cfg["train"]["max_epoch"], epochs],
           "train.display_iter": [cfg["train"].get("display_iter"), 1]}
    cfg["train"]["max_epoch"], cfg["train"]["display_iter"] = epochs, 1
    return cfg, cut


def partition_agreement(got: np.ndarray, want: np.ndarray) -> float:
    """The share of nodes on which two partitions agree under the best
    relabelling of ``got``."""
    k = int(max(got.max(), want.max())) + 1
    return max(float((np.asarray(perm)[got] == want).mean())
               for perm in itertools.permutations(range(k)))


def dense_citation_run(name: str, tmp: Path) -> dict:
    """Train ``configs/<name>.yaml`` through the CLI, cut; test it with
    ``-t``; hold the config's own check. → its JSON line's fields."""
    cfg, cut = citation_config_cut(name, DENSE_CITATION_EPOCHS)
    cfg["exp_dir"] = str(tmp / "exp")
    tmp.mkdir(parents=True)
    path = tmp / f"{name}.yaml"
    path.write_text(config_io.dumps(cfg))
    lanczos_cuda.stream_launches.reset()
    lanczos_cuda.plain_routes.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kept_runners("CitationRunner") as made:
        rc = cli.main(["-c", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stream, routes = lanczos_cuda.stream_launches.count, lanczos_cuda.plain_routes.count
    if rc != 0:
        raise SmokeFailure(f"lanczosnet_torch.cli -c {path} exited {rc}")
    run = only_run_dir(tmp / "exp", "_train")
    recs = read_metrics(run)
    losses = [r["loss"] for r in recs if r["event"] == "train"]
    (trained,) = [r["acc"] for r in recs if r["event"] == "test"]
    cfg["test"] = {"test_model": str(run / "checkpoints" / "best.pt")}
    test_path = tmp / f"{name}_t.yaml"
    test_path.write_text(config_io.dumps(cfg))
    if cli.main(["-c", str(test_path), "-t"]) != 0:
        raise SmokeFailure(f"lanczosnet_torch.cli -c {test_path} -t failed")
    (tested,) = [r["acc"] for r in read_metrics(only_run_dir(tmp / "exp", "_test"))
                 if r["event"] == "test"]
    batch = made[0].batch
    out = {"config": name, "cut": cut, "nodes": batch.n_max, "seconds": wall,
           "train_ce": losses, "test_acc": trained, "retested_acc": tested,
           "stream_launches": stream, "plain_routes": routes,
           "step_ms": [1e3 * r["step_seconds"] for r in recs if r["event"] == "epoch"],
           "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20}
    if len(losses) != DENSE_CITATION_EPOCHS or not np.isfinite(losses).all():
        raise SmokeFailure(f"{name}: losses are not {DENSE_CITATION_EPOCHS} finite numbers: {losses}")
    if not losses[-1] < losses[0]:
        raise SmokeFailure(f"{name}: train CE did not fall: {losses}")
    if tested != trained:
        raise SmokeFailure(f"{name}: -t gave test accuracy {tested}, the run {trained}")
    if batch.ritz_val is not None:  # LanczosNet's packed Ritz pairs against the plain version's
        k = batch.ritz_val.shape[-1]
        vals, vecs = batched_lanczos_ritz_dispatch(batch.ops[:, 0], batch.mask, k, impl="plain")
        out["ritz_max_abs_err_vs_plain"] = max(float((batch.ritz_val - vals).abs().max()),
                                               float((batch.ritz_vec - vecs).abs().max()))
        on_kernel = lanczos_cuda.kernel_limit(batch.n_max, k) is None
        if on_kernel and (stream < 1 or out["ritz_max_abs_err_vs_plain"] != 0.0):
            raise SmokeFailure(f"{name}: the packed Ritz pairs ({stream} streamed launches) "
                               f"differ from the plain version's by "
                               f"{out['ritz_max_abs_err_vs_plain']}")
        if not on_kernel and routes < 1:
            raise SmokeFailure(f"{name}: N={batch.n_max} went to no kernel and no plain route")
    if batch.cluster is not None:  # GPNN's partition on the card against the CPU's
        num = int(cfg["model"]["num_partition"])
        cpu = ritz_partition(batch.ops[0, 0].cpu(), batch.mask[0].cpu(), num)
        card = batch.cluster[0].cpu().numpy()
        out["partition_agreement_card_vs_cpu"] = partition_agreement(card, cpu)
        out["partition_nodes_differing"] = int(round(
            (1.0 - out["partition_agreement_card_vs_cpu"]) * card.size))
        if out["partition_agreement_card_vs_cpu"] < PUBMED_PARTITION_AGREEMENT:
            raise SmokeFailure(f"{name}: the card's partition agrees with the CPU's on "
                               f"{out['partition_agreement_card_vs_cpu']:.4f} of the nodes")
    return out


@contextlib.contextmanager
def citation_graphs_drawn_once():
    """Inside, ``CitationRunner`` draws each graph once and gets the same
    arrays again for every later run of it (its pack copies them): the
    dense phase's runs and their ``-t`` would draw Pubmed six times. One
    graph is held at a time."""
    draw, held = citation_runner_mod.citation_graph, {}

    def once(dcfg):
        key = json.dumps({k: dcfg.get(k) for k in ("source", "name", "seed", "scale", "data_dir")},
                         sort_keys=True)
        if key not in held:
            held.clear()
            held[key] = draw(dcfg)
        return held[key]

    citation_runner_mod.citation_graph = once
    try:
        yield
    finally:
        citation_runner_mod.citation_graph = draw


def phase_dense_citation(smi: str, tmp: Path) -> tuple[int, dict]:
    """The eight dense citation configs through the CLI, each graph drawn
    once. → (the streamed kernel's launches in their runs, each run's
    JSON line's fields)."""
    launches, runs = 0, {}
    with citation_graphs_drawn_once():
        for name in DENSE_CITATION_CONFIGS:
            out = dense_citation_run(name, tmp / name)
            launches += out["stream_launches"]
            runs[name] = out
            emit("dense_citation", **out, nvidia_smi=smi)
    return launches, runs


def sparse_citation_run(name: str, tmp: Path, graph: dict, graph_s: float, dev, smi: str,
                        seed: int | None = None):
    """Train ``configs/<name>.yaml`` through ``SparseCitationRunner`` on a
    graph made before, cut (``seed``, where given, replaces the config's);
    test it; time a step and profile a few. → (the runner, its JSON
    line's fields)."""
    cfg, cut = citation_config_cut(name, SPARSE_CITATION_EPOCHS)
    if seed is not None:
        cut["seed"] = [cfg["seed"], seed]
        cfg["seed"] = seed
    cfg["save_dir"] = str(tmp / name)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = SparseCitationRunner(cfg, dev, graph=graph)
    trained = runner.train()
    tested = runner.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recs = read_metrics(runner.run_dir)
    losses = [r["loss"] for r in recs if r["event"] == "train"]
    epoch_s = [r["seconds"] for r in recs if r["event"] == "epoch"]
    peak_train_mb = torch.cuda.max_memory_allocated() / 2**20
    optimizer, scheduler, clip = build_optimizer(runner.model.parameters(), cfg["train"])
    step = runner.make_train_step(optimizer, scheduler, clip)
    step_ms = host_ms(step, 5, 1)
    trace = profile_train_steps(lambda _b, _m: step(), None, None, step_ms, steps=3)
    out = {"config": name, "cut": cut, "nodes": runner.op.n, "edges": runner.op.num_edges,
           "dtype": str(runner.model.dtype), "remat": runner.remat,
           "graph_s": graph_s, "operator_s": runner.seconds["operator"],
           "ritz_or_partition_s": runner.seconds["extras"], "seconds": wall,
           "train_ce": losses, "epoch_s": epoch_s, "train_step_ms_median": step_ms,
           "best_val_acc": trained["best_val_acc"], "test_acc": trained["test_acc"],
           "peak_memory_mb_train": peak_train_mb,
           "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20, "profiler": trace}
    if len(losses) != SPARSE_CITATION_EPOCHS or not np.isfinite(losses).all():
        raise SmokeFailure(f"{name}: losses are not {SPARSE_CITATION_EPOCHS} finite numbers: {losses}")
    if not losses[-1] < losses[0]:
        raise SmokeFailure(f"{name}: train CE did not fall: {losses}")
    if tested["test_acc"] != trained["test_acc"]:
        raise SmokeFailure(f"{name}: test() gave {tested['test_acc']}, train() {trained['test_acc']}")
    return runner, out


@torch.no_grad()
def sparse_card_vs_cpu(runner) -> dict:
    """The eval-mode logits on the card against the CPU's, same weights,
    operator, features and extras, beside a control: the CPU's logits
    with the operator's edges summed in other orders (two float32
    computations that differ only in summation order, as the card's
    atomics differ from the CPU). The gate's limit is ``TOL``, or
    ``CARD_VS_CPU_CONTROL_FACTOR`` times the control where rounding alone
    moves these logits further (a forward whose in-model Lanczos meets
    close Ritz pairs at these weights)."""
    mcfg = runner.config["model"]
    twin = build_sparse_model(mcfg, runner.x.shape[1], runner.model.head.out_features)
    twin.load_state_dict({k: v.cpu() for k, v in runner.model.state_dict().items()})
    twin.eval()
    runner.model.eval()
    card = runner.forward().float().cpu()
    x, op, extras = runner.x.cpu(), runner.op.to("cpu"), [e.cpu() for e in runner.extras]
    cpu = twin(x, op, *extras).float()
    gen = torch.Generator().manual_seed(0)
    control = 0.0
    for _ in range(CARD_VS_CPU_CONTROLS):
        p = torch.randperm(op.num_edges, generator=gen)
        shuffled = op.replace(row=op.row[p], col=op.col[p], val=op.val[p], rows_sorted=False,
                              col_perm=None)
        control = max(control, float((twin(x, shuffled, *extras).float() - cpu).abs().max()))
    err = float((card - cpu).abs().max())
    return {"logits_max_abs_err_card_vs_cpu": err, "logits_max_abs_err_cpu_reordered": control,
            "card_vs_cpu_limit": max(TOL, CARD_VS_CPU_CONTROL_FACTOR * control)}


def ten_million_checks(runner) -> dict:
    """The 10M LanczosNet's operator, Ritz pairs, bfloat16 and remat gates."""
    import scipy.sparse

    op, (vals, vecs) = runner.op, runner.extras
    out = {}
    gen = torch.Generator(device=op.val.device).manual_seed(0)
    x = torch.randn(op.n, generator=gen, device=op.val.device)
    with torch.no_grad():
        y = spmv(op, x).double().cpu().numpy()
    a = scipy.sparse.csr_matrix((op.val.cpu().double().numpy(),
                                 (op.row.cpu().numpy(), op.col.cpu().numpy())), (op.n, op.n))
    out["spmv_max_abs_err_vs_scipy_f64"] = float(np.abs(y - a @ x.double().cpu().numpy()).max())
    out["ritz_val"] = vals.cpu().tolist()
    live = vecs.norm(dim=0) > 0.5
    v = vecs[:, live].double()
    out["ritz_vectors_nonzero"] = int(live.sum())
    out["ritz_ortho_max_err"] = float((v.T @ v - torch.eye(v.shape[1], dtype=v.dtype,
                                                            device=v.device)).abs().max())
    del v
    with torch.no_grad():
        runner.model.eval()
        bf16 = runner.forward().float()
        twin = build_sparse_model({**runner.config["model"], "dtype": None},
                                  runner.x.shape[1], runner.model.head.out_features)
        twin.load_state_dict(runner.model.state_dict())
        f32 = twin.to(op.val.device).eval()(runner.x, op, vals, vecs)
        out["bf16_vs_f32_rel_distance"] = float((bf16 - f32).abs().max() / f32.abs().max())
        del bf16, f32, twin

    def one_step(remat: bool) -> tuple[float, dict, float]:
        runner.model.set_remat_layers(remat)
        opt = torch.optim.SGD(runner.model.parameters(), lr=0.0)
        runner.dropout_generator.manual_seed(3)
        torch.cuda.reset_peak_memory_stats()
        loss = float(runner.make_train_step(opt)())
        grads = {k: p.grad.clone() for k, p in runner.model.named_parameters()}
        return loss, grads, torch.cuda.max_memory_allocated() / 2**20

    loss_r, grads_r, peak_r = one_step(True)
    loss_n, grads_n, peak_n = one_step(False)
    runner.model.set_remat_layers(True)
    out.update(remat_layers_loss=loss_r, no_remat_loss=loss_n, remat_layers_step_peak_mb=peak_r,
               no_remat_step_peak_mb=peak_n, remat_grad_max_rel_err=max(
                   float((grads_r[k] - grads_n[k]).abs().max() / grads_n[k].abs().max().clamp_min(
                       1e-30)) for k in grads_n))
    fails = []
    if not out["spmv_max_abs_err_vs_scipy_f64"] <= SPMV_F64_TOL:
        fails.append(f"spmv differs from scipy by {out['spmv_max_abs_err_vs_scipy_f64']}")
    if not (torch.isfinite(vals).all() and float(vals.abs().max()) <= 1.0 + 1e-3):
        fails.append(f"Ritz values out of [-1-1e-3, 1+1e-3]: {out['ritz_val']}")
    if not out["ritz_ortho_max_err"] <= RITZ_ORTHO_TOL:
        fails.append(f"Ritz vectors orthonormal only to {out['ritz_ortho_max_err']}")
    if not out["bf16_vs_f32_rel_distance"] <= SPARSE_BF16_REL_DISTANCE:
        fails.append(f"bf16 logits {out['bf16_vs_f32_rel_distance']} from the f32 twin's")
    if not abs(loss_r - loss_n) <= REMAT_LOSS_RTOL * abs(loss_n):
        fails.append(f"remat: layers loss {loss_r} against {loss_n} without")
    if fails:
        raise SmokeFailure("ten_million_sparse_lanczos_net: " + "; ".join(fails))
    return out


@contextlib.contextmanager
def coo_arrays_built_once():
    """Inside, ``SparseCitationRunner`` sorts each COO operator of a graph
    on the host once (12 s at 10M nodes, 2.5 s at Pubmed's) and gets the
    same arrays again for every later config on that graph; each run
    copies them to its device anew. Only the current graph's are held."""
    build, held = sparse_runner_mod.coo_arrays, {}

    def once(edges, n, kind, *args):
        # a dense graph's edge list is made anew for each run: compare it
        last = held.get("edges")
        if last is not edges and not (last is not None and last.shape == edges.shape
                                      and np.array_equal(last, edges)):
            held.clear()
            held["edges"] = edges
        key = (n, kind, *args)
        if key not in held:
            held[key] = build(edges, n, kind, *args)
        return held[key]

    sparse_runner_mod.coo_arrays = once
    try:
        yield
    finally:
        sparse_runner_mod.coo_arrays = build


def phase_sparse_citation(dev, smi: str, tmp: Path) -> tuple[dict, dict]:
    """The twelve single-device sparse configs through
    ``SparseCitationRunner``, each graph made once for the configs that
    share its ``dataset`` section, and its operators sorted once. →
    ({its dataset's key: the last graph}, {config: the run's peak MB over
    set-up and training})."""
    with coo_arrays_built_once():
        return sparse_citation_configs(dev, smi, tmp)


def sparse_citation_configs(dev, smi: str, tmp: Path) -> tuple[dict, dict]:
    graphs, peaks = {}, {}
    for name in SPARSE_CITATION_CONFIGS:
        dcfg = config_io.loads((QM8_CONFIG.parent / f"{name}.yaml").read_text())["dataset"]
        key = json.dumps(dcfg, sort_keys=True)
        if key not in graphs:
            graphs.clear()  # one graph on the host at a time
            t0 = time.perf_counter()
            graphs[key] = (sparse_citation_graph(dcfg), time.perf_counter() - t0)
        graph, graph_s = graphs[key]
        runner, out = sparse_citation_run(name, tmp, graph, graph_s, dev, smi)
        if runner.model.dtype == torch.float32 and name.startswith("pubmed"):
            out.update(sparse_card_vs_cpu(runner))
            if not out["logits_max_abs_err_card_vs_cpu"] <= out["card_vs_cpu_limit"]:
                raise SmokeFailure(f"{name}: card and CPU logits differ by "
                                   f"{out['logits_max_abs_err_card_vs_cpu']} > "
                                   f"{out['card_vs_cpu_limit']} (the CPU against itself "
                                   f"reordered: {out['logits_max_abs_err_cpu_reordered']})")
        if name == "ten_million_sparse_lanczos_net":
            out.update(ten_million_checks(runner))
        emit("sparse_citation", **out, nvidia_smi=smi)
        peaks[name] = out["peak_memory_mb_train"]
        del runner
        torch.cuda.empty_cache()
    return {k: g for k, (g, _) in graphs.items()}, peaks


SHARDED_CITATION_CONFIGS = ("ten_million_sparse_lanczos_net_ring", "million_sparse_gcn_sharded",
                            "million_sparse_gcn_node_sharded", "million_sparse_gcn_ring")
# the depth cuts: 3 of max_epoch 60 (1M), 2 of 20 (the ring LanczosNet)
SHARDED_CITATION_EPOCHS = {"ten_million_sparse_lanczos_net_ring": 2}
SHARDED_DEFAULT_EPOCHS = 3
# resumed for one more epoch from the primary's snapshot: the ring (the
# resume is the same code in every form; each costs a set-up)
SHARDED_RESUMED = ("million_sparse_gcn_ring",)
SHARDED_F32_TOL = 1e-4  # sharded float32 logits against one device's, same weights
# the process cut: 4 ranks of the configs' 8 (six launches of ranks that
# share the card, each rank's start-up paid in each); a CPU rehearsal sets 2
SHARDED_RANKS = 4
# the graph cuts: the ring LanczosNet to 2M of its 10M nodes (rank 0 drew
# 10M in 29 s and built its operator in 10 s, in the training launch, the
# follow-ups and the one-device check; the sparse phase trains the 10M
# configs on one device), the 1M configs to 500k; a CPU rehearsal cuts
# every graph
SHARDED_NODE_CUTS = {"ten_million_sparse_lanczos_net_ring": 2_000_000,
                     **{f"million_sparse_gcn_{s}": 500_000
                        for s in ("sharded", "node_sharded", "ring")}}
SHARDED_NODES = None


def sharded_config_cut(name: str, tmp: Path) -> tuple[dict, dict]:
    """``configs/<name>.yaml`` cut for the phase → (config, cuts)."""
    epochs = SHARDED_CITATION_EPOCHS.get(name, SHARDED_DEFAULT_EPOCHS)
    cfg, cut = citation_config_cut(name, epochs)
    cfg["exp_dir"] = str(tmp / "exp")
    # a snapshot at the last epoch, for the resume
    cut["train.snapshot_epoch"] = [cfg["train"].get("snapshot_epoch"), epochs]
    cfg["train"]["snapshot_epoch"] = epochs
    if SHARDED_RANKS is not None:
        cut["train.num_devices"] = [cfg["train"]["num_devices"], SHARDED_RANKS]
        cfg["train"]["num_devices"] = SHARDED_RANKS
    nodes = SHARDED_NODES or SHARDED_NODE_CUTS.get(name)
    if nodes is not None:
        cut["dataset.num_nodes"] = [cfg["dataset"]["num_nodes"], nodes]
        cfg["dataset"]["num_nodes"] = nodes
    return cfg, cut


def one_graph_cache(graphs: dict, dcfg: dict) -> dict:
    """The graph of ``dcfg`` from ``graphs`` (made there if missing, after
    dropping the one held: one graph on the host at a time)."""
    key = json.dumps(dcfg, sort_keys=True)
    if key not in graphs:
        graphs.clear()
        graphs[key] = sparse_citation_graph(dcfg)
    return graphs[key]


def sharded_followups(jobs: list, graph_file: str, device=None) -> int:
    """What each rank does after the CLI trained sharded runs: per job
    (``config``: a run's ``config.yaml``, ``out``: a directory, ``resume``)
    ``-t`` on the run's best checkpoint through ``cli.run`` (rank 0 saves
    the whole graph's eval logits and the weights), then, where asked,
    one more epoch resumed from the primary's latest snapshot in the
    run's own directory. The jobs share one graph: rank 0 loads it from
    ``graph_file`` (pickled by the caller) instead of drawing it again."""
    from lanczosnet_torch.parallel import multihost
    from lanczosnet_torch.utils.config import AttrDict

    rank = multihost.world().rank
    graph = None
    if rank == 0:
        with open(graph_file, "rb") as f:
            graph = pickle.load(f)

    def with_graph(config, device=None):
        return SparseCitationRunner(config, device, graph=graph)

    runner_mod.RUNNER_REGISTRY["SparseCitationRunner"] = with_graph
    worst = 0
    for job in jobs:
        base = AttrDict.convert(config_io.loads(Path(job["config"]).read_text()))
        run = Path(base.save_dir)
        tested = AttrDict.convert({**base, "save_dir": f"{run}_t", "is_test": True,
                                   "test": {"test_model": str(run / "checkpoints" / "best.pt")}})
        Path(tested.save_dir).mkdir(exist_ok=True)
        codes = {}
        with kept_runners("SparseCitationRunner") as made:
            codes["test"] = cli.run(tested, True, "INFO", device)
        if codes["test"] == 0:
            logits = made[0].gathered_logits()
            if rank == 0:  # the weights too: the resume below may write a new best
                torch.save({"logits": logits.float().cpu(),
                            "model": {k: v.cpu() for k, v in made[0].model.state_dict().items()}},
                           Path(job["out"]) / "tested.pt")
        del made
        torch.cuda.empty_cache()
        if job["resume"]:
            resumed = AttrDict.convert({**base, "train": {**base.train, "is_resume": True,
                                                          "max_epoch": base.train.max_epoch + 1}})
            codes["resume"] = cli.run(resumed, False, "INFO", device)
        (Path(job["out"]) / f"rank{rank}.json").write_text(json.dumps(codes))
        worst = max(worst, *codes.values())
    return worst


@torch.no_grad()
def sharded_vs_one_device(cfg: dict, run: Path, tested: dict, graph: dict, dev) -> dict:
    """The weights the sharded ``-t`` ran with, on one device, on the same
    graph: the distance of its eval logits from the sharded ones."""
    one = {**cfg, "save_dir": f"{run}_one", "train": {**cfg["train"], "num_devices": 1}}
    runner = SparseCitationRunner(one, dev, graph=graph)
    runner.model.load_state_dict(tested["model"])
    logits = tested["logits"]
    want = runner.gathered_logits().float().cpu()
    del runner
    torch.cuda.empty_cache()
    err = float((logits - want).abs().max())
    return {"logits_max_abs_err_vs_one_device": err,
            "logits_rel_distance_vs_one_device": err / float(want.abs().max())}


def cli_process(path: Path, device_arg, timeout: float = 900) -> None:
    """``python -m lanczosnet_torch.cli -c <path>`` in a process (which
    starts the config's ranks); raises unless it exits 0 in time."""
    # a session of its own, so that a timeout ends the ranks the CLI started too
    proc = subprocess.Popen([sys.executable, "-m", "lanczosnet_torch.cli", "-c", str(path),
                             *(["--device", device_arg] if device_arg else [])],
                            cwd=Path(__file__).resolve().parent, start_new_session=True)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise SmokeFailure(f"python -m lanczosnet_torch.cli -c {path} ran past {timeout} s")
    if proc.returncode != 0:
        raise SmokeFailure(f"python -m lanczosnet_torch.cli -c {path} exited {proc.returncode}")


def sharded_train(name: str, tmp: Path, device_arg) -> dict:
    """Train ``configs/<name>.yaml`` (cut) on its ranks through ``python -m
    lanczosnet_torch.cli`` → what the follow-ups and the checks need."""
    cfg, cut = sharded_config_cut(name, tmp)
    tmp.mkdir(parents=True)
    path = tmp / f"{name}.yaml"
    path.write_text(config_io.dumps(cfg))
    t0 = time.perf_counter()
    cli_process(path, device_arg)
    run = only_run_dir(tmp / "exp", "_train")
    (tmp / "followups").mkdir()
    return {"name": name, "cfg": cfg, "cut": cut, "run": run, "train_s": time.perf_counter() - t0,
            "job": {"config": str(run / "config.yaml"), "out": str(tmp / "followups"),
                    "resume": name in SHARDED_RESUMED}}


def sharded_followups_launch(trained: list, graph: dict, tmp: Path, device_arg) -> float:
    """The follow-ups of ``trained`` runs, which share ``graph``, in one
    launch of their ranks → seconds (the graph's pickling included)."""
    from lanczosnet_torch.parallel import multihost

    t0 = time.perf_counter()
    graph_file = tmp / "graph.pkl"
    with open(graph_file, "wb") as f:
        pickle.dump(graph, f, protocol=pickle.HIGHEST_PROTOCOL)
    code = multihost.launch(int(trained[0]["cfg"]["train"]["num_devices"]),
                            "chip_smoke:sharded_followups",
                            [[t["job"] for t in trained], str(graph_file), device_arg],
                            device=device_arg,
                            store_dir=tmp, pythonpath=[Path(__file__).resolve().parent],
                            timeout=900)
    if code != 0:
        raise SmokeFailure(f"{[t['name'] for t in trained]}: -t or resume in the ranks "
                           f"exited {code}")
    return time.perf_counter() - t0


def sharded_checks(t: dict, followup_s: float, graphs: dict, dev, device_arg) -> dict:
    """A trained and followed-up run's JSON line's fields; raises on a gate."""
    name, cfg, run = t["name"], t["cfg"], t["run"]
    ranks = int(cfg["train"]["num_devices"])
    recs = [read_metrics(run, r) for r in range(ranks)]
    setups = [next(e for e in rec if e["event"] == "setup") for rec in recs]
    trained = [[e for e in rec if e["event"] == "test"][0] for rec in recs]
    epochs = int(cfg["train"]["max_epoch"])
    losses = [e["loss"] for e in recs[0] if e["event"] == "train"][:epochs]
    steps = [e for e in recs[0] if e["event"] == "epoch"][:epochs]
    step_s = sum(e["step_seconds"] for e in steps)
    tested_state = torch.load(Path(t["job"]["out"]) / "tested.pt", weights_only=True)
    (tested,) = [e["acc"] for e in read_metrics(Path(f"{run}_t")) if e["event"] == "test"]
    out = {"config": name, "cut": t["cut"], "ranks": ranks, "shard": setups[0]["shard"],
           "backend": setups[0]["backend"], "ranks_per_card": setups[0]["ranks_per_card"],
           "rank_devices": [s["device"] for s in setups], "nodes": setups[0]["n_true"],
           "edges": setups[0]["num_edges"], "dtype": str(cfg["model"].get("dtype", "float32")),
           "setup_s_rank0": {k: v for k, v in setups[0].items() if k.endswith("_s")},
           "train_wall_s": t["train_s"], "followups_wall_s": followup_s, "train_ce": losses,
           "step_ms_median": 1e3 * float(np.median([e["step_seconds"] for e in steps])),
           "step_ms": [1e3 * e["step_seconds"] for e in steps],
           "comm_staging_share": sum(e["comm"]["staging_s"] for e in steps) / step_s,
           "comm_transport_share": sum(e["comm"]["transport_s"] for e in steps) / step_s,
           "comm_staged_mb_a_step": sum(e["comm"]["staged_bytes"] for e in steps)
           / len(steps) / 2**20,
           "peak_gb_per_rank": [e.get("peak_memory_mb", 0.0) / 1024 for e in trained],
           "host_peak_rss_gb_per_rank": [e["host_peak_rss_mb"] / 1024 for e in trained],
           "test_acc": trained[0]["acc"], "retested_acc": tested,
           **sharded_vs_one_device(cfg, run, tested_state,
                                   one_graph_cache(graphs, cfg["dataset"]), dev)}
    fails = []
    if device_arg is None and not all(d.startswith("cuda") for d in out["rank_devices"]):
        fails.append(f"a rank ran off the card: {out['rank_devices']}")
    if len(losses) != epochs or not np.isfinite(losses).all():
        fails.append(f"losses are not {epochs} finite numbers: {losses}")
    elif not losses[-1] < losses[0]:
        fails.append(f"train CE did not fall: {losses}")
    if tested != out["test_acc"]:
        fails.append(f"-t gave test accuracy {tested}, the run {out['test_acc']}")
    if t["job"]["resume"]:
        resumed = [e["epoch"] for e in read_metrics(run) if e["event"] == "train"]
        out["resumed_epochs"] = resumed[epochs:]
        if out["resumed_epochs"] != [epochs]:
            fails.append(f"the resumed run logged epochs {out['resumed_epochs']}")
    if out["dtype"] == "bfloat16":
        if not out["logits_rel_distance_vs_one_device"] <= SPARSE_BF16_REL_DISTANCE:
            fails.append(f"logits {out['logits_rel_distance_vs_one_device']} of the largest "
                         "from one device's")
    elif not out["logits_max_abs_err_vs_one_device"] <= SHARDED_F32_TOL:
        fails.append(f"logits {out['logits_max_abs_err_vs_one_device']} from one device's")
    if fails:
        raise SmokeFailure(f"{name}: " + "; ".join(fails))
    return out


def phase_sharded_citation(dev, smi: str, tmp: Path, graphs: dict | None = None,
                           device_arg=None) -> None:
    """The four sharded sparse configs, their ranks sharing the card, each
    trained through the CLI; the follow-ups of the configs that share a
    graph in one launch; the ring's per-rank peak below the node-sharded
    one's. ``graphs``: a graph the caller drew (one at most), reused."""
    graphs = {} if graphs is None else graphs
    groups = {}
    for name in SHARDED_CITATION_CONFIGS:
        dcfg = sharded_config_cut(name, tmp)[0]["dataset"]
        groups.setdefault(json.dumps(dcfg, sort_keys=True), []).append(name)
    peaks = {}
    for names in groups.values():
        trained = [sharded_train(name, tmp / name, device_arg) for name in names]
        graph = one_graph_cache(graphs, trained[0]["cfg"]["dataset"])
        followup_s = sharded_followups_launch(trained, graph, tmp, device_arg)
        del graph
        for t in trained:
            out = sharded_checks(t, followup_s, graphs, dev, device_arg)
            peaks[t["name"]] = out["peak_gb_per_rank"]
            emit("sharded_citation", **out, nvidia_smi=smi)
    graphs.clear()
    ring, node = peaks["million_sparse_gcn_ring"], peaks["million_sparse_gcn_node_sharded"]
    emit("sharded_ring_memory", ring_peak_gb=ring, node_sharded_peak_gb=node, nvidia_smi=smi)
    if device_arg is None and not all(r < n for r, n in zip(ring, node)):
        raise SmokeFailure(f"a rank's peak in the ring {ring} is not below its peak "
                           f"node-sharded {node}")


# the qm8_parallel phase: configs/qm8_lanczos_net_tp4.yaml as written
# (dp=1 × tp=4), the same with train.num_devices 8 (dp=2 × tp=4) and
# configs/qm8_lanczos_net.yaml with train.num_devices 4 (dp=4), their
# ranks sharing the card over gloo; the depth cuts, of max_epoch 30
QM8_TP4_CONFIG = QM8_CONFIG.parent / "qm8_lanczos_net_tp4.yaml"
QM8_PARALLEL_RUNS = {  # name: (config, train.num_devices, epochs, (dp, tp))
    "tp4": (QM8_TP4_CONFIG, None, 2, (1, 4)),
    "dp2_tp4": (QM8_TP4_CONFIG, 8, 2, (2, 4)),
    "dp4": (QM8_CONFIG, 4, 2, (4, 1)),
}
# the size cut of the three runs' splits, of 2048/256/256 (qm8_models' cut)
QM8_PARALLEL_SPLITS = {"num_train": 1024, "num_val": 128, "num_test": 128}
QM8_PARALLEL_FOLLOWED = "tp4"  # tested in its ranks and on one device, resumed one epoch
QM8_FIRST_STEP_MESH = (2, 4)
QM8_FIRST_STEP_RTOL = 1e-5  # the first step's loss against one device's
QM8_RETEST_TOL = 1e-6  # -t in the ranks against -t on one device, test MAE


def qm8_parallel_config(name: str, tmp: Path) -> tuple[Path, dict, dict]:
    """A run of ``QM8_PARALLEL_RUNS``, its config cut and written to
    ``tmp`` → (path, config, cuts)."""
    src, ndev, epochs, _ = QM8_PARALLEL_RUNS[name]
    cfg = config_io.loads(src.read_text())
    tcfg = cfg["train"]
    cut = {"train.max_epoch": [tcfg["max_epoch"], epochs],
           "exp_dir": [cfg.get("exp_dir"), str(tmp / "exp")]}
    tcfg["max_epoch"], cfg["exp_dir"] = epochs, str(tmp / "exp")
    for key, n in QM8_PARALLEL_SPLITS.items():
        cut[f"dataset.{key}"] = [cfg["dataset"][key], n]
        cfg["dataset"][key] = n
    if ndev is not None:
        cut["train.num_devices"] = [tcfg.get("num_devices"), ndev]
        tcfg["num_devices"] = ndev
    tmp.mkdir(parents=True)
    path = tmp / f"{name}.yaml"
    path.write_text(config_io.dumps(cfg))
    return path, cfg, cut


def qm8_parallel_followups(config: str, device=None) -> int:
    """What each rank of a trained QM8 mesh run does after it: ``-t`` on
    its best checkpoint through ``cli.run`` (in ``<run>_t``), then one
    more epoch resumed from the primary's latest snapshot."""
    from lanczosnet_torch.utils.config import AttrDict

    base = AttrDict.convert(config_io.loads(Path(config).read_text()))
    run = Path(base.save_dir)
    tested = AttrDict.convert({**base, "save_dir": f"{run}_t", "is_test": True,
                               "test": {"test_model": str(run / "checkpoints" / "best.pt")}})
    Path(tested.save_dir).mkdir(exist_ok=True)
    codes = [cli.run(tested, True, "INFO", device)]
    resumed = AttrDict.convert({**base, "train": {**base.train, "is_resume": True,
                                                  "max_epoch": base.train.max_epoch + 1}})
    codes.append(cli.run(resumed, False, "INFO", device))
    return max(codes)


def qm8_first_step_case(spec: dict, dev, layout=None) -> dict:
    """One training step of the spec's model (``model``, ``weights``,
    ``batch`` arrays, ``train``, dropout ``seed``) on ``dev``: on one
    device, or on this rank's block of the batch and of the model of a
    ``(dp, tp)`` layout → the loss and the state bytes."""
    from lanczosnet_torch.core.graph_batch import GraphBatch
    from lanczosnet_torch.models.base import set_dropout_generator
    from lanczosnet_torch.parallel import mesh
    from lanczosnet_torch.parallel.tensor import TensorParallel, measured_state_bytes

    model = build_model(spec["model"])
    model.load_state_dict(spec["weights"])
    model.to(dev)
    d, dp = (0, 1) if layout is None else (layout.d, layout.dp)
    parallel = None if layout is None else TensorParallel(model, layout.tp_comm)
    params = list(model.parameters()) if parallel is None else parallel.parameters()
    set_dropout_generator(model, torch.Generator(dev).manual_seed(spec["seed"]), rows=(d, dp))
    optimizer, scheduler, clip = build_optimizer(params, spec["train"], 1)
    step = make_train_step(model, optimizer, scheduler, clip,
                           None if layout is None else layout.dp_comm, parallel)
    bs = spec["batch"]["mask"].shape[0]
    rows = mesh.batch_rows(bs, dp, d)
    batch = GraphBatch(**{k: None if v is None else torch.from_numpy(v[rows]).to(dev)
                          for k, v in spec["batch"].items()})
    loss = float(step(batch, torch.ones(rows.stop - rows.start, device=dev), bs))
    return {"loss": loss, "state_bytes": measured_state_bytes(params, optimizer)}


def qm8_first_step(spec_file: str, out_dir: str, device=None) -> int:
    """``qm8_first_step_case`` on this rank of a ``QM8_FIRST_STEP_MESH``
    layout; each rank writes its result."""
    from lanczosnet_torch.parallel import multihost

    w = multihost.world()
    res = qm8_first_step_case(torch.load(spec_file, weights_only=False), w.device,
                              multihost.mesh2d(*QM8_FIRST_STEP_MESH))
    (Path(out_dir) / f"rank{w.rank}.json").write_text(json.dumps(res))
    return 0


def qm8_parallel_run(name: str, tmp: Path, device_arg, predicted: dict) -> dict:
    """Train a run of ``QM8_PARALLEL_RUNS`` through the CLI → its JSON
    line's fields; raises on a gate."""
    path, cfg, cut = qm8_parallel_config(name, tmp)
    dp, tp = QM8_PARALLEL_RUNS[name][3]
    t0 = time.perf_counter()
    cli_process(path, device_arg)
    wall = time.perf_counter() - t0
    run = only_run_dir(tmp / "exp", "_train")
    recs = [read_metrics(run, r) for r in range(dp * tp)]
    setups = [next(e for e in rec if e["event"] == "setup" and "rank" in e) for rec in recs]
    tests = [[e for e in rec if e["event"] == "test"][0] for rec in recs]
    epochs = [e for e in recs[0] if e["event"] == "epoch"]
    steps = int(cfg["dataset"]["num_train"]) // int(cfg["train"]["batch_size"])
    losses = [e["loss"] for e in epochs]
    comm_s = sum(e["comm"]["staging_s"] + e["comm"]["transport_s"] for e in epochs)
    packs = [e for e in recs[0] if e["event"] == "pack"]
    state = [t["state_bytes"] for t in tests]
    out = {"run": name, "config": Path(QM8_PARALLEL_RUNS[name][0]).name, "cut": cut,
           "mesh": {"dp": setups[0]["dp"], "tp": setups[0]["tp"]}, "ranks": dp * tp,
           "backend": setups[0]["backend"], "ranks_per_card": setups[0]["ranks_per_card"],
           "rank_devices": [e["device"] for e in setups], "epoch_loss": losses,
           "val_mae": [e["mae"] for e in recs[0] if e["event"] == "val"],
           "test_mae": tests[0]["mae"], "cli_wall_s": wall,
           "step_ms_median": 1e3 * float(np.median([e["epoch_time_s"] for e in epochs])) / steps,
           "step_ms": [1e3 * e["epoch_time_s"] / steps for e in epochs],
           # the first epoch carries each rank's warm-up (torch._dynamo's import
           # at the first optimizer step, the first launches)
           "step_ms_last_epoch": 1e3 * epochs[-1]["epoch_time_s"] / steps,
           "graphs_per_sec": [e["graphs_per_sec"] for e in epochs],
           "comm_share": comm_s / sum(e["epoch_time_s"] for e in epochs),
           "comm_staged_mb_a_step": sum(e["comm"]["staged_bytes"] for e in epochs)
           / len(epochs) / steps / 2**20,
           "peak_gb_per_rank": [t.get("peak_memory_mb", 0.0) / 1024 for t in tests],
           "setup_s_rank0": {k: v for e in recs[0] if e["event"] == "setup"
                             for k, v in e.items() if k.endswith("_s")},
           "pack_s": {e["split"]: e["seconds"] for e in packs},
           "lanczos_tridiag_launches": sum(e["lanczos_launches"] for e in packs),
           "state_bytes_per_rank": state, "predicted_state_bytes": predicted[(dp, tp)]}
    fails = []
    if device_arg is None and not all(d.startswith("cuda") for d in out["rank_devices"]):
        fails.append(f"a rank ran off the card: {out['rank_devices']}")
    if (out["mesh"]["dp"], out["mesh"]["tp"]) != (dp, tp):
        fails.append(f"the mesh is {out['mesh']}, not dp={dp} × tp={tp}")
    if len(losses) != QM8_PARALLEL_RUNS[name][2] or not np.isfinite(losses).all():
        fails.append(f"epoch losses {losses}")
    elif not losses[-1] < losses[0]:
        fails.append(f"the loss did not fall: {losses}")
    if any(b != predicted[(dp, tp)] for b in state):
        fails.append(f"state bytes a rank {state}, the rule predicts {predicted[(dp, tp)]}")
    if device_arg is None and out["lanczos_tridiag_launches"] < len(packs):
        fails.append(f"rank 0's packs launched B1 {out['lanczos_tridiag_launches']} times")
    if fails:
        raise SmokeFailure(f"qm8_parallel {name}: " + "; ".join(fails))
    out["run_dir"], out["cfg"] = run, cfg
    return out


def qm8_parallel_follow(t: dict, tmp: Path, dev, device_arg) -> dict:
    """-t and one resumed epoch in the ranks of a trained run, -t on one
    device, ``Predictor.from_run_dir`` on one device → fields; raises on
    a gate."""
    from lanczosnet_torch.parallel import multihost

    run, cfg = t["run_dir"], t["cfg"]
    # on one device first: the resume in the ranks may write a new best
    best = run / "checkpoints" / "best.pt"
    one = {**cfg, "exp_dir": str(tmp / "one"), "test": {"test_model": str(best)},
           "train": {**cfg["train"], "tp": 1, "num_devices": 1}}
    path = tmp / "one_device_test.yaml"
    path.write_text(config_io.dumps(one))
    with kept_runners("QM8Runner") as made:
        rc = cli.main(["-c", str(path), "-t", *(["--device", device_arg] if device_arg else [])])
    if rc != 0:
        raise SmokeFailure(f"one-device -t of {best} exited {rc}")
    (one_mae,) = [e["mae"] for e in read_metrics(only_run_dir(tmp / "one", "_test"))
                  if e["event"] == "test"]
    runner = made[0]
    test = runner.datasets["test"]
    with torch.inference_mode():
        restored = np.concatenate([
            runner.model(to_device(test.slice_batch(np.arange(lo, min(lo + 64, len(test)))),
                                   runner.device)).cpu().numpy()
            for lo in range(0, len(test), 64)]) * runner.stats.std + runner.stats.mean
    pred = Predictor.from_run_dir(run, device=dev)
    graphs = synthetic_qm8_graphs(len(test), seed=int(cfg["dataset"].get("seed", 7)) + 2,
                                  n_hi=min(int(cfg["dataset"]["n_max"]), 28))
    served = pred.predict(graphs)
    serve_err = float(np.abs(served - restored).max())

    t0 = time.perf_counter()
    code = multihost.launch(t["ranks"], "chip_smoke:qm8_parallel_followups",
                            [str(run / "config.yaml"), device_arg], device=device_arg,
                            store_dir=tmp, pythonpath=[Path(__file__).resolve().parent],
                            timeout=600)
    if code != 0:
        raise SmokeFailure(f"qm8_parallel {t['run']}: -t or resume in the ranks exited {code}")
    followup_s = time.perf_counter() - t0
    (ranks_mae,) = [e["mae"] for e in read_metrics(Path(f"{run}_t")) if e["event"] == "test"]
    resumed = [e["epoch"] for e in read_metrics(run) if e["event"] == "epoch"][len(t["epoch_loss"]):]
    out = {"followups_wall_s": followup_s, "ranks_test_mae": ranks_mae,
           "one_device_test_mae": one_mae, "resumed_epochs": resumed,
           "served_max_abs_err_vs_one_device": serve_err}
    fails = []
    if max(abs(ranks_mae - one_mae), abs(t["test_mae"] - one_mae)) > QM8_RETEST_TOL:
        fails.append(f"-t in the ranks {ranks_mae}, on one device {one_mae}, the run's test "
                     f"MAE {t['test_mae']}")
    if resumed != [len(t["epoch_loss"])]:
        fails.append(f"the resumed run logged epochs {resumed}")
    if not (np.isfinite(served).all() and serve_err <= TOL):
        fails.append(f"from_run_dir answers {serve_err} from the one-device model's")
    if fails:
        raise SmokeFailure(f"qm8_parallel {t['run']}: " + "; ".join(fails))
    return out


def qm8_first_step_check(dev, tmp: Path, device_arg) -> dict:
    """The flagship's first step at full width on a ``QM8_FIRST_STEP_MESH``
    of ranks against one device's, on the same batch (64 graphs packed
    here), weights and dropout masks → fields; raises on the gate."""
    from lanczosnet_torch.parallel import multihost

    cfg = config_io.loads(QM8_TP4_CONFIG.read_text())
    graphs = synthetic_qm8_graphs(int(cfg["train"]["batch_size"]), seed=11)
    pack = pack_dataset(graphs, n_max=int(cfg["dataset"]["n_max"]),
                        num_eig_vec=int(cfg["model"]["num_eig_vec"]), standardize=True, device=dev)
    batch = pack.slice_batch(np.arange(len(pack)))
    model_cfg = {**cfg["model"], "num_atom": NUM_ATOM, "num_task": NUM_TASK,
                 "num_edge_type": pack.ops.shape[1] - 1, "node_feat_dim": pack.node_feat.shape[-1]}
    model = build_model(model_cfg)
    model.init_weights(torch.Generator().manual_seed(int(cfg["seed"])))
    spec = {"model": model_cfg, "weights": model.state_dict(), "seed": int(cfg["seed"]),
            "train": {k: cfg["train"][k] for k in ("optimizer", "lr", "wd")},
            "batch": {f: None if getattr(batch, f) is None else getattr(batch, f).numpy()
                      for f in ("atom_type", "node_feat", "ops", "mask", "label", "ritz_val",
                                "ritz_vec", "cluster")}}
    spec_file, out = tmp / "first_step.pt", tmp / "first_step"
    out.mkdir()
    torch.save(spec, spec_file)
    dp, tp = QM8_FIRST_STEP_MESH
    t0 = time.perf_counter()
    code = multihost.launch(dp * tp, "chip_smoke:qm8_first_step",
                            [str(spec_file), str(out), device_arg], device=device_arg,
                            store_dir=tmp, pythonpath=[Path(__file__).resolve().parent],
                            timeout=600)
    if code != 0:
        raise SmokeFailure(f"qm8_parallel first step: the {dp * tp} ranks exited {code}")
    wall = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(dp * tp)]
    one = qm8_first_step_case(spec, dev)
    rel = max(abs(r["loss"] - one["loss"]) / abs(one["loss"]) for r in ranks)
    res = {"first_step_mesh": {"dp": dp, "tp": tp}, "first_step_loss_one_device": one["loss"],
           "first_step_loss_ranks": [r["loss"] for r in ranks], "first_step_loss_rel": rel,
           "first_step_rtol": QM8_FIRST_STEP_RTOL, "first_step_wall_s": wall,
           "first_step_state_bytes": [r["state_bytes"] for r in ranks],
           "one_device_state_bytes": one["state_bytes"]}
    if not rel <= QM8_FIRST_STEP_RTOL:
        raise SmokeFailure(f"qm8_parallel: the first step at dp={dp} × tp={tp} is {rel} from "
                           f"one device's loss (relative)")
    return res


def b1_at_mesh_shapes(dev) -> dict:
    """B1 against its plain version at each data-parallel block of the
    flagship's batch (B = 64/dp): 0.0 apart in all six outputs."""
    k = FLAGSHIP_MODEL["num_eig_vec"]
    errs = {}
    for dp in sorted({shape[0] for *_, shape in QM8_PARALLEL_RUNS.values()}):
        b = SERVE_BATCH // dp
        s, mask = qm8_operators(b, 20 + dp, dev)
        got = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, k, EPS)
        want = lanczos_tridiag_resid(s, mask, k, EPS)
        errs[b] = compare_outputs(f"qm8_parallel-b{b}", s, k, got, want)
    if any(e != 0.0 for e in errs.values()):
        raise SmokeFailure(f"B1 differs from its plain version at the mesh's batches: {errs}")
    return errs


def phase_qm8_parallel(dev, smi: str, tmp: Path, device_arg=None) -> int:
    """The QM8 runner's data and tensor parallelism through the CLI, the
    ranks sharing the card: the runs of ``QM8_PARALLEL_RUNS``, the
    tp run's follow-ups, the first step against one device, B1 at the
    mesh's batch blocks. The runs share one pack cache in ``tmp``: the
    first run's rank 0 packs (B1 on the card), the others read it.
    Returns B1's launches in the runs' packs."""
    t_phase = time.perf_counter()
    tmp.mkdir(parents=True)
    cache = os.environ.get("LANCZOSNET_TORCH_CACHE")
    os.environ["LANCZOSNET_TORCH_CACHE"] = str(tmp / "pack_cache")
    try:
        launches = qm8_parallel_runs(dev, smi, tmp, device_arg)
    finally:
        if cache is None:
            del os.environ["LANCZOSNET_TORCH_CACHE"]
        else:
            os.environ["LANCZOSNET_TORCH_CACHE"] = cache
    checks = qm8_first_step_check(dev, tmp, device_arg)
    if device_arg is None:
        checks["b1_max_abs_err_vs_plain"] = b1_at_mesh_shapes(dev)
    emit("qm8_parallel_checks", **checks, lanczos_tridiag_launches=launches,
         phase_s=time.perf_counter() - t_phase, nvidia_smi=smi)
    if device_arg is None and launches == 0:
        raise SmokeFailure("qm8_parallel: no pack of the phase launched B1")
    return launches


def qm8_parallel_runs(dev, smi: str, tmp: Path, device_arg) -> int:
    """The runs of ``QM8_PARALLEL_RUNS`` and the tp run's follow-ups, a
    JSON line each → B1's launches in their packs."""
    from lanczosnet_torch.parallel.tensor import predicted_state_bytes, state_plan

    predicted = {}
    for _, (src, _, _, (dp, tp)) in QM8_PARALLEL_RUNS.items():
        cfg = config_io.loads(src.read_text())
        one = build_model({**cfg["model"], "num_atom": NUM_ATOM, "num_task": NUM_TASK})
        predicted[(dp, tp)] = predicted_state_bytes(state_plan(one, tp), tp)
    launches = 0
    for name in QM8_PARALLEL_RUNS:
        t = qm8_parallel_run(name, tmp / name, device_arg, predicted)
        if name == QM8_PARALLEL_FOLLOWED:
            t.update(qm8_parallel_follow(t, tmp / name, dev, device_arg))
        launches += t["lanczos_tridiag_launches"]
        emit("qm8_parallel", **{k: v for k, v in t.items() if k not in ("run_dir", "cfg")},
             nvidia_smi=smi)
    return launches


# the node_sharded_citation phase: the dense citation runner's node rows
# over 4 ranks sharing the card over gloo; the depth cuts (of max_epoch
# 200 and 300: the dense_citation phase's 12 epochs, since with dropout
# 0.5 both losses rise over the first epochs); the Cora runs' checks and
# the Pubmed run's memory
NODE_SHARDED_RANKS = 4
NODE_SHARDED_RUNS = {"cora_ada_lanczos_net": DENSE_CITATION_EPOCHS,
                     "pubmed_lanczos_net": DENSE_CITATION_EPOCHS}
NODE_SHARDED_CHECKED = "cora_ada_lanczos_net"  # -t in the ranks and on one device, first step
NODE_SHARDED_PACKED = ("cora_lanczos_net", 2)  # trained in the follow-ups: rank 0's packs run B2
NODE_SHARDED_MEMORY = "pubmed_lanczos_net"  # its per-rank peak against one device's
NODE_SHARDED_FIRST_STEP_RTOL = 1e-5
# every epoch's loss against the dense_citation phase's one-device run of
# the same cut config (the same weights, dropout masks and seed)
NODE_SHARDED_EPOCH_RTOL = 1e-5
# what rank 0 may hold after its set-up beyond the most another rank
# holds: its piece alone, not the whole graph it packed and cut
NODE_SHARDED_RANK0_MARGIN_MB = 64.0
NODE_SHARDED_RETEST_TOL = 1e-6
NODE_SHARDED_PEAK_SHARE = 0.5  # a rank's peak against one device's, at most


def node_sharded_config(name: str, tmp: Path, epochs: int, ranks: int) -> tuple[Path, dict, dict]:
    """``configs/<name>.yaml`` cut to ``epochs`` with ``train.num_devices:
    ranks``, written to ``tmp`` → (path, config, cuts)."""
    cfg, cut = citation_config_cut(name, epochs)
    cfg["exp_dir"] = str(tmp / "exp")
    cut["train.num_devices"] = [cfg["train"].get("num_devices"), ranks]
    cfg["train"]["num_devices"] = ranks
    tmp.mkdir(parents=True)
    path = tmp / f"{name}.yaml"
    path.write_text(config_io.dumps(cfg))
    return path, cfg, cut


def node_sharded_train(name: str, tmp: Path, device_arg) -> dict:
    """Train ``configs/<name>.yaml`` (cut) on ``NODE_SHARDED_RANKS`` ranks
    through ``python -m lanczosnet_torch.cli`` → its JSON line's fields;
    raises on a gate."""
    d = NODE_SHARDED_RANKS
    path, cfg, cut = node_sharded_config(name, tmp, NODE_SHARDED_RUNS[name], d)
    t0 = time.perf_counter()
    cli_process(path, device_arg)
    wall = time.perf_counter() - t0
    run = only_run_dir(tmp / "exp", "_train")
    recs = [read_metrics(run, r) for r in range(d)]
    setups = [next(e for e in rec if e["event"] == "setup") for rec in recs]
    ends = [[e for e in rec if e["event"] == "test"][-1] for rec in recs]
    epochs = [[e for e in rec if e["event"] == "epoch"] for rec in recs]
    losses = [e["loss"] for e in epochs[0]]
    steps = [e["step_seconds"] for e in epochs[0]]
    comm_s = [sum(e["comm"]["staging_s"] + e["comm"]["transport_s"] for e in ep) for ep in epochs]
    out = {"config": name, "cut": cut, "ranks": d, "backend": setups[0]["backend"],
           "ranks_per_card": setups[0]["ranks_per_card"],
           "rank_devices": [e["device"] for e in setups], "nodes": setups[0]["n_pad"],
           "rows_per_rank": [e["rows"] for e in setups], "cli_wall_s": wall,
           "train_ce": losses, "val_acc": [e["val_acc"] for e in recs[0] if e["event"] == "train"],
           "test_acc": ends[0]["acc"], "step_ms": [1e3 * x for x in steps],
           "step_ms_last": 1e3 * steps[-1],
           # the comm layer's staging and timed transport over the steps' time
           "comm_share": [c / sum(e["step_seconds"] for e in ep) for c, ep in zip(comm_s, epochs)],
           "comm_staged_mb_a_step": sum(e["comm"]["staged_bytes"] for e in epochs[0])
           / len(epochs[0]) / 2**20,
           "setup_s_rank0": {k: v for k, v in setups[0].items() if k.endswith("_s")},
           "peak_gb_per_rank": [e.get("peak_memory_mb", 0.0) / 1024 for e in ends],
           "setup_peak_gb_per_rank": [e.get("peak_memory_mb", 0.0) / 1024 for e in setups],
           "setup_held_gb_per_rank": [e.get("memory_mb", 0.0) / 1024 for e in setups],
           "host_peak_rss_gb_per_rank": [e["host_peak_rss_mb"] / 1024 for e in ends],
           "stream_launches_per_rank": [e["stream_launches"] for e in ends],
           "plain_routes_rank0": setups[0]["plain_routes"]}
    fails = []
    # rank r on card r % cards: on the one card the script needs, all on cuda:0
    cards = [f"cuda:{r % max(torch.cuda.device_count(), 1)}" for r in range(d)]
    if device_arg is None and out["rank_devices"] != cards:
        fails.append(f"the ranks ran on {out['rank_devices']}, not on {cards}")
    if len(losses) != NODE_SHARDED_RUNS[name] or not np.isfinite(losses).all():
        fails.append(f"epoch losses {losses}")
    elif not losses[-1] < losses[0]:
        fails.append(f"the loss did not fall: {losses}")
    held = [e.get("memory_mb", 0.0) for e in setups]
    if not held[0] <= max(held[1:]) + NODE_SHARDED_RANK0_MARGIN_MB:
        fails.append(f"rank 0 holds {held[0]} MB after its set-up, the others {held[1:]}")
    if fails:
        emit("node_sharded_citation", **out, failed=fails)
        raise SmokeFailure(f"node_sharded_citation {name}: " + "; ".join(fails))
    out["run_dir"], out["cfg"] = run, cfg
    return out


def node_sharded_followups(config: str, packed: str, device=None) -> int:
    """What each rank does after the checked run: ``-t`` on its best
    checkpoint through ``cli.run`` (in ``<run>_t``); rank 0 holds B2 to
    its plain version on the learned operator gathered from the ranks'
    rows; then ``packed`` (a LanczosNet config with ``train.num_devices``,
    its run directory minted) trains through ``cli.run``, and rank 0
    holds its packed Ritz pairs to the plain version's on the operator
    gathered from the ranks' rows. Rank 0 writes what it found to
    ``<run>_t/followups.json``."""
    from lanczosnet_torch.core.graph_batch import gather_nodes
    from lanczosnet_torch.parallel import multihost
    from lanczosnet_torch.utils.config import AttrDict

    rank = multihost.world().rank
    base = AttrDict.convert(config_io.loads(Path(config).read_text()))
    run = Path(base.save_dir)
    tested = AttrDict.convert({**base, "save_dir": f"{run}_t", "is_test": True,
                               "test": {"test_model": str(run / "checkpoints" / "best.pt")}})
    Path(tested.save_dir).mkdir(exist_ok=True)
    with kept_runners("CitationRunner") as made:
        codes = [cli.run(tested, True, "INFO", device)]
    out = {}
    if codes[0] == 0:
        model, batch = made[0].model.eval(), made[0].batch
        with torch.no_grad():
            h = model.encoder(batch.atom_type, batch.node_feat, batch.mask)
            s = gather_nodes(model.learned_operator(h, batch), batch.shard).contiguous()
        if rank == 0:
            k, mask = model.num_eig_vec, batch.shard.mask
            got = lanczos_cuda.lanczos_tridiag_cuda_resid(
                s, mask, k, EPS, impl="plain" if device == "cpu" else "kernel")
            want = lanczos_tridiag_resid_stream(s, mask, k, EPS)
            out["b2_gathered_learned_operator_max_abs_err"] = compare_outputs(
                "node_sharded-gathered-learned-operator-n2708-k20", s, k, got, want)
        del made[:], model, batch, s
    lnet = AttrDict.convert(config_io.loads(Path(packed).read_text()))
    with kept_runners("CitationRunner") as made:
        codes.append(cli.run(lnet, False, "INFO", device))
    if codes[1] == 0:
        batch = made[0].batch
        with torch.no_grad():
            s = gather_nodes(batch.ops[:, 0], batch.shard).contiguous()
            vecs = gather_nodes(batch.ritz_vec, batch.shard)
        if rank == 0:
            k = batch.ritz_val.shape[-1]
            vals, want = batched_lanczos_ritz_dispatch(s, batch.shard.mask, k, impl="plain")
            out["packed_ritz_max_abs_err_vs_plain"] = max(
                float((batch.ritz_val - vals).abs().max()), float((vecs - want).abs().max()))
            out["packed_on_kernel"] = lanczos_cuda.kernel_limit(s.shape[-1], k) is None
    if rank == 0:
        out["codes"] = codes
        (Path(tested.save_dir) / "followups.json").write_text(json.dumps(out))
    return max(codes)


def node_sharded_checks(t: dict, tmp: Path, dev, device_arg) -> dict:
    """The checked run's follow-ups in its ranks; ``-t`` on one device
    from the same checkpoint; the first step on one device against the
    ranks' → fields; raises on a gate."""
    from lanczosnet_torch.parallel import multihost

    run, cfg = t["run_dir"], t["cfg"]
    name, epochs = NODE_SHARDED_PACKED
    packed_path = node_sharded_config(name, tmp / "packed", epochs, NODE_SHARDED_RANKS)[0]
    packed = config_io.load_config(packed_path)
    t0 = time.perf_counter()
    code = multihost.launch(NODE_SHARDED_RANKS, "chip_smoke:node_sharded_followups",
                            [str(run / "config.yaml"), str(Path(packed.save_dir) / "config.yaml"),
                             device_arg], device=device_arg, store_dir=tmp,
                            pythonpath=[Path(__file__).resolve().parent], timeout=600)
    followup_s = time.perf_counter() - t0
    if code != 0:
        raise SmokeFailure(f"node_sharded_citation: the follow-ups in the ranks exited {code}")
    found = json.loads((Path(f"{run}_t") / "followups.json").read_text())
    (ranks_acc,) = [e["acc"] for e in read_metrics(Path(f"{run}_t")) if e["event"] == "test"]
    pack_setup = next(e for e in read_metrics(Path(packed.save_dir)) if e["event"] == "setup")

    best = run / "checkpoints" / "best.pt"
    one = {**cfg, "exp_dir": str(tmp / "one"), "test": {"test_model": str(best)},
           "train": {**cfg["train"], "num_devices": 1}}
    path = tmp / "one_device_test.yaml"
    path.write_text(config_io.dumps(one))
    if cli.main(["-c", str(path), "-t", *(["--device", device_arg] if device_arg else [])]) != 0:
        raise SmokeFailure(f"node_sharded_citation: one-device -t of {best} failed")
    (one_acc,) = [e["acc"] for e in read_metrics(only_run_dir(tmp / "one", "_test"))
                  if e["event"] == "test"]

    # the first step on one device, on the same weights and dropout masks
    runner = CitationRunner({**one, "save_dir": str(tmp / "first_step"), "test": {}}, dev)
    optimizer, scheduler, clip = build_optimizer(runner.model.parameters(), cfg["train"], 1)
    step = make_node_train_step(runner.model, optimizer, scheduler, clip)
    first = float(step(runner.batch, runner.splits["train"]))
    del runner, step, optimizer
    rel = abs(t["train_ce"][0] - first) / abs(first)
    out = {"followups_wall_s": followup_s, "ranks_test_acc": ranks_acc,
           "one_device_test_acc": one_acc, "first_step_loss_ranks": t["train_ce"][0],
           "first_step_loss_one_device": first, "first_step_loss_rel": rel,
           "first_step_rtol": NODE_SHARDED_FIRST_STEP_RTOL, **found,
           "packed_config": name, "packed_stream_launches_rank0": pack_setup["stream_launches"]}
    fails = []
    if max(abs(ranks_acc - one_acc), abs(t["test_acc"] - one_acc)) > NODE_SHARDED_RETEST_TOL:
        fails.append(f"-t in the ranks {ranks_acc}, on one device {one_acc}, the run's test "
                     f"accuracy {t['test_acc']}")
    if not rel <= NODE_SHARDED_FIRST_STEP_RTOL:
        fails.append(f"the first step is {rel} from one device's loss (relative)")
    if device_arg is None:
        if found.get("b2_gathered_learned_operator_max_abs_err") != 0.0:
            fails.append(f"B2 on the gathered learned operator: {found}")
        if not (found.get("packed_on_kernel") and pack_setup["stream_launches"] >= 1
                and found.get("packed_ritz_max_abs_err_vs_plain") == 0.0):
            fails.append(f"rank 0's pack of {name}: {pack_setup['stream_launches']} B2 launches, "
                         f"{found}")
        forwards = 2 * len(t["train_ce"]) + 1  # a train and a val forward an epoch, the test
        if min(t["stream_launches_per_rank"]) < forwards:
            fails.append(f"B2 launches a rank {t['stream_launches_per_rank']}, fewer than the "
                         f"{forwards} forwards")
    if fails:
        emit("node_sharded_citation_checks", **out, failed=fails)
        raise SmokeFailure("node_sharded_citation: " + "; ".join(fails))
    return out


def phase_node_sharded_citation(dev, smi: str, tmp: Path, one_device: dict,
                                device_arg=None) -> int:
    """The dense citation runner's node-sharding through the CLI, the
    ranks sharing the card: ``NODE_SHARDED_RUNS``, the checked run's
    follow-ups and one-device checks, every run's epoch losses and the
    memory run's per-rank peak against one device's (``one_device``, the
    dense_citation phase's runs by config). → B2's launches on this
    path: every rank's in the checked run, rank 0's in the packed run."""
    t_phase = time.perf_counter()
    launches = 0
    for name in NODE_SHARDED_RUNS:
        t = node_sharded_train(name, tmp / name, device_arg)
        if name == NODE_SHARDED_CHECKED:
            t.update(node_sharded_checks(t, tmp / name, dev, device_arg))
            launches += sum(t["stream_launches_per_rank"]) + t["packed_stream_launches_rank0"]
        if name in one_device:
            want = one_device[name]["train_ce"]
            rel = [abs(a - b) / abs(b) for a, b in zip(t["train_ce"], want)]
            t.update(one_device_train_ce=want, epoch_loss_rel=rel,
                     epoch_loss_rtol=NODE_SHARDED_EPOCH_RTOL)
            if len(rel) != len(want) or not max(rel) <= NODE_SHARDED_EPOCH_RTOL:
                fail = f"epoch losses {t['train_ce']} against one device's {want}"
                emit("node_sharded_citation", **{k: v for k, v in t.items()
                                                 if k not in ("run_dir", "cfg")}, failed=[fail])
                raise SmokeFailure(f"node_sharded_citation {name}: {fail}")
        if name == NODE_SHARDED_MEMORY:
            one = one_device.get(name, {}).get("peak_memory_mb", 0.0) / 1024
            t.update(one_device_peak_gb=one, peak_share_limit=NODE_SHARDED_PEAK_SHARE)
            if device_arg is None and not max(t["peak_gb_per_rank"]) < NODE_SHARDED_PEAK_SHARE * one:
                raise SmokeFailure(f"node_sharded_citation {name}: per-rank peaks "
                                   f"{t['peak_gb_per_rank']} GB, one device's {one} GB")
        emit("node_sharded_citation", **{k: v for k, v in t.items() if k not in ("run_dir", "cfg")},
             nvidia_smi=smi)
    emit("node_sharded_citation_phase", stream_launches=launches,
         phase_s=time.perf_counter() - t_phase, nvidia_smi=smi)
    if device_arg is None and launches == 0:
        raise SmokeFailure("node_sharded_citation: no rank launched B2")
    return launches


# ------------------------------------ the Ritz eigensolver and the tools
EIGH_BATCHES = (SERVE_BATCH, 256)
EIGH_TOL = 1e-4  # Jacobi against cuSOLVER: Ritz values, V tanh(D) Vᵀ, predictions
EIGH_SLEEP_CYCLES = 100_000_000  # a sleeping kernel queued ahead of a call: about 50 ms
PROFILE_STEP_EPOCHS = 1  # the depth cut: of torch_profile_step.py's 10
PROFILE_SUM_RTOL = 0.01  # the table's self times against the trace's busy time
MEM_PROBE_CONFIG = "ten_million_sparse_lanczos_net"
MEM_PROBE_RTOL = 0.15  # the probe's train-step peak against the full run's


def script(name: str):
    """A module of ``scripts/``, loaded from its file (the folder is no
    package)."""
    import importlib.util

    path = QM8_CONFIG.parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_launches(fn) -> int:
    """The device's kernels, copies and memsets in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)))


def host_waits(fn, host_ms_of_call: float) -> dict:
    """Whether ``fn`` waits for the device, two ways: ``sync_calls``, the
    synchronizing calls PyTorch's sync debug mode reports in one call
    (``waits_on_host`` if any); ``returned_during_sleep``, whether it
    returns while a sleeping kernel queued ahead of it, four times as long
    as the call takes on the host (at least 50 ms), still runs. A call of
    more launches than the launch queue holds (about a thousand) blocks
    on the full queue and reads False there without a sync."""
    import warnings

    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(EIGH_SLEEP_CYCLES)
    end.record()
    end.synchronize()
    base_ms = start.elapsed_time(end)
    cycles = int(EIGH_SLEEP_CYCLES * max(1.0, 4.0 * host_ms_of_call / base_ms))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    fn()
    returned_during_sleep = not end.query()
    torch.cuda.synchronize()
    return {"waits_on_host": syncs > 0, "sync_calls": syncs,
            "returned_during_sleep": returned_during_sleep, "sleep_ms": start.elapsed_time(end)}


def ritz_pairs(alphas, betas, q, impl: str):
    """``ritz_from_tridiag`` with the solver named."""
    vals, u = eigh_dispatch(tridiag_matrix(alphas, betas), impl)
    with f32_matmul():
        return vals, q.transpose(1, 2) @ u


def tanh_fn(vals, vecs):
    with f32_matmul():
        return vecs @ (torch.tanh(vals)[:, :, None] * vecs.transpose(1, 2))


def served_with(pred: Predictor, chunk: list, impl: str) -> np.ndarray:
    """The Predictor's model on a packed chunk, its Ritz pairs from B1
    and the solver named."""
    k = pred.num_eig_vec
    with torch.inference_mode():
        batch = pred.graph_batch(*pred._pack(chunk))
        alphas, betas, q, *_ = lanczos_cuda.lanczos_tridiag_cuda_resid(
            batch.ops[:, 0], batch.mask, k, EPS)
        batch.ritz_val, batch.ritz_vec = ritz_pairs(alphas, betas[:, : k - 1], q, impl)
        return pred.model(batch).cpu().numpy()[: len(chunk)]


def phase_eigh(dev, smi: str) -> int:
    """The Ritz eigensolver, Jacobi (``ops/jacobi.py``) against the
    default (cuSOLVER), on the flagship's tridiagonals from B1 at B=64 and
    B=256, K=20: the Ritz values and V tanh(D) Vᵀ within 1e-4, the
    flagship's predictions with Jacobi's Ritz pairs within 1e-4 of the
    default's; each solver's ms (CUDA events, host clock), its device
    launches and whether it waits on the host. → B1's launches."""
    k = FLAGSHIP_MODEL["num_eig_vec"]
    lanczos_cuda.launches.reset()
    cases = {}
    for b in EIGH_BATCHES:
        s, mask = qm8_operators(b, 1, dev)
        alphas, betas, q, *_ = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, k, EPS)
        cases[b] = (alphas, betas[:, : k - 1], q)
    cfg = {**FLAGSHIP_MODEL, "num_atom": NUM_ATOM, "num_task": NUM_TASK}
    model = build_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    pred = Predictor(model, model.state_dict(), n_max=FLAGSHIP_DATASET["n_max"],
                     batch_size=SERVE_BATCH, num_eig_vec=k,
                     operator_kind=FLAGSHIP_DATASET["operator_kind"], num_task=NUM_TASK,
                     device=dev)
    chunk = synthetic_qm8_graphs(SERVE_BATCH, seed=2)
    served = {impl: served_with(pred, chunk, impl) for impl in ("auto", "jacobi")}
    launches = lanczos_cuda.launches.count

    out, errs = {}, {}
    for b, (alphas, betas, q) in cases.items():
        t = tridiag_matrix(alphas, betas)
        pairs = {impl: ritz_pairs(alphas, betas, q, impl) for impl in ("auto", "jacobi")}
        val_err = float((pairs["jacobi"][0] - pairs["auto"][0]).abs().max())
        fn_err = float((tanh_fn(*pairs["jacobi"]) - tanh_fn(*pairs["auto"])).abs().max())
        finite = all(bool(torch.isfinite(x).all()) for pair in pairs.values() for x in pair)
        solvers = {}
        for impl, reps in (("auto", 20), ("jacobi", 5)):
            call = lambda impl=impl: eigh_dispatch(t, impl)  # noqa: E731
            wall = host_ms(call, reps, 1)
            solvers[impl] = {"ms": cuda_ms(call, reps, 1), "host_ms": wall,
                             **host_waits(call, wall)}
            if b == SERVE_BATCH:  # the same at every B: the rounds do not grow with it
                solvers[impl]["device_launches"] = device_launches(call)
        out[b] = {"ritz_val_max_abs_err": val_err, "tanh_fn_max_abs_err": fn_err,
                  "finite": finite, "solvers": solvers}
        errs[b] = max(val_err, fn_err) if finite else float("inf")
    pred_err = float(np.abs(served["jacobi"] - served["auto"]).max())
    emit("eigh", k=k, sweeps=jacobi_sweeps(k), batches=out,
         served_max_abs_err_jacobi_vs_auto=pred_err, tol=EIGH_TOL,
         lanczos_tridiag_launches=launches, nvidia_smi=smi)
    if max(errs.values()) > EIGH_TOL:
        raise SmokeFailure(f"Jacobi's Ritz pairs differ from the default solver's: {errs}")
    if not (np.isfinite(served["jacobi"]).all() and pred_err <= EIGH_TOL):
        raise SmokeFailure(f"the flagship served with Jacobi's Ritz pairs differs by {pred_err}")
    return launches


def phase_profile_step(dev, smi: str, tmp: Path) -> int:
    """``scripts/torch_profile_step.py`` at the bench's working point, cut
    to 2 epochs: the table of self device time by op category sums to
    the trace's busy time (1%), and holds B1 (the pack's). → B1's
    launches."""
    tps = script("torch_profile_step")
    lanczos_cuda.launches.reset()
    t0 = time.perf_counter()
    report = tps.profile(dev, out=tmp, epochs=PROFILE_STEP_EPOCHS)
    wall = time.perf_counter() - t0
    launches = lanczos_cuda.launches.count
    rows = {r["category"]: r for r in report["table"]}
    busy_ms = None if report["device_busy_s"] is None else report["device_busy_s"] * 1e3
    emit("profile_step", seconds=wall, lanczos_tridiag_launches=launches,
         busy_ms=busy_ms, cut={"epochs": [tps.EPOCHS, PROFILE_STEP_EPOCHS]},
         **{k: v for k, v in report.items() if k != "trace_file"}, nvidia_smi=smi)
    if busy_ms is None or report["timeline"] != "device":
        raise SmokeFailure("the profile_step trace holds no device time")
    if abs(report["self_ms_total"] - busy_ms) > PROFILE_SUM_RTOL * busy_ms:
        raise SmokeFailure(f"the table sums to {report['self_ms_total']} ms, the trace's busy "
                           f"time is {busy_ms} ms")
    if rows.get("B1 lanczos_tridiag", {}).get("ops", 0) < 1 or launches < 1:
        raise SmokeFailure(f"the profile holds no B1 row: {sorted(rows)}; launches {launches}")
    if not np.isfinite(report["loss"]):
        raise SmokeFailure(f"the profiled training's loss is {report['loss']}")
    return launches


BENCH_CUT = {"group": 1, "rounds": 1}  # the depth cut: of torch_bench.py's 10 epochs and 2 groups
BENCH_SERVE_RUNS = (("--window", "2", "--concurrency", "1,16"),
                    ("--window", "2", "--native", "--binary", "--concurrency", "16"))
# the depth cut: bfloat16 alone of the tool's two dtypes (each a process
# of its own), 250k of its 1M nodes
BENCH_SPARSE_ARGS = ("--feat", "128", "--steps", "3", "--nodes", "250000", "--dtypes",
                     "bfloat16")


def tool_run(name: str, args, timeout: float = 300) -> tuple[list[dict], str, float]:
    """``scripts/<name>.py args`` in a process of its own → (its JSON rows,
    its stderr, seconds); raises unless it exits 0 in time."""
    root = QM8_CONFIG.parents[1]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(root / "scripts" / f"{name}.py"), *args],
                          cwd=root, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(f"{name}.py {' '.join(args)} exited {proc.returncode}: "
                           f"{(proc.stdout + proc.stderr)[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return rows, proc.stderr, wall


def phase_bench(dev, smi: str) -> dict[str, int]:
    """The three measuring tools. ``scripts/torch_bench.py`` in process at
    its working point, cut to one warm, one timed and one traced epoch:
    the loss finite, graphs/s above 0, the traced share of device time
    in (0, 1], B1 launched by the pack. ``torch_bench_serve.py`` over
    HTTP (1 and 16 clients) and over the native front with the binary
    wire (16): no request fails, B1 launched. ``torch_bench_sparse.py`` at
    F=128, 3 steps, 250k nodes, bfloat16: a row with a finite loss.
    → B1's launches by path."""
    tb = script("torch_bench")
    lanczos_cuda.launches.reset()
    t0 = time.perf_counter()
    line, r = tb.run(device=dev, **BENCH_CUT)
    wall = time.perf_counter() - t0
    launches = {"bench": lanczos_cuda.launches.count}
    emit("bench", seconds=wall, line=line, loss=r["loss"], pack_s=r["pack_s"],
         device_busy_s=r["device_busy_s"], lanczos_tridiag_launches=launches["bench"],
         cut={k: [getattr(tb, k.upper()), v] for k, v in BENCH_CUT.items()}, nvidia_smi=smi)
    frac = line["device_time_frac"]
    if not (np.isfinite(r["loss"]) and line["value"] > 0 and frac is not None and 0 < frac <= 1
            and launches["bench"] >= 1):
        raise SmokeFailure(f"torch_bench: loss {r['loss']}, {line['value']} graphs/s, device "
                           f"time share {frac}, B1 launches {launches['bench']}")
    serve_launches = 0
    for args in BENCH_SERVE_RUNS:
        rows, err, wall = tool_run("torch_bench_serve", args)
        counts = [int(ln.rsplit(":", 1)[1]) for ln in err.splitlines()
                  if ln.startswith("lanczos_tridiag launches:")]
        serve_launches += sum(counts)
        emit("bench_serve", seconds=wall, args=list(args), rows=rows,
             lanczos_tridiag_launches=counts, nvidia_smi=smi)
        if not rows or any(row["errors"] != 0 for row in rows) or len(counts) != 1 \
                or counts[0] < 1:
            raise SmokeFailure(f"torch_bench_serve.py {' '.join(args)}: rows {rows}, "
                               f"B1 launches {counts}")
    launches["bench_serve"] = serve_launches
    rows, _, wall = tool_run("torch_bench_sparse", BENCH_SPARSE_ARGS)
    emit("bench_sparse", seconds=wall, args=list(BENCH_SPARSE_ARGS), rows=rows, nvidia_smi=smi)
    if len(rows) != 1 or not all(np.isfinite(row.get("loss", np.nan)) for row in rows):
        raise SmokeFailure(f"torch_bench_sparse.py: rows {rows}")
    return launches


def phase_mem_probe(dev, smi: str, tmp: Path, graphs: dict, peaks: dict) -> None:
    """``scripts/torch_mem_probe.py --stub-precompute`` on the 10M-node
    LanczosNet, on the graph the sparse phase drew: the train step's peak
    within 15% of the full run's peak in that phase."""
    probe = script("torch_mem_probe")
    cfg, _ = citation_config_cut(MEM_PROBE_CONFIG, SPARSE_CITATION_EPOCHS)
    cfg["save_dir"] = str(tmp)
    key = json.dumps(cfg["dataset"], sort_keys=True)
    t0 = time.perf_counter()
    rows = probe.probe(cfg, dev, stub_precompute=True, graph=graphs[key])
    wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    train = next(r for r in rows if r["program"] == "train_step")
    full_mb = peaks[MEM_PROBE_CONFIG]
    ratio = train["peak_allocated_bytes"] / 2**20 / full_mb
    emit("mem_probe", config=MEM_PROBE_CONFIG, seconds=wall, rows=rows,
         full_run_peak_mb=full_mb, train_peak_over_full_run=ratio, rtol=MEM_PROBE_RTOL,
         nvidia_smi=smi)
    if abs(ratio - 1.0) > MEM_PROBE_RTOL:
        raise SmokeFailure(f"the probe's train-step peak is {ratio:.3f} of the full run's "
                           f"{full_mb} MB")
    if not all(r["fits"] for r in rows):
        raise SmokeFailure(f"the probe says {MEM_PROBE_CONFIG} does not fit: {rows}")


def phase_poisoned_alloc(dev, smi: str) -> None:
    """B1 and B2 over a caching allocator poisoned with NaN blocks of
    every size the call allocates: all six outputs bit for bit a clean
    call's (``lanczosnet_torch/utils/poison.py``)."""
    t0 = time.perf_counter()
    check = poisoned_lanczos_check(dev, np.random.default_rng(0))
    emit("poisoned_alloc", seconds=time.perf_counter() - t0, cases=check, nvidia_smi=smi)
    bad = [name for name, c in check.items() if not (c["bit_equal"] and c["finite"])]
    if bad:
        raise SmokeFailure(f"{bad} differ from a clean call over poisoned memory: {check}")


def phase_run_all(smi: str, tmp: Path) -> None:
    """``scripts/torch_run_all.py --only qm8_gcn --qm8-epochs 1`` into a
    file of its own: exit 0, one row, the card named in the header."""
    out = tmp / "RESULTS_TORCH.md"
    tmp.mkdir(parents=True, exist_ok=True)
    root = QM8_CONFIG.parents[1]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(root / "scripts" / "torch_run_all.py"), "--only",
                           "qm8_gcn", "--qm8-epochs", "1", "--out", str(out)],
                          cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    text = out.read_text() if out.exists() else ""
    rows = [line for line in text.splitlines() if line.startswith("| qm8_gcn |")]
    emit("run_all", seconds=wall, rc=proc.returncode, rows=rows,
         header=text.splitlines()[2] if text.count("\n") > 2 else None,
         stderr_tail=proc.stderr[-2000:] if proc.returncode else "", nvidia_smi=smi)
    if proc.returncode != 0 or len(rows) != 1 or smi not in text:
        raise SmokeFailure(f"torch_run_all.py exited {proc.returncode}, rows {rows}, "
                           f"the card named: {smi in text}")


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then the phase's wall seconds on a line of
    their own: ``{"phase": name, "wall_s": s}``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(json.dumps({"phase": name, "wall_s": time.perf_counter() - t0}), flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    smi = timed("device", phase_device)
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    barrier = timed("barrier", phase_barrier, dev)
    kern = timed("kernel", phase_kernel, dev, barrier["small_launch_ms"])
    spmm, spmm_heads = timed("spmm_kernel", phase_spmm_kernel, dev, smi)
    serve_launches = timed("serve", phase_serve, dev, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runs_") as runs:
        runs = Path(runs)
        pack_launches, flagship_run, flagship_gps = timed(
            "qm8_train", phase_qm8_train, dev, smi, runs / "qm8_train")
        eigh_launches = timed("eigh", phase_eigh, dev, smi)
        profile_launches = timed("profile_step", phase_profile_step, dev, smi,
                                 runs / "profile_step")
        bench_launches = timed("bench", phase_bench, dev, smi)
        timed("poisoned_alloc", phase_poisoned_alloc, dev, smi)
        model_launches, model_runs = timed("qm8_models", phase_qm8_models, dev, smi,
                                           runs / "qm8_models")
        bucket_launches = timed("qm8_buckets", phase_qm8_buckets, dev, smi,
                                runs / "qm8_buckets", flagship_gps)
        front_launches = timed("serve_fronts", phase_serve_fronts, dev, smi, flagship_run,
                               model_runs[QM8_MODELS_CLI], runs / "serve_fronts")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cora_") as run_dir:
        runner = timed("citation_setup", CitationRunner, citation_config(run_dir), device=dev)
        stream = timed("stream_kernel", phase_stream_kernel, dev, runner, barrier)
        stream_launches = timed("citation_train", phase_citation_train, runner, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_citation_") as runs:
        dense_launches, dense_runs = timed("dense_citation", phase_dense_citation, smi,
                                           Path(runs) / "dense")
        node_launches = timed("node_sharded_citation", phase_node_sharded_citation, dev, smi,
                              Path(runs) / "node_sharded", dense_runs)
        csr_before = [c.count for c in CSR_COUNTERS]
        graphs, peaks = timed("sparse_citation", phase_sparse_citation, dev, smi,
                              Path(runs) / "sparse")
        csr_main = [c.count - b for c, b in zip(CSR_COUNTERS, csr_before)]
        timed("mem_probe", phase_mem_probe, dev, smi, Path(runs) / "mem_probe", graphs, peaks)
        timed("sharded_citation", phase_sharded_citation, dev, smi, Path(runs) / "sharded",
              graphs)
        parallel_launches = timed("qm8_parallel", phase_qm8_parallel, dev, smi,
                                  Path(runs) / "qm8_parallel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_all_") as tmp:
        timed("run_all", phase_run_all, smi, Path(tmp))
    dryrun_launches = timed("dryrun", phase_dryrun, smi)
    print(json.dumps({"phase": "total", "wall_s": time.perf_counter() - t_start}), flush=True)
    t64, t256 = kern["timing"][SERVE_BATCH], kern["timing"][256]
    ts = stream["timing"]
    no_library = "none: no single PyTorch call computes K-step Lanczos"
    by_path = {"serve": serve_launches, "qm8_train_packs": pack_launches,
               "eigh": eigh_launches, "profile_step": profile_launches, **bench_launches,
               "qm8_models_bf16_run": model_launches[QM8_BF16],
               "qm8_models_ada_run": model_launches[QM8_ADA], "qm8_buckets": bucket_launches,
               **front_launches, "qm8_parallel": parallel_launches, "dryrun": dryrun_launches}
    print(json.dumps({"kernels": [{
        "name": "lanczos_tridiag",
        "route": "cuda",
        "source": "lanczosnet_torch/csrc/lanczos_tridiag.cu",
        "replaces": "lanczosnet_tpu/ops/lanczos_pallas.py:81",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "custom_op": "lanczosnet::lanczos_tridiag_resid",
        "max_abs_err": kern["max_abs_err"],
        "ms": t64["kernel_ms"],
        "kernel_ms": t64["kernel_ms"],
        "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"],
        "bound_by": t64["bound_by"],
        "library_ms": None,
        "library": no_library,
        "shape": f"B={SERVE_BATCH} N=32 K=20",
        "latency_floor_ms": t64["latency_floor_ms"],
        "device_launches_per_call": t64["device_launches_per_call"],
        "b256": t256,
    }, {
        "name": "lanczos_stream",
        "route": "cuda",
        "source": "lanczosnet_torch/csrc/lanczos_stream.cu",
        "replaces": "lanczosnet_tpu/ops/lanczos_pallas.py:184",
        "launches": stream_launches + dense_launches + node_launches,
        "launches_by_path": {"citation_train": stream_launches, "dense_citation": dense_launches,
                             "node_sharded_citation": node_launches},
        "max_abs_err": stream["max_abs_err"],
        "ms": ts["kernel_ms"],
        "kernel_ms": ts["kernel_ms"],
        "plain_ms": ts["plain_ms"],
        "bound_ms": ts["bound_ms"],
        "bound_by": ts["bound_by"],
        "library_ms": None,
        "library": no_library,
        "shape": "B=1 N=2708 K=20",
        "latency_floor_ms": ts["latency_floor_ms"],
        "device_launches_per_call": ts["device_launches_per_call"],
        "barrier_us": ts["barrier_us"],
        "barriers_per_call": ts["barriers_per_call"],
        "launches_counts": "cooperative launches on the device",
        "kernel_ms_l2_flushed": ts["kernel_ms_l2_flushed"],
        "s_read_k_times_ms": ts["s_read_k_times_ms"],
    }, *({
        "name": name,
        "route": "cuda",
        "source": "lanczosnet_torch/csrc/spmm_csr.cu",
        "replaces": "none: XLA's take and segment_sum (lanczosnet_tpu/ops/sparse.py:spmv)",
        "launches": launches,
        "launches_by_path": {"sparse_citation": launches},
        "by_shape": {f: {**spmm[f][name], "max_abs_err": spmm[f][err],
                         "launches_per_call": spmm[f]["launches_per_call"][name]}
                     for f in spmm},
        "by_head_width": {d: {**spmm_heads[d][name], "max_abs_err": spmm_heads[d][err],
                              "launches_per_call": spmm_heads[d]["launches_per_call"][name]}
                          for d in spmm_heads},
        "library_ms": {f: spmm[f][name]["library_ms"] for f in spmm},
        "library": LIBRARY_ROUTES[name],
    } for name, err, launches in zip(("spmm", "spmm_t", "sddmm"),
                                     ("out_max_abs_err", "dx_max_abs_err", "dval_max_abs_err"),
                                     csr_main))]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
