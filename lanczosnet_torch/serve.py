"""Inference and serving.

Counterpart of ``lanczosnet_tpu/serve.py``:

- ``Predictor`` keeps a model on its device and answers graph dicts in
  chunks of a fixed batch, ghost-padded with empty graphs. A request
  ships as the compact wire, the raw uint8 adjacency and the atom types;
  operator normalization, the padding mask and, for LanczosNet, the
  K-step Ritz precompute (the CUDA Lanczos kernel on the card) run on
  the device inside the request program. A chunk whose adjacency is not
  uint8-exact ships float32 adjacency and an explicit mask into the same
  program: the legacy wire's math without a host pack. GPNN's requests
  always take the float32 wire: its partition (``cluster``) is computed
  on the host from channel 0 of the request's operators by the function
  that partitions a packed split (``data/partition.py:cluster_of_ops``),
  so a served GPNN sees the partition it was trained with; the compact
  wire carries none.
- ``RequestProgram`` is that device program as one module: the
  operator stack, the Ritz precompute and the model on the padded wire
  tensors. ``Predictor`` runs it per request batch and ``export.py``
  exports it, so one path serves both.
- ``MicroBatcher`` coalesces single-graph requests from many client
  threads into one device program per batch, keeps per-request latency
  percentiles, and drains queued requests on ``close()``.

    pred = Predictor(model, state_dict, n_max=32, num_eig_vec=20)
    y = pred.predict(graphs)          # graphs: list of graph dicts

    mb = MicroBatcher(pred, max_delay_ms=5)
    y = mb.submit(graph).result()
    print(mb.latency_stats())         # {"p50_ms": ..., "p95_ms": ...}

    pred = Predictor.from_run_dir("exp/qm8_lanczos_net/<run_id>")  # a trained run
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.data.dataset import LabelStats
from lanczosnet_torch.data.partition import cluster_of_ops
from lanczosnet_torch.data.qm8 import NUM_TASK, synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.ops.lanczos_cuda import batched_lanczos_ritz_dispatch
from lanczosnet_torch.ops.normalize import build_operator_stack
from lanczosnet_torch.ops.precision import bf16_f32_accumulation
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.utils.config import loads
from lanczosnet_torch.utils.device import resolve_device


class RequestProgram(torch.nn.Module):
    """The device part of one request batch, as one module: the padded
    wire tensors → standardized predictions ``[B, T]``.

    ``adj`` ``[B,E,N,N]`` uint8 (the compact wire) or float32, ``atom``
    ``[B,N]`` int32, ``node_feat`` ``[B,N,Fc]`` float32, and on the
    float32 wire ``mask`` ``[B,N]`` float32 (the compact wire derives it
    as ``atom > 0``) and, for GPNN, ``cluster`` ``[B,N]``, the partition
    the host computed. Inside: the operator stack, for LanczosNet the
    Ritz pairs (Lanczos through the custom operator, the K×K eigh, the
    rotation), and the model. ``Predictor`` runs it per request batch;
    ``export.py`` exports it with ``torch.export``."""

    def __init__(self, model: torch.nn.Module, num_eig_vec: int = 0, operator_kind: str = "sym"):
        super().__init__()
        self.model = model
        self.num_eig_vec = num_eig_vec
        self.operator_kind = operator_kind

    def graph_batch(self, adj, atom, node_feat, mask=None, cluster=None) -> GraphBatch:
        """The wire tensors → a ``GraphBatch`` with its operator stack."""
        mask = (atom > 0).float() if mask is None else mask
        ops = build_operator_stack(adj.float(), mask, kind=self.operator_kind)
        return GraphBatch(atom_type=atom, node_feat=node_feat, ops=ops, mask=mask, cluster=cluster)

    def forward(self, adj, atom, node_feat, mask=None, cluster=None) -> torch.Tensor:
        batch = self.graph_batch(adj, atom, node_feat, mask, cluster)
        if self.num_eig_vec > 0:
            batch.ritz_val, batch.ritz_vec = batched_lanczos_ritz_dispatch(
                batch.ops[:, 0], batch.mask, self.num_eig_vec)
        return self.model(batch)


class Predictor:
    """Device-resident single-model prediction service."""

    def __init__(
        self,
        model: torch.nn.Module,
        state_dict: Mapping[str, torch.Tensor],
        n_max: int,
        batch_size: int = 64,
        num_eig_vec: int = 0,
        num_cluster: int = 0,
        operator_kind: str = "sym",
        stats: Optional[LabelStats] = None,
        num_task: int = 16,
        device: str | torch.device | None = None,
        compact_wire: bool = True,
    ):
        self.device = resolve_device(device)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.program = RequestProgram(self.model, num_eig_vec, operator_kind).eval()
        self.n_max = n_max
        self.batch_size = batch_size
        self.num_eig_vec = num_eig_vec
        self.num_cluster = num_cluster
        self.operator_kind = operator_kind
        self.stats = stats
        self.num_task = num_task
        # the compact wire carries no partition, so GPNN never takes it
        self.compact_wire = compact_wire and num_cluster == 0

    @classmethod
    def from_run_dir(
        cls,
        run_dir: str | Path,
        tag: str = "best",
        batch_size: int = 64,
        device: str | torch.device | None = None,
        compact_wire: bool = True,
    ) -> "Predictor":
        """Serve a training run: its ``config.yaml`` and the snapshot
        ``tag`` of its checkpoints, with the label width and the training
        split's stats from the snapshot's meta (falling back to ``best``,
        then ``latest``, for tags written without them). A run the JAX
        package trained (``checkpoints/<tag>.msgpack``, no ``.pt``) is
        read too: its flax parameters are mapped to the model's
        ``state_dict`` (``weights.py``)."""
        run_dir = Path(run_dir)
        cfg = loads((run_dir / "config.yaml").read_text())
        dcfg, mcfg = cfg["dataset"], dict(cfg["model"])
        ck = Checkpointer(run_dir)
        metas = [ck.meta(t) or {} for t in (tag, "best", "latest")]
        num_task = next((int(m["num_task"]) for m in metas if "num_task" in m),
                        int(dcfg.get("num_task", NUM_TASK)))
        stats = next((LabelStats(mean=np.asarray(m["label_mean"]), std=np.asarray(m["label_std"]))
                      for m in metas[:2] if "label_mean" in m), None)
        mcfg.setdefault("num_atom", int(dcfg.get("num_atom", 8)))
        mcfg["num_task"] = num_task
        return cls(
            build_model(mcfg),
            ck.restore(tag, model_name=mcfg["name"])["model"],
            n_max=int(dcfg.get("n_max", 32)),
            batch_size=batch_size,
            num_eig_vec=int(mcfg.get("num_eig_vec", 20)) if mcfg["name"] == "LanczosNet" else 0,
            num_cluster=int(mcfg.get("num_partition", 2)) if mcfg["name"] == "GPNN" else 0,
            operator_kind=dcfg.get("operator_kind", "sym"),
            stats=stats,
            num_task=num_task,
            device=device,
            compact_wire=compact_wire,
        )

    def warmup(self) -> None:
        """Run one dummy request through each wire the predictor takes
        (the float32 one alone with the compact wire off), so the first
        real request pays no kernel build or first-launch cost."""
        probe = synthetic_qm8_graphs(1, seed=0, n_lo=4, n_hi=min(8, self.n_max))
        self.predict(probe)
        if self.compact_wire:
            self._finish(*self._dispatch(probe, compact=False))

    def _compact_ok(self, chunk: Sequence[dict]) -> bool:
        """Lossless-uint8 eligibility: the compact wire on (never for
        GPNN: it has no partition), every adjacency entry an integer in
        [0, 255] and every real atom type positive (the device program
        rebuilds the padding mask as atom_type > 0)."""
        if not self.compact_wire:
            return False
        for g in chunk:
            adj = np.asarray(g["adj"])
            if adj.size and (
                adj.min() < 0 or adj.max() > 255 or not np.array_equal(adj, np.trunc(adj))
            ):
                return False
            if (np.asarray(g["atom_type"]) <= 0).any():
                return False
        return True

    def _pack(self, chunk: Sequence[dict], compact: Optional[bool] = None):
        """Pad one chunk on the host to the fixed batch: (adj
        ``[B,E,N,N]`` uint8 or float32, atom ``[B,N]`` int32, node_feat
        ``[B,N,Fc]`` float32, mask ``[B,N]`` float32 or None when the
        device derives it from the atom types)."""
        real = len(chunk)
        if real > self.batch_size:
            raise ValueError(f"chunk {real} > batch_size={self.batch_size}")
        if compact is None:
            compact = self._compact_ok(chunk)
        if compact and not self.compact_wire:
            raise ValueError("this predictor takes the float32 wire alone: the compact wire is off "
                             "(always for GPNN, whose partition it cannot carry)")
        bs, n = self.batch_size, self.n_max
        e = int(np.asarray(chunk[0]["adj"]).shape[0])
        feat0 = chunk[0].get("node_feat")
        fc = 0 if feat0 is None else int(np.asarray(feat0).shape[-1])
        adj = np.zeros((bs, e, n, n), np.uint8 if compact else np.float32)
        atom = np.zeros((bs, n), np.int32)
        feat = np.zeros((bs, n, fc), np.float32)
        mask = None if compact else np.zeros((bs, n), np.float32)
        for i, g in enumerate(chunk):
            at = np.asarray(g["atom_type"], np.int32)
            ni = at.shape[0]
            if ni > n:
                raise ValueError(f"graph has {ni} nodes > n_max={n}")
            atom[i, :ni] = at
            adj[i, :, :ni, :ni] = np.asarray(g["adj"], adj.dtype)
            if fc:
                feat[i, :ni] = np.asarray(g["node_feat"], np.float32)
            if mask is not None:
                mask[i, :ni] = 1.0
        return adj, atom, feat, mask

    def device_args(self, adj, atom, feat, mask) -> tuple[torch.Tensor, ...]:
        """A packed chunk on the device as ``RequestProgram``'s arguments:
        (adj, atom, node_feat) on the compact wire; mask added on the
        float32 wire, and for GPNN the partition of channel 0 of the
        chunk's operators (built on the device, partitioned on the host
        by ``data/partition.py:cluster_of_ops``, as the pack does)."""
        dev = self.device
        args = tuple(torch.from_numpy(a).to(dev) for a in (adj, atom, feat))
        if mask is None:
            return args
        mask_t = torch.from_numpy(mask).to(dev)
        if not self.num_cluster:
            return (*args, mask_t)
        ops = build_operator_stack(args[0].float(), mask_t, kind=self.operator_kind)
        cluster = cluster_of_ops(ops.cpu().numpy(), mask, self.num_cluster)
        return (*args, mask_t, torch.from_numpy(cluster).to(dev))

    def graph_batch(self, adj, atom, feat, mask) -> GraphBatch:
        """A packed chunk on the device as the model's ``GraphBatch``
        (operators, and for GPNN the partition), without the Ritz pairs."""
        return self.program.graph_batch(*self.device_args(adj, atom, feat, mask))

    def _run(self, args: tuple[torch.Tensor, ...]) -> torch.Tensor:
        return self.program(*args)

    def _dispatch(self, chunk: Sequence[dict], compact: Optional[bool] = None):
        """Pack one ≤ batch_size chunk and launch its device program
        without waiting. Returns ``(device_handle, real_count)`` for
        :meth:`_finish`."""
        packed = self._pack(chunk, compact)
        with torch.inference_mode(), bf16_f32_accumulation():
            return self._run(self.device_args(*packed)), len(chunk)

    def _finish(self, handle: torch.Tensor, real: int) -> np.ndarray:
        """Fetch a dispatched chunk's predictions (blocking) in original
        label units when stats are set."""
        pred = handle.cpu().numpy()[:real]
        if self.stats is not None:
            pred = pred * self.stats.std + self.stats.mean
        return pred

    def predict(self, graphs: Sequence[dict]) -> np.ndarray:
        """Graph dicts → ``[len(graphs), T]`` predictions. Every chunk is
        dispatched before any is fetched."""
        graphs = list(graphs)
        bs = self.batch_size
        handles = [self._dispatch(graphs[lo : lo + bs]) for lo in range(0, len(graphs), bs)]
        return np.concatenate([self._finish(h, r) for h, r in handles])


class MicroBatcher:
    """Deadline-bounded request coalescing in front of a ``Predictor``.

    Client threads ``submit(graph)`` and get a Future. A worker thread
    waits at most ``max_delay_ms`` from the first queued request, takes
    up to ``predictor.batch_size`` requests and dispatches one device
    program; a completer thread fetches the results in order and
    resolves the Futures. ``inflight`` bounds the dispatched but
    unfetched batches; depth 1 still overlaps the next batch's pack and
    dispatch with the current fetch, and its back-pressure makes batches
    fuller at saturation.
    """

    def __init__(self, predictor: Predictor, max_delay_ms: float = 5.0, inflight: int = 1):
        self.predictor = predictor
        self.max_delay = max_delay_ms / 1e3
        self._q: "queue.Queue[tuple[dict, Future, float]]" = queue.Queue()
        self._pending: "queue.Queue" = queue.Queue(maxsize=max(1, inflight))
        self._latencies: list[float] = []
        self._batch_sizes: list[int] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._completer = threading.Thread(target=self._complete, daemon=True)
        self._worker.start()
        self._completer.start()

    def submit(self, graph: dict) -> Future:
        fut: Future = Future()
        self._q.put((graph, fut, time.perf_counter()))
        return fut

    def _run(self) -> None:
        """Coalesce requests, dispatch, hand the handle to the completer."""
        bs = self.predictor.batch_size
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_delay
            while len(batch) < bs:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                handle, real = self.predictor._dispatch([b[0] for b in batch])
            except Exception as exc:  # resolve, never wedge clients
                for _, fut, _ in batch:
                    fut.set_exception(exc)
                continue
            self._pending.put((batch, handle, real))

    def _complete(self) -> None:
        """Fetch dispatched handles in order and resolve their Futures."""
        while True:
            try:
                batch, handle, real = self._pending.get(timeout=0.05)
            except queue.Empty:
                # exit only once the dispatcher can no longer produce, or
                # a batch dispatched during shutdown would never resolve
                if self._stop.is_set() and not self._worker.is_alive():
                    return
                continue
            try:
                preds = self.predictor._finish(handle, real)
            except Exception as exc:
                for _, fut, _ in batch:
                    fut.set_exception(exc)
                continue
            done = time.perf_counter()
            with self._lock:
                self._batch_sizes.append(len(batch))
                for (_, fut, t0), y in zip(batch, preds):
                    self._latencies.append(done - t0)
                    fut.set_result(np.asarray(y))

    def latency_stats(self) -> dict:
        """Per-request latency percentiles and batch occupancy."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64) * 1e3
            sizes = np.asarray(self._batch_sizes, np.int64)
        if lat.size == 0:
            return {"count": 0}
        return {
            "count": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "mean_ms": float(lat.mean()),
            "batches": int(sizes.size),
            "mean_batch_size": float(sizes.mean()) if sizes.size else 0.0,
            "max_batch_size": int(sizes.max()) if sizes.size else 0,
        }

    def log_stats(self, metrics) -> dict:
        """Append the current latency stats to a ``MetricsLogger`` as a
        ``serving_latency`` event."""
        stats = self.latency_stats()
        metrics.log("serving_latency", **stats)
        return stats

    def close(self) -> None:
        """Stop both threads; fail every request not yet answered."""
        self._stop.set()
        self._worker.join(timeout=2.0)
        self._completer.join(timeout=10.0)
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher closed"))
        while True:
            try:
                batch, _, _ = self._pending.get_nowait()
            except queue.Empty:
                break
            for _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(RuntimeError("batcher closed"))
