"""Experiment runner for graph regression (the QM8 configs).

Counterpart of ``lanczosnet_tpu/train/runner.py``: builds
the three packed splits, the model and the optimizer from a config; runs
the epochs with validation every ``valid_epoch``; keeps the best (on
validation MAE) and the latest checkpoint; resumes; tests the best
snapshot. Metrics go to the log and to ``metrics.jsonl`` (events
``epoch``, ``train``, ``val``, ``test``, with the JAX runner's fields;
``pack``, the seconds each split took to pack, and ``setup``, the
seconds of the optimizer's set-up and of the resident splits' copy).

    runner = QM8Runner(config)             # on the card
    runner = QM8Runner(config, "cpu")      # where the caller asks
    runner.train(); runner.test()

``config`` is a mapping with the keys of ``configs/qm8_*.yaml`` and a
``save_dir`` (``utils/config.py:load_config`` mints one). With
``train.scan_epoch`` true, or ``auto`` and a training split under 2 GiB,
the splits stay on the device and each epoch is gathered there
(``train/scan_epoch.py``); otherwise batches stream from the host
through ``data/loader.py``.

Data and tensor parallelism. ``train.num_devices`` and ``train.tp`` lay
the run out as the JAX runner's ``(dp, tp)`` mesh
(``parallel/mesh.py:mesh_shape``), one process a rank
(``parallel/multihost.py``; the CLI starts them): rank ``d·tp + t``
trains on block ``d`` of every batch with block ``t`` of every cut
parameter and of its Adam moments (``parallel/tensor.py``). Rank 0
packs the splits (or reads the pack cache) and sends them to the
others; only rank 0 writes checkpoints, which hold the one-device
state, gathered, so that one device, ``Predictor.from_run_dir`` and
``export.py`` read them unchanged. Rank r > 0 logs to
``metrics.rank<r>.jsonl``. A group whose size is not the mesh's raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from lanczosnet_torch.data.buckets import pack_dataset_bucketed
from lanczosnet_torch.data.dataset import (
    PACK_FORMAT_VERSION,
    PackedDataset,
    load_packed,
    pack_dataset,
    save_packed,
)
from lanczosnet_torch.data.loader import BatchLoader, prefetch_to_device
from lanczosnet_torch.data.qm8 import import_reference_pickles, synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.models.base import set_dropout_generator
from lanczosnet_torch.ops import lanczos_cuda
from lanczosnet_torch.parallel import mesh, multihost
from lanczosnet_torch.parallel.tensor import (
    TensorParallel,
    measured_state_bytes,
    predicted_state_bytes,
    state_plan,
)
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.scan_epoch import (
    SHUFFLE_SEED_OFFSET,
    ResidentEval,
    chunk_schedule,
    device_dataset,
    device_permutation,
    host_permutation,
    pair_schedule,
    train_epoch,
    train_pair_piece,
)
from lanczosnet_torch.train.step import make_eval_step, make_pair_step, make_train_step
from lanczosnet_torch.train.unported import refuse_unported
from lanczosnet_torch.utils.device import resolve_device
from lanczosnet_torch.utils.logger import MetricsLogger, get_logger
from lanczosnet_torch.utils.profiling import program_cost, trace

SPLITS = ("train", "val", "test")
SCAN_BYTES_MAX = 2 * 1024**3
# lanczosnet_tpu/train/runner.py's refusal, where a bucketed run would
# stream batches from the host
BUCKETS_RESIDENT_ONLY = ("bucketed datasets run through the scanned trainer only "
                         "(train.scan_epoch must not be false with dataset.buckets)")


def pack_cache_root() -> Path:
    """The port's own pack cache: its Ritz pairs differ from the JAX
    package's in sign and at breakdown, so the two never share packs."""
    root = os.environ.get("LANCZOSNET_TORCH_CACHE")
    return Path(root) if root else Path.home() / ".cache" / "lanczosnet_torch"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class QM8Runner:
    """Config-driven molecular regression on one device or a mesh of ranks."""

    def __init__(self, config: Mapping, device: str | torch.device | None = None):
        refuse_unported(config, "QM8Runner")
        self.config = config
        tcfg = config["train"]
        self.batch_size = int(tcfg["batch_size"])
        self.dp, self.tp = mesh.mesh_shape(self.batch_size, int(tcfg.get("num_devices") or 0),
                                           int(tcfg.get("tp") or 1))
        self.world = self.layout = None
        if self.dp * self.tp > 1:
            self.world = multihost.initialize(self.dp * self.tp, device)
            self.layout = multihost.mesh2d(self.dp, self.tp)
            self.device = self.world.device
        else:
            self.device = resolve_device(device)
        self.rank = 0 if self.world is None else self.world.rank
        self.rows = mesh.batch_rows(self.batch_size, self.dp,
                                    0 if self.layout is None else self.layout.d)
        self.dp_comm = None if self.layout is None else self.layout.dp_comm
        self.log = get_logger()
        self.run_dir = Path(config["save_dir"])
        self.metrics = MetricsLogger(
            self.run_dir / ("metrics.jsonl" if self.rank == 0
                            else f"metrics.rank{self.rank}.jsonl"),
            # the TensorBoard mirror is rank 0's
            tensorboard_dir=(self.run_dir / "tb" if tcfg.get("tensorboard") and self.rank == 0
                             else None))
        self.ckpt = Checkpointer(self.run_dir, writer=self.rank == 0)
        self.seed = int(config.get("seed", 1234))

        dcfg = config["dataset"]
        mcfg = dict(config["model"])
        self.num_eig_vec = int(mcfg.get("num_eig_vec", 20)) if mcfg["name"] == "LanczosNet" else 0
        self.num_cluster = int(mcfg.get("num_partition", 2)) if mcfg["name"] == "GPNN" else 0
        t0 = time.perf_counter()
        if self.world is None:
            self.datasets = self._build_datasets(dcfg)
        else:
            self.datasets = self.world.comm.broadcast_object(
                self._build_datasets(dcfg) if self.rank == 0 else None)
        datasets_s = time.perf_counter() - t0
        train = self.first("train")
        self.stats = train.stats

        mcfg.setdefault("num_atom", int(dcfg.get("num_atom", 8)))
        mcfg["num_task"] = train.label.shape[-1]
        # widths that flax infers from the first batch
        mcfg["num_edge_type"] = train.ops.shape[1] - 1
        mcfg["node_feat_dim"] = train.node_feat.shape[-1]
        self.model = build_model(mcfg)
        self.model.init_weights(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        self.state_plan = state_plan(self.model, self.tp)
        self.tensor_parallel = (TensorParallel(self.model, self.layout.tp_comm)
                                if self.tp > 1 else None)
        if self.world is not None:
            self.metrics.log("setup", **self.world.describe(), **self.layout.describe(),
                             datasets_s=datasets_s)
        self.log.info(
            "runner: model=%s devices=%d (dp=%d tp=%d) device=%s batch=%d "
            "train/val/test=%d/%d/%d n_max=%s", mcfg["name"], self.dp * self.tp, self.dp,
            self.tp, self.device, self.batch_size, *(self.total(s) for s in SPLITS),
            sorted(self.buckets("train")) if self.bucketed else train.n_max,
        )

    # ---------------------------------------------------------------- data
    @property
    def bucketed(self) -> bool:
        return isinstance(self.datasets["train"], dict)

    def buckets(self, split: str) -> dict[int, PackedDataset]:
        """A split's size buckets, ``{bound: PackedDataset}``; an unbucketed
        split is one bucket at its ``n_max``."""
        ds = self.datasets[split]
        return ds if isinstance(ds, dict) else {ds.n_max: ds}

    def first(self, split: str) -> PackedDataset:
        """A split's first (smallest) bucket, or the split."""
        return next(iter(self.buckets(split).values()))

    def total(self, split: str) -> int:
        return sum(len(d) for d in self.buckets(split).values())

    def _build_datasets(self, dcfg: Mapping) -> dict:
        """Three packed splits from ``dataset.source``: ``synthetic``
        (QM8-like graphs from a seed), ``packed`` (npz paths) or
        ``reference_pickle`` (the reference's per-split pickles). What
        this packs persists in the pack cache, keyed by every field that
        decides its content; ``dataset.pack_cache: false`` opts out.
        With ``dataset.buckets`` each split is ``{bound: PackedDataset}``
        (``data/buckets.py``; not cached, as in the JAX runner), the
        training split's buckets of at least one batch."""
        source = dcfg.get("source", "synthetic")
        kind = dcfg.get("operator_kind", "sym")
        n_max = int(dcfg.get("n_max", 32))
        buckets = dcfg.get("buckets")
        if source == "packed":
            if buckets:
                raise ValueError("dataset.buckets needs raw graphs; pre-packed npz splits "
                                 "are already shaped — pack them bucketed instead")
            return {s: load_packed(dcfg[f"{s}_path"]) for s in SPLITS}
        if source == "synthetic":
            counts = {
                "train": int(dcfg.get("num_train", 2048)),
                "val": int(dcfg.get("num_val", 256)),
                "test": int(dcfg.get("num_test", 256)),
            }
            seed0 = int(dcfg.get("seed", 7))
            raw = {
                s: (lambda s=s, i=i: synthetic_qm8_graphs(
                    counts[s], seed=seed0 + i, n_hi=min(n_max, 28)))
                for i, s in enumerate(SPLITS)
            }
            cache_key = {"counts": counts, "seed": seed0}
        elif source == "reference_pickle":
            raw = {s: (lambda s=s: import_reference_pickles(dcfg[f"{s}_path"])) for s in SPLITS}
            try:
                # path, mtime in ns, inode and size: a rewrite shows
                cache_key = {}
                for s in SPLITS:
                    st = os.stat(dcfg[f"{s}_path"])
                    cache_key[s] = [dcfg[f"{s}_path"], st.st_mtime_ns, st.st_ino, st.st_size]
            except OSError:
                cache_key = None
        else:
            raise ValueError(f"unknown dataset source {source!r}")
        standardize = bool(dcfg.get("standardize", True))
        if buckets:
            return self._pack_bucketed(raw, [int(b) for b in buckets], kind, standardize)

        cache_dir = None
        if cache_key is not None and bool(dcfg.get("pack_cache", True)):
            payload = json.dumps({
                "format": PACK_FORMAT_VERSION, "source": source, "key": cache_key,
                "n_max": n_max, "kind": kind, "num_eig_vec": self.num_eig_vec,
                "num_cluster": self.num_cluster, "standardize": standardize,
            }, sort_keys=True)
            digest = hashlib.sha1(payload.encode()).hexdigest()[:16]
            cache_dir = pack_cache_root() / "packs" / digest

        out: dict[str, PackedDataset] = {}
        stats = None
        for s in SPLITS:
            path = cache_dir / f"{s}.npz" if cache_dir else None
            if path is not None and path.exists():
                out[s] = load_packed(path)
                stats = out[s].stats or stats
                self.log.info("pack cache hit for %s: %s", s, path)
                continue
            t0 = time.perf_counter()
            launches = lanczos_cuda.launches.count
            out[s] = pack_dataset(
                raw[s](), n_max=n_max, operator_kind=kind, num_eig_vec=self.num_eig_vec,
                num_cluster=self.num_cluster, stats=stats, standardize=standardize,
                device=self.device,
            )
            stats = out[s].stats or stats
            seconds = time.perf_counter() - t0
            self.log.info("packed %s: %d graphs in %.2fs", s, len(out[s]), seconds)
            self.metrics.log("pack", split=s, graphs=len(out[s]), seconds=seconds,
                             lanczos_launches=lanczos_cuda.launches.count - launches)
            if path is not None:
                path.parent.mkdir(parents=True, exist_ok=True)
                # the suffix ends in .npz, or np.savez would append one
                fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
                os.close(fd)
                try:
                    save_packed(out[s], tmp)
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        return out

    def _pack_bucketed(self, raw: Mapping, bounds: list[int], kind: str,
                       standardize: bool) -> dict:
        out: dict[str, dict[int, PackedDataset]] = {}
        stats = None
        for s in SPLITS:
            t0 = time.perf_counter()
            launches = lanczos_cuda.launches.count
            out[s], stats = pack_dataset_bucketed(
                raw[s](), bounds, stats=stats, standardize=standardize,
                # a training bucket smaller than a batch would never give a step
                min_count=self.batch_size if s == "train" else 0,
                operator_kind=kind, num_eig_vec=self.num_eig_vec,
                num_cluster=self.num_cluster, device=self.device,
            )
            seconds = time.perf_counter() - t0
            sizes = {b: len(d) for b, d in out[s].items()}
            self.log.info("packed %s in buckets %s in %.2fs", s, sizes, seconds)
            self.metrics.log("pack", split=s, graphs=sum(sizes.values()), seconds=seconds,
                             buckets={str(b): n for b, n in sizes.items()},
                             lanczos_launches=lanczos_cuda.launches.count - launches)
        return out

    def _loader(self, split: str, shuffle: bool, drop_last: bool,
                ds: Optional[PackedDataset] = None) -> BatchLoader:
        if ds is None and self.bucketed:
            raise ValueError(BUCKETS_RESIDENT_ONLY)
        return BatchLoader(self.datasets[split] if ds is None else ds, batch_size=self.batch_size,
                           shuffle=shuffle, drop_last=drop_last, seed=self.seed, rows=self.rows)

    # ---------------------------------------------------------------- eval
    def _mae(self, esum, count) -> np.ndarray:
        """Per-task MAE in original label units from the error sums."""
        mae = np.asarray(esum, np.float64) / max(float(count), 1.0)
        return self.stats.unstandardize_mae(mae) if self.stats is not None else mae

    def _evaluate(self, eval_step, split: str) -> np.ndarray:
        """Exact per-task MAE over a split (over its buckets, in turn),
        batches streamed from the host."""
        esum, count = 0.0, 0.0
        for ds in self.buckets(split).values():
            loader = self._loader(split, shuffle=False, drop_last=False, ds=ds)
            for batch, valid in prefetch_to_device(loader.epoch(), self.device):
                e, c = eval_step(batch, valid)
                esum, count = esum + e, count + c
        if self.dp > 1:
            summed = self.dp_comm.all_reduce(torch.cat([esum, count[None]]))
            esum, count = summed[:-1], summed[-1]
        return self._mae(esum.cpu().numpy(), float(count))

    def _resident_eval(self, split: str):
        """``(eval_step) → (esum, count)`` over a split resident on the
        device, its buckets' sums added."""
        evals = [ResidentEval(device_dataset(ds, self.device), self.batch_size, self.rows,
                              self.dp_comm) for ds in self.buckets(split).values()]

        def run(eval_step):
            sums = [ev(eval_step) for ev in evals]
            return sum(e for e, _ in sums), sum(c for _, c in sums)

        return run

    # ---------------------------------------------------------------- state
    def parameters(self) -> list[torch.nn.Parameter]:
        """This rank's parameters, in the one-device model's order."""
        tp = self.tensor_parallel
        return list(self.model.parameters()) if tp is None else tp.parameters()

    def _state(self, optimizer, scheduler) -> dict:
        """The one-device training state (under ``tp`` every rank gathers it)."""
        tp = self.tensor_parallel
        return {
            "model": self.model.state_dict() if tp is None else tp.full_state_dict(),
            "optimizer": (optimizer.state_dict() if tp is None
                          else tp.full_optimizer_state(optimizer.state_dict())),
            "scheduler": scheduler.state_dict(),
        }

    def _load_state(self, state: dict, optimizer=None, scheduler=None) -> None:
        """Load a one-device state (under ``tp``, this rank's blocks of it)."""
        tp = self.tensor_parallel
        if tp is None:
            self.model.load_state_dict(state["model"], strict=True)
        else:
            tp.load_full_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"] if tp is None
                                      else tp.shard_optimizer_state(state["optimizer"]))
            scheduler.load_state_dict(state["scheduler"])

    def state_bytes(self, optimizer) -> dict:
        """This rank's bytes of parameters and Adam moments, measured, and
        as the rule predicts them."""
        return {"state_bytes": measured_state_bytes(self.parameters(), optimizer),
                "predicted_state_bytes": predicted_state_bytes(self.state_plan, self.tp)}

    def _best_meta(self, epoch: int, val_mae: Optional[float] = None) -> dict:
        """Snapshot metadata: with the label width and the training
        split's stats, ``serve.Predictor.from_run_dir`` rebuilds the head
        and answers in original units."""
        meta = {"epoch": epoch, "num_task": int(self.first("train").label.shape[-1])}
        if val_mae is not None:
            meta["val_mae"] = val_mae
        if self.stats is not None:
            meta["label_mean"] = np.asarray(self.stats.mean).tolist()
            meta["label_std"] = np.asarray(self.stats.std).tolist()
        return meta

    # ---------------------------------------------------------------- train
    def _scan_mode(self) -> bool:
        """``train.scan_epoch``: true, false, or auto (resident when the
        training split's large fields are under 2 GiB: the resident split
        and one epoch's gathered copy must stay a small part of memory)."""
        mode = self.config["train"].get("scan_epoch", "auto")
        if self.bucketed:  # buckets are a resident-trainer feature
            if mode is False:
                raise ValueError(BUCKETS_RESIDENT_ONLY)
            return True
        if isinstance(mode, bool):
            return mode
        ds = self.datasets["train"]
        nbytes = sum(getattr(ds, f).nbytes for f in ("ops", "node_feat", "ritz_vec")
                     if getattr(ds, f) is not None)
        return nbytes < SCAN_BYTES_MAX

    def train(self) -> dict:
        return self._train_scanned() if self._scan_mode() else self._train_per_step()

    def _start(self, steps_per_epoch: int):
        """Optimizer, schedule and the dropout stream; the state of
        ``latest`` (``train.is_resume``) or of ``train.resume_model``.
        → (optimizer, scheduler, train_step, first epoch, best val MAE)."""
        tcfg = self.config["train"]
        optimizer, scheduler, clip = build_optimizer(self.parameters(), tcfg, steps_per_epoch)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(self.seed)
        set_dropout_generator(self.model, self.dropout_generator, rows=self._dropout_rows())
        start_epoch, best_val = 0, float("inf")
        if tcfg.get("is_resume") and self.ckpt.exists("latest"):
            self._load_state(self.ckpt.restore("latest", self.device), optimizer, scheduler)
            start_epoch = int((self.ckpt.meta("latest") or {}).get("epoch", -1)) + 1
            best_val = float((self.ckpt.meta("best") or {}).get("val_mae", float("inf")))
            self.log.info("resumed from epoch %d (best val so far %.6f)", start_epoch, best_val)
        elif tcfg.get("resume_model"):
            self._load_state(Checkpointer.restore_file(tcfg["resume_model"], self.device,
                                                      self.config["model"]["name"]))
            self.log.info("warm-started from %s", tcfg["resume_model"])
        train_step = make_train_step(self.model, optimizer, scheduler, clip, self.dp_comm,
                                     self.tensor_parallel)
        self.pair_step = make_pair_step(self.model, optimizer, scheduler, clip, self.dp_comm,
                                        self.tensor_parallel)
        return optimizer, scheduler, train_step, start_epoch, best_val

    def _dropout_rows(self, cut: bool = True) -> tuple[int, int]:
        """The block of each dropout mask this rank keeps: its rows of the
        batch, or (``cut`` False: every rank holds the whole batch) all."""
        return (0 if self.layout is None else self.layout.d, self.dp) if cut else (0, 1)

    def _validated(self, epoch: int, val_mae: np.ndarray, best_val: float, state: dict) -> float:
        """Log a validation and keep ``best`` → the best val MAE so far."""
        mean_mae = float(val_mae.mean())
        self.metrics.log("val", epoch=epoch, mae=mean_mae, per_task=val_mae.tolist())
        if mean_mae < best_val:
            best_val = mean_mae
            self.ckpt.save("best", state, self._best_meta(epoch, mean_mae))
        return best_val

    def _saved(self, epoch: int, state: dict) -> None:
        """``latest``, and the ``epoch_<n>`` tag every ``snapshot_epoch``."""
        self.ckpt.save("latest", state, self._best_meta(epoch))
        snap = int(self.config["train"].get("snapshot_epoch", 0))
        if snap and (epoch + 1) % snap == 0:
            self.ckpt.save(f"epoch_{epoch}", state, self._best_meta(epoch))

    def _tested(self, best_val: float, test_mae_of, optimizer) -> dict:
        """Restore ``best`` and test it → the result of ``train()``."""
        test_mae = None
        if self.world is not None:  # rank 0 may still be writing best
            multihost.barrier()
        if self.ckpt.exists("best"):
            self._load_state(self.ckpt.restore("best", self.device))
            test_mae = float(test_mae_of().mean())
            self.log.info("best val %.6f | test MAE %.6f", best_val, test_mae)
            self.metrics.log("test", mae=test_mae, best_val=best_val,
                             **self.state_bytes(optimizer), **self._peak_memory())
        return {"best_val_mae": best_val, "test_mae": test_mae}

    def _peak_memory(self) -> dict:
        if self.device.type != "cuda":
            return {}
        return {"peak_memory_mb": torch.cuda.max_memory_allocated(self.device) / 2**20}

    def _comm_stats(self):
        """The counts of this rank's ``dp`` and ``tp`` groups' comm layers."""
        if self.layout is None:
            return None
        return [self.layout.dp_comm.stats.copy(), self.layout.tp_comm.stats.copy()]

    def _comm_since(self, before) -> dict:
        if before is None:
            return {}
        now = self._comm_stats()
        return {"comm": {k: sum(b.minus(a)[k] for a, b in zip(before, now))
                         for k in now[0].as_dict()}}

    def _train_scanned(self) -> dict:
        """The splits resident on the device; the epochs between two
        validations run without a host sync, and the group's losses and
        validation sums are fetched together.

        Size buckets (``dataset.buckets``, more than one training bucket):
        each epoch runs pieces of a bucket's batches, smallest bucket
        first before the pieces are shuffled (``scan_epoch.py:
        chunk_schedule``, ``train.bucket_chunk`` steps a piece), or, with
        ``train.bucket_pair``, paired steps of two half-batches of two
        buckets (``pair_schedule``); both schedules come from the host's
        Philox stream of the run's seed, as in the JAX runner. One
        training bucket takes the single-shape path."""
        tcfg = self.config["train"]
        bs = int(tcfg["batch_size"])
        train_b = self.buckets("train")
        sizes = {b: len(d) for b, d in train_b.items()}
        pairing = bool(tcfg.get("bucket_pair")) and len(train_b) > 1
        half = bs // 2
        if pairing and half == 0:
            raise ValueError("train.bucket_pair needs batch_size >= 2")
        if pairing:  # two half-batches a step
            steps = sum(g // half for g in sizes.values()) // 2
        else:
            steps = sum(g // bs for g in sizes.values())
        if steps == 0:
            if self.bucketed:
                raise ValueError(f"train.batch_size={bs} exceeds every train bucket (sizes "
                                 f"{list(sizes.values())}); shrink the batch or grow the dataset")
            raise ValueError(
                f"train.batch_size={bs} exceeds the train split ({self.total('train')} graphs)")
        t0 = time.perf_counter()
        optimizer, scheduler, train_step, epoch, best_val = self._start(steps)
        eval_step = make_eval_step(self.model)
        t1 = time.perf_counter()
        data = {b: device_dataset(d, self.device) for b, d in train_b.items()}
        val_eval = self._resident_eval("val")
        _sync(self.device)
        self.metrics.log("setup", optimizer_s=t1 - t0, resident_s=time.perf_counter() - t1)
        device_shuffle = bool(tcfg.get("device_shuffle", True))
        gen = torch.Generator(device=self.device).manual_seed(self.seed + SHUFFLE_SEED_OFFSET)
        rng = np.random.Generator(np.random.Philox(self.seed))
        chunk = int(tcfg.get("bucket_chunk", 4))
        # a half-batch is cut over dp where it divides, else every rank takes it whole
        half_cut = half % self.dp == 0
        half_cols = (mesh.batch_rows(half, self.dp, 0 if self.layout is None else self.layout.d)
                     if half_cut else slice(None))

        def run_epoch() -> torch.Tensor:
            if len(data) == 1:
                ((b, d),) = data.items()
                perm = (device_permutation(gen, sizes[b], bs, self.device) if device_shuffle
                        else host_permutation(rng, sizes[b], bs, self.device))
                return train_epoch(train_step, d, perm, self.rows)
            if not pairing:
                return torch.cat([
                    train_epoch(train_step, data[b], torch.from_numpy(rows).to(self.device),
                                self.rows)
                    for b, rows in chunk_schedule(rng, sizes, bs, chunk)])
            set_dropout_generator(self.model, self.dropout_generator,
                                  rows=self._dropout_rows(half_cut))
            try:
                return torch.cat([
                    train_pair_piece(self.pair_step, data[ba], torch.from_numpy(ra).to(self.device),
                                     data[bb], torch.from_numpy(rb).to(self.device), half_cols,
                                     1 if half_cut else self.dp)
                    for ba, ra, bb, rb in pair_schedule(rng, sizes, half, chunk)])
            finally:
                set_dropout_generator(self.model, self.dropout_generator, rows=self._dropout_rows())

        valid_every = int(tcfg.get("valid_epoch", 1))
        max_epoch = int(tcfg.get("max_epoch", 10))
        profile_group = epoch if tcfg.get("profile") else -1
        self.log.info("resident epochs: %d steps/epoch on %s%s", steps, self.device,
                      f", buckets {sizes}" if self.bucketed else "")
        while epoch < max_epoch:
            group = min(valid_every, max_epoch - epoch)
            t0 = time.perf_counter()
            comm0 = self._comm_stats()
            tracing = epoch == profile_group
            with trace(self.run_dir / "trace" if tracing else None):
                losses = [run_epoch() for _ in range(group)]
                if tracing:
                    _sync(self.device)
            esum, count = val_eval(eval_step)
            # the group's one host sync
            fetched = torch.cat([torch.stack(losses).flatten(), esum, count[None]]).cpu().numpy()
            group_time = time.perf_counter() - t0
            epoch_time, gps = group_time / group, group * steps * bs / group_time
            per_epoch = fetched[: group * steps].reshape(group, steps).mean(1)
            val_mae = self._mae(fetched[group * steps : -1], fetched[-1])
            comm = self._comm_since(comm0)
            for i, lv in enumerate(per_epoch):
                self.metrics.log("epoch", epoch=epoch + i, loss=float(lv),
                                 epoch_time_s=epoch_time, graphs_per_sec=gps, **comm)
            epoch += group
            self.log.info(
                "epoch %d | loss %.6f | val MAE %.6f | %.0f graphs/s | %.3fs/epoch | lr %.2e",
                epoch - 1, float(per_epoch[-1]), float(val_mae.mean()), gps, epoch_time,
                scheduler.get_last_lr()[0],
            )
            state = self._state(optimizer, scheduler)
            best_val = self._validated(epoch - 1, val_mae, best_val, state)
            self._saved(epoch - 1, state)

        def test_mae() -> np.ndarray:
            esum, count = self._resident_eval("test")(eval_step)
            return self._mae(esum.cpu().numpy(), float(count))

        return self._tested(best_val, test_mae, optimizer)

    def _train_per_step(self) -> dict:
        """Batches streamed from the host, one step at a time."""
        tcfg = self.config["train"]
        loader = self._loader("train", shuffle=bool(tcfg.get("shuffle", True)), drop_last=True)
        steps = len(loader)
        if steps == 0:
            raise ValueError(
                f"train.batch_size={tcfg['batch_size']} exceeds the train split "
                f"({self.total('train')} graphs)"
            )
        optimizer, scheduler, train_step, start_epoch, best_val = self._start(steps)
        eval_step = make_eval_step(self.model)
        display_iter = int(tcfg.get("display_iter", 50))
        valid_every = int(tcfg.get("valid_epoch", 1))
        max_epoch = int(tcfg.get("max_epoch", 10))
        profile_epoch = start_epoch + 1 if tcfg.get("profile") else -1
        cost_logged = False
        for epoch in range(start_epoch, max_epoch):
            t0 = time.perf_counter()
            comm0 = self._comm_stats()
            with trace(self.run_dir / "trace" if epoch == profile_epoch else None):
                for it, (batch, valid) in enumerate(
                        prefetch_to_device(loader.epoch(), self.device)):
                    # drop_last: every batch is whole, its valid graphs the batch size
                    if cost_logged:
                        loss = train_step(batch, valid, self.batch_size)
                    else:  # the first step, its operations counted as it runs
                        cost_logged, out = True, []
                        cost = program_cost(
                            lambda: out.append(train_step(batch, valid, self.batch_size)))
                        loss = out[0]
                        self.log.info("train-step program cost: %s", cost)
                        self.metrics.log("program_cost", program="train_step", **cost)
                    if (it + 1) % display_iter == 0 or it + 1 == steps:
                        lv = float(loss)  # waits for the step: only at display points
                        step = scheduler.last_epoch
                        self.log.info("epoch %d it %d | loss %.6f | lr %.2e",
                                      epoch, it + 1, lv, scheduler.get_last_lr()[0])
                        self.metrics.log("train", epoch=epoch, step=step, loss=lv)
                _sync(self.device)
            epoch_time = time.perf_counter() - t0
            gps = steps * int(tcfg["batch_size"]) / epoch_time
            self.metrics.log("epoch", epoch=epoch, epoch_time_s=epoch_time, graphs_per_sec=gps,
                             **self._comm_since(comm0))
            state = self._state(optimizer, scheduler)
            if (epoch + 1) % valid_every == 0 or epoch == max_epoch - 1:
                val_mae = self._evaluate(eval_step, "val")
                self.log.info("epoch %d | val MAE %.6f | %.1f graphs/s | %.2fs/epoch",
                              epoch, float(val_mae.mean()), gps, epoch_time)
                best_val = self._validated(epoch, val_mae, best_val, state)
            self._saved(epoch, state)
        return self._tested(best_val, lambda: self._evaluate(eval_step, "test"), optimizer)

    # ---------------------------------------------------------------- test
    def test(self) -> dict:
        """Test a snapshot: ``test.test_model``, else this run's ``best``."""
        path = (self.config.get("test") or {}).get("test_model")
        if path:
            state = Checkpointer.restore_file(path, self.device, self.config["model"]["name"])
        elif self.ckpt.exists("best"):
            state = self.ckpt.restore("best", self.device)
        else:
            raise FileNotFoundError("no checkpoint: set test.test_model or train first")
        self._load_state(state)
        mae = self._evaluate(make_eval_step(self.model), "test")
        mean = float(mae.mean())
        self.log.info("test MAE %.6f (per-task %s)", mean, np.round(mae, 6).tolist())
        self.metrics.log("test", mae=mean, per_task=mae.tolist())
        return {"test_mae": mean, "per_task": mae.tolist()}


def _citation_runner(config, device=None):
    from lanczosnet_torch.train.citation_runner import CitationRunner

    return CitationRunner(config, device)


def _sparse_citation_runner(config, device=None):
    from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner

    return SparseCitationRunner(config, device)


RUNNER_REGISTRY = {"QM8Runner": QM8Runner, "CitationRunner": _citation_runner,
                   "SparseCitationRunner": _sparse_citation_runner}


def build_runner(config: Mapping, device: str | torch.device | None = None):
    """The runner that ``config['runner']`` names (QM8Runner by default)."""
    name = config.get("runner", "QM8Runner")
    if name not in RUNNER_REGISTRY:
        raise KeyError(f"unknown runner {name!r}; available: {sorted(RUNNER_REGISTRY)}")
    return RUNNER_REGISTRY[name](config, device)
