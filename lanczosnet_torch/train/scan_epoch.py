"""Device-resident epochs, the fast path of QM8 training.

Counterpart of ``lanczosnet_tpu/train/scan_epoch.py``. A packed split
goes to the device once and stays there for the run. Each epoch's
shuffled batches are taken from it by one flat row gather per field
(``index_select`` on the ``[G, -1]`` view, reshaped to ``[steps, B,
...]``), and the steps run back to back on slices of that copy. Losses
stay on the device until the caller fetches them, once per validation
interval; validation runs over fixed ``idx``/``valid`` tables whose
batches are gathered once.

Where the JAX package compiles a whole group of epochs into one
``lax.scan`` program, the port launches each step's kernels from
Python; the host never waits for the device inside a group.

Data parallelism: every rank holds the whole split, draws the same
permutation and takes its block of each batch (its columns of the
``[steps, B]`` table, as the JAX runner's ``P(None, "data")`` places
it); validation sums and counts are summed over the ``dp`` ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.data.dataset import PackedDataset
from lanczosnet_torch.parallel.comm import Comm

# the device shuffle stream's seed is the run's seed plus this, as in
# lanczosnet_tpu/train/runner.py
SHUFFLE_SEED_OFFSET = 0x5E1F


def _map(batch: GraphBatch, fn: Callable[[torch.Tensor], torch.Tensor]) -> GraphBatch:
    return GraphBatch(**{
        f.name: None if getattr(batch, f.name) is None else fn(getattr(batch, f.name))
        for f in dataclasses.fields(batch)
    })


def device_dataset(ds: PackedDataset, device: torch.device) -> GraphBatch:
    """A packed split on ``device`` as one ``GraphBatch`` whose leading
    axis is the whole split, copied once."""
    return _map(ds.slice_batch(slice(None)), lambda t: t.to(device))


def gather_batch(data: GraphBatch, idx: torch.Tensor) -> GraphBatch:
    """The graphs ``idx [B]`` of a resident split."""
    return _map(data, lambda x: x.index_select(0, idx))


def shuffle_epoch(data: GraphBatch, perm: torch.Tensor) -> GraphBatch:
    """One epoch's batches ``[steps, B, ...]`` for the index table
    ``perm [steps, B]``, by one flat row gather per field: batch s is
    ``gather_batch(data, perm[s])``."""
    flat = perm.reshape(-1)

    def take(x: torch.Tensor) -> torch.Tensor:
        rows = x.flatten(1) if x.dim() > 1 else x
        return rows.index_select(0, flat).view(tuple(perm.shape) + tuple(x.shape[1:]))

    return _map(data, take)


def batch_at(batches: GraphBatch, step: int) -> GraphBatch:
    """Batch ``step`` of ``shuffle_epoch``'s output (views, no copy)."""
    return _map(batches, lambda x: x[step])


def device_permutation(
    generator: torch.Generator, num_graphs: int, batch_size: int, device: torch.device
) -> torch.Tensor:
    """One epoch's ``[steps, B]`` index table, drawn on ``device`` from
    ``generator``; the ``num_graphs % B`` graphs left over sit out the
    epoch, as in the JAX package."""
    steps = num_graphs // batch_size
    perm = torch.randperm(num_graphs, generator=generator, device=device)
    return perm[: steps * batch_size].view(steps, batch_size)


def host_permutation(
    rng: np.random.Generator, num_graphs: int, batch_size: int, device: torch.device
) -> torch.Tensor:
    """The same table from the host's Philox stream, drawn as
    ``lanczosnet_tpu/train/runner.py`` draws it with
    ``train.device_shuffle: false``."""
    steps = num_graphs // batch_size
    perm = rng.permutation(num_graphs)[: steps * batch_size].reshape(steps, batch_size)
    return torch.from_numpy(perm).to(device)


def train_epoch(
    train_step: Callable[..., torch.Tensor],
    data: GraphBatch,
    perm: torch.Tensor,
    rows: slice = slice(None),
) -> torch.Tensor:
    """Run one epoch's steps over ``shuffle_epoch(data, perm[:, rows])``
    (``rows``: a data-parallel rank's block of each batch) → the losses
    ``[steps]``, on the device and not waited for."""
    batch_size = perm.shape[1]  # every graph of a batch is real
    perm = perm[:, rows]
    batches = shuffle_epoch(data, perm)
    valid = torch.ones(perm.shape[1], device=perm.device)
    return torch.stack([train_step(batch_at(batches, s), valid, batch_size)
                        for s in range(perm.shape[0])])


def eval_tables(num_graphs: int, batch_size: int, device: torch.device):
    """Fixed ``idx``/``valid`` tables ``[S, B]`` that cover a split once in
    order; the tail is padded with graph 0 at weight 0."""
    steps = -(-num_graphs // batch_size)
    idx = torch.zeros(steps * batch_size, dtype=torch.long)
    valid = torch.zeros(steps * batch_size)
    idx[:num_graphs] = torch.arange(num_graphs)
    valid[:num_graphs] = 1.0
    shape = (steps, batch_size)
    return idx.view(shape).to(device), valid.view(shape).to(device)


class ResidentEval:
    """Per-task |err| sums and the count over a resident split, its
    batches gathered once: ``(eval_step) → (esum [T], count)`` on the
    device. A data-parallel rank evaluates its ``rows`` of each batch and
    the sums are summed over ``comm``."""

    def __init__(self, data: GraphBatch, batch_size: int, rows: slice = slice(None),
                 comm: Optional[Comm] = None):
        idx, valid = eval_tables(data.mask.shape[0], batch_size, data.mask.device)
        self.idx, self.valid = idx[:, rows], valid[:, rows]
        self.batches = shuffle_epoch(data, self.idx)
        self.comm = comm if comm is not None and comm.size > 1 else None

    def __call__(self, eval_step) -> tuple[torch.Tensor, torch.Tensor]:
        esum: Optional[torch.Tensor] = None
        count: Optional[torch.Tensor] = None
        for s in range(self.idx.shape[0]):
            e, c = eval_step(batch_at(self.batches, s), self.valid[s])
            esum, count = (e, c) if esum is None else (esum + e, count + c)
        if self.comm is not None:
            summed = self.comm.all_reduce(torch.cat([esum, count[None]]))
            esum, count = summed[:-1], summed[-1]
        return esum, count


# ---------------------------------------------------------------- size buckets
def chunk_schedule(rng: np.random.Generator, sizes: dict[int, int], batch_size: int,
                   chunk: int) -> list[tuple[int, np.ndarray]]:
    """One epoch over size buckets (``sizes``: graphs a bucket, in bucket
    order), without pairing: each bucket's shuffled ``[steps, B]`` table
    cut into pieces of ``chunk`` steps, the pieces shuffled across
    buckets, so that same-size batches come in short runs. → ``[(bucket,
    rows [≤chunk, B])]``. Drawn from ``rng`` with the calls, in the order,
    of ``lanczosnet_tpu/train/runner.py``, so a seed gives JAX's pieces."""
    pieces = []
    for bound, g in sizes.items():
        steps = g // batch_size
        if steps == 0:
            continue
        perm = rng.permutation(g)[: steps * batch_size].reshape(steps, batch_size)
        for lo in range(0, steps, chunk):
            pieces.append((bound, perm[lo: lo + chunk]))
    rng.shuffle(pieces)
    return pieces


def pair_schedule(rng: np.random.Generator, sizes: dict[int, int], half: int,
                  chunk: int) -> list[tuple[int, np.ndarray, int, np.ndarray]]:
    """One epoch of paired steps (``train.bucket_pair``): every bucket's
    shuffled ``[s_b, half]`` half-batches, each step pairing the two
    buckets with the most half-batches left (a bucket with itself only
    when it is the last), the steps grouped by bucket pair and cut into
    pieces of ``chunk``, the pieces shuffled. → ``[(bucket_a, rows_a
    [≤chunk, half], bucket_b, rows_b)]``; ``rng``'s calls and their order
    are the JAX runner's."""
    pools = {}
    for bound, g in sizes.items():
        s_b = g // half
        if s_b:
            pools[bound] = rng.permutation(g)[: s_b * half].reshape(s_b, half)
    used = {b: 0 for b in pools}
    groups: dict[tuple[int, int], list] = {}
    while True:
        avail = sorted(((pools[b].shape[0] - used[b], b) for b in pools), reverse=True)
        if len(avail) > 1 and avail[1][0] > 0:
            ba, bb = avail[0][1], avail[1][1]
        elif avail and avail[0][0] >= 2:
            ba = bb = avail[0][1]
        else:
            break
        ia = pools[ba][used[ba]]
        used[ba] += 1
        ib = pools[bb][used[bb]]
        used[bb] += 1
        groups.setdefault((ba, bb), []).append((ia, ib))
    pieces = []
    for (ba, bb), rows in groups.items():
        ra = np.stack([r[0] for r in rows])
        rb = np.stack([r[1] for r in rows])
        for lo in range(0, ra.shape[0], chunk):
            pieces.append((ba, ra[lo: lo + chunk], bb, rb[lo: lo + chunk]))
    rng.shuffle(pieces)
    return pieces


def train_pair_piece(
    pair_step: Callable[..., torch.Tensor],
    data_a: GraphBatch, rows_a: torch.Tensor,
    data_b: GraphBatch, rows_b: torch.Tensor,
    cols: slice = slice(None), replicas: int = 1,
) -> torch.Tensor:
    """Run a piece of paired steps: step s takes the half-batches
    ``rows_a[s]`` of ``data_a`` and ``rows_b[s]`` of ``data_b``
    (``cols``: a data-parallel rank's block of each half; ``replicas``:
    how many ranks hold the same half, whose losses are then each the
    share). → the losses ``[steps]`` on the device."""
    half_a, half_b = rows_a.shape[1], rows_b.shape[1]
    batches_a = shuffle_epoch(data_a, rows_a[:, cols])
    batches_b = shuffle_epoch(data_b, rows_b[:, cols])
    return torch.stack([
        pair_step(batch_at(batches_a, s), half_a * replicas, batch_at(batches_b, s),
                  half_b * replicas)
        for s in range(rows_a.shape[0])
    ])
