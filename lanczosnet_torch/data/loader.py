"""Batches of a packed split, and their copy to the device.

Counterpart of ``lanczosnet_tpu/data/loader.py``. Packing already made
fixed-shape arrays, so loading is index slicing:

- the epoch's order is ``numpy.random.Generator(Philox(seed))``'s
  permutation, the JAX package's stream, so both packages visit the
  graphs in the same order from the same seed;
- every batch has the same shape: the tail batch is padded with ghost
  graphs (index 0, node mask zeroed) and a ``valid`` vector weights
  them out;
- a data-parallel rank takes its block of each batch (``rows``), ghost
  graphs and ``valid`` included;
- ``prefetch_to_device`` copies each batch from pinned host memory with
  ``non_blocking=True`` and keeps one batch in flight, so the copy of
  batch i+1 overlaps the step on batch i.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import GraphBatch
from lanczosnet_torch.data.dataset import PackedDataset


class BatchLoader:
    """Iterates ``(GraphBatch, valid [B])`` epochs over a ``PackedDataset``
    as CPU tensors; ``rows`` of each batch only, where given."""

    def __init__(
        self,
        ds: PackedDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        rows: slice = slice(None),
    ):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rows = rows
        self._rng = np.random.Generator(np.random.Philox(seed))

    def __len__(self) -> int:
        g = len(self.ds)
        if self.drop_last:
            return g // self.batch_size
        return -(-g // self.batch_size)

    def epoch(self) -> Iterator[tuple[GraphBatch, torch.Tensor]]:
        g = len(self.ds)
        order = self._rng.permutation(g) if self.shuffle else np.arange(g)
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs : (b + 1) * bs]
            valid = np.ones(bs, np.float32)
            if len(idx) < bs:  # ghost-pad the tail batch
                pad = bs - len(idx)
                idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
                valid[bs - pad :] = 0.0
            idx, valid = idx[self.rows], valid[self.rows]
            batch = self.ds.slice_batch(idx)
            valid_t = torch.from_numpy(valid)
            if valid.min() == 0.0:
                # zero the ghosts' masks so they contribute nothing
                batch.mask = batch.mask * valid_t[:, None]
            yield batch, valid_t


def _put(t: torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    """``t`` on ``device``; to a CUDA device from pinned memory, without
    blocking the host."""
    if t is None:
        return None
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_device(batch: GraphBatch, device: torch.device) -> GraphBatch:
    """A copy of ``batch`` on ``device``."""
    return GraphBatch(**{f.name: _put(getattr(batch, f.name), device)
                         for f in dataclasses.fields(batch)})


def prefetch_to_device(
    it: Iterator[tuple[GraphBatch, torch.Tensor]], device: torch.device, depth: int = 1
) -> Iterator[tuple[GraphBatch, torch.Tensor]]:
    """``(batch, valid)`` pairs of ``it`` on ``device``, ``depth`` copies
    issued ahead of the one handed out."""
    queue: list = []
    for batch, valid in it:
        queue.append((to_device(batch, device), _put(valid, device)))
        if len(queue) > depth:
            yield queue.pop(0)
    yield from queue
