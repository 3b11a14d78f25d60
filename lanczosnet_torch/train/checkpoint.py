"""Checkpoint and resume.

Counterpart of ``lanczosnet_tpu/train/checkpoint.py``: best-on-validation
and periodic snapshots of the whole training state, restorable for
resume and for ``test()``. The state is a dictionary of ``state_dict``s
and numbers written with ``torch.save`` to a temporary file and renamed
into place, so a reader never sees half a file.

In a sharded run only rank 0 writes (``writer``), as
``lanczosnet_tpu/train/checkpoint.py`` has the primary process write;
the other ranks read the same files, after a barrier where rank 0 may
still be writing. A data- or tensor-parallel QM8 run writes the
one-device state (``QM8Runner`` gathers a tensor-parallel model's
blocks first, ``parallel/tensor.py``), so one device, ``-t`` and
``serve.Predictor.from_run_dir`` read it as they read any run's.

Layout inside the run directory:
    checkpoints/<tag>.pt           (tag: latest, best, …)
    checkpoints/<tag>.meta.json    ({epoch, val_acc, …})

A run the JAX package trained holds ``checkpoints/<tag>.msgpack``
instead (flax's msgpack of its ``TrainState``). ``restore`` reads it where
no ``<tag>.pt`` exists, and ``restore_file`` reads such a file by name:
given the model's name, its ``params`` become ``{"model": state_dict}``
through ``weights.py``'s map for that model (``flax_msgpack.py`` decodes
the file). Its optimizer state is not carried over.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import torch

from lanczosnet_torch.train.flax_msgpack import msgpack_restore
from lanczosnet_torch.weights import state_dict_from_flax


class Checkpointer:
    """``writer`` False (a rank other than 0 of a sharded run): ``save``
    writes nothing, the directory is not made; reads are as on the
    writer, after a barrier where the writer may be writing."""

    def __init__(self, run_dir: str | Path, writer: bool = True):
        self.dir = Path(run_dir) / "checkpoints"
        self.writer = writer
        if writer:
            self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, tag: str) -> Path:
        return self.dir / f"{tag}.pt"

    def save(self, tag: str, state: dict, meta: Optional[dict] = None) -> Optional[Path]:
        """Atomically write ``state`` under ``tag`` (on the writer only)."""
        if not self.writer:
            return None
        path = self._path(tag)
        tmp = path.with_suffix(".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        if meta is not None:
            (self.dir / f"{tag}.meta.json").write_text(json.dumps(meta, indent=2))
        return path

    def restore(self, tag: str, map_location: Any = "cpu",
                model_name: Optional[str] = None) -> dict:
        """The state saved under ``tag``, its tensors on ``map_location``;
        where only the JAX package's ``<tag>.msgpack`` exists, its model
        parameters (``model_name`` names the map)."""
        path = self._path(tag)
        if not path.exists() and path.with_suffix(".msgpack").exists():
            path = path.with_suffix(".msgpack")
        return self.restore_file(path, map_location, model_name)

    def meta(self, tag: str) -> Optional[dict]:
        p = self.dir / f"{tag}.meta.json"
        return json.loads(p.read_text()) if p.exists() else None

    def exists(self, tag: str) -> bool:
        return self._path(tag).exists()

    @staticmethod
    def restore_file(path: str | Path, map_location: Any = "cpu",
                     model_name: Optional[str] = None) -> dict:
        """The state in an explicit checkpoint file (``test.test_model``):
        a ``.pt`` as saved, or a JAX ``.msgpack`` as ``{"model":
        state_dict}`` of the model ``model_name``."""
        path = Path(path)
        if path.suffix != ".msgpack":
            return torch.load(path, map_location=map_location, weights_only=True)
        if model_name is None:
            raise ValueError(f"{path} is a JAX checkpoint: its model's name is needed to map it")
        params = msgpack_restore(path.read_bytes())["params"]
        state = state_dict_from_flax(model_name, params)
        return {"model": {k: v.to(map_location) for k, v in state.items()}}
