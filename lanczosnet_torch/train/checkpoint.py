"""Checkpoint and resume.

Counterpart of ``lanczosnet_tpu/train/checkpoint.py``: best-on-validation
and periodic snapshots of the whole training state, restorable for
resume and for ``test()``. The state is a dictionary of ``state_dict``s
and numbers written with ``torch.save`` to a temporary file and renamed
into place, so a reader never sees half a file.

Layout inside the run directory:
    checkpoints/<tag>.pt           (tag: latest, best, …)
    checkpoints/<tag>.meta.json    ({epoch, val_acc, …})
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import torch


class Checkpointer:
    def __init__(self, run_dir: str | Path):
        self.dir = Path(run_dir) / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, tag: str) -> Path:
        return self.dir / f"{tag}.pt"

    def save(self, tag: str, state: dict, meta: Optional[dict] = None) -> Path:
        """Atomically write ``state`` under ``tag``."""
        path = self._path(tag)
        tmp = path.with_suffix(".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        if meta is not None:
            (self.dir / f"{tag}.meta.json").write_text(json.dumps(meta, indent=2))
        return path

    def restore(self, tag: str, map_location: Any = "cpu") -> dict:
        """The state saved under ``tag``, its tensors on ``map_location``."""
        return self.restore_file(self._path(tag), map_location)

    def meta(self, tag: str) -> Optional[dict]:
        p = self.dir / f"{tag}.meta.json"
        return json.loads(p.read_text()) if p.exists() else None

    def exists(self, tag: str) -> bool:
        return self._path(tag).exists()

    @staticmethod
    def restore_file(path: str | Path, map_location: Any = "cpu") -> dict:
        """The state in an explicit checkpoint file (``test.test_model``)."""
        return torch.load(Path(path), map_location=map_location, weights_only=True)
