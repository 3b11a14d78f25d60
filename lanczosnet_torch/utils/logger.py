"""Logging and structured metrics.

Counterpart of ``lanczosnet_tpu/utils/logger.py``: the package logger,
``setup_logging`` (a stream and an optional per-run file handler, which
the CLI installs), and ``MetricsLogger``, an append-only JSONL stream
(``metrics.jsonl`` in the run directory) that tools can parse without
scraping log text, mirrored into TensorBoard under
``train.tensorboard: true``.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Optional

LOGGER_NAME = "lanczosnet_torch"


def setup_logging(log_file: Optional[str | Path] = None, level: str = "INFO",
                  stream: bool = True) -> logging.Logger:
    """Configure the package logger: stdout (unless ``stream`` is False),
    and ``log_file`` if given."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s | %(message)s", "%H:%M:%S")
    if stream:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def get_logger(name: str = LOGGER_NAME) -> logging.Logger:
    return logging.getLogger(name)


class MetricsLogger:
    """Append-only JSONL metrics writer, one record per event.

    ``tensorboard_dir`` mirrors every numeric field (not a bool, not NaN)
    into a ``torch.utils.tensorboard.SummaryWriter`` there, as the scalar
    ``<event>/<field>``, flushed after each record, as the JAX logger
    does; the step is the record's ``epoch``, ``step`` or ``iter`` field,
    else a count of that event's records. The runners pass it on rank 0
    only. Where the writer cannot be made (no ``tensorboard`` package)
    the JSONL stream goes on alone and one warning says so; ``tensorboard``
    tells whether the mirror is on."""

    def __init__(self, path: str | Path, tensorboard_dir: str | Path | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self._tb = None
        self._tb_counts: dict[str, int] = {}
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(tensorboard_dir))
            except Exception as exc:  # the mirror is optional; the JSONL is the record
                get_logger().warning("no TensorBoard writer in %s, JSONL only: %s",
                                     tensorboard_dir, exc)

    @property
    def tensorboard(self) -> bool:
        return self._tb is not None

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is None:
            return
        step = None
        for k in ("epoch", "step", "iter"):
            v = fields.get(k)
            if isinstance(v, (int, float)) and v == v:
                step = int(v)
                break
        if step is None:
            step = self._tb_counts.get(event, 0)
            self._tb_counts[event] = step + 1
        for k, v in fields.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) and v == v:
                self._tb.add_scalar(f"{event}/{k}", v, step)
        self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
