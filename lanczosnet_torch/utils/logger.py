"""Logging and structured metrics.

Counterpart of ``lanczosnet_tpu/utils/logger.py``: the package logger,
``setup_logging`` (a stream and an optional per-run file handler, which
the CLI installs), and ``MetricsLogger``, an append-only JSONL stream
(``metrics.jsonl`` in the run directory) that tools can parse without
scraping log text.
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
    """Append-only JSONL metrics writer, one record per event."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
