"""Logging and structured metrics.

Counterpart of ``lanczosnet_tpu/utils/logger.py``: the package logger
(handlers are the application's to configure, with ``logging``) and
``MetricsLogger``, an append-only JSONL stream (``metrics.jsonl`` in the
run directory) that tools can parse without scraping log text.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any

LOGGER_NAME = "lanczosnet_torch"


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
