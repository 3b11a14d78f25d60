"""Shared fixtures of the benchmark's CPU tests: the repository on the
import path, and cells cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(cfg: dict) -> dict:
    """The configuration with its graph cut to the nodes its file gives
    the CPU (``cpu_nodes``); the widths stay as configured."""
    cfg = copy.deepcopy(cfg)
    cfg["dataset"]["num_nodes"] = int(cfg["cpu_nodes"])
    return cfg


@pytest.fixture
def tiny():
    return shrink
