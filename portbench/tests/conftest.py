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

# nodes a cell's graph is cut to on the CPU (the widths stay as configured)
TINY_NODES = {"ten_million_sparse_lanczos_net": 3000, "million_sparse_gcn_wide": 2000}


def shrink(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["dataset"]["num_nodes"] = TINY_NODES[cfg["name"]]
    return cfg


@pytest.fixture
def tiny():
    return shrink
