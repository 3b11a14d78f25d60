"""Label statistics.

Counterpart of ``lanczosnet_tpu/data/dataset.py:LabelStats``; packing a
dataset (``PackedDataset``, ``pack_dataset``) comes with ROADMAP A1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LabelStats:
    """Per-task standardization stats; metrics report in original units."""

    mean: np.ndarray  # [T]
    std: np.ndarray  # [T]

    def standardize(self, y: np.ndarray) -> np.ndarray:
        return (y - self.mean) / self.std

    def unstandardize_mae(self, mae_std: np.ndarray) -> np.ndarray:
        """MAE on standardized labels → MAE in original units."""
        return mae_std * self.std

    @staticmethod
    def fit(labels: np.ndarray, eps: float = 1e-8) -> "LabelStats":
        return LabelStats(mean=labels.mean(0), std=np.maximum(labels.std(0), eps))
