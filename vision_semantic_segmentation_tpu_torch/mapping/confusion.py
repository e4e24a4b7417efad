"""Confusion-matrix evidence model for the Bayesian map update.

Rebuild of `reference: src/data/confusion_matrix.py:6-63`: load an NxN
count matrix (sklearn convention: C[i, j] = truth i predicted j), take the
submatrix over the mapped label indices, row-normalize to probabilities and
optionally take the log — producing the per-class log-likelihood columns
that are scatter-added into the grid (ref mapping.py:127-132,424).

Port copy of ``vision_semantic_segmentation_tpu/mapping/confusion.py``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class ConfusionMatrix:
    def __init__(self, load_path: str = "", matrix: np.ndarray | None = None):
        if matrix is None:
            matrix = np.load(load_path)
        self._mtx = np.asarray(matrix, dtype=np.float64)
        h, w = self._mtx.shape
        assert h == w, "confusion matrix must be square"
        self.num_class = h

    def get_submatrix(
        self, indices: Sequence[int], to_probability: bool = False, use_log: bool = False
    ) -> np.ndarray:
        """Submatrix over ``indices``; optionally row-normalized (+log)."""
        if len(indices) == 0:
            return np.zeros((0, 0))
        if len(indices) > self.num_class:
            raise ValueError("More indices than classes in the confusion matrix")
        for i in indices:
            if i < 0 or i >= self.num_class:
                raise ValueError(f"Invalid index {i}")
        sub = self._mtx[np.ix_(indices, indices)]
        if to_probability:
            sub = sub / np.sum(sub, axis=1, keepdims=True)
            if use_log:
                sub = np.log(sub)
        return sub

    def __len__(self) -> int:
        return self.num_class

    def __getitem__(self, item):
        return self._mtx[item]

    def __str__(self) -> str:
        return str(self._mtx)


def evidence_matrix(cfg, num_labels: int) -> np.ndarray:
    """The (C, C) additive evidence used by the mapping engine.

    Log-probability confusion submatrix when configured, identity otherwise
    (ref mapping.py:127-132).
    """
    if cfg.MAPPING.CONFUSION_MTX.LOAD_PATH:
        cm = ConfusionMatrix(load_path=cfg.MAPPING.CONFUSION_MTX.LOAD_PATH)
        return cm.get_submatrix(list(cfg.LABELS), to_probability=True, use_log=True)
    return np.eye(num_labels)
