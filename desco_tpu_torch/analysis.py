"""Evaluation metrics, copied from ``desco_tpu/analysis.py`` (host-only
code; the port imports nothing of desco_tpu): the paper's normalized MSE,
MSE and MAE per query-size group. Predictions are rounded and ReLU'd
graph-level counts."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def norm_mse(pred: np.ndarray, truth: np.ndarray,
             groupby: Optional[List[List[int]]] = None) -> List[float]:
    if groupby is None:
        groupby = [list(range(pred.shape[1]))]
    pred = pred.astype(np.float64)
    truth = truth.astype(np.float64)
    out = []
    for group in groupby:
        mse = np.mean((pred[:, group] - truth[:, group]) ** 2)
        var = np.var(truth[:, group])
        if var == 0.0:
            # constant truth column group: the normalized metric is the
            # limit 0 (exact) or inf (any error) — never nan
            out.append(0.0 if mse == 0.0 else float("inf"))
        else:
            out.append(float(mse / var))
    return out


def mse(pred, truth, groupby=None) -> List[float]:
    if groupby is None:
        groupby = [list(range(pred.shape[1]))]
    pred = pred.astype(np.float64)
    truth = truth.astype(np.float64)
    return [float(np.mean((pred[:, g] - truth[:, g]) ** 2)) for g in groupby]


def mae(pred, truth, groupby=None) -> List[float]:
    if groupby is None:
        groupby = [list(range(pred.shape[1]))]
    return [float(np.mean(np.abs(pred[:, g] - truth[:, g])))
            for g in groupby]


def round_relu(counts: np.ndarray) -> np.ndarray:
    """round(relu(x)) — applied to graph-level predictions before
    scoring."""
    return np.round(np.maximum(counts, 0.0))
