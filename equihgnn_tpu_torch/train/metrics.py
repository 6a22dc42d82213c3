"""Evaluation metrics: MAE/MSE with bootstrap uncertainty.

Copy of `equihgnn_tpu/train/metrics.py`, unchanged. The reference wraps
torchmetrics MAE/MSE in `BootStrapper(num_bootstraps=50)` (`reference
main.py:36-42`) and logs `{val,test}_{mae,mse}_{mean,std}`; this computes
the same estimator at epoch end from the full prediction/target arrays: 50
bootstrap resamples (with replacement) of the epoch's samples → mean/std of
each metric (resampling the full epoch instead of torchmetrics' per-update
poisson weights, a documented deviation of the JAX package).
"""

from __future__ import annotations

import numpy as np


def bootstrap_metrics(
    preds: np.ndarray,
    targets: np.ndarray,
    num_bootstraps: int = 50,
    seed: int = 0,
) -> dict[str, float]:
    preds = np.asarray(preds, dtype=np.float64).reshape(-1)
    targets = np.asarray(targets, dtype=np.float64).reshape(-1)
    err = preds - targets
    out = {
        "mae_raw": float(np.mean(np.abs(err))),
        "mse_raw": float(np.mean(err**2)),
    }
    rng = np.random.default_rng(seed)
    n = err.shape[0]
    maes, mses = np.empty(num_bootstraps), np.empty(num_bootstraps)
    for b in range(num_bootstraps):
        idx = rng.integers(0, n, size=n)
        maes[b] = np.mean(np.abs(err[idx]))
        mses[b] = np.mean(err[idx] ** 2)
    out.update(
        mae_mean=float(maes.mean()),
        mae_std=float(maes.std()),
        mse_mean=float(mses.mean()),
        mse_std=float(mses.std()),
    )
    return out


class EvalAccumulator:
    """Accumulates de-normalized (pred, target) pairs across eval batches.

    Mirrors `LitModel.validation_step` semantics (`reference main.py:65-68`):
    predictions and targets are multiplied by the target std before the
    metric update. Only real (non-padding) graphs are accumulated.
    """

    def __init__(self, std: float | None = None):
        self.std = std
        self.reset()

    def reset(self):
        self._preds: list[np.ndarray] = []
        self._targets: list[np.ndarray] = []

    def update(self, preds, targets, graph_mask):
        preds = np.asarray(preds)
        targets = np.asarray(targets)
        mask = np.asarray(graph_mask).astype(bool)
        p, t = preds[mask], targets[mask]
        if self.std:
            p, t = p * self.std, t * self.std
        self._preds.append(p)
        self._targets.append(t)

    @property
    def num_samples(self) -> int:
        return int(sum(p.shape[0] for p in self._preds))

    def arrays(self):
        return np.concatenate(self._preds), np.concatenate(self._targets)

    def compute(self, prefix: str = "", num_bootstraps: int = 50, seed: int = 0):
        preds, targets = self.arrays()
        m = bootstrap_metrics(preds, targets, num_bootstraps=num_bootstraps, seed=seed)
        return {f"{prefix}{k}": v for k, v in m.items()}
