"""Host-side training controllers: plateau LR decay and early stopping.

Copy of `equihgnn_tpu/train/schedule.py`, unchanged. The reference uses
`ReduceLROnPlateau(mode=min, factor=0.1, patience=10, min_lr=lr*1e-5)`
monitoring `val_mae_mean` and `EarlyStopping(monitor=val_mae_mean,
patience=50)` (`reference main.py:137-151,267`). The port's trainer sets the
controller's learning rate in the optimizer's `param_groups` between epochs.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode=min)."""

    def __init__(
        self,
        init_lr: float,
        factor: float = 0.1,
        patience: int = 10,
        min_lr: float | None = None,
        threshold: float = 1e-4,
    ):
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = float(min_lr) if min_lr is not None else init_lr * 1e-5
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Update with this epoch's monitored value; returns current LR."""
        # torch default threshold_mode='rel': improvement if m < best*(1-thr)
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr


class EarlyStopping:
    """Lightning EarlyStopping(mode=min) semantics."""

    def __init__(self, patience: int = 50, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.wait = 0
        self.should_stop = False

    def step(self, metric: float) -> bool:
        if metric < self.best - self.min_delta:
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.should_stop = True
        return self.should_stop
