"""Training harness of the port: train/eval steps and host-side controllers.

Port of `equihgnn_tpu/train/trainer.py` (`TrainConfig`, `Trainer`,
`_Prefetcher`) in PyTorch idiom:

  * masked MSE on normalized targets, `sq / max(cnt, 1)`; eval
    de-normalized by the target std;
  * `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)`:
    L2 decay folded into the gradient before the moments, as the JAX
    package's `_adam_like` builds with optax; `clip_gnorm` clips the global
    gradient norm before the step (torch adds 1e-6 to the norm, optax does
    not). Every parameter holds a gradient tensor from the start and
    `zero_grad(set_to_none=False)` keeps it, so a parameter that the loss
    does not reach (the EGNN coordinate branch) gets a zero gradient and is
    still decayed and counted by Adam, as optax does; with `grad=None`,
    `torch.optim.Adam` would skip it;
  * ReduceLROnPlateau + EarlyStopping on `val_mae_mean`; the learning rate
    is set per epoch in the optimizer's `param_groups`;
  * `model.train()` for training steps (dropout on; a masked BatchNorm
    normalizes by the batch's statistics and updates its running ones),
    `model.eval()` + `torch.inference_mode()` for evaluation (the running
    statistics normalize);
  * no host sync per step: the loss stays a device tensor and is fetched
    once per epoch;
  * a bounded background-thread prefetcher pads the next batches, pins
    them and copies them with `non_blocking=True` while the current step
    runs. The copies go to the thread's current stream, the default stream
    that the steps run on, so stream order keeps them ahead of their use;
  * best/last checkpoints, CSV log, `test_results.csv` and `resume`.
    `ckpt_{tag}.pt` is the model's state dict alone (the BatchNorms'
    running statistics included), which
    `equihgnn_tpu_torch.predict` serves; `ckpt_{tag}.opt.pt` the optimizer
    state; `ckpt_{tag}.pt.meta.json` the run meta plus `epoch` and `lr`.

A batch is a `HyperGraphBatch` or, for the 2-D baselines, a `GraphBatch`:
the trainer reads its `y`, `graph_mask`, `pin_memory` and `to` only.

Dropout draws from torch's global generator, seeded from (seed, epoch) at
each epoch, so a seed gives one trajectory on one device (and a resumed
run the same stream); the streams differ from JAX's by design. Comet
logging, the profiler hook and data parallelism are not ported
(`equihgnn_tpu_torch.main` raises on `--data_parallel`).
"""

from __future__ import annotations

import csv
import json
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from equihgnn_tpu_torch.predict import resolve_device
from equihgnn_tpu_torch.train.metrics import EvalAccumulator
from equihgnn_tpu_torch.train.schedule import EarlyStopping, ReduceLROnPlateau


@dataclass
class TrainConfig:
    epochs: int = 300
    lr: float = 1e-4
    weight_decay: float = 0.0
    clip_gnorm: float | None = None  # reference parses but never applies this
    seed: int = 0
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    min_lr: float | None = None  # defaults to lr * 1e-5 (reference main.py:146)
    early_stop_patience: int = 50
    num_bootstraps: int = 50
    log_dir: str | None = None
    debug: bool = False  # fast_dev_run: 1 train + 1 val batch, no checkpoint
    resume: bool = False  # restore ckpt_last before fitting
    # run identity (method, ModelConfig, std, ...) merged into every
    # checkpoint's .meta.json so that predict can rebuild the model
    run_meta: dict | None = None


def masked_mse(preds: torch.Tensor, y: torch.Tensor, graph_mask: torch.Tensor):
    """(Σ (preds − y)² over real graphs, number of real graphs)."""
    m = graph_mask.to(preds.dtype)
    return torch.sum((preds - y) ** 2 * m), torch.sum(m)


class _Prefetcher:
    """Bounded background-thread iterator: runs the producer (host padding,
    pinning, host → device copy) ahead of the consumer."""

    _END, _ERR = object(), object()

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it):
        try:
            for x in it:
                if not self._put(("ok", x)):
                    return
            self._put((self._END, None))
        except BaseException as e:  # propagate to the consumer
            self._put((self._ERR, e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():  # closed or exhausted: never block again
            raise StopIteration
        kind, val = self._q.get()
        if kind is self._END:
            self._stop.set()
            raise StopIteration
        if kind is self._ERR:
            self._stop.set()
            raise val
        return val

    def close(self):
        """Stop the producer and wait for it: no thread outlives the loop."""
        self._stop.set()
        self._thread.join()


class Trainer:
    """Drives one run of (fit + test) for a model on padded-batch loaders.

    `device` is keyword-only and defaults to "cuda", as the CLIs do: without
    a card that raises, and the run never carries on on the CPU unless the
    caller names it (`device="cpu"`)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 std: float | None = None, *, device="cuda"):
        self.cfg = cfg
        self.std = std
        self.device = resolve_device(str(device))
        self.model = model.to(self.device)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        for p in self.params:  # zero, never None: see the module docstring
            p.grad = torch.zeros_like(p)
        self.opt = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=cfg.weight_decay)
        self.history: list[dict] = []

    # ------------------------------------------------------------------ steps
    def set_lr(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr

    def train_step(self, batch) -> torch.Tensor:
        """One Adam step on a device batch; the loss as a device scalar."""
        self.model.train()
        sq, cnt = masked_mse(self.model(batch), batch.y, batch.graph_mask)
        loss = sq / torch.clamp(cnt, min=1.0)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        if self.cfg.clip_gnorm:
            torch.nn.utils.clip_grad_norm_(self.params, self.cfg.clip_gnorm)
        self.opt.step()
        return loss.detach()

    # ------------------------------------------------------------------ loops
    def _device_batches(self, loader: Iterable):
        """(host batch's real-graph count, device batch), prefetched on a
        background thread so that the padding and copy of the next batches
        overlap the current step."""
        dev = self.device

        def src():
            for b in loader:
                n = int(b.graph_mask.sum())
                if dev.type == "cuda":
                    b = b.pin_memory().to(dev, non_blocking=True)
                else:
                    b = b.to(dev)
                yield n, b

        pf = _Prefetcher(src(), depth=2)
        try:
            yield from pf
        finally:
            pf.close()

    def train_epoch(self, loader, lr: float) -> float:
        """Mean train loss of the epoch, fetched from the device once.
        `self.epoch_counts` gets the epoch's steps and real graphs."""
        self.set_lr(lr)
        losses: list = []
        graphs = 0
        for n, batch in self._device_batches(loader):
            losses.append(self.train_step(batch))
            graphs += n
            if self.cfg.debug:
                break
        self.epoch_counts = {"train_steps": len(losses), "train_graphs": graphs}
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())  # one fetch per epoch

    def eval_epoch(self, loader) -> EvalAccumulator:
        acc = EvalAccumulator(std=self.std)
        pending = []
        self.model.eval()
        with torch.inference_mode():
            for _, batch in self._device_batches(loader):
                pending.append((self.model(batch), batch.y, batch.graph_mask))
                if self.cfg.debug:
                    break
        for preds, y, mask in pending:  # fetch after all launches
            acc.update(preds.cpu().numpy().reshape(-1), y.cpu().numpy().reshape(-1),
                       mask.cpu().numpy().reshape(-1))
        return acc

    def fit(self, train_loader_fn: Callable[[int], Iterable],
            val_loader_fn: Callable[[], Iterable]) -> dict:
        cfg = self.cfg
        plateau = ReduceLROnPlateau(
            cfg.lr, factor=cfg.plateau_factor, patience=cfg.plateau_patience,
            min_lr=cfg.min_lr if cfg.min_lr is not None else cfg.lr * 1e-5,
        )
        early = EarlyStopping(patience=cfg.early_stop_patience)
        best = {"val_mae_mean": float("inf"), "epoch": -1}
        lr = cfg.lr
        start_epoch = 0
        if cfg.resume:
            meta = self._restore_checkpoint("last")
            if meta:
                start_epoch = int(meta.get("epoch", -1)) + 1
                lr = float(meta.get("lr", lr))

        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            torch.manual_seed(cfg.seed * 100003 + epoch)  # the epoch's dropout stream
            train_loss = self.train_epoch(train_loader_fn(epoch), lr)
            train_time = time.time() - t0
            acc = self.eval_epoch(val_loader_fn())
            metrics = acc.compute(prefix="val_", num_bootstraps=cfg.num_bootstraps, seed=epoch)
            metrics.update(epoch=epoch, train_loss=train_loss, lr=lr,
                           epoch_time=time.time() - t0, train_time=train_time,
                           **self.epoch_counts)
            self.history.append(metrics)
            self._log_csv(metrics)

            monitored = metrics["val_mae_mean"]
            if monitored < best["val_mae_mean"] and not cfg.debug:
                best = {"val_mae_mean": monitored, "epoch": epoch}
                self._save_checkpoint("best", meta={"epoch": epoch, "lr": lr})
            lr = plateau.step(monitored)
            if not cfg.debug:
                self._save_checkpoint("last", meta={"epoch": epoch, "lr": lr})
            if early.step(monitored) or cfg.debug:
                break
        return best

    def test(self, test_loader_fn, restore_best: bool = True) -> dict:
        if restore_best and not self.cfg.debug:
            self._restore_checkpoint("best")
        acc = self.eval_epoch(test_loader_fn())
        metrics = acc.compute(prefix="test_", num_bootstraps=self.cfg.num_bootstraps)
        self._log_csv(metrics)
        if self.cfg.log_dir:
            preds, targets = acc.arrays()
            path = os.path.join(self.cfg.log_dir, "test_results.csv")
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["pred", "truth"])
                w.writerows(zip(preds.tolist(), targets.tolist()))
        return metrics

    # ------------------------------------------------------------- utilities
    def _log_csv(self, metrics: dict):
        if not self.cfg.log_dir:
            return
        os.makedirs(self.cfg.log_dir, exist_ok=True)
        path = os.path.join(self.cfg.log_dir, "metrics.csv")
        exists = os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted(metrics.keys()))
            if not exists:
                w.writeheader()
            w.writerow(metrics)

    def _ckpt_path(self, tag: str) -> str:
        base = self.cfg.log_dir or "checkpoints"
        return os.path.abspath(os.path.join(base, f"ckpt_{tag}.pt"))

    def _save_checkpoint(self, tag: str, meta: dict):
        path = self._ckpt_path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(self.model.state_dict(), path)
        torch.save(self.opt.state_dict(), path[: -len(".pt")] + ".opt.pt")
        with open(path + ".meta.json", "w") as f:
            json.dump({**(self.cfg.run_meta or {}), **meta}, f)

    def _restore_checkpoint(self, tag: str) -> dict | None:
        path = self._ckpt_path(tag)
        if not os.path.exists(path):
            return None
        self.model.load_state_dict(torch.load(path, map_location=self.device, weights_only=True))
        self.opt.load_state_dict(torch.load(path[: -len(".pt")] + ".opt.pt",
                                            map_location=self.device, weights_only=True))
        meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
        return {}
