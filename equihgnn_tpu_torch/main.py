"""Training CLI of the port — the flags of `equihgnn_tpu/main.py`
(`reference main.py:154-298`).

Usage:
    python -m equihgnn_tpu_torch.main --data synthetic_hg_3d \\
        --method egnn_equihnns --epochs 3 --device cuda

Ported methods: `egnn_equihnns`, `faformer_equihnns`.

Differences from the JAX CLI:
  * `--device` is a torch device string (default `cuda`, as in
    `equihgnn_tpu_torch.predict`); it replaces the JAX CLI's ignored
    `--device` int and its `--platform`. `cuda` without a card raises; the
    run never carries on on the CPU.
  * Flags of paths that are not ported raise NotImplementedError when set:
    `--data_parallel`, `--streaming`, `--pack_slots`, `--buckets`,
    `--compute_dtype`, `--remat`. `--num_devices` only sizes the
    data-parallel path, so it has no effect until that path is ported.
  * Batches come from `iter_batches` (the JAX package's native packer is
    not ported); each epoch's order is drawn from the same seed.
  * `run` returns the run's `log_dir` beside the metrics, and takes
    `splits=` (train, valid, test, std) in place of loading `--data`.

Kept: `--clip_gnorm` clips when set (the reference parses it and never
applies it); `--min_lr` is used only with `--use_min_lr` (the reference's
plateau floor is lr·1e-5); logs and checkpoints go to
`logs/<data>_<target>_<method>/version_<n>/` under the working directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
from equihgnn_tpu_torch.data.splits import create_train_val_test_set_and_normalize
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.predict import resolve_device
from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer

# flag → the ROADMAP item that ports its path
UNPORTED_FLAGS = {
    "data_parallel": "ROADMAP item 10 (data parallelism)",
    "streaming": "ROADMAP item 4 (packed slot rows and the streaming data path)",
    "pack_slots": "ROADMAP item 4 (packed slot rows and the streaming data path)",
    "buckets": "ROADMAP item 4 (packed slot rows and the streaming data path)",
    "compute_dtype": "ROADMAP item 11 (bfloat16 and remat)",
    "remat": "ROADMAP item 11 (bfloat16 and remat)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Training with MHNN (PyTorch port)")
    # Dataset arguments (reference main.py:162-164)
    p.add_argument("--data_dir", type=str, default="datasets/opv3d")
    p.add_argument("--target", type=int, default=0, help="target of dataset")
    p.add_argument("--data", default="opv_hg", help="data type")
    # Training hyperparameters (reference main.py:167-175)
    p.add_argument("--runs", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu (default cuda)")
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", default=0.0001, type=float)
    p.add_argument("--min_lr", default=0.000001, type=float)
    p.add_argument("--use_min_lr", action="store_true")
    p.add_argument("--wd", default=0.0, type=float)
    p.add_argument("--clip_gnorm", default=None, type=float)
    # Model hyperparameters (reference main.py:178-203)
    p.add_argument("--method", default="mhnns", help="model type")
    p.add_argument("--All_num_layers", default=3, type=int)
    p.add_argument("--MLP1_num_layers", default=2, type=int)
    p.add_argument("--MLP2_num_layers", default=2, type=int)
    p.add_argument("--MLP3_num_layers", default=2, type=int)
    p.add_argument("--MLP4_num_layers", default=2, type=int)
    p.add_argument("--MLP_hidden", default=64, type=int)
    p.add_argument("--output_num_layers", default=2, type=int)
    p.add_argument("--output_hidden", default=64, type=int)
    p.add_argument("--aggregate", default="mean", choices=["sum", "mean"])
    p.add_argument("--normalization", default="ln", choices=["bn", "ln", "None"])
    p.add_argument("--activation", default="relu", choices=["Id", "relu", "prelu"])
    p.add_argument("--dropout", default=0.0, type=float)
    # Debugging (reference main.py:206-208) + extensions of the JAX CLI
    p.add_argument("--debug", action="store_true", help="one train/val step only")
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--num_devices", default=None, type=int)
    p.add_argument("--synthetic_size", default=None, type=int)
    p.add_argument("--synthetic_max_atoms", default=29, type=int)
    p.add_argument("--pack_slots", action="store_true",
                   help="pack small molecules into shared dense slot rows")
    p.add_argument("--buckets", default=None, type=str,
                   help="comma-separated atom-count boundaries for size-"
                        "bucketed batching, e.g. '16,24'")
    p.add_argument("--streaming", action="store_true",
                   help="object-free packed data path")
    p.add_argument("--compute_dtype", default=None, choices=["bfloat16"],
                   help="bf16 activations in the geometric encoders")
    p.add_argument("--remat", action="store_true",
                   help="additionally checkpoint whole encoders")
    return p


def load_splits(args):
    """(train, valid, test, std) of `--data`, normalized, before the target
    column is selected."""
    data_kwargs = {}
    if args.data.startswith("synthetic") and args.synthetic_size:
        data_kwargs["size"] = args.synthetic_size
    return create_train_val_test_set_and_normalize(
        target=args.target, data_name=args.data, data_dir=args.data_dir, **data_kwargs)


def run(args, splits=None) -> dict:
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet: {item}")
    device = resolve_device(args.device)

    import equihgnn_tpu_torch.data.datasets  # noqa: F401  (registration)

    data_cls = registry.get_data_class(args.data)
    if data_cls is None:
        raise ValueError(f"Unknown or unported dataset name: {args.data!r}")
    train_s, valid_s, test_s, std = load_splits(args) if splits is None else splits
    with_pos = data_cls.has_pos

    spec = spec_for_samples(train_s + valid_s + test_s, batch_size=args.batch_size)

    def loader(samples, shuffle, epoch=0):
        rng = np.random.default_rng(args.seed * 100003 + epoch)
        return iter_batches(samples, spec, target=args.target, with_pos=with_pos,
                            shuffle=shuffle, rng=rng)

    results = []
    for run_idx in range(args.runs):
        seed = args.seed + run_idx
        print(f"\nRun No. {run_idx + 1}:\nSeed: {seed}\n")
        exp = f"{args.data}_{args.target}_{args.method}"
        version = 0
        while os.path.exists(os.path.join("logs", exp, f"version_{version}")):
            version += 1
        log_dir = os.path.join("logs", exp, f"version_{version}")

        cfg = ModelConfig.from_args(args)
        model = create_model(args.method, num_target=1, cfg=cfg, device=device,
                             generator=torch.Generator().manual_seed(seed))
        tcfg = TrainConfig(
            epochs=args.epochs,
            lr=args.lr,
            weight_decay=args.wd,
            clip_gnorm=args.clip_gnorm,
            seed=seed,
            min_lr=args.min_lr if args.use_min_lr else None,
            log_dir=log_dir,
            debug=args.debug,
            run_meta={
                "method": args.method,
                "model_config": dataclasses.asdict(cfg),
                "std": float(std),
                "target": args.target,
                "data": args.data,
            },
        )
        trainer = Trainer(model, tcfg, std=std, device=device)
        best = trainer.fit(
            lambda epoch: loader(train_s, True, epoch),
            lambda: loader(valid_s, False),
        )
        metrics = trainer.test(lambda: loader(test_s, False), restore_best=not args.debug)
        print(json.dumps({**best, **metrics}, indent=2))
        results.append({**best, **metrics, "log_dir": log_dir, "history": trainer.history})
    return results[-1]


def main():
    print("Task start time:")
    print(time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()))
    start = time.time()
    args = build_parser().parse_args()
    print(args)
    run(args)
    print("Task end time:")
    print(time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()))
    print("Total time taken: {} s.".format(int(time.time() - start)))


if __name__ == "__main__":
    main()
