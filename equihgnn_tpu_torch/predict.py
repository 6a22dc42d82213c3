"""Batch inference / serving entry of the port: checkpoint + SDF → predictions CSV.

    python -m equihgnn_tpu_torch.predict --device cuda --ckpt model.pt \\
        --sdf molecules.sdf --out preds.csv

The same CLI as `equihgnn_tpu/predict.py`, for the port. The checkpoint is
the port's own: `torch.save` of the model's state dict at `<ckpt>`, with
`<ckpt>.meta.json` beside it holding the keys of the JAX run meta:
`method`, `model_config` and `std` (see `save_checkpoint`). The model is
rebuilt from the meta alone. Molecules are featurized by the first-party
SDF reader; a record that fails to parse gives a `nan` row, so the output
stays aligned with the input. Predictions are de-normalized by `std`.

`--device cuda` needs a card and raises without one; it never falls back
to the CPU. Covered so far: hypergraph methods with 3-D coordinates
(`egnn_equihnns`, `faformer_equihnns`) from `--sdf`.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
from equihgnn_tpu_torch.data.featurize import mol_to_hypergraph
from equihgnn_tpu_torch.data.sdf import read_sdf, read_titles
from equihgnn_tpu_torch.data.structures import HyperGraphSample
from equihgnn_tpu_torch.models.config import ModelConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint file (torch state dict); expects "
                        "<ckpt>.meta.json next to it")
    p.add_argument("--sdf", required=True, help="input molecules (.sdf, 3-D)")
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu (default cuda)")
    return p


def save_checkpoint(path: str, model: torch.nn.Module, method: str,
                    cfg: ModelConfig, std: float = 1.0) -> str:
    """Write `path` (state dict) and `path.meta.json` for `load_checkpoint`."""
    torch.save(model.state_dict(), path)
    meta = {"method": method, "model_config": dataclasses.asdict(cfg), "std": std}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_checkpoint(ckpt: str):
    """(meta dict, state dict on the CPU) from a port checkpoint."""
    meta_path = ckpt + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{meta_path} not found next to the checkpoint")
    with open(meta_path) as f:
        meta = json.load(f)
    for key in ("method", "model_config"):
        if key not in meta:
            raise KeyError(f"{meta_path} lacks '{key}'")
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    return meta, state


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA device without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (torch "
            f"{torch.__version__}); pass --device cpu to run on the CPU"
        )
    return device


def featurize_sdf(path: str) -> list[tuple[str, HyperGraphSample | None]]:
    """[(title, sample | None)] via the first-party reader + perception."""
    out = []
    y0 = np.zeros(1, np.float32)
    for title, mol in zip(read_titles(path), read_sdf(path)):
        if mol is None:
            out.append((title, None))
            continue
        try:
            pos = np.asarray(mol.GetConformer().GetPositions(), dtype=np.float32)
            z = np.asarray([a.GetAtomicNum() for a in mol.GetAtoms()], dtype=np.int32)
            out.append((title, mol_to_hypergraph(mol, y=y0, pos=pos, z=z)))
        except (ValueError, KeyError, IndexError) as e:  # malformed record → nan row
            print(f"skip {title!r}: {e}")
            out.append((title, None))
    return out


def predict_samples(model: torch.nn.Module, samples: Sequence[HyperGraphSample],
                    batch_size: int, device: torch.device) -> np.ndarray:
    """The serving path: spec → padded batches → forward → one prediction
    per sample, in input order (not de-normalized)."""
    spec = spec_for_samples(samples, batch_size=batch_size)
    preds = []
    with torch.inference_mode():
        for batch in iter_batches(samples, spec, with_pos=True):
            out = model(batch.to(device))
            preds.append(out[batch.graph_mask.to(device)].cpu().numpy())
    return np.concatenate(preds)


def run(args) -> str:
    device = resolve_device(args.device)
    meta, state = load_checkpoint(args.ckpt)
    method = meta["method"]
    cfg = ModelConfig(**meta["model_config"])
    std = float(meta.get("std", 1.0))

    rows = featurize_sdf(args.sdf)
    samples = [s for _, s in rows if s is not None]
    if not samples:
        raise ValueError("no parseable molecules in the input")

    model = create_model(method, num_target=1, cfg=cfg, device=device)
    model.load_state_dict(state)
    model.eval()
    preds = predict_samples(model, samples, args.batch_size, device) * std

    it = iter(preds.tolist())
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "title", "prediction"])
        for i, (title, s) in enumerate(rows):
            w.writerow([i, title, next(it) if s is not None else "nan"])
    print(f"wrote {len(rows)} predictions ({len(preds)} valid) to {args.out}")
    return args.out


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
