"""Batch inference / serving entry of the port: checkpoint + SDF or SMILES
→ predictions CSV.

    python -m equihgnn_tpu_torch.predict --device cuda --ckpt model.pt \\
        --sdf molecules.sdf --out preds.csv
    python -m equihgnn_tpu_torch.predict --device cuda --ckpt model.pt \\
        --smiles molecules.smi --out preds.csv

The same CLI as `equihgnn_tpu/predict.py`, for the port. The checkpoint is
the port's own: `torch.save` of the model's state dict at `<ckpt>`, with
`<ckpt>.meta.json` beside it holding the keys of the JAX run meta:
`method`, `model_config` and `std` (see `save_checkpoint`). The model is
rebuilt from the meta alone. Molecules are featurized by the first-party
SDF reader (`--sdf`) or SMILES parser (`--smiles`, one SMILES a line, blank
lines skipped; RDKit's where installed): as hypergraphs, or as plain
graphs (`mol2graph`) for the 2-D baselines; with coordinates for the
geometric encoders only. A record that fails to parse gives a `nan` row,
so the output stays aligned with the input. Predictions are de-normalized
by `std`. This is `equihgnn_tpu/predict.py`'s behaviour.

`--device cuda` needs a card and raises without one; it never falls back
to the CPU. Covered: every model the port registers. From `--sdf`: the
MHNN family (`mhnn`, `mhnns`, `mhnnm`) and the 2-D baselines (`gin`,
`gcn`, `gat`, `gatv2`), which read no coordinates, and the encoders with
3-D coordinates (`egnn_equihnn{,s,m}`, `faformer_equihnn{,s,m}`,
`visnet_equihnn{,s,m}`, `se3_transformer_equihnns`,
`equiformer_equihnns`). From `--smiles`: the
methods without coordinates; a geometric method raises. The model serves
in `eval()` mode: dropout off, and a masked BatchNorm normalizes by its
running statistics, which the checkpoint carries. It computes in the
checkpoint's compute dtype, or in `--compute_dtype` where given (the
weights are float32 either way, so an f32 checkpoint serves in bfloat16 on
the models that take it).
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
from equihgnn_tpu_torch.data.featurize import (
    mol_from_smiles,
    mol_to_graph,
    mol_to_hypergraph,
    smiles_to_hypergraph,
)
from equihgnn_tpu_torch.data.sdf import read_sdf, read_titles
from equihgnn_tpu_torch.data.structures import GraphSample, HyperGraphSample
from equihgnn_tpu_torch.models.config import ModelConfig

# the methods whose encoders read 3-D coordinates (`equihgnn_tpu/predict.py:101-103`)
GEOMETRIC_PREFIXES = ("egnn", "visnet", "equiformer", "se3", "faformer")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint file (torch state dict); expects "
                        "<ckpt>.meta.json next to it")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--sdf", help="input molecules (.sdf, 3-D capable)")
    src.add_argument("--smiles", help="input molecules (text file, one SMILES per line; "
                                      "the methods without coordinates only)")
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu (default cuda)")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default=None,
                   help="serve in this compute dtype (default: the checkpoint's own); "
                        "the weights are float32 in either")
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


def featurize_sdf(path: str, hyper: bool = True, with_pos: bool = True
                  ) -> list[tuple[str, HyperGraphSample | GraphSample | None]]:
    """[(title, sample | None)] via the first-party reader + perception: a
    hypergraph, or (`hyper=False`) a plain graph; with coordinates and
    atomic numbers when `with_pos`."""
    out = []
    y0 = np.zeros(1, np.float32)
    featurize = mol_to_hypergraph if hyper else mol_to_graph
    for title, mol in zip(read_titles(path), read_sdf(path)):
        if mol is None:
            out.append((title, None))
            continue
        try:
            pos = z = None
            if with_pos:
                pos = np.asarray(mol.GetConformer().GetPositions(), dtype=np.float32)
                z = np.asarray([a.GetAtomicNum() for a in mol.GetAtoms()], dtype=np.int32)
            out.append((title, featurize(mol, y=y0, pos=pos, z=z)))
        except (ValueError, KeyError, IndexError) as e:  # malformed record → nan row
            print(f"skip {title!r}: {e}")
            out.append((title, None))
    return out


def featurize_smiles_file(path: str, hyper: bool
                          ) -> list[tuple[str, HyperGraphSample | GraphSample | None]]:
    """[(smiles, sample | None)], one a non-blank line, via RDKit or the
    first-party parser; a SMILES that does not parse gives None."""
    y0 = np.zeros(1, np.float32)
    out = []
    with open(path) as f:
        for line in f:
            smi = line.strip()
            if not smi:
                continue
            if hyper:
                out.append((smi, smiles_to_hypergraph(smi, y=y0)))
            else:
                mol = mol_from_smiles(smi)
                out.append((smi, mol_to_graph(mol, y=y0) if mol is not None else None))
    return out


def predict_samples(model: torch.nn.Module,
                    samples: Sequence[HyperGraphSample] | Sequence[GraphSample],
                    batch_size: int, device: torch.device) -> np.ndarray:
    """The serving path: spec → padded batches → forward → one prediction
    per sample, in input order (not de-normalized). Hypergraph or plain
    graph batches after the samples' type, with coordinates when every
    sample has them."""
    spec = spec_for_samples(samples, batch_size=batch_size)
    hyper = not isinstance(samples[0], GraphSample)
    with_pos = all(s.pos is not None for s in samples)
    preds = []
    with torch.inference_mode():
        for batch in iter_batches(samples, spec, hyper=hyper, with_pos=with_pos):
            out = model(batch.to(device))
            preds.append(out[batch.graph_mask.to(device)].cpu().numpy())
    return np.concatenate(preds)


def run(args) -> str:
    from equihgnn_tpu_torch.main import GRAPH_METHODS

    device = resolve_device(args.device)
    meta, state = load_checkpoint(args.ckpt)
    method = meta["method"]
    cfg = ModelConfig(**meta["model_config"])
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    std = float(meta.get("std", 1.0))
    hyper = method not in GRAPH_METHODS
    with_pos = method.startswith(GEOMETRIC_PREFIXES)

    if args.smiles:
        if with_pos:
            raise ValueError(f"method {method!r} needs 3-D coordinates — use --sdf")
        rows = featurize_smiles_file(args.smiles, hyper)
    else:
        rows = featurize_sdf(args.sdf, hyper, with_pos)
    samples = [s for _, s in rows if s is not None]
    if not samples:
        raise ValueError("no parseable molecules in the input")

    extra = {} if hyper else {"gnn_type": method}
    model = create_model(method, num_target=1, cfg=cfg, device=device, **extra)
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
