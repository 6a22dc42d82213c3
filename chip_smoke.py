#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`equihgnn_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each of which raises on failure (exit code 1, no
result line):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: both CUDA kernels compiled from `equihgnn_tpu_torch/csrc/`;
3. kernels vs their plain PyTorch versions on the card, at the shapes of
   the serving path (a batch of 768 synthetic molecules at hidden 256):
   error and median time of each;
4. serve: `egnn_equihnns` at the bench recipe (hidden 256, 3 conv layers,
   output hidden 128 over 3 layers, mean aggregation, LayerNorm, f32) with
   random weights from a seed, saved as a port checkpoint, served through
   `equihgnn_tpu_torch.predict.run` on `datasets/real_sample/sample.sdf`
   and checked against the same model on the CPU; then one request of 768
   synthetic molecules through the same library path. The kernels' launch
   counters must show that both served requests ran through both kernels.

The second-to-last line is `{"kernels": [...]}`, the last
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SDF = os.path.join(ROOT, "datasets", "real_sample", "sample.sdf")
BATCH = 768
HIDDEN = 256


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(*fns, iters: int = 20, warmup_s: float = 0.3) -> list[float]:
    """Median device time in ms of each of `fns`, from CUDA events around
    each call. The card first runs `warmup_s` seconds of the same work, so
    that it leaves its idle clocks, and the functions then alternate call by
    call, so that a clock change affects each of them alike."""
    t_end = time.perf_counter() + warmup_s
    while time.perf_counter() < t_end:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(iters):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def read_csv(path: str) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    return name, smi


def phase_build() -> None:
    import equihgnn_tpu_torch
    from equihgnn_tpu_torch.ops.kernels import build

    pkg = os.path.dirname(os.path.abspath(equihgnn_tpu_torch.__file__))
    check(pkg == os.path.join(ROOT, "equihgnn_tpu_torch"),
          f"equihgnn_tpu_torch imported from {pkg}, not from this checkout")
    t0 = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t0
    print(f"build: {seconds:.2f} s, nvcc {' '.join(build.NVCC_FLAGS)} "
          f"-> {build.library_path().name} from {[s.name for s in build.sources()]}")


def phase_kernels(batch) -> list[dict]:
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
        fused_edge_messages,
        fused_edge_messages_plain,
    )
    from equihgnn_tpu_torch.ops.kernels.segment_sum import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )
    from equihgnn_tpu_torch.ops.knn import knn_dense

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows = []

    # kernel A at the hyperedge-direction reduction of the trunk
    ids = batch.hedge_idx.to(dev)
    m, s = ids.shape[0], batch.num_hedges
    data = torch.randn(m, HIDDEN, generator=gen).to(dev)
    got = sorted_segment_sum(data, ids, s)
    ref = sorted_segment_sum_plain(data, ids, s)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"kernel A sorted_segment_sum [M={m}, D={HIDDEN}] -> [S={s}]: "
          f"max|d| {err:.3e}, max rel {err / scale:.3e} (limit 1e-5 * {scale:.3f})")
    check(err <= 1e-5 * scale, "kernel A disagrees with its plain version")
    ms, plain_ms = median_ms(lambda: sorted_segment_sum(data, ids, s),
                             lambda: sorted_segment_sum_plain(data, ids, s))
    rows.append(dict(
        name="sorted_segment_sum", route="cuda",
        source="equihgnn_tpu_torch/csrc/segment_sum.cu",
        replaces="equihgnn_tpu/ops/pallas/segment_sum.py:92",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
    ))

    # kernel B on the real neighbourhoods of the batch's slot view
    sm = batch.slot_mask.to(dev)
    pd = batch.pos.to(dev)[batch.slot_index.to(dev)] * sm[..., None]
    nbr_idx, _, _ = knn_dense(pd, sm, 16, slot_gid=batch.slot_gid.to(dev))
    r = torch.arange(pd.shape[0], device=dev)[:, None, None]
    rel = pd[:, :, None, :] - pd[r, nbr_idx]
    dist = torch.sum(rel * rel, dim=-1)
    g, a, k = nbr_idx.shape
    f, mo = 2 * (2 * HIDDEN + 1), 16
    ui = torch.randn(g, a, f, generator=gen).to(dev)
    ujn = torch.randn(g, a, f, generator=gen).to(dev)
    wd, b0 = (0.1 * torch.randn(f, generator=gen)).to(dev), (0.1 * torch.randn(f, generator=gen)).to(dev)
    w1, b1 = (0.1 * torch.randn(f, mo, generator=gen)).to(dev), (0.1 * torch.randn(mo, generator=gen)).to(dev)
    args = (ui, ujn, dist, nbr_idx, wd, b0, w1, b1)
    got = fused_edge_messages(*args)
    ref = fused_edge_messages_plain(*args)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    err = float(diff.max())
    rel_err = float((diff / ref.abs().clamp(min=1e-30)).max())
    ok = bool((diff <= 1e-5 + 1e-4 * ref.abs()).all())
    print(f"kernel B fused_edge_messages [G={g}, A={a}, k={k}, F={f}, m={mo}]: "
          f"max|d| {err:.3e}, max rel {rel_err:.3e} (atol 1e-5, rtol 1e-4): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "kernel B disagrees with its plain version")
    ms, plain_ms = median_ms(lambda: fused_edge_messages(*args),
                             lambda: fused_edge_messages_plain(*args))
    rows.append(dict(
        name="fused_edge_messages", route="cuda",
        source="equihgnn_tpu_torch/csrc/edge_mlp.cu",
        replaces="equihgnn_tpu/ops/pallas/edge_mlp.py:179",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
    ))
    for row in rows:
        print(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
              f"(median of 20, the two alternating, CUDA events)")
    return rows


def phase_serve(samples, smi: str) -> dict[str, int]:
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import fused_edge_messages
    from equihgnn_tpu_torch.ops.kernels.segment_sum import sorted_segment_sum
    from equihgnn_tpu_torch.predict import build_parser, predict_samples, run, save_checkpoint

    method = "egnn_equihnns"
    cfg = ModelConfig(mlp_hidden=HIDDEN, output_hidden=128, all_num_layers=3,
                      output_num_layers=3, aggregate="mean", normalization="ln")
    dev = torch.device("cuda")
    model = create_model(method, num_target=1, cfg=cfg,
                         generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "model.pt"), model, method, cfg, std=1.0)
        out_gpu, out_cpu = os.path.join(tmp, "gpu.csv"), os.path.join(tmp, "cpu.csv")

        sorted_segment_sum.launches = 0
        fused_edge_messages.launches = 0
        t0 = time.perf_counter()
        run(build_parser().parse_args(
            ["--ckpt", ckpt, "--sdf", SDF, "--out", out_gpu, "--device", "cuda"]))
        t_sdf = time.perf_counter() - t0
        model_gpu = model.to(dev).eval()
        preds = predict_samples(model_gpu, samples, BATCH, dev)
        launches = {"sorted_segment_sum": sorted_segment_sum.launches,
                    "fused_edge_messages": fused_edge_messages.launches}
        print(f"launches while serving (2 requests, 1 batch each): {launches}")
        check(launches == {"sorted_segment_sum": 2 * cfg.all_num_layers,
                           "fused_edge_messages": 2},
              "the served requests did not run through both kernels as expected")

        rows = read_csv(out_gpu)
        vals = np.array([float(r["prediction"]) for r in rows])
        print(f"serve {os.path.relpath(SDF, ROOT)} on cuda: {len(rows)} rows in "
              f"{t_sdf:.2f} s, predictions [{vals.min():.5f}, {vals.max():.5f}]")
        check(len(rows) == 20, "expected 20 prediction rows")
        check(bool(np.isfinite(vals).all()), "non-finite prediction in the SDF request")
        check(rows[4]["title"] == "benzene", f"row 4 is {rows[4]['title']!r}, not benzene")

        run(build_parser().parse_args(
            ["--ckpt", ckpt, "--sdf", SDF, "--out", out_cpu, "--device", "cpu"]))
        cpu_vals = np.array([float(r["prediction"]) for r in read_csv(out_cpu)])
        d = float(np.abs(vals - cpu_vals).max())
        ok = bool(np.allclose(vals, cpu_vals, rtol=1e-4, atol=1e-5))
        print(f"cuda vs cpu predictions: max|d| {d:.3e} (rtol 1e-4, atol 1e-5): "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "card and CPU predictions disagree")

    check(preds.shape == (BATCH,), f"batch-{BATCH} request gave shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), f"non-finite prediction in the batch-{BATCH} request")
    print(f"batch-{BATCH} request: {preds.shape[0]} finite predictions, "
          f"mean {preds.mean():.5f}, std {preds.std():.5f}")

    # throughput of the batch-768 request: host batching + copy + forward
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_samples(model_gpu, samples, BATCH, dev)
        torch.cuda.synchronize()
        if i:  # the first call is a warm-up
            times.append(time.perf_counter() - t0)
    t_req = float(np.median(times))
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples

    batch_dev = next(iter_batches(samples, spec_for_samples(samples, BATCH), with_pos=True)).to(dev)
    with torch.inference_mode():
        fwd_ms, = median_ms(lambda: model_gpu(batch_dev), iters=10)
    print(f"served: {BATCH / t_req:.1f} molecules/s end to end (batch {BATCH}, "
          f"median request {t_req * 1e3:.2f} ms incl. host batching); forward alone "
          f"{fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.1f} molecules/s; card: {smi}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    name, smi = phase_device()
    phase_build()

    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset

    samples = make_synthetic_dataset(BATCH, seed=0, num_targets=1)
    batch = next(iter_batches(samples, spec_for_samples(samples, BATCH), with_pos=True))
    kernels = phase_kernels(batch)
    launches = phase_serve(samples, smi)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
