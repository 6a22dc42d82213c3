#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`equihgnn_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each of which raises on failure (exit code 1, no
result line):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: the CUDA kernels compiled from `equihgnn_tpu_torch/csrc/`;
3. kernels vs their plain PyTorch versions on the card, at the shapes of a
   batch of 768 synthetic molecules at hidden 256: kernel A (sorted segment
   sum), kernel B (edge MLP forward) and kernel C (edge MLP backward, its
   seven gradients against autograd through the plain forward); error and
   median time of each, and kernel A's device time under torch.profiler;
4. serve: `egnn_equihnns` at the bench recipe (hidden 256, 3 conv layers,
   output hidden 128 over 3 layers, mean aggregation, LayerNorm, f32) with
   random weights from a seed, saved as a port checkpoint, served through
   `equihgnn_tpu_torch.predict.run` on `datasets/real_sample/sample.sdf`
   and checked against the same model on the CPU; then one request of 768
   synthetic molecules through the same library path. The kernels' launch
   counters must show that both served requests ran through A and B;
5. gradients: one train step's parameter gradients of the full-width model
   on 32 molecules, on the card (kernels) against the CPU (plain versions);
   every parameter the CPU reaches must be reached on the card;
6. train: `equihgnn_tpu_torch.main.run` on `synthetic_hg_3d` with
   `egnn_equihnns` at the recipe, batch 768, 3 epochs of ~10 steps, a
   learnable target, into a temporary log directory. Every train loss
   finite and the last below the first; the launch counters show kernels
   A (3×), B and C on every train step and A (3×) and B on every eval
   forward; `ckpt_best.pt` serves through `predict.run --device cuda`;
7. step: one train step at batch 768 (forward + backward + Adam): its
   launches, median device time, peak memory and a `torch.profiler` table
   of its top device kernels.

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


def device_kernels(prof, calls: int) -> list[tuple[float, int, str]]:
    """(device ms per call, launches per call, kernel name) of every device
    kernel a `torch.profiler` run recorded over `calls` calls, largest first."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = evt.self_cuda_time_total
            rows.append((t / 1e3 / calls, evt.count // calls, evt.key))
    return sorted(rows, reverse=True)


def profiled_device_ms(fn, calls: int = 20) -> float:
    """Device time in ms per call of `fn`: the sum of its kernels' times
    under `torch.profiler`, without the host time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(t for t, _, _ in device_kernels(prof, calls))


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


def counters() -> dict:
    """name → the launch-counted wrapper of every kernel."""
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
        fused_edge_messages,
        fused_edge_messages_bwd,
    )
    from equihgnn_tpu_torch.ops.kernels.segment_sum import sorted_segment_sum

    return {"sorted_segment_sum": sorted_segment_sum,
            "fused_edge_messages": fused_edge_messages,
            "fused_edge_messages_bwd": fused_edge_messages_bwd}


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in counters().items()}


def phase_kernels(batch) -> list[dict]:
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
        fused_edge_messages,
        fused_edge_messages_bwd,
        fused_edge_messages_bwd_plain,
        fused_edge_messages_plain,
    )
    from equihgnn_tpu_torch.ops.kernels.segment_sum import (
        _launch,
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
    # the kernel's launch alone (no autograd dispatch in the timed window),
    # the wrapper (through `_SortedSegmentSum.apply`) and the plain version
    ms, wrapper_ms, plain_ms = median_ms(lambda: _launch(data, ids, s),
                                         lambda: sorted_segment_sum(data, ids, s),
                                         lambda: sorted_segment_sum_plain(data, ids, s))
    dev_ms = profiled_device_ms(lambda: _launch(data, ids, s))
    dev_plain_ms = profiled_device_ms(lambda: sorted_segment_sum_plain(data, ids, s))
    print(f"kernel A by CUDA events: launch {ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; device kernels alone (torch.profiler, 20 calls): "
          f"kernel {dev_ms:.4f} ms, plain {dev_plain_ms:.4f} ms")
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

    # kernel C on the same inputs, for an output gradient at O(1)
    dm = torch.randn(g, a, k, mo, generator=gen).to(dev)
    got = fused_edge_messages_bwd(*args, dm)
    ref = fused_edge_messages_bwd_plain(*args, dm)
    torch.cuda.synchronize()
    err = 0.0
    for gname, x, y in zip(("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1"), got, ref):
        d, scale = float((x - y).abs().max()), float(y.abs().max())
        err = max(err, d)
        ok = d <= 1e-4 * scale
        print(f"kernel C fused_edge_messages_bwd {gname} {tuple(x.shape)}: max|d| {d:.3e}, "
              f"max|ref| {scale:.3e}, rel {d / scale:.3e} (limit 1e-4 * max|ref|): "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel C's {gname} disagrees with the plain backward")
    ms, plain_ms = median_ms(lambda: fused_edge_messages_bwd(*args, dm),
                             lambda: fused_edge_messages_bwd_plain(*args, dm))
    rows.append(dict(
        name="fused_edge_messages_bwd", route="cuda",
        source="equihgnn_tpu_torch/csrc/edge_mlp.cu",
        replaces="equihgnn_tpu/ops/pallas/edge_mlp.py:222",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
    ))
    for row in rows:
        print(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
              f"(median of 20, the two alternating, CUDA events)")
    return rows


def recipe():
    from equihgnn_tpu_torch.models.config import ModelConfig

    return ModelConfig(mlp_hidden=HIDDEN, output_hidden=128, all_num_layers=3,
                       output_num_layers=3, aggregate="mean", normalization="ln")


def phase_serve(samples, smi: str) -> dict[str, int]:
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.predict import build_parser, predict_samples, run, save_checkpoint

    method = "egnn_equihnns"
    cfg = recipe()
    dev = torch.device("cuda")
    model = create_model(method, num_target=1, cfg=cfg,
                         generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "model.pt"), model, method, cfg, std=1.0)
        out_gpu, out_cpu = os.path.join(tmp, "gpu.csv"), os.path.join(tmp, "cpu.csv")

        reset_launches()
        t0 = time.perf_counter()
        run(build_parser().parse_args(
            ["--ckpt", ckpt, "--sdf", SDF, "--out", out_gpu, "--device", "cuda"]))
        t_sdf = time.perf_counter() - t0
        model_gpu = model.to(dev).eval()
        preds = predict_samples(model_gpu, samples, BATCH, dev)
        launches = read_launches()
        print(f"launches while serving (2 requests, 1 batch each): {launches}")
        check(launches == {"sorted_segment_sum": 2 * cfg.all_num_layers,
                           "fused_edge_messages": 2, "fused_edge_messages_bwd": 0},
              "the served requests did not run through kernels A and B as expected")

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


def phase_grads(samples) -> None:
    """One train step's gradients on the card (kernels) against the CPU
    (plain versions), full width, 32 molecules."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import masked_mse

    batch = next(iter_batches(samples, spec_for_samples(samples, len(samples)),
                              with_pos=True, target=0))

    def grads(device):
        model = create_model("egnn_equihnns", num_target=1, cfg=recipe(), device=device,
                             generator=torch.Generator().manual_seed(3)).train()
        b = batch.to(device)
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        (sq / torch.clamp(cnt, min=1.0)).backward()
        return {n: (p.grad.cpu() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    want = grads("cpu")
    reset_launches()
    got = grads("cuda")
    launches = read_launches()
    check(launches == {"sorted_segment_sum": 3, "fused_edge_messages": 1,
                       "fused_edge_messages_bwd": 1},
          f"the card's train step did not run through kernels A, B and C: {launches}")
    worst, reached = 0.0, 0
    for name, w in want.items():
        if w is None or float(w.abs().max()) == 0.0:
            continue
        reached += 1
        x = got[name]
        check(x is not None and float(x.abs().max()) > 0.0,
              f"{name} has a gradient on the CPU and none on the card")
        rel = float((x - w).abs().max()) / float(w.abs().max())
        worst = max(worst, rel)
        check(rel <= 1e-4, f"{name}: card and CPU gradients differ, rel {rel:.3e} > 1e-4")
    for name in ("egnn_layer.edge_mlp_0.weight_i", "egnn_layer.edge_mlp_1.weight",
                 "atom_encoder.atom.embedding", "trunk.conv.W1.lin_0.weight"):
        check(want[name] is not None and float(want[name].abs().max()) > 0, f"{name} unreached")
    print(f"gradients, card vs cpu, one train step at full width on {len(samples)} molecules: "
          f"{reached} parameters reached on both (of {len(want)}), worst max|d| / max|cpu| "
          f"{worst:.3e} (limit 1e-4 per tensor); launches {launches}")


def phase_train(smi: str) -> dict[str, int]:
    """Train through `equihgnn_tpu_torch.main.run` at the recipe, batch 768."""
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.main import build_parser, load_splits, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import run as predict_run

    cfg = recipe()
    argv = ["--data", "synthetic_hg_3d", "--method", "egnn_equihnns", "--device", "cuda",
            "--batch_size", str(BATCH), "--synthetic_size", "9600", "--epochs", "3",
            "--lr", "1e-3", "--MLP_hidden", str(cfg.mlp_hidden),
            "--output_hidden", str(cfg.output_hidden),
            "--All_num_layers", str(cfg.all_num_layers),
            "--output_num_layers", str(cfg.output_num_layers),
            "--aggregate", cfg.aggregate, "--normalization", cfg.normalization]
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    train_s, valid_s, test_s, _ = load_splits(args)
    print(f"train data: {len(train_s)}/{len(valid_s)}/{len(test_s)} molecules generated "
          f"in {time.perf_counter() - t0:.2f} s")
    for s in train_s + valid_s + test_s:  # learnable target: normalized atom count
        s.y = np.float32((s.n_atoms - 16.0) / 8.0)
    spec = spec_for_samples(train_s + valid_s + test_s, batch_size=BATCH)
    n_val = sum(1 for _ in iter_batches(valid_s, spec, with_pos=True))
    n_test = sum(1 for _ in iter_batches(test_s, spec, with_pos=True))

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # logs/ and checkpoints land in the temporary directory
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            res = run(args, splits=(train_s, valid_s, test_s, 1.0))
            torch.cuda.synchronize()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            hist = res["history"]
            losses = [h["train_loss"] for h in hist]
            steps = sum(h["train_steps"] for h in hist)
            evals = n_val * len(hist) + n_test
            print(f"train: {len(hist)} epochs, {steps} steps, {evals} eval forwards; "
                  f"train loss per epoch {losses}; val_mae_mean "
                  f"{[round(h['val_mae_mean'], 5) for h in hist]}; test_mae_mean "
                  f"{res['test_mae_mean']:.5f}")
            for h in hist:
                print(f"  epoch {h['epoch']}: {h['train_graphs']} molecules in "
                      f"{h['train_time']:.3f} s = {h['train_graphs'] / h['train_time']:.1f} "
                      f"trained molecules/s end to end ({h['train_steps']} steps; epoch incl. "
                      f"val {h['epoch_time']:.3f} s); card: {smi}")
            print(f"launches while training: {launches}; peak memory "
                  f"{peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
            check(len(hist) == 3, f"expected 3 epochs, got {len(hist)}")
            check(all(np.isfinite(losses)), "non-finite train loss")
            check(losses[-1] < losses[0], f"the train loss did not fall: {losses}")
            check(launches == {"sorted_segment_sum": 3 * (steps + evals),
                               "fused_edge_messages": steps + evals,
                               "fused_edge_messages_bwd": steps},
                  "training did not run A 3x, B and C on every train step and "
                  "A 3x and B on every eval forward")
            ckpt = os.path.join(res["log_dir"], "ckpt_best.pt")
            out = os.path.join(tmp, "trained.csv")
            predict_run(predict_parser().parse_args(
                ["--ckpt", ckpt, "--sdf", SDF, "--out", out, "--device", "cuda"]))
            vals = np.array([float(r["prediction"]) for r in read_csv(out)])
            check(vals.shape == (20,) and bool(np.isfinite(vals).all()),
                  "the trained checkpoint gave no 20 finite predictions")
            print(f"served {os.path.basename(ckpt)} on cuda: 20 predictions in "
                  f"[{vals.min():.5f}, {vals.max():.5f}]")
        finally:
            os.chdir(cwd)
    return launches


def phase_step(samples, smi: str) -> None:
    """One train step at batch 768: launches, device time, memory, profile."""
    from torch.profiler import ProfilerActivity, profile

    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    batch = next(iter_batches(samples, spec_for_samples(samples, BATCH), with_pos=True,
                              target=0)).to(dev)
    model = create_model("egnn_equihnns", num_target=1, cfg=recipe(), device=dev)
    trainer = Trainer(model, TrainConfig(lr=1e-4), std=1.0, device=dev)
    trainer.train_step(batch)  # warm-up: cuBLAS handles, Adam state
    reset_launches()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step_launches = read_launches()
    with torch.inference_mode():
        model.eval()
        reset_launches()
        model(batch)
        eval_launches = read_launches()
    print(f"launches of one train step: {step_launches}; of one eval forward: {eval_launches}")
    check(step_launches == {"sorted_segment_sum": 3, "fused_edge_messages": 1,
                            "fused_edge_messages_bwd": 1}, "train step launches")
    check(eval_launches == {"sorted_segment_sum": 3, "fused_edge_messages": 1,
                            "fused_edge_messages_bwd": 0}, "eval forward launches")

    torch.cuda.reset_peak_memory_stats()
    step_ms, = median_ms(lambda: trainer.train_step(batch), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step at batch {BATCH} (forward + backward + Adam): median {step_ms:.3f} ms "
          f"device time (CUDA events, 10 steps) = {BATCH / step_ms * 1e3:.1f} molecules/s; "
          f"peak memory {peak / 2**20:.1f} MiB; card: {smi}")

    steps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = device_kernels(prof, steps)
    busy = sum(t for t, _, _ in kernels)
    print(f"torch.profiler, {steps} train steps: device kernels {busy:.3f} ms of "
          f"{wall_ms:.3f} ms wall per step (busy share {busy / wall_ms:.2f}); top kernels "
          f"per step:" if kernels else "torch.profiler: no device kernel events recorded")
    for t, n, key in kernels[:12]:
        print(f"  {t:8.3f} ms  {n:3d}x  {key[:110]}")


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
    served = phase_serve(samples, smi)
    phase_grads(samples[:32])
    trained = phase_train(smi)
    phase_step(samples, smi)
    for row in kernels:
        row["launches"] = served[row["name"]] + trained[row["name"]]
    print(f"launches by path: serve {served}, train {trained}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
