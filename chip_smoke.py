#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`equihgnn_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each of which raises on failure (exit code 1, no
result line), each printing its seconds:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: the CUDA kernels compiled from `equihgnn_tpu_torch/csrc/` (one
   nvcc per source, in parallel);
3. kernels vs their plain PyTorch versions on the card, at the shapes of a
   batch of 768 synthetic molecules at hidden 256: kernel A (sorted segment
   sum), B (EGNN edge MLP forward), C (its backward, seven gradients against
   autograd through the plain forward), D (FAFormer's frame-averaged
   SwiGLU forward) and E (its backward, five gradients) at both FAFormer
   sites (EdgeModule P = 393,728, C = 4; FAFFN P = 24,608, C = 3), and D/E
   with dropout 0.1 at P = 24,608 (the same seed must give the same mask);
   error and median time of each;
then, for each model, `egnn_equihnns` and `faformer_equihnns` at the bench
recipe (hidden 256, 3 MHNNS conv layers, output hidden 128 over 3 layers,
mean aggregation, LayerNorm, f32; the FAFormer: 2 layers, 2 heads, k = 16),
with random weights from a seed:
4. serve: saved as a port checkpoint, served through
   `equihgnn_tpu_torch.predict.run` on `datasets/real_sample/sample.sdf`
   and checked against the CPU molecule by molecule; then one request of
   768 synthetic molecules through the same library path. The kernels'
   launch counters must show that both requests ran through the model's
   kernels (egnn: A 3x and B per forward; faformer: A 3x and D 5x);
5. gradients: one train step's parameter gradients at full width on 32
   molecules (eval mode: no dropout), on the card (kernels) against the
   CPU (plain versions); every parameter the CPU reaches must be reached
   on the card;
6. train: `equihgnn_tpu_torch.main.run` on `synthetic_hg_3d` at the
   recipe, batch 768, 3 epochs of ~10 steps, a learnable target, into a
   temporary log directory. Every train loss finite and the last below the
   first; the launch counters show the model's kernels on every train step
   (egnn: A 3x, B, C; faformer: A 3x, D 5x, E 4x) and every eval forward;
   `ckpt_best.pt` serves through `predict.run --device cuda`;
7. step: one train step at batch 768 (forward + backward + Adam): its
   launches, median device time, peak memory and a `torch.profiler` table
   of its top device kernels.

FAFormer's frames are the eigenvectors of 3x3 covariances. Where a
covariance is rank-deficient or has repeated eigenvalues (small, planar or
symmetric molecules), the closed-form eigensolver's fallback branches are
decided by the last bits of arccos/cos, which differ between the CPU, the
card and JAX: the frame, and so the prediction, is not determined at f32
(the JAX package is discontinuous there too; ROADMAP §3). So the card is
held to the CPU on the molecules whose CPU prediction moves by at most
1e-5 under six translations of the input by 1e-4 to 1e-3 Å (the models are
translation invariant), at least 8 of the sample's 20; the others are
printed with that spread. The gradient phase takes the 32 molecules of 64
that move least.

The second-to-last line is `{"kernels": [...]}`, the last
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import csv
import dataclasses
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
METHODS = ("egnn_equihnns", "faformer_equihnns")
# kernel launches per forward and per backward of each model's train step
FWD_LAUNCHES = {
    "egnn_equihnns": {"sorted_segment_sum": 3, "fused_edge_messages": 1},
    # 3 EdgeModules + 2 FAFFNs
    "faformer_equihnns": {"sorted_segment_sum": 3, "fused_frame_swiglu": 5},
}
BWD_LAUNCHES = {
    "egnn_equihnns": {"fused_edge_messages_bwd": 1},
    # the last layer's EdgeModule feeds nothing that reaches the loss
    "faformer_equihnns": {"fused_frame_swiglu_bwd": 4},
}


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
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
        fused_frame_swiglu,
        fused_frame_swiglu_bwd,
    )
    from equihgnn_tpu_torch.ops.kernels.segment_sum import sorted_segment_sum

    return {"sorted_segment_sum": sorted_segment_sum,
            "fused_edge_messages": fused_edge_messages,
            "fused_edge_messages_bwd": fused_edge_messages_bwd,
            "fused_frame_swiglu": fused_frame_swiglu,
            "fused_frame_swiglu_bwd": fused_frame_swiglu_bwd}


def expected_launches(method: str, forwards: int, backwards: int) -> dict[str, int]:
    want = dict.fromkeys(counters(), 0)
    for name, n in FWD_LAUNCHES[method].items():
        want[name] += n * forwards
    for name, n in BWD_LAUNCHES[method].items():
        want[name] += n * backwards
    return want


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
    rows += frame_swiglu_rows(pd, sm, gen)
    for row in rows:
        print(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
              f"(median of 20, the two alternating, CUDA events; D and E at the "
              f"EdgeModule site)")
    return rows


def mask_probe(p: int, gen, dev) -> float:
    """Kernel D with dropout on inputs that make every mask bit visible:
    SwiGLU values in [1.5, 4.5] (never near 0) and distinct in each frame,
    so one kept value the kernel dropped (or the reverse), or a swap
    between frames, moves its output by > 1e-2. Agreement within 1e-5
    means the kernel's mask is the plain version's, bit for bit."""
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import frame_swiglu_plain, fused_frame_swiglu

    hh = HIDDEN // 2
    x = (0.5 + torch.rand(p, 4, generator=gen)).to(dev)
    w1 = torch.cat([0.2 * torch.rand(4, hh, generator=gen) + 0.1,
                    0.02 * torch.randn(4, hh, generator=gen)], 1).to(dev)
    b1 = torch.cat([torch.linspace(2.5, 3.5, hh), torch.ones(hh)]).to(dev)
    ls, lb = torch.ones(hh, device=dev), torch.zeros(hh, device=dev)
    got = fused_frame_swiglu(x, w1, b1, ls, lb, drop_rate=0.1, seed=13)
    ref = frame_swiglu_plain(x, w1, b1, ls, lb, drop_rate=0.1, seed=13)
    torch.cuda.synchronize()
    d = float((got - ref).abs().max())
    other = float((frame_swiglu_plain(x, w1, b1, ls, lb, drop_rate=0.1, seed=14) - got).abs().max())
    print(f"kernel D dropout mask probe [P={p}, C=4]: max|d| {d:.3e} against the plain "
          f"version's mask (limit 1e-5; another seed's mask: {other:.3e})")
    check(d <= 1e-5 and other > 1e-2, "kernel D's dropout mask differs from the plain version's")
    return d


def frame_swiglu_rows(pd, sm, gen) -> list[dict]:
    """Kernels D and E at FAFormer's two sites of the batch: the EdgeModule's
    coordinate MLP on [vbar ‖ |r|²] of each atom's k = 16 neighbourhood
    (P = G·A·k, C = 4) and the FAFFN's on the molecule frames (P = G·A,
    C = 3), with the batch's real projections; weights at the width 256."""
    from equihgnn_tpu_torch.nn.faformer import create_frame_basis
    from equihgnn_tpu_torch.ops.gather import nbr_gather
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
        frame_swiglu_bwd_plain,
        frame_swiglu_plain,
        fused_frame_swiglu,
        fused_frame_swiglu_bwd,
    )
    from equihgnn_tpu_torch.ops.knn import knn_dense

    dev = pd.device
    idx, nmask, _ = knn_dense(pd, sm, 16, valid_radius=5.0, exclude_self=True)
    radial = pd[:, :, None, :] - nbr_gather(pd, idx, nmask)
    vbar, _ = create_frame_basis(radial, nmask)
    sites = {
        "EdgeModule": torch.cat([vbar, torch.sum(radial * radial, -1, keepdim=True)],
                                -1).reshape(-1, 4).contiguous(),
        "FAFFN": create_frame_basis(pd, sm)[0].reshape(-1, 3).contiguous(),
    }
    err_d = err_e = 0.0
    times = {}
    for site, x in sites.items():
        p, c = x.shape
        params = [((torch.rand(c, HIDDEN, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
                  ((torch.rand(HIDDEN, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
                  (1.0 + 0.2 * torch.randn(HIDDEN // 2, generator=gen)).to(dev),
                  (0.1 * torch.randn(HIDDEN // 2, generator=gen)).to(dev)]
        dout = torch.randn(p, HIDDEN // 2, generator=gen).to(dev)
        for rate in (0.0, 0.1):
            # dropout: at the FAFFN's P (the plain mask is [P, 8, H/2] int64)
            xs = x if rate == 0.0 else x[:sites["FAFFN"].shape[0]]
            ds = dout[:xs.shape[0]]
            got = fused_frame_swiglu(xs, *params, drop_rate=rate, seed=7)
            ref = frame_swiglu_plain(xs, *params, drop_rate=rate, seed=7)
            torch.cuda.synchronize()
            diff = (got - ref).abs()
            d = float(diff.max())
            ok = bool((diff <= 1e-5 + 1e-4 * ref.abs()).all())
            err_d = max(err_d, d)
            tag = f"kernel D fused_frame_swiglu {site} [P={xs.shape[0]}, C={c}, H={HIDDEN}] drop {rate}"
            print(f"{tag}: max|d| {d:.3e} (atol 1e-5, rtol 1e-4): {'ok' if ok else 'FAIL'}")
            check(ok, f"{tag} disagrees with its plain version")
            if rate > 0.0:  # a mask that differs moves its row far beyond the tolerance
                other = frame_swiglu_plain(xs, *params, drop_rate=rate, seed=8)
                check(float((other - got).abs().max()) > 1e-2, "another seed gave the same output")
            got = fused_frame_swiglu_bwd(xs, *params, ds, rate, 7)
            ref = frame_swiglu_bwd_plain(xs, *params, ds, rate, 7)
            torch.cuda.synchronize()
            for gname, a, b in zip(("dx", "dw1", "db1", "dls", "dlb"), got, ref):
                d, scale = float((a - b).abs().max()), float(b.abs().max())
                err_e = max(err_e, d)
                ok = d <= 1e-4 * scale + 1e-6
                print(f"kernel E fused_frame_swiglu_bwd {site} drop {rate} {gname} {tuple(a.shape)}: "
                      f"max|d| {d:.3e}, max|ref| {scale:.3e} (limit 1e-4 * max|ref|): "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"kernel E's {gname} at {site}, drop {rate}, disagrees")
        # the [P, 8, H] frames never reach device memory: a call allocates
        # its output (D) or its gradients and workspace (E), nothing more
        frames_mb = p * 8 * HIDDEN * 4 / 2**20
        for kname, call in (("D", lambda: fused_frame_swiglu(x, *params)),
                            ("E", lambda: fused_frame_swiglu_bwd(x, *params, dout))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            extra_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(f"kernel {kname} at {site}: {extra_mb:.1f} MiB allocated at peak "
                  f"(the [P, 8, {HIDDEN}] frames would be {frames_mb:.1f} MiB)")
            check(extra_mb < frames_mb / 4, f"kernel {kname} allocated frame-sized memory")
        times[site] = (median_ms(lambda: fused_frame_swiglu(x, *params),
                                 lambda: frame_swiglu_plain(x, *params)),
                       median_ms(lambda: fused_frame_swiglu_bwd(x, *params, dout),
                                 lambda: frame_swiglu_bwd_plain(x, *params, dout)))
        (dk, dp), (ek, ep) = times[site]
        print(f"kernels D/E at {site} [P={p}, C={c}]: D {dk:.4f} ms vs plain {dp:.4f} ms; "
              f"E {ek:.4f} ms vs plain backward {ep:.4f} ms (median of 20, CUDA events)")
    err_d = max(err_d, mask_probe(sites["FAFFN"].shape[0], gen, dev))
    (dk, dp), (ek, ep) = times["EdgeModule"]
    src = "equihgnn_tpu_torch/csrc/frame_swiglu.cu"
    return [
        dict(name="fused_frame_swiglu", route="cuda", source=src,
             replaces="equihgnn_tpu/ops/pallas/frame_swiglu.py:254",
             max_abs_err=err_d, ms=dk, plain_ms=dp),
        dict(name="fused_frame_swiglu_bwd", route="cuda", source=src,
             replaces="equihgnn_tpu/ops/pallas/frame_swiglu.py:274",
             max_abs_err=err_e, ms=ek, plain_ms=ep),
    ]


def recipe():
    from equihgnn_tpu_torch.models.config import ModelConfig

    return ModelConfig(mlp_hidden=HIDDEN, output_hidden=128, all_num_layers=3,
                       output_num_layers=3, aggregate="mean", normalization="ln")


def translation_spread(model, samples, batch_size: int) -> np.ndarray:
    """Per molecule, the most the CPU's prediction moves when the input is
    translated by 1e-4 to 1e-3 Å (six directions): the models are
    translation invariant, so this is rounding, amplified where a FAFormer
    frame is ill-posed."""
    from equihgnn_tpu_torch.predict import predict_samples

    cpu = torch.device("cpu")
    base = predict_samples(model, samples, batch_size, cpu)
    spread = np.zeros_like(base)
    for t in ((1e-4, 0.7e-4, -0.3e-4), (-2e-4, 1e-4, 0.5e-4), (0.3e-4, -1e-4, 2e-4),
              (1e-3, 0.0, 0.0), (0.0, -1e-3, 0.0), (0.0, 0.0, 1e-3)):
        moved = [dataclasses.replace(s, pos=(s.pos + np.float32(t)).astype(np.float32))
                 for s in samples]
        spread = np.maximum(spread, np.abs(predict_samples(model, moved, batch_size, cpu) - base))
    return spread


def phase_serve(method: str, samples, smi: str) -> dict[str, int]:
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.predict import (
        build_parser,
        featurize_sdf,
        predict_samples,
        run,
        save_checkpoint,
    )

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
        print(f"{method} launches while serving (2 requests, 1 batch each): {launches}")
        check(launches == expected_launches(method, 2, 0),
              f"the served requests did not run through {method}'s kernels as expected")

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
        model_cpu = model.to("cpu").eval()
        spread = translation_spread(model_cpu, [m for _, m in featurize_sdf(SDF)], 256)
        d = np.abs(vals - cpu_vals)
        well = spread <= 1e-5
        bad = well & (d > 1e-5 + 1e-4 * np.abs(cpu_vals))
        print(f"cuda vs cpu predictions on the {int(well.sum())} of 20 molecules whose CPU "
              f"prediction moves <= 1e-5 under a translation: max|d| {d[well].max():.3e} "
              f"(rtol 1e-4, atol 1e-5): {'ok' if not bad.any() else 'FAIL'}")
        for i in np.flatnonzero(~well):
            print(f"  ill-posed frames, not compared: {rows[i]['title']}: |d| {d[i]:.3e}, "
                  f"CPU translation spread {spread[i]:.3e}")
        check(bool(well.sum() >= 8), "fewer than 8 molecules with well-posed frames")
        check(not bad.any(), f"card and CPU predictions disagree: molecules "
                             f"{[rows[i]['title'] for i in np.flatnonzero(bad)]}")
        model.to(dev)

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
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms, = median_ms(lambda: model_gpu(batch_dev), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"{method} served: {BATCH / t_req:.1f} molecules/s end to end (batch {BATCH}, "
          f"median request {t_req * 1e3:.2f} ms incl. host batching); forward alone "
          f"{fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.1f} molecules/s; peak memory "
          f"{peak / 2**20:.1f} MiB; card: {smi}")
    return launches


# Per-tensor limit on max|card − CPU| / max|CPU| of a train step's gradients.
# The step's gradient is discontinuous wherever a ReLU input of the trunk
# sits at its kink. With FAFormer's O(1) encoder outputs (egnn's are
# O(0.1)) some lie within ~1e-6 of it: on the CPU alone, one draw of a 1e-6
# relative perturbation of the trunk's input moved trunk.conv.W2's gradient
# by 4.0e-3 of its max, another by 1e-6 (the phase prints the largest of
# four draws). The encoder's own gradients, under a smooth loss, are held
# to 1e-4 for both models.
STEP_LIMIT = {"egnn_equihnns": 1e-4, "faformer_equihnns": 1e-2}


def phase_grads(method: str, pool) -> None:
    """Gradients on the card (kernels) against the CPU (plain versions), full
    width, on the 32 molecules of `pool` whose CPU predictions are the least
    sensitive to rounding, in eval mode (dropout off, gradients on): of one
    train step (masked MSE), and of the encoder alone under a smooth loss."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import masked_mse

    def make(device):
        return create_model(method, num_target=1, cfg=recipe(), device=device,
                            generator=torch.Generator().manual_seed(3)).eval()

    spread = translation_spread(make("cpu"), pool, len(pool))
    pick = np.sort(np.argsort(spread, kind="stable")[:32])
    check(float(spread[pick].max()) <= 1e-5, "fewer than 32 well-conditioned molecules")
    samples = [pool[i] for i in pick]
    batch = next(iter_batches(samples, spec_for_samples(samples, len(samples)),
                              with_pos=True, target=0))
    gen = torch.Generator().manual_seed(4)
    proj = torch.randn(batch.num_atoms, HIDDEN, generator=gen)  # the smooth loss

    def step_loss(model, b, jitter=None):
        x = model.encode(b)
        if jitter is not None:
            x = x * (1.0 + jitter.to(x.device))
        sq, cnt = masked_mse(model.trunk(x, b), b.y, b.graph_mask)
        return sq / torch.clamp(cnt, min=1.0)

    def encoder_loss(model, b):
        return torch.sum(model.encode(b)[b.atom_mask] * proj.to(b.pos.device)[b.atom_mask])

    def grads(device, loss_fn, **kw):
        model = make(device)
        loss_fn(model, batch.to(device), **kw).backward()
        return {n: (p.grad.cpu() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    def compare(want, got, limit, what):
        worst, reached = 0.0, 0
        for name, w in want.items():
            if w is None or float(w.abs().max()) == 0.0:
                continue
            reached += 1
            x = got[name]
            check(x is not None and float(x.abs().max()) > 0.0,
                  f"{name} has a gradient on the CPU and none on the card ({what})")
            rel = float((x - w).abs().max()) / float(w.abs().max())
            worst = max(worst, rel)
            check(rel <= limit, f"{name}: card and CPU gradients differ ({what}), "
                                f"rel {rel:.3e} > {limit:g}")
        return worst, reached

    def rel_spread(a, b):
        return max(float((a[n] - b[n]).abs().max()) / float(b[n].abs().max())
                   for n in b if b[n] is not None and float(b[n].abs().max()) > 0)

    want = grads("cpu", step_loss)
    cpu_spread = max(
        rel_spread(grads("cpu", step_loss,
                         jitter=1e-6 * torch.randn(batch.num_atoms, HIDDEN, generator=gen)), want)
        for _ in range(4))
    reset_launches()
    got = grads("cuda", step_loss)
    launches = read_launches()
    check(launches == expected_launches(method, 1, 1),
          f"the card's train step did not run through {method}'s kernels: {launches}")
    worst, reached = compare(want, got, STEP_LIMIT[method], "train step")
    first = {"egnn_equihnns": "egnn_layer.edge_mlp_0.weight_i",
             "faformer_equihnns": "fa_former.edge_module.coord_mlp.fc1.weight"}[method]
    for name in (first, "atom_encoder.atom.embedding", "trunk.conv.W1.lin_0.weight"):
        check(want[name] is not None and float(want[name].abs().max()) > 0, f"{name} unreached")
    print(f"{method} gradients, card vs cpu, one train step at full width on {len(samples)} "
          f"molecules (CPU translation spread <= {spread[pick].max():.1e}): {reached} "
          f"parameters reached on both (of {len(want)}), worst max|d| / max|cpu| {worst:.3e} "
          f"(limit {STEP_LIMIT[method]:g} per tensor; the CPU's own change under a 1e-6 "
          f"relative jitter of the trunk's input, largest of 4 draws: {cpu_spread:.3e}); "
          f"launches {launches}")
    worst, reached = compare(grads("cpu", encoder_loss), grads("cuda", encoder_loss), 1e-4,
                             "encoder, smooth loss")
    print(f"{method} encoder gradients under a smooth loss (sum of its output times a "
          f"fixed random matrix), card vs cpu: {reached} parameters reached on both, worst "
          f"max|d| / max|cpu| {worst:.3e} (limit 1e-4 per tensor)")


def phase_train(method: str, smi: str) -> dict[str, int]:
    """Train through `equihgnn_tpu_torch.main.run` at the recipe, batch 768."""
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.main import build_parser, load_splits, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import run as predict_run

    cfg = recipe()
    argv = ["--data", "synthetic_hg_3d", "--method", method, "--device", "cuda",
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
            print(f"{method} train: {len(hist)} epochs, {steps} steps, {evals} eval forwards; "
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
            check(launches == expected_launches(method, steps + evals, steps),
                  f"training did not run {method}'s kernels on every train step and "
                  f"every eval forward")
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


def phase_step(method: str, samples, smi: str) -> None:
    """One train step at batch 768: launches, device time, memory, profile."""
    from torch.profiler import ProfilerActivity, profile

    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    batch = next(iter_batches(samples, spec_for_samples(samples, BATCH), with_pos=True,
                              target=0)).to(dev)
    model = create_model(method, num_target=1, cfg=recipe(), device=dev)
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
    print(f"{method} launches of one train step: {step_launches}; of one eval forward: "
          f"{eval_launches}")
    check(step_launches == expected_launches(method, 1, 1), "train step launches")
    check(eval_launches == expected_launches(method, 1, 0), "eval forward launches")

    torch.cuda.reset_peak_memory_stats()
    step_ms, = median_ms(lambda: trainer.train_step(batch), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"{method} train step at batch {BATCH} (forward + backward + Adam): median "
          f"{step_ms:.3f} ms device time (CUDA events, 10 steps) = "
          f"{BATCH / step_ms * 1e3:.1f} molecules/s; peak memory {peak / 2**20:.1f} MiB; "
          f"card: {smi}")

    # one step: over three FAFormer steps one run recorded about a third of
    # the kernel time (48.5 ms a step, where another run recorded 137.5)
    steps = 1
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


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase {label}: {time.perf_counter() - t0:.1f} s]")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    name, smi = phase_device()
    timed("build", phase_build)

    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset

    samples = make_synthetic_dataset(BATCH, seed=0, num_targets=1)
    batch = next(iter_batches(samples, spec_for_samples(samples, BATCH), with_pos=True))
    kernels = timed("kernels", phase_kernels, batch)
    paths = {}
    for method in METHODS:
        served = timed(f"{method} serve", phase_serve, method, samples, smi)
        timed(f"{method} gradients", phase_grads, method, samples[:64])
        trained = timed(f"{method} train", phase_train, method, smi)
        timed(f"{method} step", phase_step, method, samples, smi)
        paths[f"{method} serve"], paths[f"{method} train"] = served, trained
    for row in kernels:
        row["launches"] = sum(counts[row["name"]] for counts in paths.values())
    print(f"launches by path: {paths}")
    for row in kernels:
        check(row["launches"] > 0, f"kernel {row['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
