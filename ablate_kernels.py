"""Where kernels A, G, I, J, K and L spend their time, on the card: each is
rebuilt with one part of its work switched off (A: with other tile shapes)
and timed beside the whole kernel,
the PyTorch call that computes its function (where there is one) and itself
again, at the batch-768 shapes of `chip_smoke.py` (its batch, kNN mask and
timer).

    python3 ablate_kernels.py [--kernels A,GI,J,K,L] [--vis-mix-before FILE]

G and I (`csrc/vis_mix.cu`, ViSNet's vector-mix backward at `chip_smoke`'s
  `vis_mix_inputs`: G = 769, A = 32, k = 17, L = 8, h = 256): full; without
  the cluster's dd sum (each rank writes its own chunk's terms); without
  the per-source walk, the target pass, or both (what is left: the copies,
  the lists, the zeros the walk writes and the dd sum), and without the
  lists too; the lists' ballots 1 or 8 at a time, not 4; without the
  per-edge butterflies (a lane's own term stands for the sum); G loading 4
  edges' rows ahead, not 8, and I 4 or 1, not 2; blocks of 8 or 12 warps,
  not 16; without staging (G's and I's gathers read device memory, as at
  A > 70 / 97); I without restaging u for the walk; I keeping no gw (the
  walk reads it again); and, with --vis-mix-before, the kernels of
  another `vis_mix.cu` (e.g. an earlier commit's, from `git show
  <commit>:equihgnn_tpu_torch/csrc/vis_mix.cu`), timed in the same turns.
  One call a sample, and device time alone (torch.profiler).

A (`csrc/segment_sum.cu`, the batch's hyperedge ids, D = 256): 32-row
  tiles (the kernel), 16 and 64 rows, 8 and 32 rows in flight a thread;
  `index_add_`; 10 calls a sample and device time alone (torch.profiler).
J (`csrc/pooled_conv_fwd.cu`, with the model's live sites, C = 1 and 3):
  full; consumers only (the producers neither copy nor build: the products
  and the barriers); producers only (the consumers skip the products: the
  copies, the M-builds and the barriers); `torch.einsum`.
K (`csrc/pooled_conv.cu`, with the model's live sites, C = 1 and 3): full;
  dM products only (the dM kernel skips the dh and dtc reductions); dM
  without products (its copies, stores and reductions); dW consumers only
  (its producers neither copy after the first chunk nor rebuild M); dW
  producers only (its consumers skip the products); the dM kernel with a
  W ring of 3 stages or stages of 32 o, its tile then as many sites as the
  shared memory left takes. Each variant's two
  kernels are also timed apart (torch.profiler, device time).
L (`csrc/pooled_m.cu`, bf16, X = 64 and 192): full; without the zero-site
  skip; without the products (the ring and the stores); `torch.bmm`.
A variant is the source with exact lines removed or replaced; a line that is
not in the source once stops the script. A variant's output is wrong by
design and is not checked. Times: `chip_smoke.median_ms`, 10 samples (L: of
10 calls back to back), the variants alternating. Needs nvcc and one card;
writes nothing outside a temporary directory.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from chip_smoke import (
    bench_batch,
    kernel_split,
    median_ms,
    pooled_mask,
    profiled_device_ms,
    vis_mix_inputs,
)
from equihgnn_tpu_torch.ops.kernels import build

A_SRC, J_SRC, K_SRC, L_SRC, GI_SRC = (build.CSRC_DIR / n for n in (
    "segment_sum.cu", "pooled_conv_fwd.cu", "pooled_conv.cu", "pooled_m.cu", "vis_mix.cu"))
_TR, _BATCH = "constexpr int TR = 32;", "constexpr int BATCH = 16;"
A_PATCHES = {  # name -> (patches, rows of a tile)
    "16-row tiles": ([(_TR, "constexpr int TR = 16;")], 16),
    "64-row tiles": ([(_TR, "constexpr int TR = 64;")], 64),
    "8 rows in flight": ([(_BATCH, "constexpr int BATCH = 8;")], 32),
    "32 rows in flight": ([(_BATCH, "constexpr int BATCH = 32;")], 32),
}
J_PATCHES = {  # name -> (text, its replacement)
    "consumers only": [("      build_a(d, n, b, p);", ""),
                       ("        load_wh<VEC>(h, w, d, n + 1, n_fc, o0, b, p);", ""),
                       ("        load_t<VEC>(tc, d, Chunk(n + 1, n_fc).ic, b, p);", "")],
    "producers only": [("    mma_chunk(d, n, b, acc);", "")],
}
_STAGES, _OC = "constexpr int STAGES = 2;", "constexpr int OC = 64;"
K_PATCHES = {
    "dM products only": [("    reduce_chunk(d, ts, ic, fc, b, fc + 1 == n_fc ? dtc : nullptr, dh_sums);",
                          "")],
    "dM no products": [("      mma_stage<MT>(d, q, b.w + (z % STAGES) * OC * WS, b, acc);", "")],
    "dW consumers only": [("      build_a(d, n, b, p);", ""),
                          ("        load_chunk<VEC>(h, tc, dout, d, n + 1, i0, f0, o0, b, p);", "")],
    "dW producers only": [("    mma_chunk(d, n, b, acc);", "")],
    # the dM kernel's W ring: depth (stages) and o of a stage; its tile then
    # takes as many sites as the shared memory left allows
    "dM 3 stages": [(_STAGES, "constexpr int STAGES = 3;")],
    "dM stages of 32 o": [(_OC, "constexpr int OC = 32;")],
}
GI_PATCHES = {
    "no cluster dd sum": [
        ("      for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(part, q)[src];",
         "      s = part[src];"),
        ("  cluster.sync();  // every rank's partial sums are complete", ""),
        ("  cluster.sync();  // no rank leaves while another reads its shared memory", "")],
    "no per-source walk": [("      const int hi = off_s[j + 1];", "      const int hi = off_s[j];")],
    "no target pass": [("    for (int i = warp; i < a_slots; i += WARPS) {\n      float gi[L];",
                        "    for (int i = a_slots; i < a_slots; i += WARPS) {\n      float gi[L];"),
                       ("    for (int i = warp; i < a_slots; i += WARPS) {\n      float dui[L];",
                        "    for (int i = a_slots; i < a_slots; i += WARPS) {\n      float dui[L];")],
    "no passes": [("    for (int i = warp; i < a_slots; i += WARPS) {\n      float gi[L];",
                   "    for (int i = a_slots; i < a_slots; i += WARPS) {\n      float gi[L];"),
                  ("    for (int i = warp; i < a_slots; i += WARPS) {\n      float dui[L];",
                   "    for (int i = a_slots; i < a_slots; i += WARPS) {\n      float dui[L];"),
                  ("      const int hi = off_s[j + 1];", "      const int hi = off_s[j];")],
    "no passes, no lists": [
        ("    for (int i = warp; i < a_slots; i += WARPS) {\n      float gi[L];",
         "    for (int i = a_slots; i < a_slots; i += WARPS) {\n      float gi[L];"),
        ("    for (int i = warp; i < a_slots; i += WARPS) {\n      float dui[L];",
         "    for (int i = a_slots; i < a_slots; i += WARPS) {\n      float dui[L];"),
        ("      const int hi = off_s[j + 1];", "      const int hi = off_s[j];"),
        ("  for (int j = warp; j < a_slots; j += WARPS) {\n    int n = 0;",
         "  for (int j = a_slots; j < a_slots; j += WARPS) {\n    int n = 0;"),
        ("  for (int j = warp; j < a_slots; j += WARPS) {\n    int at = off_s[j];",
         "  for (int j = a_slots; j < a_slots; j += WARPS) {\n    int at = off_s[j];"),
        ("      int v = j <= a_slots ? off_s[j] : 0;", "      int v = 0;")],
    "lists by 1 ballot a round": [("  constexpr int U = 4;", "  constexpr int U = 1;")],
    "lists by 8 ballots a round": [("  constexpr int U = 4;", "  constexpr int U = 8;")],
    "no butterflies": [("          const float r = warp_sum_many<P>(part, lane);",
                        "          const float r = part[0];")],
    "G 4 edges ahead": [("constexpr int AHEAD_G = 8;", "constexpr int AHEAD_G = 4;")],
    "I 4 edges ahead": [("constexpr int AHEAD_I = 2;", "constexpr int AHEAD_I = 4;")],
    "8 warps": [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
    "12 warps": [("constexpr int WARPS = 16;", "constexpr int WARPS = 12;")],
    "I 1 edge ahead": [("constexpr int AHEAD_I = 2;", "constexpr int AHEAD_I = 1;")],
    "no staging": [("  const bool stage = agg_bwd_smem(a_slots, k_nbrs, L, true) <= MAX_SMEM;",
                    "  const bool stage = false;"),
                   ("  const bool stage = wdot_bwd_smem(a_slots, k_nbrs, L, true) <= MAX_SMEM;",
                    "  const bool stage = false;")],
    "I no u restage": [("      stage_chunk_async(u, g, a_slots, L, h, n * HC, vec4, x_s);\n", "")],
    "I keeps no gw": [("    keep = (TWO_BLOCK_SMEM - base) / per_row < ak ? (TWO_BLOCK_SMEM - base) / per_row : ak;",
                       "    keep = 0;")],
}
L_PATCHES = {
    "no zero-site skip": [("for (int k = 0; nonzero && k < d.k; ++k)", "for (int k = 0; k < d.k; ++k)")],
    "no products": [("for (int k = 0; nonzero && k < d.k; ++k)", "for (int k = 0; false; ++k)")],
}


def _patched(src: Path, patches, out: Path) -> Path:
    """`src` with each (text, replacement) applied: every occurrence, of
    which there must be one, or two for G's and I's common lines."""
    text = src.read_text()
    for old, new in patches:
        if text.count(old) not in ((1, 2) if src == GI_SRC else (1,)):
            raise RuntimeError(f"{src.name}: {old!r} is not in the source once (or twice)")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def _build_all(tmp: Path, srcs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    nvcc = build._nvcc()
    libs = {name: tmp / f"lib{i}.so" for i, name in enumerate(srcs)}
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-shared",
                               "-o", str(libs[n]), str(s)],
                              stderr=subprocess.PIPE, text=True) for n, s in srcs.items()]
    for proc, name in zip(procs, srcs):
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def _time_a(libs, batch, dev) -> None:
    ids = batch.hedge_idx.to(dev)
    m, n_seg = ids.shape[0], batch.num_hedges
    data = torch.randn(m, 256, device=dev)
    zeros = torch.zeros(n_seg, 256, device=dev)
    stream0 = torch.cuda.current_stream().cuda_stream
    an = [n for n in libs if n.startswith("A")]
    afns = []
    for name in an:
        rows = A_PATCHES[name[2:]][1] if name != "A full" else 32
        ws = 2 * -(-m // rows) * 256
        buf = torch.empty(n_seg * 256 + ws, device=dev)
        fn = libs[name].sorted_segment_sum_f32
        fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 4 + (ctypes.c_void_p,)
        afns.append(lambda fn=fn, buf=buf, ws=ws: fn(
            data.data_ptr(), ids.data_ptr(), buf.data_ptr(),
            buf.data_ptr() + 4 * n_seg * 256, ws, m, 256, n_seg, stream0))
    afns += [lambda: zeros.index_add_(0, ids, data), afns[0]]
    times = median_ms(*afns, reps=10)
    dev_ms = [profiled_device_ms(fn) for fn in afns[:-1]]
    print("A (10 calls a sample; device alone): " + ", ".join(
        f"{n} {t:.4f} / {dv:.4f} ms" for n, t, dv in
        zip(an + ["index_add_"], times, dev_ms)) + f", A full again {times[-1]:.4f} ms")


def _time_jkl(libs, batch, dev) -> None:
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import live_sites

    jn = [n for n in libs if n.startswith("J")]
    kn = [n for n in libs if n.startswith("K")]
    ln = [n for n in libs if n.startswith("L")]
    if not (jn or kn or ln):
        return
    mask = pooled_mask(batch)
    g, a, k = mask.shape
    s, f, i, o = g * a, 128, 256, 256
    sites = live_sites(mask.any(-1))
    gen = torch.Generator().manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for c in (1, 3) if jn else ():
        h = torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]
        tc = torch.randn(g, a, k, c * i, generator=gen).to(dev) * mask[..., None]
        w = (torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5
        out = torch.zeros(g, a, c, o, device=dev)
        fns = []
        for name in jn:
            fn = libs[name].pooled_conv_fwd_f32
            fn.argtypes = (P, P, P, P, P, P, I, I, I, I, I, I, P)
            fns.append(lambda fn=fn: fn(h.data_ptr(), tc.data_ptr(), w.data_ptr(),
                                        sites.ids.data_ptr(), sites.count.data_ptr(),
                                        out.data_ptr(), s, k, c, i, f, o, stream))
        fns += [lambda: torch.einsum("gakf,gakci,foi->gaco", h, tc.view(g, a, k, c, i), w),
                fns[0]]
        times = median_ms(*fns, iters=10)
        print(f"J C={c}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                       zip(jn + ["torch.einsum", "J full again"], times)))
    for c in (1, 3) if kn else ():
        h = torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]
        tc = torch.randn(g, a, k, c * i, generator=gen).to(dev) * mask[..., None]
        w = (torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5
        dout = torch.randn(g, a, c, o, generator=gen).to(dev)
        dh, dtc, dw = torch.empty_like(h), torch.empty_like(tc), torch.empty_like(w)
        fns, floats = [], ctypes.c_int64()
        for name in kn:
            lib = libs[name]
            lib.pooled_conv_bwd_workspace_f32.argtypes = (I, I, I, ctypes.POINTER(I64))
            lib.pooled_conv_bwd_workspace_f32(i, f, o, ctypes.byref(floats))
            ws = torch.empty(floats.value, device=dev)  # each variant's own W layout
            fn = lib.pooled_conv_bwd_f32
            fn.argtypes = (P,) * 10 + (I,) * 6 + (P,)
            fns.append(lambda fn=fn, ws=ws: fn(h.data_ptr(), tc.data_ptr(), w.data_ptr(),
                                               dout.data_ptr(), sites.ids.data_ptr(),
                                               sites.count.data_ptr(), dh.data_ptr(),
                                               dtc.data_ptr(), dw.data_ptr(), ws.data_ptr(),
                                               s, k, c, i, f, o, stream))
        times = median_ms(*fns, fns[0], iters=5)
        print(f"K C={c}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                       zip(kn + ["K full again"], times)))
        for name, fn in zip(kn, fns):
            print(f"  K C={c} {name} by kernel: " + ", ".join(
                f"{kname} {t:.4f} ms" for kname, t in kernel_split(fn).items()))
        del h, tc, w, dout, dh, dtc, dw, ws, fns
        torch.cuda.empty_cache()
    for x in (64, 192) if ln else ():
        h = (torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]).bfloat16()
        tc = (torch.randn(g, a, k, x, generator=gen).to(dev) * mask[..., None]).bfloat16()
        m = torch.empty(g, a, x, f, device=dev, dtype=torch.bfloat16)
        fns = []
        for name in ln:
            fn = libs[name].pooled_m_fwd_bf16
            fn.argtypes = (P, P, P, I64, I, I, I, P)
            fns.append(lambda fn=fn: fn(h.data_ptr(), tc.data_ptr(), m.data_ptr(), s, k, f, x,
                                        stream))
        fns += [lambda: torch.bmm(tc.view(s, k, x).transpose(1, 2), h.view(s, k, f)), fns[0]]
        times = median_ms(*fns, iters=10, reps=10)
        print(f"L X={x}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                       zip(ln + ["torch.bmm", "L full again"], times)))


def _time_gi(libs, batch) -> None:
    """G and I of each variant at `vis_mix_inputs`: one call a sample (the
    variants in turns), then device time alone."""
    x = vis_mix_inputs(batch, torch.Generator().manual_seed(0))
    g, a, k = x["idx"].shape
    L, h = x["d"].shape[-1], x["vec"].shape[-1]
    out = dict(dvec=torch.empty_like(x["vec"]), ds1=torch.empty_like(x["s2m"]),
               ds2m=torch.empty_like(x["s2m"]), dd=torch.empty_like(x["d"]),
               du=torch.empty_like(x["u"]), dvv=torch.empty_like(x["vv"]))
    p = {n: t.data_ptr() for n, t in {**x, **out}.items()}
    stream = torch.cuda.current_stream().cuda_stream
    names = [n for n in libs if n.startswith("GI")]
    for letter, entry in (("G", "vis_vec_agg_bwd_f32"), ("I", "vis_wdot_bwd_f32")):
        fns = []
        for name in names:
            fn = getattr(libs[name], entry)
            fn.argtypes = build.SIGNATURES[entry]
            if letter == "G":
                fns.append(lambda fn=fn: fn(p["vec"], p["s1"], x["s1"].stride(2), p["s2m"], p["d"],
                                            p["idx"], p["mask"], p["gva"], p["dvec"], p["ds1"],
                                            p["ds2m"], p["dd"], g, a, k, L, h, stream))
            else:
                fns.append(lambda fn=fn: fn(p["d"], p["u"], p["vv"], p["idx"], p["mask"], p["gw"],
                                            p["du"], p["dvv"], p["dd"], g, a, k, L, h, stream))
        times = median_ms(*fns, fns[0])
        dev_ms = [profiled_device_ms(fn) for fn in fns]
        print(f"{letter} (one call a sample; device alone): " + ", ".join(
            f"{n[3:]} {t:.4f} / {dv:.4f} ms" for n, t, dv in zip(names, times, dev_ms))
            + f", full again {times[-1]:.4f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", default="A,GI,J,K,L",
                        help="the kernels to ablate, of A, GI, J, K and L")
    parser.add_argument("--vis-mix-before", type=Path,
                        help="another vis_mix.cu whose G and I to time beside this one's")
    args = parser.parse_args()
    kinds = args.kernels.split(",")
    if not torch.cuda.is_available():
        print("ablate_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        srcs = {}
        for kind, src, table in (("A", A_SRC, {n: p for n, (p, _) in A_PATCHES.items()}),
                                 ("GI", GI_SRC, GI_PATCHES), ("J", J_SRC, J_PATCHES),
                                 ("K", K_SRC, K_PATCHES), ("L", L_SRC, L_PATCHES)):
            if kind not in kinds:
                continue
            srcs[f"{kind} full"] = src
            for name, patches in table.items():
                srcs[f"{kind} {name}"] = _patched(src, patches, tmp / f"v{len(srcs)}.cu")
        if "GI" in kinds and args.vis_mix_before:
            srcs["GI before"] = args.vis_mix_before
        libs = _build_all(tmp, srcs)
        batch = bench_batch()[1]
        if "A" in kinds:
            _time_a(libs, batch, dev)
        if "GI" in kinds:
            _time_gi(libs, batch)
        _time_jkl(libs, batch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
