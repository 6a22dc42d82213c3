"""Where kernels A, C, E, G, I, J, K and L spend their time, on the card:
each is rebuilt with one part of its work switched off (A: with other tile
shapes) and timed beside the whole kernel, the PyTorch call that computes
its function (where there is one) and itself again, at the batch-768 shapes
of `chip_smoke.py` (its batch, kNN mask and timer).

    python3 ablate_kernels.py [--kernels A,C,E,GI,J,K,L] [--vis-mix-before FILE]
        [--edge-mlp-before FILE] [--frame-swiglu-before FILE]

C (`csrc/edge_mlp.cu`, the EGNN edge MLP's backward at `chip_smoke`'s
  `edge_mlp_inputs`: G = 769, A = 32, k = 16, F = 1026, m = 16), in case
  (a), dm at O(1) on every edge, and case (b), dm 0 on the edges the model
  masks: full (z saved by kernel B); z computed again (kernel B's forward
  writing z, then C: what a step would pay without the saved z); without
  the skip of zero-gradient edges;
  with one butterfly an edge for ddist (not one per 8 edges); a quarter
  of the W1 products (dz·W1ᵀ and dW1: 4 of 16 columns); blocks of 4 rows,
  not 2; registers for 4 or 6 blocks an SM, not 5; a warp's live edges
  walked 4 or 16 at a time, not 8; and, with --edge-mlp-before, the kernel of another `edge_mlp.cu`
  that takes no z (e.g. an earlier commit's, from `git show
  <commit>:equihgnn_tpu_torch/csrc/edge_mlp.cu`). Kernel B is timed with
  and without z written.
E (`csrc/frame_swiglu.cu`, FAFormer's frame-SwiGLU backward at its
  EdgeModule site, P = 393,728, C = 4, and its FAFFN site, P = 24,608,
  C = 3, H = 256), in case (a), dout at O(1) everywhere, and case (b), dout
  0 at the positions the model gives none: full; without the skip; the
  frame statistics in three dependent chains (mean, variance, mean(dz·z)),
  not one butterfly; the parameter sums in registers, one block an SM (the
  layout of the kernel before it); 3 blocks an SM, not 2; and, with
  --frame-swiglu-before, the kernel of another `frame_swiglu.cu`.
C and E: one call a sample, and device time alone (torch.profiler).

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
    HIDDEN,
    bench_batch,
    edge_mlp_inputs,
    frame_swiglu_sites,
    kernel_split,
    median_ms,
    pooled_mask,
    profiled_device_ms,
    vis_mix_inputs,
)
from equihgnn_tpu_torch.ops.kernels import build

A_SRC, J_SRC, K_SRC, L_SRC, GI_SRC, C_SRC, E_SRC = (build.CSRC_DIR / n for n in (
    "segment_sum.cu", "pooled_conv_fwd.cu", "pooled_conv.cu", "pooled_m.cu", "vis_mix.cu",
    "edge_mlp.cu", "frame_swiglu.cu"))
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
C_PATCHES = {
    "no skip": [
        ("pf_z[r] = i < n_el && pf_dm[r] != 0.f ? z[row * n_el + i] : 0.f;",
         "pf_z[r] = i < n_el ? z[row * n_el + i] : 0.f;"),
        ("sb.dz[i] = v == 0.f ? 0.f : v * dsilu(zz);", "sb.dz[i] = v * dsilu(zz);"),
        ("sb.live[e0] = (nz & 0xFFFFu) != 0;", "sb.live[e0] = nz == nz;"),
        ("sb.live[e0 + 1] = (nz >> 16) != 0;", "sb.live[e0 + 1] = nz == nz;")],
    "a butterfly an edge": [
        ("          dd[u] = dpre * wdf;",
         "          float r = dpre * wdf;\n"
         "          for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(FULL, r, off);\n"
         "          if (lane == 0) sb.dd[warp * (k_nbrs + 1) + kk] = r;"),
        ("        const float r = warp_reduce_scatter<GROUP>(dd, lane);\n"
         "        if (lane % SPAN == 0) sb.dd[warp * (k_nbrs + 1) + list[i0 + lane / SPAN]] = r;",
         "")],
    "a quarter of the W1 products": [
        ("for (int q = 0; q < M_OUT / 4; ++q) {\n            const float4 v = dz4[q];",
         "for (int q = 0; q < 1; ++q) {\n            const float4 v = dz4[q];")],
    "4 rows a block": [("constexpr int BW_ROWS = 2;", "constexpr int BW_ROWS = 4;")],
    "4 blocks an SM": [("constexpr int BW_MIN_BLOCKS = 5;", "constexpr int BW_MIN_BLOCKS = 4;")],
    "6 blocks an SM": [("constexpr int BW_MIN_BLOCKS = 5;", "constexpr int BW_MIN_BLOCKS = 6;")],
    "groups of 4 edges": [("constexpr int GROUP = 8;", "constexpr int GROUP = 4;")],
    "groups of 16 edges": [("constexpr int GROUP = 8;", "constexpr int GROUP = 16;")],
}
# kernel E's frame statistics from its pivot-shifted sums in one butterfly
# (the shipped code), and the same three in dependent chains
_E_STATS = """      const float piv = __shfl_sync(FULL, y[0], 0);
      float st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        y[q] -= piv;
        st[0] += y[q];
        st[1] = fmaf(y[q], y[q], st[1]);
        st[2] = fmaf(dzn[q], y[q], st[2]);
      }
      const float r = warp_reduce_scatter<4>(st, lane);
      const float dmu = __shfl_sync(FULL, r, 0) / HH;
      const float var = fmaxf(__shfl_sync(FULL, r, 8) / HH - dmu * dmu, 0.f);
      const float inv = rsqrtf(var + LN_EPS);
      const float m2 = inv * (__shfl_sync(FULL, r, 16) / HH - dmu * m1);"""
_E_CHAINS = """      float s1 = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) s1 += y[q];
      const float dmu = warp_sum(s1) / HH;
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) ss += (y[q] - dmu) * (y[q] - dmu);
      const float inv = rsqrtf(warp_sum(ss) / HH + LN_EPS);
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) t += dzn[q] * (y[q] - dmu) * inv;
      const float m2 = warp_sum(t) / HH;"""
# kernel E's parameter sums in registers, written to the warp's row at the
# end (PR 3's layout), with one block an SM
_E_SUMS = """        acc[c * H + j] += xv[c] * (c < 3 ? G[c < 3 ? c : 0][k] : D[k]);
      acc[C * H + j] += D[k];
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      acc[C * H + H + lane + 32 * q] += d[q] * 0.125f * zsum[q];
      acc[C * H + H + HH + lane + 32 * q] += d[q];
    }
  }
  __syncthreads();"""
_E_REG_SUMS = """        rdw[c][k] += xv[c] * (c < 3 ? G[c < 3 ? c : 0][k] : D[k]);
      rdb[k] += D[k];
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      rdg[q] += d[q] * 0.125f * zsum[q];
      rdbe[q] += d[q];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = col<CPL>(k, lane);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c * H + j] = rdw[c][k];
    acc[C * H + j] = rdb[k];
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    acc[C * H + H + lane + 32 * q] = rdg[q];
    acc[C * H + H + HH + lane + 32 * q] = rdbe[q];
  }
  __syncthreads();"""
_E_G = "  for (int q = 0; q < CPL; ++q) g[q] = ls[lane + 32 * q];\n\n  const int64_t nwarps"
E_PATCHES = {
    "no skip": [("    if (!__any_sync(FULL, nz)) {", "    if (false) {")],
    "chains unbatched": [(_E_STATS, _E_CHAINS)],
    "sums in registers, one block an SM": [
        ("for (int c = 0; c < C; ++c) acc[c * H + j] += xv[c]",
         "for (int c = 0; c < C; ++c)\n        acc[c * H + j] += xv[c]"),
        (_E_SUMS, _E_REG_SUMS),
        (_E_G, "  for (int q = 0; q < CPL; ++q) g[q] = ls[lane + 32 * q];\n"
               "  float rdw[C][K] = {}, rdb[K] = {}, rdg[CPL] = {}, rdbe[CPL] = {};\n\n"
               "  const int64_t nwarps"),
        ("constexpr int BWD_MIN_BLOCKS = 2;", "constexpr int BWD_MIN_BLOCKS = 1;")],
    "3 blocks an SM": [("constexpr int BWD_MIN_BLOCKS = 2;", "constexpr int BWD_MIN_BLOCKS = 3;")],
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


def _time_c(libs, batch) -> None:
    """B with and without z, then C of each variant in cases (a) and (b):
    one call a sample (the variants in turns), then device time alone."""
    gen = torch.Generator().manual_seed(1)
    args, pair_mask, _, _ = edge_mlp_inputs(batch, gen)
    g, a, f = args[0].shape
    k, dev = args[3].shape[-1], args[0].device
    dm = torch.randn(g, a, k, 16, generator=gen).to(dev)
    cases = {"a": dm, "b": dm * pair_mask[..., None]}
    inp = [t.data_ptr() for t in args]
    out, z = torch.empty(g, a, k, 16, device=dev), torch.empty(g, a, k, 16, device=dev)
    outs = [torch.empty(g, a, f, device=dev), torch.empty(g, a, f, device=dev),
            torch.empty(g, a, k, device=dev), torch.empty(f * 18 + 16, device=dev)]
    optr = [t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream().cuda_stream
    fwd = libs["C full"].edge_mlp_fwd_f32
    fwd.argtypes = build.SIGNATURES["edge_mlp_fwd_f32"]
    b_fns = [lambda zp=zp: fwd(*inp, out.data_ptr(), zp, g, a, k, f, 16, stream)
             for zp in (None, z.data_ptr())]
    b_fns[1]()  # z for the variants
    times = median_ms(*b_fns)
    print(f"B (one call a sample): serving, out only {times[0]:.4f} ms; with z written "
          f"{times[1]:.4f} ms")
    P, I = ctypes.c_void_p, ctypes.c_int
    names = [n for n in libs if n.startswith("C")]
    fns = {case: [] for case in cases}
    for name in names:
        lib, floats = libs[name], ctypes.c_int64()
        lib.edge_mlp_bwd_workspace_f32.argtypes = build.SIGNATURES["edge_mlp_bwd_workspace_f32"]
        lib.edge_mlp_bwd_workspace_f32(g, a, k, f, 16, ctypes.byref(floats))
        ws = torch.empty(floats.value, device=dev)
        fn = lib.edge_mlp_bwd_f32
        # an edge_mlp.cu whose kernel C computes z again itself takes no z
        zs = () if name == "C before" else (z.data_ptr(),)
        fn.argtypes = (P,) * (14 + len(zs)) + (I,) * 5 + (P,)
        for case, d in cases.items():
            fns[case].append(lambda fn=fn, d=d, zs=zs, ws=ws: fn(
                *inp, d.data_ptr(), *zs, *optr, ws.data_ptr(), g, a, k, f, 16, stream))
    names.insert(1, "C z computed again")
    for case, d in cases.items():
        full = fns[case][0]
        fns[case].insert(1, lambda full=full: (b_fns[1](), full()))
    for case, cfns in fns.items():
        times = median_ms(*cfns, cfns[0])
        dev_ms = [profiled_device_ms(fn) for fn in cfns]
        print(f"C case ({case}) (one call a sample; device alone): " + ", ".join(
            f"{n[2:]} {t:.4f} / {dv:.4f} ms" for n, t, dv in zip(names, times, dev_ms))
            + f", full again {times[-1]:.4f} ms")


def _time_e(libs, batch) -> None:
    """E of each variant at both FAFormer sites, in cases (a) and (b), and
    (b) with dropout 0.1 as the model trains: one call a sample, then
    device time alone."""
    dev = torch.device("cuda")
    sm = batch.slot_mask.to(dev)
    pd = batch.pos.to(dev)[batch.slot_index.to(dev)] * sm[..., None]
    sites, kept = frame_swiglu_sites(pd, sm)
    gen = torch.Generator().manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    names = [n for n in libs if n.startswith("E")]
    for site, x in sites.items():
        p, c = x.shape
        h = HIDDEN
        w1 = ((torch.rand(c, h, generator=gen) * 2 - 1) / c ** 0.5).to(dev)
        b1 = ((torch.rand(h, generator=gen) * 2 - 1) / c ** 0.5).to(dev)
        ls = (1.0 + 0.2 * torch.randn(h // 2, generator=gen)).to(dev)
        dout = torch.randn(p, h // 2, generator=gen).to(dev)
        cases = {"a": (dout, 0), "b": (dout * kept[site][:, None], 0),
                 "b, drop 0.1": (dout * kept[site][:, None], 1)}
        dx, dparams = torch.empty(p, c, device=dev), torch.empty(c * h + 2 * h, device=dev)
        thresh = int(round(0.1 * 2.0 ** 32))
        fns = {case: [] for case in cases}
        for name in names:
            lib, floats = libs[name], ctypes.c_int64()
            lib.frame_swiglu_bwd_workspace_f32.argtypes = build.SIGNATURES[
                "frame_swiglu_bwd_workspace_f32"]
            lib.frame_swiglu_bwd_workspace_f32(p, c, h, ctypes.byref(floats))
            ws = torch.empty(floats.value, device=dev)
            fn = lib.frame_swiglu_bwd_f32
            fn.argtypes = build.SIGNATURES["frame_swiglu_bwd_f32"]
            for case, (d, drop) in cases.items():
                fns[case].append(lambda fn=fn, d=d, drop=drop, ws=ws: fn(
                    x.data_ptr(), w1.data_ptr(), b1.data_ptr(), ls.data_ptr(), d.data_ptr(),
                    dx.data_ptr(), dparams.data_ptr(), ws.data_ptr(), p, c, h, drop,
                    thresh if drop else 0, 1.0 / 0.9 if drop else 1.0, 7, stream))
        for case, cfns in fns.items():
            times = median_ms(*cfns, cfns[0])
            dev_ms = [profiled_device_ms(fn) for fn in cfns]
            print(f"E {site} [P={p}, C={c}] case ({case}) (one call a sample; device alone): "
                  + ", ".join(f"{n[2:]} {t:.4f} / {dv:.4f} ms"
                              for n, t, dv in zip(names, times, dev_ms))
                  + f", full again {times[-1]:.4f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", default="A,C,E,GI,J,K,L",
                        help="the kernels to ablate, of A, C, E, GI, J, K and L")
    parser.add_argument("--vis-mix-before", type=Path,
                        help="another vis_mix.cu whose G and I to time beside this one's")
    parser.add_argument("--edge-mlp-before", type=Path,
                        help="another edge_mlp.cu (kernel C without z) to time beside this one's")
    parser.add_argument("--frame-swiglu-before", type=Path,
                        help="another frame_swiglu.cu whose E to time beside this one's")
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
                                 ("K", K_SRC, K_PATCHES), ("L", L_SRC, L_PATCHES),
                                 ("C", C_SRC, C_PATCHES), ("E", E_SRC, E_PATCHES)):
            if kind not in kinds:
                continue
            srcs[f"{kind} full"] = src
            for name, patches in table.items():
                srcs[f"{kind} {name}"] = _patched(src, patches, tmp / f"v{len(srcs)}.cu")
        if "GI" in kinds and args.vis_mix_before:
            srcs["GI before"] = args.vis_mix_before
        if "C" in kinds and args.edge_mlp_before:
            srcs["C before"] = args.edge_mlp_before
        if "E" in kinds and args.frame_swiglu_before:
            srcs["E before"] = args.frame_swiglu_before
        libs = _build_all(tmp, srcs)
        batch = bench_batch()[1]
        if "A" in kinds:
            _time_a(libs, batch, dev)
        if "C" in kinds:
            _time_c(libs, batch)
        if "E" in kinds:
            _time_e(libs, batch)
        if "GI" in kinds:
            _time_gi(libs, batch)
        _time_jkl(libs, batch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
