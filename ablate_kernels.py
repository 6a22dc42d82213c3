"""Where kernels A-E, G-M spend their time, on the card:
each is rebuilt with one part of its work switched off (A: with other tile
shapes) and timed beside the whole kernel, the PyTorch call that computes
its function (where there is one) and itself again, at the batch-768 shapes
of `chip_smoke.py` (its batch, kNN mask and timer).

    python3 ablate_kernels.py [--kernels A,B,C,D,E,GI,GIb,H,J,K,L,M,Jb,Kb] [--vis-mix-before FILE]
        [--edge-mlp-before FILE] [--frame-swiglu-before FILE] [--pooled-m-before FILE]
        [--pooled-conv-bf16-before FILE] [--step PATH]

B (`csrc/edge_mlp.cu`, the EGNN edge MLP's forward at `edge_mlp_inputs`),
  serving, in case (a), no mask (every edge), and case (b), the model's
  pair_mask: full; without the slot skip (every tile computed, the output
  still masked); ujn read from L2, not staged; stages of 32 columns, not 64;
  2 tiles a warp, not 4 (16 a pass, not 32); 4 warps of up to 8 tiles (2
  blocks an SM, or 3 at 32 columns); the sums carried on the tensor
  cores over a chunk's 8 k-steps, not each group's 2; the A fragments split by
  cvt.rna.tf32 (not by integer operations), or by floating-point operations
  (Veltkamp's split, of both parts or of the big part alone); no products
  (a1 formed and split, no mma); a1 without its SiLU; and, with
  --edge-mlp-before
  (e.g. `git show <commit>:equihgnn_tpu_torch/csrc/edge_mlp.cu` of the
  kernel before it), that kernel, and the CUDA-core alternative made from
  it: its layout (a warp per slot and 4 neighbours, lanes over f, 64
  partial sums a lane) given the mask (its 4-edge items skipped where all
  dead), `__fdividef`, and its 64 full butterflies or one reduce-scatter.
D (`csrc/frame_swiglu.cu`, FAFormer's frame-SwiGLU forward at its two
  sites), at dropout 0 and 0.1: full; the full kernel's bf16 entry (x and
  out bf16, timed in the same turns); the statistics a frame at a time (two
  dependent butterflies a frame); E's one-pass pivot-shifted statistics (one
  butterfly of 16 sums); the frames in Gray-code order (each moving the
  coordinate terms by ±2·x_i·w1[i]), not each frame's terms anew; the exact sigmoid (`expf`, IEEE division); tanh.approx in the
  sigmoid (also held to D's gate); the dropout hash's first finalizer again
  for every value; x not loaded a position ahead; 3 blocks an SM, not 2;
  and, with --frame-swiglu-before, the kernel of another `frame_swiglu.cu`.
B and D: one call a sample, and device time alone (torch.profiler), and
  ptxas's registers of the forward kernels (full and before).

C (`csrc/edge_mlp.cu`, the EGNN edge MLP's backward at `chip_smoke`'s
  `edge_mlp_inputs`: G = 769, A = 32, k = 16, F = 1026, m = 16), in case
  (a), dm at O(1) on every edge, and case (b), dm 0 on the edges the model
  masks: full (z saved by kernel B); z computed again (kernel B's forward
  writing z, then C: what a step would pay without the saved z); without
  the skip of zero-gradient edges;
  with one butterfly an edge for ddist (not one per 8 edges); a quarter
  of the W1 products (dz·W1ᵀ and dW1: 4 of 16 columns); blocks of 4 rows,
  not 2; registers for 4 or 6 blocks an SM, not 5; a warp's live edges
  walked 4 or 16 at a time, not 8; and, with --edge-mlp-before, the kernel C
  of another `edge_mlp.cu` (with or without z, as its source says). Kernel B
  is timed with and without z written.
E (`csrc/frame_swiglu.cu`, FAFormer's frame-SwiGLU backward at its
  EdgeModule site, P = 393,728, C = 4, and its FAFFN site, P = 24,608,
  C = 3, H = 256), in case (a), dout at O(1) everywhere, and case (b), dout
  0 at the positions the model gives none: full; without the skip; the
  frame statistics in three dependent chains (mean, variance, mean(dz·z)),
  not one butterfly; the parameter sums in registers, one block an SM (the
  layout of the kernel before it); 3 blocks an SM, not 2; and, with
  --frame-swiglu-before, the kernel of another `frame_swiglu.cu`; the full
  kernel's bf16 entry (x, dout and dx bf16, timed in the same turns).
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
--step PATH: `chip_smoke.phase_step` of that path (a train step at batch 768:
  its time, peak memory and profile), with this tree's kernels and, with
  --vis-mix-before, with that vis_mix.cu in place of this one, in turns.
GIb (G and I in bf16, `vis_mix_inputs` in bf16): full; one block an SM (no
  minimum of 2 blocks: registers up to 128 a thread); blocks of 12 warps,
  not 16 (two an SM: 85 registers a thread); G without its edges'
  rows ahead, or 8 ahead, not 4; G skipping a masked edge's ds1 products;
  I's target pass alone, its walk alone; I keeping no gw rows in shared
  memory; and, with --vis-mix-before, the bf16 G and I of another
  `vis_mix.cu`; beside them the full build's f32 G and I at the same inputs
  in f32, in the same turns. One call a sample, device time alone, each
  build's distance from the plain bf16 version, and ptxas's registers and
  spills of each build's bf16 G and I.

A (`csrc/segment_sum.cu`, the batch's hyperedge ids, D = 256): 32-row
  tiles (the kernel), 16 and 64 rows, 8 and 32 rows in flight a thread;
  `index_add_`; 10 calls a sample and device time alone (torch.profiler).
J (`csrc/pooled_conv_fwd.cu`, with the model's live sites, C = 1 and 3):
  full; consumers only (the producers neither copy nor build: the products
  and the barriers); producers only (the consumers skip the products: the
  copies, the M-builds and the barriers); `torch.einsum`.
Jb, Kb (`csrc/pooled_conv_bf16.cu`, J and K in bf16, with the model's live
  sites, C = 1 and 3; one build of the whole source for both): J full;
  products alone (the producers copy and store M as 0, without its FMAs); M
  build alone (the consumers skip the products); copies alone (both
  skipped: the copies and the barriers); 2 producer warpgroups, not 3;
  tiles of 64 rows (64 / C sites) on the persistent grid, not the live
  sites spread evenly over it; the M build unrolled 4, not 2; the tensor
  cores' sums from 0 each chunk, not each 4; no TMA (J's general path:
  cp.async W, h 4 f a chunk); and, with --pooled-conv-bf16-before (e.g.
  `git show <commit>:equihgnn_tpu_torch/csrc/pooled_conv_bf16.cu`), that
  source's J and K; bf16 `torch.einsum`. One call a sample and device time alone
  (torch.profiler), and each one's distance from the plain bf16 version (a
  variant's output is wrong by design where it skips work). K full; its dM
  kernels without the dh and dtc products, or without the dM products, or
  with a W ring of 2 stages, or K's general dM path (cp.async W, 128-column
  chunks); its dW kernel without its products (M built), without its M
  build (products run), or K's general dW (64 pairs a block); the cuBLAS
  composition of K's function (`chip_smoke.k_bf16_reference`); one call a
  sample, and each build's kernels by device time (torch.profiler).
  ptxas's registers and spills of every kernel of the full build and of
  the before one, and of each variant's patched kernels.
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
M (`csrc/pooled_m.cu`, bf16, X = 64 and 192, h and tc 0 on the neighbours
  the 5 Å radius masks): full; without the dead-site skip (every site's dM
  read and its products run); without the ring (each unit's copies waited
  for before its products); 4 h/tc slots, not 3 (the next two sites' h and
  tc in flight, not the next one); registers for 4 blocks an SM, not 3 (128
  a thread); dh and dtc tiles
  of 4 × 2, not 4 × 8 and 4 × 4 (fed by 4-byte loads); scalar stores, not
  16-byte ones; without the products (the copies, the OR and the stores);
  and, with --pooled-m-before, the kernel M of another `pooled_m.cu` (with
  whether the full kernel gives its bits); the two `torch.bmm` calls that
  compute dh and dtc. 10 calls a sample, and device time alone
  (torch.profiler).
H (`csrc/vis_mix.cu`, at `vis_mix_inputs`): full; the grid's row index
  fastest, not the chunk (a row's 8 chunk blocks ~G blocks apart); plain
  stores, not streaming ones; synchronous staging (plain loads, not
  cp.async); masked edges computed; and, with --vis-mix-before, the kernel
  H of another `vis_mix.cu`; beside it F of the full and the before build
  (F's code unchanged). One call a sample, and device time alone.
B, D, E, H (with F), G and I, and M: ptxas's registers of their kernels (full and before;
D's and E's in both instances, float and bf16).
A variant is the source with exact lines removed or replaced; a line that is
not in the source once stops the script. A variant's output is wrong by
design and is not checked. Times: `chip_smoke.median_ms`, 10 samples (L: of
10 calls back to back), the variants alternating. Needs nvcc and one card;
writes nothing outside a temporary directory.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from chip_smoke import (
    HIDDEN,
    bench_batch,
    bf16_distance,
    edge_mlp_inputs,
    frame_swiglu_sites,
    kernel_split,
    median_ms,
    pooled_mask,
    profiled_device_ms,
    vis_mix_inputs,
)
from equihgnn_tpu_torch.ops.kernels import build
from equihgnn_tpu_torch.ops.kernels.edge_mlp import fwd_workspace_floats

_KINDS: set[str] = set()  # the --kernels given
A_SRC, J_SRC, K_SRC, L_SRC, GI_SRC, C_SRC, E_SRC, JB_SRC = (build.CSRC_DIR / n for n in (
    "segment_sum.cu", "pooled_conv_fwd.cu", "pooled_conv.cu", "pooled_m.cu", "vis_mix.cu",
    "edge_mlp.cu", "frame_swiglu.cu", "pooled_conv_bf16.cu"))
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
# J and K in bf16 (`pooled_conv_bf16.cu`), each with one part of its work
# switched off: J's M build (the producers store M as 0 without its FMAs),
# its products (the consumers only wait and signal), both (the copies and
# the barriers alone), its tiles of 64 rows (not balanced); K's dM kernels without their dh / dtc products or
# without their dM products, or with a W ring of 2 stages; K's dW kernel
# without its M build or without its products
_J_BUILD = "          on ? d.k : 0, m);"
_J_PRODUCTS = ("      wg_products(smem + a.lay.m + (n % MS_T) * M_BYTES, smem + (n % NS_T) * W_BYTES, cg, on,\n"
               "                  q % PART_CHUNKS == 0, part);\n")
_J_WGS = "constexpr int PRODUCER_WGS = 3;  // warpgroups of copies and M builds: chunk n is n % 3's"
_J_UNROLL = "#pragma unroll 2\n  for (int k = 0; k < k_n; ++k) {"
_J_SHARE = ("  const int64_t lo = static_cast<int64_t>(live) * blockIdx.x / per;\n"
            "  const int share = static_cast<int>(static_cast<int64_t>(live) * (blockIdx.x + 1) / per - lo);\n")
# the blocks' shares as whole tiles of 64 / C sites, as many a block as the
# busiest block of the tiles' own grid takes (the rest idle)
_J_TILES64 = ("  const int span = ((live + BM / d.c - 1) / (BM / d.c) + per - 1) / per * (BM / d.c);\n"
              "  const int64_t lo = static_cast<int64_t>(span) * blockIdx.x < live\n"
              "                         ? static_cast<int64_t>(span) * blockIdx.x : live;\n"
              "  const int share = static_cast<int>(lo + span < live ? span : live - lo);\n")
_J_PART = "constexpr int PART_CHUNKS = 4;  // chunks summed in the tensor cores before a flush"
JB_PATCHES = {
    "products alone": [(_J_BUILD, "          0, m);")],
    "M build alone": [(_J_PRODUCTS, "")],
    "copies alone": [(_J_BUILD, "          0, m);"), (_J_PRODUCTS, "")],
    "2 producer warpgroups": [(_J_WGS, _J_WGS.replace("= 3", "= 2"))],
    "tiles of 64 rows (unbalanced)": [(_J_SHARE, _J_TILES64)],
    "M build unrolled 4": [(_J_UNROLL, _J_UNROLL.replace("unroll 2", "unroll 4"))],
    "sums from 0 each chunk": [(_J_PART, _J_PART.replace("= 4", "= 1"))],
    "no TMA (cp.async W, 8-byte h)": [
        ("  if (launch_fwd_tma(a, stream, err)) return err;\n", "")],
}
_DW_BUILD = "  build_m(hs + row * PF + fq * 4, RC * PF, ts + row * PI, RC * PI, a.d.k, m);"
_DW_MMA = ("    mma_chunk(a, smem, q, o0, acc);\n"
           "    if (q + 2 < nq) bar_arrive(BAR_EMPTY + q % NS, THREADS);")
KB_PATCHES = {
    "dM without dh, dtc products": [
        ("            mma(part[kt][0], af, b[0], b[1]);\n"
         "            mma(part[kt][1], af, b[2], b[3]);", ""),
        ("          mma(part[0], af, b[0], b[1]);\n          mma(part[1], af, b[2], b[3]);", "")],
    "dM without dM products": [("    dm_products_t(L, smem, u, acc);\n", "")],
    "dM W ring of 2": [("  for (int nsw = 4; nsw >= 2; --nsw) {\n    l.nsw = nsw;\n    l.w",
                        "  for (int nsw = 2; nsw >= 2; --nsw) {\n    l.nsw = nsw;\n    l.w")],
    "dM general path (cp.async W, 128 columns)": [
        ("    if (k > 16 ? launch_dm_tma<2>(a, stream, err) : launch_dm_tma<1>(a, stream, err)) {",
         "    if (false) {")],
    "dW products alone": [(_DW_BUILD, _DW_BUILD.replace("a.d.k", "0"))],
    "dW M build alone": [(_DW_MMA, _DW_MMA.split("\n")[1])],
    "dW 64 pairs (general)": [("  if (lv.ns) {  // dW, 128 pairs a block", "  if (false) {")],
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
# G and I in bf16, each with one part of the design switched off: one block
# an SM (no minimum of 2 blocks, so registers up to 128 a thread), no edges'
# s2m / s1 rows ahead (G; I reads its kept gw rows from shared memory), 8
# ahead, not 4; G skipping a masked edge's ds1 products; each of I's passes
# alone; I keeping no gw rows (both passes read them from device memory)
_GB_BOUNDS = "__launch_bounds__(THREADS, 2)\nvec_agg_bwd_bf16_kernel("
_IB_BOUNDS = "__launch_bounds__(THREADS, 2)\nwdot_bwd_bf16_kernel("
_GB_AHEAD = "constexpr int AHEAD_GB = 4;"
_GB_T1 = """          const uint32_t v = j >= 0 ? vec_at(j, l) : 0u;
          t1x = add(t1x, mul(bf_lo(v), gx[l]));
          t1y = add(t1y, mul(bf_hi(v), gy[l]));
"""
_GB_PART = "          part[l] = add(mul(sx, gx[l]), mul(sy, gy[l]));\n        }\n"
GIB_PATCHES = {
    "one block an SM": [(_GB_BOUNDS, _GB_BOUNDS.replace(", 2)", ")")),
                        (_IB_BOUNDS, _IB_BOUNDS.replace(", 2)", ")"))],
    "12 warps a block (85 registers)": [("constexpr int WARPS = 16;", "constexpr int WARPS = 12;")],
    "G no edges ahead": [(_GB_AHEAD, _GB_AHEAD.replace("4", "1"))],
    "G 8 edges ahead": [(_GB_AHEAD, _GB_AHEAD.replace("4", "8"))],
    # a masked edge's ds1 products skipped (+0, the value for finite gva)
    "G masked edges' ds1 skipped": [
        (_GB_T1, ""),
        (_GB_PART, _GB_PART + "        if (j >= 0) {\n#pragma unroll\n"
         "          for (int l = 0; l < L; ++l) {\n            const uint32_t v = vec_at(j, l);\n"
         "            t1x = add(t1x, mul(bf_lo(v), gx[l]));\n"
         "            t1y = add(t1y, mul(bf_hi(v), gy[l]));\n          }\n        }\n")],
    # what each of I's passes costs: the other one alone (outputs wrong)
    "I target pass alone": [("      const int begin = off_s[j], end = off_s[j + 1];",
                             "      const int begin = off_s[j], end = begin;")],
    "I walk alone": [("    for (int i = warp; i < a_slots; i += WARPS) {\n      float ux[L], uy[L];",
                      "    for (int i = a_slots; i < a_slots; i += WARPS) {\n      float ux[L], uy[L];")],
    "I keeps no gw": [("  if (n_chunks <= MAX_CLUSTER && base < TWO_BLOCK_SMEM)",
                       "  if (false)")],
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
        ("for (int q = 0; q < M_OUT / 4; ++q) {\n              const float4 v = dz4[q];",
         "for (int q = 0; q < 1; ++q) {\n              const float4 v = dz4[q];")],
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
# kernel B (csrc/edge_mlp.cu, the forward): this tree's kernel with one part
# switched off or done otherwise
_B_SPLIT = """      split_tf32_alu(v[0][2 * s], ah[0], al[0]);
      split_tf32_alu(v[1][2 * s], ah[1], al[1]);
      split_tf32_alu(v[0][2 * s + 1], ah[2], al[2]);
      split_tf32_alu(v[1][2 * s + 1], ah[3], al[3]);"""
# the split by floating-point operations (Veltkamp: big = c − (c − x), c =
# 8193·x, rounds to 11 significant bits), of both parts, or of big alone with
# small's low bits left to the tensor cores
_B_SPLIT_FP = """__device__ __forceinline__ float veltkamp(float x) {
  const float c = __fmul_rn(x, 8193.f);
  return __fsub_rn(c, __fsub_rn(c, x));
}
__device__ __forceinline__ void split_fp(float x, uint32_t& big, uint32_t& small) {
  const float b = veltkamp(x);
  big = __float_as_uint(b);
  small = __float_as_uint(veltkamp(__fsub_rn(x, b)));
}
__device__ __forceinline__ void split_fp_big(float x, uint32_t& big, uint32_t& small) {
  const float b = veltkamp(x);
  big = __float_as_uint(b);
  small = __float_as_uint(__fsub_rn(x, b));
}

// Kernel B's W1 as mma.sync B fragments"""
_B_UJN_READ = "            const float4 j4 = E::load4(ujn_st + jo[i][h] + c);"
B_PATCHES = {
    "no slot skip": [("      bool on = tile < n_tiles && !emask;", "      bool on = tile < n_tiles;")],
    "ujn from L2": [
        ("        jo[i][h] = ex ? static_cast<int>(idx[at]) * CWP : 0;",
         "        jo[i][h] = ex ? static_cast<int>(idx[at]) * f_dim : 0;"),
        ("      for (int i = tid; i < a_slots * WORDS; i += THREADS) {",
         "      for (int i = a_slots * WORDS; i < a_slots * WORDS; i += THREADS) {"),
        (_B_UJN_READ,
         "            const T* jp = ujn + row0 * f_dim + jo[i][h] + ch * CW + c;\n"
         "            const int fl = f_dim - ch * CW - c;\n"
         "            const float4 j4 = make_float4(fl > 0 ? E::f(jp[0]) : 0.f, fl > 1 ? E::f(jp[1]) : 0.f,\n"
         "                                          fl > 2 ? E::f(jp[2]) : 0.f, fl > 3 ? E::f(jp[3]) : 0.f);")],
    "stages of 32 columns": [("  for (int cw = 64; cw >= 16; cw /= 2)", "  for (int cw = 32; cw >= 16; cw /= 2)")],
    "2 tiles a warp": [("constexpr int FW_TPW = 4;", "constexpr int FW_TPW = 2;")],
    # 4 warps of up to 8 tiles (a row's 17 live tiles are then 5 a warp at
    # most, not 3 of 8 warps' 2.1): 2 blocks an SM, or 3 at 32 columns
    "4 warps of 8 tiles": [("constexpr int FW_WARPS = 8;", "constexpr int FW_WARPS = 4;"),
                           ("constexpr int FW_TPW = 4;", "constexpr int FW_TPW = 8;")],
    "4 warps of 8 tiles, 3 blocks an SM, 32 columns": [
        ("constexpr int FW_WARPS = 8;", "constexpr int FW_WARPS = 4;"),
        ("constexpr int FW_TPW = 4;", "constexpr int FW_TPW = 8;"),
        ("constexpr int FW_MIN_BLOCKS = 2;", "constexpr int FW_MIN_BLOCKS = 3;"),
        ("  for (int cw = 64; cw >= 16; cw /= 2)", "  for (int cw = 32; cw >= 16; cw /= 2)")],
    "split by cvt.rna": [(_B_SPLIT, _B_SPLIT.replace("split_tf32_alu(", "split_tf32("))],
    # the chunk's sums carried on the tensor cores over its 8 k-steps, not
    # each 16-column group's from 0
    "sums over the chunk on the tensor cores": [
        ("#pragma unroll\n    for (int j = 0; j < 2; ++j)\n#pragma unroll\n"
         "      for (int r = 0; r < 4; ++r) grp[j][r] = 0.f;\n", ""),
        ("          float grp[2][4];\n          E::product(grp, v, wf);\n#pragma unroll\n"
         "          for (int j = 0; j < 2; ++j)\n#pragma unroll\n"
         "            for (int r = 0; r < 4; ++r) acc[i][j][r] += grp[j][r];",
         "          E::product(acc[i], v, wf);")],
    # what the products and the SiLUs cost: a1 formed and split, no mma
    # (a dependence on every split value keeps them); a1 without its SiLU
    "no products": [("        mma_3xtf32(grp[j], ah, al, __float_as_uint(hb[2 * s]), __float_as_uint(hb[2 * s + 1]),\n"
                     "                   __float_as_uint(lb[2 * s]), __float_as_uint(lb[2 * s + 1]));",
                     "        grp[j][0] += as_float(ah[0] ^ ah[1] ^ ah[2] ^ ah[3] ^ al[0] ^ al[1] ^\n"
                     "                                 al[2] ^ al[3] ^ __float_as_uint(hb[2 * s] + lb[2 * s]));")],
    "no SiLU in a1": [("    return silu(base + uj + d * w);", "    return base + uj + d * w;")],
    # the split by floating-point operations (Veltkamp: big = c − (c − x), c =
    # 8193·x, rounds to 11 significant bits), of both parts, or of big alone
    # with small's low bits left to the tensor cores
    "split by FP ops": [("// Kernel B's W1 as mma.sync B fragments", _B_SPLIT_FP),
                        (_B_SPLIT, _B_SPLIT.replace("split_tf32_alu(", "split_fp("))],
    "split by FP ops, small unrounded": [("// Kernel B's W1 as mma.sync B fragments", _B_SPLIT_FP),
                                         (_B_SPLIT, _B_SPLIT.replace("split_tf32_alu(", "split_fp_big("))],
}
# the CUDA-core alternative: the kernel before it (one warp per slot and 4
# neighbours, lanes over f, W1 read from shared memory, ujn from L2) given
# this tree's interface and function (the edge mask, its 4-edge items skipped
# where all dead, 0 at the dead edges) and `__fdividef`, with its 64 full
# butterflies or one reduce-scatter of the 4·16 partial sums
_CC_COMMON = [
    ("__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }",
     "__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }"),
    ("                    const float* __restrict__ dist, const int64_t* __restrict__ idx,\n"
     "                    const float* __restrict__ wd, const float* __restrict__ b0,\n"
     "                    const float* __restrict__ w1, const float* __restrict__ b1,\n"
     "                    float* __restrict__ out, float* __restrict__ zout,",
     "                    const float* __restrict__ dist, const int64_t* __restrict__ idx,\n"
     "                    const uint8_t* __restrict__ emask,\n"
     "                    const float* __restrict__ wd, const float* __restrict__ b0,\n"
     "                    const float* __restrict__ w1, const float* __restrict__ b1,\n"
     "                    float* __restrict__ out, float* __restrict__ zout,"),
    ("    float acc[NE][M_OUT];\n#pragma unroll\n    for (int e = 0; e < NE; ++e)\n#pragma unroll\n"
     "      for (int j = 0; j < M_OUT; ++j) acc[e][j] = 0.f;",
     "    bool any = !emask;\n"
     "    for (int e = 0; e < NE; ++e)\n"
     "      if (emask && k0 + e < k_nbrs) any |= emask[row * k_nbrs + k0 + e] != 0;\n"
     "    if (!any) {  // the item's edges are all dead: 0\n"
     "      for (int i = lane; i < NE * M_OUT; i += 32)\n"
     "        if (k0 + i / M_OUT < k_nbrs) out[(row * k_nbrs + k0) * M_OUT + i] = 0.f;\n"
     "      continue;\n"
     "    }\n"
     "    float acc[NE][M_OUT];\n#pragma unroll\n    for (int e = 0; e < NE; ++e)\n#pragma unroll\n"
     "      for (int j = 0; j < M_OUT; ++j) acc[e][j] = 0.f;"),
    ("extern \"C\" int edge_mlp_fwd_f32(const float* ui, const float* ujn, const float* dist,\n"
     "                                const int64_t* idx, const float* wd, const float* b0,\n"
     "                                const float* w1, const float* b1, float* out, float* zout,\n"
     "                                int g_rows,",
     "extern \"C\" int edge_mlp_fwd_f32(const float* ui, const float* ujn, const float* dist,\n"
     "                                const int64_t* idx, const uint8_t* emask, const float* wd,\n"
     "                                const float* b0, const float* w1, const float* b1, float* out,\n"
     "                                float* zout, float* ws, int g_rows,"),
    ("      ui, ujn, dist, idx, wd, b0, w1, b1, out, zout, a_slots, k_nbrs, f_dim);",
     "      ui, ujn, dist, idx, emask, wd, b0, w1, b1, out, zout, a_slots, k_nbrs, f_dim);"),
]
_CC_WRITE = ("          out[o] = silu(z);",
             "          out[o] = !emask || emask[row * k_nbrs + k0 + e] ? silu(z) : 0.f;")
_CC_BUTTERFLIES = """#pragma unroll
    for (int e = 0; e < NE; ++e)
#pragma unroll
      for (int j = 0; j < M_OUT; ++j)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[e][j] += __shfl_xor_sync(FULL, acc[e][j], off);

    // every lane now holds all NE·M sums; lane t % 32 writes output t
#pragma unroll
    for (int e = 0; e < NE; ++e) {
#pragma unroll
      for (int j = 0; j < M_OUT; ++j) {
        if (((e * M_OUT + j) & 31) == lane && k0 + e < k_nbrs) {
          const size_t o = (row * k_nbrs + k0 + e) * M_OUT + j;
          const float z = acc[e][j] + b1[j];
          out[o] = silu(z);
          if (zout) zout[o] = z;
        }
      }
    }"""
_CC_REDUCE_SCATTER = """    // one reduce-scatter of the NE·M = 64 sums: lane l ends with 2l, 2l + 1
#define ACC(i) acc[(i) >> 4][(i) & 15]
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int half = 32 >> s, bit = 16 >> s;
      const bool up = lane & bit;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i < half) {
          const float send = up ? ACC(i) : ACC(i + half);
          const float keep = up ? ACC(i + half) : ACC(i);
          ACC(i) = keep + __shfl_xor_sync(FULL, send, bit);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int oi = 2 * lane + u, e = oi / M_OUT, j = oi % M_OUT;
      if (k0 + e < k_nbrs) {
        const size_t o = (row * k_nbrs + k0 + e) * M_OUT + j;
        const float z = ACC(u) + b1[j];
        out[o] = !emask || emask[row * k_nbrs + k0 + e] ? silu(z) : 0.f;
        if (zout) zout[o] = z;
      }
    }
#undef ACC"""
B_BEFORE_PATCHES = {
    "CUDA cores, 64 butterflies": _CC_COMMON + [_CC_WRITE],
    "CUDA cores, one reduce-scatter": _CC_COMMON + [(_CC_BUTTERFLIES, _CC_REDUCE_SCATTER)],
}
# kernel D (csrc/frame_swiglu.cu, the forward): this tree's kernel with one
# part switched off or done otherwise
_D_STATS = """    float mu[8], inv[8], ss[8];
    const float r1 = warp_reduce_scatter<8>(s, lane);
#pragma unroll
    for (int o = 0; o < 8; ++o) mu[o] = __shfl_sync(FULL, r1, 4 * o) * INV_HH;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      ss[o] = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        y[o][q] -= mu[o];
        ss[o] = fmaf(y[o][q], y[o][q], ss[o]);
      }
    }
    const float r2 = warp_reduce_scatter<8>(ss, lane);
#pragma unroll
    for (int o = 0; o < 8; ++o) inv[o] = rsqrtf(__shfl_sync(FULL, r2, 4 * o) * INV_HH + LN_EPS);"""
# a frame at a time: the mean's butterfly, then the variance's (the kernel
# before it: two dependent chains a frame)
_D_CHAINS = """    float mu[8], inv[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      mu[o] = warp_sum(s[o]) * INV_HH;
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        y[o][q] -= mu[o];
        ss = fmaf(y[o][q], y[o][q], ss);
      }
      inv[o] = rsqrtf(warp_sum(ss) * INV_HH + LN_EPS);
    }"""
# E's one-pass statistics: Σ(y − c) and Σ(y − c)² of all 8 frames, shifted by
# a pivot c_o (lane 0's first value of frame o), in one butterfly of 16
_D_PIVOT = """    float mu[8], inv[8], st[16];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float piv = __shfl_sync(FULL, y[o][0], 0);
      st[o] = 0.f;
      st[8 + o] = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        y[o][q] -= piv;
        st[o] += y[o][q];
        st[8 + o] = fmaf(y[o][q], y[o][q], st[8 + o]);
      }
    }
    const float r = warp_reduce_scatter<16>(st, lane);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float dmu = __shfl_sync(FULL, r, 2 * o) * INV_HH;  // μ − c
      const float var = fmaxf(__shfl_sync(FULL, r, 16 + 2 * o) * INV_HH - dmu * dmu, 0.f);
      inv[o] = rsqrtf(var + LN_EPS);
#pragma unroll
      for (int q = 0; q < CPL; ++q) y[o][q] -= dmu;
      mu[o] = dmu;
    }"""
# the frames in Gray-code order (each next frame flips one sign: its coordinate
# terms move by ±2·x_i·w1[i], one FMA a column), not each frame's terms anew
_D_DIRECT = """    // pre_o = base + u_o: base = b1 + Σ_{c≥3} x_c·w1[c] the same in every
    // frame, u_o = Σ_{i<3} s_o,i·x_i·w1[i] (3 FMAs a column) kept apart from
    // it, so that u's roundings fall at the size of the coordinate terms,
    // not at that of base (b1 + 10 would carry them at 10)
    float base[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = b[k];
#pragma unroll
      for (int c = 3; c < C; ++c) v = fmaf(xv[c], w[c][k], v);
      base[k] = v;
    }
    // y[o] = drop(silu(h1)·h2) of frame o, and the lane's part of its sum
    float y[8][CPL], s[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      s[o] = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        float u1 = 0.f, u2 = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          u1 = fmaf(sgn(o, i) * xv[i], w[i][q], u1);
          u2 = fmaf(sgn(o, i) * xv[i], w[i][CPL + q], u2);
        }
        const float h1 = base[q] + u1, h2 = base[CPL + q] + u2;
        float v = h1 * sigmoid_fast(h1) * h2;
"""
_D_GRAY = """    // pre = base + u: base = b1 + Σ_{c≥3} x_c·w1[c] the same in every frame,
    // u = Σ_{i<3} s_o,i·x_i·w1[i] frame 0's (every coordinate sign −1); the
    // frames are visited in Gray-code order, so that each next one flips one
    // sign and u moves by ±2·x_i·w1[i]. u is kept apart from base: its
    // roundings then fall at the size of the coordinate terms, not at that
    // of base (b1 + 10 would carry 7 roundings at 10 into the last frame)
    float base[K], u[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = b[k];
#pragma unroll
      for (int c = 3; c < C; ++c) v = fmaf(xv[c], w[c][k], v);
      base[k] = v;
      v = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) v = fmaf(-xv[i], w[i][k], v);
      u[k] = v;
    }
    // y[o] = drop(silu(h1)·h2) of frame o, and the lane's part of its sum
    float y[8][CPL], s[8];
#pragma unroll
    for (int step = 0; step < 8; ++step) {
      const int o = step ^ (step >> 1);
      if (step > 0) {  // the one coordinate whose sign flips: u ± 2·x_i·w1[i]
        const int flip = o ^ ((step - 1) ^ ((step - 1) >> 1));
        const int i = flip == 4 ? 0 : flip == 2 ? 1 : 2;
        const float t = 2.f * sgn(o, i) * xv[i];
#pragma unroll
        for (int k = 0; k < K; ++k) u[k] = fmaf(t, w[i][k], u[k]);
      }
      s[o] = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const float h1 = base[q] + u[q], h2 = base[CPL + q] + u[CPL + q];
        float v = h1 * sigmoid_fast(h1) * h2;
"""
_D_SIG = "        float v = h1 * sigmoid_fast(h1) * h2;"
_D_KEEP = "          v = keep_bit_h(ph, drop.smix, o * HH + lane + 32 * q, drop.thresh) ? v * drop.inv_keep"
_D_TANH = """__device__ __forceinline__ float sigmoid_tanh(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * x));
  return fmaf(0.5f, t, 0.5f);
}

// Kernel D's blocks an SM"""
D_PATCHES = {
    "statistics a frame at a time": [(_D_STATS, _D_CHAINS)],
    "one-pass pivot statistics": [(_D_STATS, _D_PIVOT)],
    "Gray code": [(_D_DIRECT, _D_GRAY)],
    "exact sigmoid": [(_D_SIG, "        float v = h1 * (1.f / (1.f + expf(-h1))) * h2;")],
    "tanh.approx sigmoid": [("// Kernel D's blocks an SM", _D_TANH),
                            (_D_SIG, "        float v = h1 * sigmoid_tanh(h1) * h2;")],
    "hash per value": [(_D_KEEP, _D_KEEP.replace("keep_bit_h(ph,", "keep_bit_h(fmix32(static_cast<uint32_t>(p) ^ drop.smix),"))],
    "x not loaded ahead": [("    for (int c = 0; c < C; ++c) xv[c] = xn[c];",
                            "    for (int c = 0; c < C; ++c) xv[c] = to_f32(x[p * C + c]);")],
    "3 blocks an SM": [("constexpr int FWD_MIN_BLOCKS = 2;", "constexpr int FWD_MIN_BLOCKS = 3;")],
}
L_PATCHES = {
    "no zero-site skip": [("for (int k = 0; nonzero && k < d.k; ++k)", "for (int k = 0; k < d.k; ++k)")],
    "no products": [("for (int k = 0; nonzero && k < d.k; ++k)", "for (int k = 0; false; ++k)")],
}

H_PATCHES = {
    "old grid order": [("  const int g = blockIdx.x / n_chunks, c0 = blockIdx.x % n_chunks * HC;",
                        "  const int g = blockIdx.x % g_rows, c0 = blockIdx.x / g_rows * HC;")],
    "plain stores": [("      if (live) __stcs(o + static_cast<size_t>(k) * h, w);",
                      "      if (live) o[static_cast<size_t>(k) * h] = w;")],
    "synchronous staging": [
        ("  stage_chunk_async(vv, g, a_slots, L, h, c0, vec4, vv_s);\n"
         "  stage_row_async(d_row, ak * L, d4, d_s);\n  cp_async_commit();\n",
         "  stage_chunk(vv, g, a_slots, L, h, c0, vv_s);\n"
         "  for (int t = threadIdx.x; t < ak * L; t += THREADS) d_s[t] = d_row[t];\n")],
    "masked edges computed": [("      if (j >= 0) {  // the same for the whole warp", "      {")],
}
M_PATCHES = {
    "no dead-site skip": [("  return (bits & 0x7fff7fffu) != 0;  // the signs aside: a site of ±0 "
                           "alone has no neighbour", "  return true;")],
    "no ring": [("    cp_async_commit();\n    if (live) {", "    cp_async_commit();\n"
                 "    cp_async_wait<0>();\n    __syncthreads();\n    if (live) {")],
    "4 h/tc slots": [("constexpr int HT_SLOTS = 3;", "constexpr int HT_SLOTS = 4;")],
    "4 blocks an SM": [("__global__ void __launch_bounds__(BWD_THREADS, 3)",
                        "__global__ void __launch_bounds__(BWD_THREADS, 4)")],
    "4 x 2 tiles": [("constexpr int DH_W = 8;", "constexpr int DH_W = 2;"),
                    ("constexpr int DT_W = 4;", "constexpr int DT_W = 2;")],
    "scalar stores": [("put<DH_W, VEC>(", "put<DH_W, false>("),
                      ("if constexpr (VEC && DT_W == 4) {", "if constexpr (false) {"),
                      ("zero_site<VEC>(d, dh, dtc, s);", "zero_site<false>(d, dh, dtc, s);")],
    "no products": [("      for (int x0 = 0; x0 < xcc; x0 += 8) {",
                     "      for (int x0 = 0; x0 < 0; x0 += 8) {"),
                    ("      for (int f0 = 0; on && f0 < d.fs; f0 += 8) {",
                     "      for (int f0 = 0; on && f0 < 0; f0 += 8) {")],
}
# builds whose ptxas report to print, and the kernels in it to print
REGISTERS = {"B full": ("fwd_kernel", "w1_frags"), "B before": ("fwd_kernel", "w1_frags"),
             "D full": ("fwd_kernel",), "D before": ("fwd_kernel",),
             "E full": ("bwd_kernel",), "E before": ("bwd_kernel",),
             "H full": ("wdot_fwd_kernel", "vec_agg_fwd_kernel"),
             "H before": ("wdot_fwd_kernel", "vec_agg_fwd_kernel"),
             "GI full": ("vec_agg_bwd_kernel", "wdot_bwd_kernel"),
             "GI before": ("vec_agg_bwd_kernel", "wdot_bwd_kernel"),
             "GIb full": ("vec_agg_bwd_bf16_kernel", "wdot_bwd_bf16_kernel"),
             "GIb before": ("vec_agg_bwd_bf16_kernel", "wdot_bwd_bf16_kernel"),
             "M full": ("pooled_m_bwd",), "M before": ("pooled_m_bwd",),
             "JKb full": ("fwd_kernel", "fwd_tma_kernel", "dm_kernel", "dm_tma_kernel",
                          "dw_kernel"),
             "JKb before": ("fwd_kernel", "dm_kernel", "dw_kernel")}

def _patched(src: Path, patches, out: Path) -> Path:
    """`src` with each (text, replacement) applied: every occurrence, of
    which there must be one, or two for G's and I's common lines (a line
    that is not there, e.g. in a --*-before source of another layout, stops
    the script)."""
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
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC_DIR),
                               "-shared", "-o", str(libs[n]), str(s)],
                              stderr=subprocess.PIPE, text=True) for n, s in srcs.items()]
    for proc, name in zip(procs, srcs):
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        if name in REGISTERS:
            _print_registers(name, err, REGISTERS[name])
        elif name.startswith("GIb "):
            _print_registers(name, err, REGISTERS["GIb full"])
        elif name[:3] in ("Jb ", "Kb "):  # a variant's own kernel, patched
            _print_registers(name, err, ("fwd_tma_kernel",) if name[0] == "J" else
                             ("dm_tma_kernel", "dw_kernel"))
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def _print_registers(name: str, ptxas: str, kernels) -> None:
    """ptxas's registers and spills of each kernel of a build's report whose
    name holds one of `kernels`."""
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(k in line for k in kernels):
            fn = line.split("'")[1] if "'" in line else line
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "", fn)  # the file's namespace
            info = " ".join(x.split("ptxas info    :")[-1].strip() for x in lines[i + 1:i + 4]
                            if "registers" in x or "spill" in x)
            print(f"{name} ptxas: {fn[:80]}: {info}")


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

    jn = [n for n in libs if n.startswith("J ")]
    kn = [n for n in libs if n.startswith("K ")]
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


def _time_jkb(libs, batch, dev) -> None:
    """J and K in bf16 (`pooled_conv_bf16.cu`) with the model's live sites,
    C = 1 and 3: the full kernels, their variants and, with
    --pooled-conv-bf16-before, another source's ("JKb before"), in turns;
    J one call a sample and device time alone beside the one bf16
    `torch.einsum` call, with each build's distance from the plain bf16
    version (a variant's output is wrong by design); K one call a sample
    beside its cuBLAS composition (`chip_smoke.k_bf16_reference`, on the
    live sites gathered beforehand), and each build's kernels by device
    time (torch.profiler)."""
    from chip_smoke import k_bf16_reference
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import live_sites, pooled_conv_plain

    before = ["JKb before"] if "JKb before" in libs else []
    jn = ["JKb full"] + [n for n in libs if n.startswith("Jb ")] + before
    kn = ["JKb full"] + [n for n in libs if n.startswith("Kb ")] + before
    do_j = any(n.startswith("Jb ") for n in libs) or "Jb" in _KINDS
    do_k = any(n.startswith("Kb ") for n in libs) or "Kb" in _KINDS
    mask = pooled_mask(batch)
    g, a, k = mask.shape
    s, f, i, o = g * a, 128, HIDDEN, HIDDEN
    live = mask.any(-1)
    sites = live_sites(live)
    gen = torch.Generator().manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    for c in (1, 3):
        h = (torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]).bfloat16()
        tc = (torch.randn(g, a, k, c * i, generator=gen).to(dev) * mask[..., None]).bfloat16()
        w = ((torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5).bfloat16()
        dout = torch.randn(g, a, c, o, generator=gen).to(dev).bfloat16()
        if do_j:
            want = pooled_conv_plain(h, tc, w, c, live)
            fns = []
            for name in jn:
                out = torch.zeros(g, a, c, o, device=dev, dtype=torch.bfloat16)  # dead: 0
                fn = libs[name].pooled_conv_fwd_bf16
                fn.argtypes = (P, P, P, P, P, P, I, I, I, I, I, I, P)
                fns.append(lambda fn=fn, out=out: (
                    fn(h.data_ptr(), tc.data_ptr(), w.data_ptr(), sites.ids.data_ptr(),
                       sites.count.data_ptr(), out.data_ptr(), s, k, c, i, f, o, stream), out)[1])
            for name, fn in zip(jn, fns):
                same, far = bf16_distance(fn(), want)
                print(f"J bf16 C={c} {name}: {same:.5f} the plain version's bits, {far:.2f} bf16 "
                      f"ulps at most")
            fns += [lambda: torch.einsum("gakf,gakci,foi->gaco", h, tc.view(g, a, k, c, i), w),
                    fns[0]]
            times = median_ms(*fns, iters=10)
            dev_ms = [profiled_device_ms(fn, calls=5) for fn in fns[:-1]]
            print(f"J bf16 C={c} (one call; device alone): " + ", ".join(
                f"{n} {t:.4f} / {dv:.4f} ms" for n, t, dv in
                zip(jn + ["bf16 torch.einsum"], times, dev_ms)) +
                f", JKb full again {times[-1]:.4f} ms")
            del want, fns
        if do_k:
            fns = []
            for name in kn:
                dh, dtc, dw = torch.empty_like(h), torch.empty_like(tc), torch.empty_like(w)
                fn = libs[name].pooled_conv_bwd_bf16
                fn.argtypes = (P,) * 9 + (I,) * 6 + (P,)
                fns.append(lambda fn=fn, dh=dh, dtc=dtc, dw=dw: fn(
                    h.data_ptr(), tc.data_ptr(), w.data_ptr(), dout.data_ptr(),
                    sites.ids.data_ptr(), sites.count.data_ptr(), dh.data_ptr(), dtc.data_ptr(),
                    dw.data_ptr(), s, k, c, i, f, o, stream))
            ref = k_bf16_reference(h, tc, w, c, dout, live)
            times = median_ms(*fns, ref, fns[0], iters=5)
            print(f"K bf16 C={c} (one call): " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in zip(kn + ["cuBLAS composition"], times)) +
                f", JKb full again {times[-1]:.4f} ms")
            for name, fn in zip(kn + ["cuBLAS composition"], fns + [ref]):
                print(f"  K bf16 C={c} {name} by kernel: " + ", ".join(
                    f"{kname} {t:.4f} ms" for kname, t in kernel_split(fn).items()))
            del fns, ref
        del h, tc, w, dout
        torch.cuda.empty_cache()


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


def _time_gib(libs, batch) -> None:
    """G and I in bf16 of each build at `vis_mix_inputs` in bf16 (the bf16
    ViSNet's shapes), beside the full build's f32 G and I at the f32 inputs,
    in the same turns: one call a sample, then device time alone; and each
    build's distance from the plain bf16 version (a variant that skips work
    is not wrong by design here: each computes the whole function)."""
    from equihgnn_tpu_torch.ops.kernels.vis_mix import vec_agg_bwd_plain, wdot_bwd_plain

    gen = torch.Generator().manual_seed(18)
    xb = vis_mix_inputs(batch, gen, torch.bfloat16)
    x32 = {n: t.float() if t.is_floating_point() else t for n, t in xb.items()}
    x32["s1"] = xb["s1"].float()  # a contiguous f32 copy of the strided view
    g, a, k = xb["idx"].shape
    L, h = xb["d"].shape[-1], xb["vec"].shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    names = [n for n in libs if n.startswith("GIb")]

    def call(lib, entry, x, out):
        fn = getattr(lib, entry)
        fn.argtypes = build.SIGNATURES[entry]
        p = {n: t.data_ptr() for n, t in x.items()}
        o = [t.data_ptr() for t in out]
        if entry.startswith("vis_vec_agg"):
            return lambda: fn(p["vec"], p["s1"], x["s1"].stride(2), p["s2m"], p["d"], p["idx"],
                              p["mask"], p["gva"], *o, g, a, k, L, h, stream)
        return lambda: fn(p["d"], p["u"], p["vv"], p["idx"], p["mask"], p["gw"], *o, g, a, k, L,
                          h, stream)

    for letter, stem in (("G", "vis_vec_agg_bwd"), ("I", "vis_wdot_bwd")):
        if letter == "G":
            want = vec_agg_bwd_plain(*(xb[n] for n in ("vec", "s1", "s2m", "d", "idx", "mask",
                                                       "gva")))
            shapes = [t.shape for t in want]  # dvec, ds1, ds2m, dd
            order = [0, 1, 2, 3]
        else:
            want = wdot_bwd_plain(*(xb[n] for n in ("d", "u", "vv", "idx", "mask", "gw")))
            shapes = [want[1].shape, want[2].shape, want[0].shape]  # du, dvv, dd
            order = [2, 0, 1]  # the plain version's (dd, du, dvv) from the entry's outputs
        fns = []
        for name in names:
            out = [torch.empty(s, dtype=torch.bfloat16, device=xb["d"].device) for s in shapes]
            fns.append(call(libs[name], f"{stem}_bf16", xb, out))
            fns[-1]()
            torch.cuda.synchronize()
            far = max(bf16_distance(out[order[q]], w)[1] for q, w in enumerate(want))
            same = min(bf16_distance(out[order[q]], w)[0] for q, w in enumerate(want))
            print(f"{letter} bf16 {name}: {same:.5f} the plain version's bits (least of its "
                  f"outputs), {far:.2f} bf16 ulps at most")
        out32 = [torch.empty(s, device=xb["d"].device) for s in shapes]
        fns.append(call(libs["GIb full"], f"{stem}_f32", x32, out32))
        del want
        times = median_ms(*fns, fns[0])
        dev_ms = [profiled_device_ms(fn) for fn in fns]
        print(f"{letter} bf16 (one call a sample; device alone): " + ", ".join(
            f"{n[4:]} {t:.4f} / {dv:.4f} ms" for n, t, dv in
            zip(names + ["GIb f32 (full build)"], times, dev_ms))
            + f", full again {times[-1]:.4f} ms")
        del fns, out32
        torch.cuda.empty_cache()


def _time_steps(path: str, vis_mix_before: Path | None, tmp: Path) -> None:
    """`chip_smoke.phase_step` of `path` (one train step at batch 768: its
    time, memory and profile) with this tree's kernels and, given another
    vis_mix.cu, with a copy of csrc/ that has it in place of this one, in
    turns: before, this, this, before (each build cached by its sources)."""
    import shutil

    from chip_smoke import phase_device, phase_step

    _, smi = phase_device()
    samples = bench_batch()[0]
    dirs = {"this": build.CSRC_DIR}
    order = ["this"]
    if vis_mix_before:
        dirs["before"] = tmp / "csrc_before"
        shutil.copytree(build.CSRC_DIR, dirs["before"])
        shutil.copy(vis_mix_before, dirs["before"] / "vis_mix.cu")
        order = ["before", "this", "this", "before"]
    for name in order:
        build.CSRC_DIR = dirs[name]
        build.library.cache_clear()
        print(f"--- {path} train step with the {name} kernels (csrc {dirs[name]})")
        phase_step(path, samples, smi)
    build.CSRC_DIR = dirs["this"]
    build.library.cache_clear()


def _time_h(libs, batch) -> None:
    """H of each variant at `vis_mix_inputs`, and F of the full and before
    builds (F's code is unchanged): one call a sample (the variants in
    turns), then device time alone."""
    x = vis_mix_inputs(batch, torch.Generator().manual_seed(0))
    g, a, k = x["idx"].shape
    L, h = x["d"].shape[-1], x["vec"].shape[-1]
    out, agg = torch.empty_like(x["s2m"]), torch.empty_like(x["vec"])
    p = {n: t.data_ptr() for n, t in x.items()}
    stream = torch.cuda.current_stream().cuda_stream
    names = [n for n in libs if n.startswith("H")]
    fns = []
    for name in names:
        fn = libs[name].vis_wdot_fwd_f32
        fn.argtypes = build.SIGNATURES["vis_wdot_fwd_f32"]
        fns.append(lambda fn=fn: fn(p["d"], p["u"], p["vv"], p["idx"], p["mask"], out.data_ptr(),
                                    g, a, k, L, h, stream))
    times = median_ms(*fns, fns[0])
    dev_ms = [profiled_device_ms(fn) for fn in fns]
    print("H (one call a sample; device alone): " + ", ".join(
        f"{n[2:]} {t:.4f} / {dv:.4f} ms" for n, t, dv in zip(names, times, dev_ms))
        + f", full again {times[-1]:.4f} ms")
    fnames = [n for n in ("H full", "H before") if n in libs]
    ffns = []
    for name in fnames:
        fn = libs[name].vis_vec_agg_fwd_f32
        fn.argtypes = build.SIGNATURES["vis_vec_agg_fwd_f32"]
        ffns.append(lambda fn=fn: fn(p["vec"], p["s1"], x["s1"].stride(2), p["s2m"], p["d"],
                                     p["idx"], p["mask"], agg.data_ptr(), g, a, k, L, h, stream))
    times = median_ms(*ffns)
    print("F (one call a sample; device alone): " + ", ".join(
        f"{n[2:]} build {t:.4f} / {profiled_device_ms(fn):.4f} ms"
        for n, t, fn in zip(fnames, times, ffns)))


def _time_m(libs, batch, dev) -> None:
    """M of each variant in bf16 at X = 64 and 192 (`pooled_m_rows`' inputs:
    h and tc 0 on the neighbours the 5 Å radius masks, dM random): 10 calls
    a sample (the variants in turns) and device time alone, beside the two
    `torch.bmm` calls that compute dh and dtc; whether the full kernel gives
    the bits of the one before."""
    mask = pooled_mask(batch)
    g, a, k = mask.shape
    s, f = g * a, 128
    gen = torch.Generator().manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    names = [n for n in libs if n.startswith("M")]
    for x in (64, 192):
        h = (torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]).bfloat16()
        tc = (torch.randn(g, a, k, x, generator=gen).to(dev) * mask[..., None]).bfloat16()
        dm = torch.randn(g, a, x, f, generator=gen).to(dev).bfloat16()
        outs = {n: (torch.empty_like(h), torch.empty_like(tc)) for n in names}
        fns = []
        for name in names:
            fn = libs[name].pooled_m_bwd_bf16
            fn.argtypes = (P, P, P, P, P, I64, I, I, I, P)
            dh, dtc = outs[name]
            fns.append(lambda fn=fn, dh=dh, dtc=dtc: fn(
                h.data_ptr(), tc.data_ptr(), dm.data_ptr(), dh.data_ptr(), dtc.data_ptr(), s, k,
                f, x, stream))
        dms = dm.view(s, x, f)
        fns.append(lambda: (torch.bmm(tc.view(s, k, x), dms),
                            torch.bmm(h.view(s, k, f), dms.transpose(1, 2))))
        times = median_ms(*fns, fns[0], iters=10, reps=10)
        dev_ms = [profiled_device_ms(fn) for fn in fns]
        print(f"M X={x} (10 calls a sample; device alone): " + ", ".join(
            f"{n} {t:.4f} / {dv:.4f} ms" for n, t, dv in
            zip(names + ["two torch.bmm"], times, dev_ms)) + f", M full again {times[-1]:.4f} ms")
        if "M before" in outs:
            fns[0](), fns[names.index("M before")]()
            same = all(torch.equal(u_, v_) for u_, v_ in zip(outs["M full"], outs["M before"]))
            print(f"M X={x}: the full kernel's dh and dtc are the bits of the one before: {same}")
        del h, tc, dm, outs, fns
        torch.cuda.empty_cache()

def _time_c(libs, batch, c_before_takes_z: bool = False) -> None:
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
    ws = torch.empty(fwd_workspace_floats(f), device=dev)
    b_fns = [lambda zp=zp: fwd(*inp[:4], None, *inp[4:], out.data_ptr(), zp, ws.data_ptr(), g, a,
                               k, f, 16, stream)
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
        zs = () if name == "C before" and not c_before_takes_z else (z.data_ptr(),)
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


def _time_b(libs, batch, b_before_masks: set) -> None:
    """B of each variant in case (a), no mask (every edge), and case (b), the
    model's pair_mask, serving (no z): one call a sample (the variants in
    turns), then device time alone; first each variant's error in case (b)
    against the plain version. A kernel of the earlier interface (no mask,
    no workspace) computes every edge in both cases, as the model called it
    (its dead edges then differ from the plain version's 0)."""
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import fused_edge_messages_plain

    gen = torch.Generator().manual_seed(1)
    args, pair_mask, _, _ = edge_mlp_inputs(batch, gen)
    g, a, f = args[0].shape
    k, dev = args[3].shape[-1], args[0].device
    inp = [t.data_ptr() for t in args]
    out = torch.empty(g, a, k, 16, device=dev)
    ws = torch.empty(fwd_workspace_floats(f), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    names = [n for n in libs if n.startswith("B")]
    fns = {"a": [], "b": []}
    for name in names:
        fn = libs[name].edge_mlp_fwd_f32
        if name in b_before_masks:
            fn.argtypes = build.SIGNATURES["edge_mlp_fwd_f32"]
            for case, m in (("a", None), ("b", pair_mask.data_ptr())):
                fns[case].append(lambda fn=fn, m=m: fn(*inp[:4], m, *inp[4:], out.data_ptr(), None,
                                                       ws.data_ptr(), g, a, k, f, 16, stream))
        else:  # the earlier interface
            fn.argtypes = (P,) * 10 + (I,) * 5 + (P,)
            for case in fns:
                fns[case].append(lambda fn=fn: fn(*inp, out.data_ptr(), None, g, a, k, f, 16,
                                                  stream))
    ref = fused_edge_messages_plain(*args, pair_mask)
    errs = []
    for fn in fns["b"]:  # each variant's error in case (b); some are wrong by design
        out.zero_()
        fn()
        errs.append(float(((out - ref).abs() - 1e-4 * ref.abs()).max()))
    print("B case (b), max(|d| − 1e-4·|ref|) against the plain version (B's gate: 1e-5): "
          + ", ".join(f"{n[2:]} {e:.2e}" for n, e in zip(names, errs)))
    del ref
    for case, cfns in fns.items():
        times = median_ms(*cfns, cfns[0])
        dev_ms = [profiled_device_ms(fn) for fn in cfns]
        print(f"B case ({case}) (one call a sample; device alone): " + ", ".join(
            f"{n[2:]} {t:.4f} / {dv:.4f} ms" for n, t, dv in zip(names, times, dev_ms))
            + f", full again {times[-1]:.4f} ms")


def _time_d(libs, batch) -> None:
    """D of each variant at both FAFormer sites, at dropout 0 and at the
    train step's 0.1: one call a sample, then device time alone. The
    tanh.approx variant is also held to D's gate (atol 1e-5 + rtol 1e-4
    against the plain version at dropout 0)."""
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import frame_swiglu_plain

    dev = torch.device("cuda")
    sm = batch.slot_mask.to(dev)
    pd = batch.pos.to(dev)[batch.slot_index.to(dev)] * sm[..., None]
    sites, _ = frame_swiglu_sites(pd, sm)
    gen = torch.Generator().manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    names = [n for n in libs if n.startswith("D")] + ["D full bf16"]
    thresh = int(round(0.1 * 2.0 ** 32))
    for site, x in sites.items():
        p, c = x.shape
        h = HIDDEN
        params = [((torch.rand(c, h, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
                  ((torch.rand(h, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
                  (1.0 + 0.2 * torch.randn(h // 2, generator=gen)).to(dev),
                  (0.1 * torch.randn(h // 2, generator=gen)).to(dev)]
        out = torch.empty(p, h // 2, device=dev)
        xb, outb = x.to(torch.bfloat16), torch.empty(p, h // 2, dtype=torch.bfloat16, device=dev)
        fns = {0: [], 1: []}
        for name in names:
            sfx = "bf16" if name.endswith("bf16") else "f32"
            fn = getattr(libs[name.removesuffix(" bf16")], f"frame_swiglu_fwd_{sfx}")
            fn.argtypes = build.SIGNATURES[f"frame_swiglu_fwd_{sfx}"]
            xi, oi = (xb, outb) if sfx == "bf16" else (x, out)
            for drop in fns:
                fns[drop].append(lambda fn=fn, drop=drop, xi=xi, oi=oi: fn(
                    xi.data_ptr(), *[t.data_ptr() for t in params], oi.data_ptr(), p, c, h, drop,
                    thresh if drop else 0, 1.0 / 0.9 if drop else 1.0, 7, stream))
        if "D tanh.approx sigmoid" in names:
            fns[0][names.index("D tanh.approx sigmoid")]()
            ref = frame_swiglu_plain(x, *params)
            diff = (out - ref).abs()
            ok = bool((diff <= 1e-5 + 1e-4 * ref.abs()).all())
            print(f"D {site} tanh.approx sigmoid against the plain version: max|d| "
                  f"{float(diff.max()):.3e}, D's gate (atol 1e-5, rtol 1e-4) "
                  f"{'met' if ok else 'MISSED'}")
            del ref, diff
        for drop, dfns in fns.items():
            times = median_ms(*dfns, dfns[0])
            dev_ms = [profiled_device_ms(fn) for fn in dfns]
            print(f"D {site} [P={p}, C={c}] dropout {0.1 if drop else 0} (one call a sample; "
                  f"device alone): " + ", ".join(f"{n[2:]} {t:.4f} / {dv:.4f} ms"
                                                 for n, t, dv in zip(names, times, dev_ms))
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
    names = [n for n in libs if n.startswith("E")] + ["E full bf16"]
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
        xb, dxb = x.to(torch.bfloat16), torch.empty(p, c, dtype=torch.bfloat16, device=dev)
        thresh = int(round(0.1 * 2.0 ** 32))
        fns = {case: [] for case in cases}
        for name in names:
            sfx = "bf16" if name.endswith("bf16") else "f32"
            lib, floats = libs[name.removesuffix(" bf16")], ctypes.c_int64()
            ws_fn = getattr(lib, f"frame_swiglu_bwd_workspace_{sfx}")
            ws_fn.argtypes = build.SIGNATURES[f"frame_swiglu_bwd_workspace_{sfx}"]
            ws_fn(p, c, h, ctypes.byref(floats))
            ws = torch.empty(floats.value, device=dev)
            fn = getattr(lib, f"frame_swiglu_bwd_{sfx}")
            fn.argtypes = build.SIGNATURES[f"frame_swiglu_bwd_{sfx}"]
            xi, dxi = (xb, dxb) if sfx == "bf16" else (x, dx)
            for case, (d, drop) in cases.items():
                di = d.to(torch.bfloat16) if sfx == "bf16" else d
                fns[case].append(lambda fn=fn, di=di, drop=drop, ws=ws, xi=xi, dxi=dxi: fn(
                    xi.data_ptr(), w1.data_ptr(), b1.data_ptr(), ls.data_ptr(), di.data_ptr(),
                    dxi.data_ptr(), dparams.data_ptr(), ws.data_ptr(), p, c, h, drop,
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
    parser.add_argument("--kernels", default="A,B,C,D,E,GI,GIb,H,J,K,L,M,Jb,Kb",
                        help="the kernels to ablate, of A, B, C, D, E, GI, GIb, H, J, K, L, M, "
                             "Jb and Kb (GIb: G and I in bf16; Jb, Kb: J and K in bf16)")
    parser.add_argument("--vis-mix-before", type=Path,
                        help="another vis_mix.cu whose G and I (f32 or bf16, and H) to time "
                             "beside this one's")
    parser.add_argument("--step",
                        help="a chip_smoke path (e.g. 'visnet_equihnns bf16') whose train step "
                             "chip_smoke.phase_step times and profiles, with this tree's kernels "
                             "and, with --vis-mix-before, with that vis_mix.cu in its place, "
                             "in turns: before, this, this, before")
    parser.add_argument("--pooled-m-before", type=Path,
                        help="another pooled_m.cu whose M to time beside this one's")
    parser.add_argument("--edge-mlp-before", type=Path,
                        help="another edge_mlp.cu whose B (and C) to time beside this one's")
    parser.add_argument("--pooled-conv-bf16-before", type=Path,
                        help="another pooled_conv_bf16.cu whose J and K to time beside this one's")
    parser.add_argument("--frame-swiglu-before", type=Path,
                        help="another frame_swiglu.cu whose D and E to time beside this one's")
    args = parser.parse_args()
    kinds = args.kernels.split(",")
    _KINDS.update(kinds)
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
                                 ("C", C_SRC, C_PATCHES), ("E", E_SRC, E_PATCHES),
                                 ("B", C_SRC, B_PATCHES), ("D", E_SRC, D_PATCHES),
                                 ("H", GI_SRC, H_PATCHES), ("M", L_SRC, M_PATCHES),
                                 ("Jb", JB_SRC, JB_PATCHES), ("Kb", JB_SRC, KB_PATCHES),
                                 ("GIb", GI_SRC, GIB_PATCHES)):
            if kind not in kinds:
                continue
            if kind in ("Jb", "Kb"):  # one build of the whole source serves both
                srcs["JKb full"] = src
            else:
                srcs[f"{kind} full"] = src
            for name, patches in table.items():
                srcs[f"{kind} {name}"] = _patched(src, patches, tmp / f"v{len(srcs)}.cu")
        b_masks = {n for n in srcs if n.startswith("B")}  # B variants that take a mask
        if "GI" in kinds and args.vis_mix_before:
            srcs["GI before"] = args.vis_mix_before
        if "GIb" in kinds and args.vis_mix_before:
            srcs["GIb before"] = args.vis_mix_before
        if "H" in kinds and args.vis_mix_before:
            srcs["H before"] = args.vis_mix_before
        if "M" in kinds and args.pooled_m_before:
            srcs["M before"] = args.pooled_m_before
        if ("Jb" in kinds or "Kb" in kinds) and args.pooled_conv_bf16_before:
            srcs["JKb before"] = args.pooled_conv_bf16_before
        if "B" in kinds and args.edge_mlp_before:
            srcs["B before"] = args.edge_mlp_before
            for name, patches in B_BEFORE_PATCHES.items():
                srcs[f"B {name}"] = _patched(args.edge_mlp_before, patches, tmp / f"v{len(srcs)}.cu")
                b_masks.add(f"B {name}")
        if "C" in kinds and args.edge_mlp_before:
            srcs["C before"] = args.edge_mlp_before
        if "D" in kinds and args.frame_swiglu_before:
            srcs["D before"] = args.frame_swiglu_before
        if "E" in kinds and args.frame_swiglu_before:
            srcs["E before"] = args.frame_swiglu_before
        libs = _build_all(tmp, srcs)
        batch = bench_batch()[1]
        if "A" in kinds:
            _time_a(libs, batch, dev)
        if "B" in kinds:
            _time_b(libs, batch, b_masks)
        if "C" in kinds:
            before = args.edge_mlp_before.read_text() if args.edge_mlp_before else ""
            _time_c(libs, batch, "const float* z, float* dui" in before)
        if "D" in kinds:
            _time_d(libs, batch)
        if "E" in kinds:
            _time_e(libs, batch)
        if "GI" in kinds:
            _time_gi(libs, batch)
        if "GIb" in kinds:
            _time_gib(libs, batch)
        if "H" in kinds:
            _time_h(libs, batch)
        if "M" in kinds:
            _time_m(libs, batch, dev)
        if "Jb" in kinds or "Kb" in kinds:
            _time_jkb(libs, batch, dev)
        _time_jkl(libs, batch, dev)
        if args.step:
            _time_steps(args.step, args.vis_mix_before, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
