#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`equihgnn_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each of which raises on failure (exit code 1, no
result line), each printing its seconds:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN,
   and cuBLAS's reduced-precision bf16 reductions off (the references sum
   in f32, as XLA does);
2. build: the CUDA kernels compiled from `equihgnn_tpu_torch/csrc/` (one
   nvcc per source, in parallel), and beside them `frame_swiglu.cu` once
   more with ptxas's report, whose f32 D and E instances must keep the
   parent commit's registers and spills (`FRAME_F32_PTXAS_BEFORE`);
3. kernels vs their plain PyTorch versions on the card, at the shapes of a
   batch of 768 synthetic molecules at hidden 256: kernel A (sorted
   segment sum; also at six edge cases at D = 256, each the same bits
   twice, and timed against `index_add_` one call a sample, 10 calls a
   sample and device time alone, with its host time a call), B (EGNN
   edge MLP forward) in three modes, serving with the model's pair_mask,
   training with it (z written) and no mask (every edge), each timed one
   call a sample and by device time alone (the same output bits with z as
   without, and at the live edges with the mask as without; 0 at every
   dead edge; its bounds over every edge and over the kept ones, its
   W1 products at the TF32 peak as its route runs them, and at the f32
   peak), C (its backward from B's z, seven gradients against
   autograd through the plain forward), D (FAFormer's frame-averaged
   SwiGLU forward, timed at dropout 0 and 0.1) and E (its backward, five
   gradients) at both FAFormer sites (EdgeModule P = 393,728, C = 4; FAFFN
   P = 24,608, C = 3; each site's times with its bounds); B and D with
   the special-function floor of their SiLUs and sigmoids (two operations
   each, 16 a clock an SM); C and E in case (a), an output gradient
   at every edge or position, and case (b), 0 where the model masks (the
   skip must give 0 there, the same bits twice), each timed one call a
   sample and by device time alone, with a live bound over the kept edges
   or positions; and D/E
   with dropout 0.1 at P = 24,608 (the same seed must give the same
   mask); F and H (ViSNet's vector aggregation and vector-rejection dot
   products) and their backwards G and I on the batch's k = 17
   neighbourhoods (self included, 5 Å) at L = 8, h = 256, with s1 a
   strided view as in ViS_MP (G and I one cluster of blocks a row; each of
   F-I also by its device time alone, and the same bits as the parent
   commit's f32 kernels, `F32_BEFORE`, where the inputs are the recorded
   run's), then F-I in bf16 (`vis_mix_bf16_rows`) at the same shapes
   against their plain bf16 versions within one bf16 ulp; J and K (the
   SE(3)-Transformer's fused pooled ConvSE3 unit, forward and backward) at
   its pooled sites (k = 16, F = 128, I = O = 256; C = 1 at three of the four, C = 3 at
   conv_in's 0 → 1), J and K with the sites that have a neighbour as
   `live` (as the model calls them) and without, against the plain
   versions (K's on dout · live, 0 at the dead sites) and, for J, the
   one `torch.einsum` call, with their route (3xTF32 on the tensor
   cores), their bounds at the TF32 and f32 peaks and K's time by
   kernel; L and M (the pooled-M build of the bf16 path's per-J pooled
   units, forward and backward) in bf16 at k = 16, F = 128, X = 64
   (three of the four units) and 192 (conv_in's 0 → 1), against the
   plain versions (M also +0 in every bit at the sites with no neighbour,
   where dM is random), each also by its device time alone, and, for L,
   one `torch.bmm` over the sites, for M two (dh = tc·dM, dtc = h·dMᵀ, a
   reference time only); then L in
   f32 at the recipe's C = 1 unit with its projection against J
   (recorded only); then A, B and C in bf16 (the bf16 paths' variants,
   `bf16_kernel_rows`) at the same shapes against their plain bf16
   versions, the same bits twice: A at the trunk's reduction and its edge
   cases within one bf16 ulp, timed against `index_add_` into f32 and a
   cast; B in its three modes within one ulp; C in cases (a) and (b)
   within two ulps past the bound of dz's rounding; each timed one call a
   sample and by device time alone, B's and C's products bound at the bf16
   peak; then D and E in bf16 (`frame_swiglu_bf16_rows`) at both FAFormer
   sites against their plain bf16 versions, out and dx within one bf16 ulp
   (dropout 0 and 0.1, cases (a) and (b), a bf16 mask probe against the f32
   plain version), the f32 D and E also against the parent commit's bits
   (`FRAME_F32_BEFORE`); then J and K in bf16 (`pooled_conv_bf16_rows`,
   the bf16 recipe's fused pooled units) at J's and K's f32 shapes, with
   the model's `live` and without, against their plain bf16 versions
   within one bf16 ulp (K's dh and dtc past the bound of dM's rounding),
   the same bits twice, +0 at the dead sites, timed one call a sample and
   by device time alone, J also against one bf16 `torch.einsum` call, their
   bounds at the bf16 peak; the f32 J and K also against the parent
   commit's bits (`PC_F32_BEFORE`); error, median time, allocation and the
   card's least time (`bound_ms`) of each;
then, for each path, `egnn_equihnns`, `faformer_equihnns`,
`visnet_equihnns`, `se3_transformer_equihnns` and `equiformer_equihnns`,
the MHNN family `mhnn`,
`mhnns` and `mhnnm`, and the encoders with the MHNN and MHNNM trunks
(`egnn_equihnn{,m}`, `faformer_equihnn{,m}`, `visnet_equihnn{,m}`), at the
bench recipe (hidden 256, 3 conv layers, output hidden 128 over 3 layers
(TrunkFull's output MLP: 256 wide over a 512-wide input), mean
aggregation, LayerNorm, relu, f32; the FAFormer: 2 layers, 2 heads, k = 16;
ViSNet: 6 layers, 8 heads, lmax 2, k = 17, 32 RBFs, cutoff 5 Å; the
SE(3)-Transformer: dim 256, 2 heads, depth 2, dim_head 32, degrees 0 and
1, k = 16 within 5 Å; the Equiformer: fibers (256, 256), 1 head, depth 1,
dim_head 48, MLP attention, k = 16 within 5 Å, no kernel of its own, its
zero-init output weights drawn nonzero wherever a phase compares, so that
its attention and feed-forward take part, `live_branches`), and
`se3_transformer_equihnns bf16`, the
SE(3)-Transformer with `--compute_dtype bfloat16` at the CLI's default
widths (hidden 64, output hidden 64 over 2 layers; its pooled units take
kernels L and M; trained on 4,800 molecules),
`se3_transformer_equihnns bf16 recipe` (the recipe with `--compute_dtype
bfloat16`: JAX's gate fuses its four pooled units at A = 32, kernels J and
K in bf16; the trunk's A in f32), `egnn_equihnns bf16` and `mhnns bf16` (the recipe with
`--compute_dtype bfloat16`: the EGNN and the trunk in bf16, kernels A, B
and C in bf16), `visnet_equihnns bf16` (ViSNet's layer loop in bf16,
kernels F-I in bf16, its readout and the trunk f32) and, served only (4),
`visnet_equihnn bf16` and `visnet_equihnnm bf16`, `faformer_equihnns bf16`
(the FAFormer and the trunk in bf16: kernels D, E and A in bf16) and, served
only, `faformer_equihnn bf16` and `faformer_equihnnm bf16`, the 2-D baselines `gin`,
`gcn`, `gat` and `gatv2` at ModelConfig's gnn_* widths (5 layers, 300
wide, JK "last", mean pooling, dropout 0; GAT: 4 heads averaged), and `egnn_equihnns cross-molecule`
(the recipe with `cross_molecule_knn=True`: EGNN's flat path, a batch-wide
kNN), with random weights from a seed:
4. serve: saved as a port checkpoint, served through
   `equihgnn_tpu_torch.predict.run` on `datasets/real_sample/sample.sdf`
   (the bf16 paths with `--compute_dtype bfloat16`) and checked against
   the CPU molecule by molecule; then one request of
   768 synthetic molecules through the same library path. The kernels'
   launch counters must show that both requests ran through the model's
   kernels (egnn: A 3x and B per forward; faformer: A 3x and D 5x;
   visnet: A 3x, F 6x, H 5x; se3: A 3x, J 4x; se3 bf16: A 3x, L 4x; se3
   bf16 recipe: A 3x, J 4x, also on the bf16 counter, no L;
   egnn bf16: A 3x and B, mhnns bf16: A 3x, each also on the wrapper's
   bf16 counter (`launches_bf16`, which the f32 paths must leave at 0);
   visnet bf16 and its hybrids: F 6x and H 5x, each also on the bf16
   counter, A 3x in f32; faformer bf16 and its hybrids: A 3x and D 5x, each
   also on the bf16 counter; the
   MHNN family and equiformer: A 3x; a hybrid: its encoder's, and A 3x; the
   cross-molecule path: A 3x and no B, JAX's flat EGNN being unfused); a
   2-D baseline serves the SDF and a SMILES file the script writes from
   `SMILES` (its last line does not parse: a nan row), each on the card
   and the CPU within rtol 1e-4 / atol 1e-5, benzene's two rows equal,
   and the batch-768 request of plain graphs, with no kernel launched; the
   bf16 paths are held instead to their CPU runs (BF16_SERVE_SHARE of the CPU's
   bf16-vs-f32 distance), its distance from the f32 model at the same
   weights on the card recorded;
5. gradients: one train step's parameter gradients at full width on 32
   molecules (eval mode: no dropout), on the card (kernels) against the
   CPU (plain versions) with the card's pattern of ReLU signs; every
   parameter the CPU reaches must be reached on the card (the bf16 paths:
   against their CPU bf16 runs, as relative L2 over all parameters, a step
   and the encoder under a smooth loss, BF16_GRAD_SHARE; se3 bf16 recipe
   with its attention queries scaled by GRAD_QUERY_SCALE); a hybrid takes
   16 molecules and checks the step only: its encoder alone is held on
   its `*_equihnns` path; a 2-D baseline takes 64 molecules, the CPU run
   taking the card's ReLU and LeakyReLU signs, every parameter reached on
   both, no kernel launched; the f32 paths' CPU references that need no
   card (`grads_cpu_refs`) run from the kernels phase on in a worker
   process (CPU_WORKER_THREADS threads), beside the card's phases, and
   stopped while the host times anything (`host_quiet`: every timing
   function, the served SDF request, the train and step phases); these
   f32 gradient phases run after every path's other phases;
6. train: `equihgnn_tpu_torch.main.run` on `synthetic_hg_3d` (the MHNN
   family: `synthetic_hg`, which has no coordinates; the 2-D baselines:
   `synthetic_g`, plain graphs) at the recipe, batch
   768, 3 epochs of ~10 steps (the hybrids, gcn, gat and gatv2 and se3
   bf16: ~5, on 4,800 molecules), a
   learnable target, into a temporary log directory, at lr 1e-3 (visnet's
   paths 1e-4: it diverges at 5e-4 in both frameworks). Every train loss
   finite and the last below the first; the launch counters show the
   model's kernels on every train step (egnn: A 3x, B, C; faformer: A 3x,
   D 5x, E 4x; visnet: A 3x, F 6x, H 5x, G 6x, I 5x; se3: A 3x, J 4x, K 4x;
   se3 bf16: A 3x, L 8x, M 4x; se3 bf16 recipe: A 3x, J 4x, K 4x, J and
   K also on the bf16 counters; visnet bf16: as visnet, F-I on the bf16
   counters too; faformer bf16: as faformer, A, D and E on the bf16
   counters too; the MHNN family and equiformer: A 3x; a
   hybrid: its encoder's; the 2-D baselines: none) and every eval forward;
   `ckpt_best.pt` serves through `predict.run --device cuda`; the
   cross-molecule path has no train phase (neither CLI sets the flag);
7. step: one train step at batch 768 (forward + backward + Adam): its
   launches, median device time (and the eval forward's), peak memory and a
   `torch.profiler` table
   of its top device kernels; for egnn and faformer, in one more step, the
   share of kernel C's dm and kernel E's dout rows that are exactly 0,
   beside the rows the model masks (egnn's dm must be 0 on every masked
   edge); for egnn bf16, the kNN on the batch's bf16 positions on the card
   and the CPU: the slots whose neighbour set differs (recorded);
8. remat (the encoder paths, se3 bf16, se3 bf16 recipe, egnn bf16, visnet
   bf16 and faformer bf16): one
   train step with `remat=True` against the same step without it on the
   card, training mode, the gradient phase's molecules; the remat step's launches (the
   encoder's kernels again in its backward: egnn B, faformer D 5x, visnet
   F 6x and H 5x, se3 J 4x, se3 bf16 L 4x, se3 bf16 recipe J 4x in bf16,
   egnn bf16 B more, faformer bf16 D 5x more); the steps
   with PyTorch's deterministic algorithms (`index_add_` in a fixed order,
   not with atomics); each gradient within 1e-5 of its max plus twice the
   card's own change between two plain steps; for se3 and equiformer, the
   batch-768 step's time and peak memory with and without remat
   (recorded).

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
that move least (fewer on the slower paths, GRAD_CUT).

The second-to-last line is `{"kernels": [...]}`, the last
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import dataclasses
import functools
import hashlib
import json
import math
import multiprocessing
import os
import re
import signal
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
# the encoders with the MHNNS trunk; the MHNN family (the atom embedding, then
# the TrunkFull, TrunkS or TrunkM trunk); the encoders with TrunkFull and TrunkM
ENCODER_METHODS = ("egnn_equihnns", "faformer_equihnns", "visnet_equihnns",
                   "se3_transformer_equihnns", "equiformer_equihnns")
MHNN_METHODS = ("mhnn", "mhnns", "mhnnm")
HYBRID_METHODS = ("egnn_equihnn", "egnn_equihnnm", "faformer_equihnn", "faformer_equihnnm",
                  "visnet_equihnn", "visnet_equihnnm")
METHODS = ENCODER_METHODS + MHNN_METHODS + HYBRID_METHODS
# the 2-D baselines on plain graphs, at ModelConfig's gnn_* widths (5 layers, 300
# wide, JK "last", mean pooling, dropout 0), which neither CLI can change
GRAPH_METHODS = ("gin", "gcn", "gat", "gatv2")
# se3_transformer_equihnns --compute_dtype bfloat16 at the CLI's default widths
# (`equihgnn_tpu/main.py:62-64`), where JAX's fused pooled unit refuses O = 64
BF16_PATH = "se3_transformer_equihnns bf16"
# egnn_equihnns and mhnns with --compute_dtype bfloat16 at the recipe: the
# EGNN encoder and the trunk in bf16 (kernels A, B and C in bf16)
EGNN_BF16, MHNNS_BF16 = "egnn_equihnns bf16", "mhnns bf16"
BF16_HYPER_PATHS = (EGNN_BF16, MHNNS_BF16)
# the ViSNet models with --compute_dtype bfloat16 at the recipe: ViSNet's layer
# loop in bf16 (kernels F-I in bf16), its readout and the trunk in f32; the two
# hybrids are served only (their encoder is held on the visnet_equihnns path)
VISNET_BF16 = "visnet_equihnns bf16"
VISNET_HYBRIDS_BF16 = ("visnet_equihnn bf16", "visnet_equihnnm bf16")
# the FAFormer models with --compute_dtype bfloat16 at the recipe: the FAFormer
# and the trunk in bf16 (kernels D and E in bf16, the trunk's A in bf16); the two
# hybrids are served only (their encoder is held on the faformer_equihnns path)
FAFORMER_BF16 = "faformer_equihnns bf16"
FAFORMER_HYBRIDS_BF16 = ("faformer_equihnn bf16", "faformer_equihnnm bf16")
# se3_transformer_equihnns with --compute_dtype bfloat16 at the recipe (hidden
# 256): JAX's gate fuses its four pooled units at A = 32 (kernels J and K in bf16)
SE3_BF16 = "se3_transformer_equihnns bf16 recipe"
SERVE_ONLY = VISNET_HYBRIDS_BF16 + FAFORMER_HYBRIDS_BF16
# egnn_equihnns with the reference's batch-as-one-point-cloud kNN
# (cross_molecule_knn=True): EGNN's flat path, JAX's unfused edge MLP (no kernel B)
CROSS_PATH = "egnn_equihnns cross-molecule"
# path → (method, its config's changes to the recipe)
PATHS = {**{m: (m, {}) for m in METHODS},
         BF16_PATH: ("se3_transformer_equihnns", dict(mlp_hidden=64, output_hidden=64,
                                                      output_num_layers=2,
                                                      compute_dtype="bfloat16")),
         EGNN_BF16: ("egnn_equihnns", dict(compute_dtype="bfloat16")),
         MHNNS_BF16: ("mhnns", dict(compute_dtype="bfloat16")),
         SE3_BF16: ("se3_transformer_equihnns", dict(compute_dtype="bfloat16")),
         **{p: (p.removesuffix(" bf16"), dict(compute_dtype="bfloat16"))
            for p in (VISNET_BF16, *VISNET_HYBRIDS_BF16, FAFORMER_BF16,
                      *FAFORMER_HYBRIDS_BF16)},
         **{m: (m, {}) for m in GRAPH_METHODS},
         CROSS_PATH: ("egnn_equihnns", dict(cross_molecule_knn=True))}
# SMILES served by the 2-D paths (one a line; the last does not parse: a nan row)
SMILES = ("C", "CC", "C=C", "C#C", "c1ccccc1", "Cc1ccccc1", "C=Cc1ccccc1", "c1ccc(cc1)-c1ccccc1",
          "c1ccc2ccccc2c1", "c1ccncc1", "c1ccoc1", "C=CC=C", "NC=O", "CC(=O)C", "CC(=O)O",
          "C=CC#N", "Fc1ccccc1", "Nc1ccccc1", "Oc1ccccc1", "c1cc[nH]c1", "CC(=O)[O-].[Na+]",
          "C1CCC")
# kernel launches per forward and per backward of each path's train step
FWD_LAUNCHES = {
    "egnn_equihnns": {"sorted_segment_sum": 3, "fused_edge_messages": 1},
    # 3 EdgeModules + 2 FAFFNs
    "faformer_equihnns": {"sorted_segment_sum": 3, "fused_frame_swiglu": 5},
    # 6 ViS_MP layers, the last without the edge update
    "visnet_equihnns": {"sorted_segment_sum": 3, "vis_vec_agg": 6, "vis_wdot": 5},
    # the pooled units: conv_in 0 → 0 and 0 → 1, conv_out 0 → 0 and 1 → 0
    "se3_transformer_equihnns": {"sorted_segment_sum": 3, "pooled_conv": 4},
    # the same four units, each a per-J step through kernel L
    BF16_PATH: {"sorted_segment_sum": 3, "pooled_m": 4},
    # the same four units fused, J in bf16; the encoder's output is f32: A in f32
    SE3_BF16: {"sorted_segment_sum": 3, "pooled_conv": 4, "pooled_conv bf16": 4},
    # the Equiformer runs no kernel (JAX computes it with XLA einsums)
    "equiformer_equihnns": {"sorted_segment_sum": 3},
    # bf16: each launch counts on the wrapper's counter and on its bf16 one
    EGNN_BF16: {"sorted_segment_sum": 3, "sorted_segment_sum bf16": 3,
                "fused_edge_messages": 1, "fused_edge_messages bf16": 1},
    MHNNS_BF16: {"sorted_segment_sum": 3, "sorted_segment_sum bf16": 3},
    # the trunk reads ViSNet's f32 readout: A in f32
    VISNET_BF16: {"sorted_segment_sum": 3, "vis_vec_agg": 6, "vis_vec_agg bf16": 6,
                  "vis_wdot": 5, "vis_wdot bf16": 5},
    # FAFormer's output is bf16: the trunk's A in bf16
    FAFORMER_BF16: {"sorted_segment_sum": 3, "sorted_segment_sum bf16": 3,
                    "fused_frame_swiglu": 5, "fused_frame_swiglu bf16": 5},
}
BWD_LAUNCHES = {
    "egnn_equihnns": {"fused_edge_messages_bwd": 1},
    # the last layer's EdgeModule feeds nothing that reaches the loss
    "faformer_equihnns": {"fused_frame_swiglu_bwd": 4},
    "visnet_equihnns": {"vis_vec_agg_bwd": 6, "vis_wdot_bwd": 5},
    # all four reach the loss (conv_in's through the AtomEncoder)
    "se3_transformer_equihnns": {"pooled_conv_bwd": 4},
    # kernel M, and L again where the checkpointed step is recomputed
    BF16_PATH: {"pooled_m": 4, "pooled_m_bwd": 4},
    # kernel K in bf16; the fused unit has no checkpoint: J does not run again
    SE3_BF16: {"pooled_conv_bwd": 4, "pooled_conv_bwd bf16": 4},
    "equiformer_equihnns": {},
    EGNN_BF16: {"fused_edge_messages_bwd": 1, "fused_edge_messages_bwd bf16": 1},
    MHNNS_BF16: {},
    VISNET_BF16: {"vis_vec_agg_bwd": 6, "vis_vec_agg_bwd bf16": 6, "vis_wdot_bwd": 5,
                  "vis_wdot_bwd bf16": 5},
    FAFORMER_BF16: {"fused_frame_swiglu_bwd": 4, "fused_frame_swiglu_bwd bf16": 4},
}
# each hybrid's encoder, whose *_equihnns path it shares its encoder's kernels with
ENCODER_OF = {m: m.removesuffix("m") + "s" for m in HYBRID_METHODS}
# every MHNNConv and MHNNSConv trunk runs kernel A on its 3 V→E reductions; the
# MHNN family runs no other kernel and has no kernel in its backward
for _m in MHNN_METHODS:
    FWD_LAUNCHES[_m], BWD_LAUNCHES[_m] = {"sorted_segment_sum": 3}, {}
for _m, _enc in ENCODER_OF.items():
    FWD_LAUNCHES[_m], BWD_LAUNCHES[_m] = dict(FWD_LAUNCHES[_enc]), dict(BWD_LAUNCHES[_enc])
# the 2-D baselines run no kernel (JAX reduces them with jax.ops.segment_*); the
# flat EGNN path runs the trunk's kernel A only
for _m in GRAPH_METHODS:
    FWD_LAUNCHES[_m], BWD_LAUNCHES[_m] = {}, {}
FWD_LAUNCHES[CROSS_PATH], BWD_LAUNCHES[CROSS_PATH] = {"sorted_segment_sum": 3}, {}
# TrunkFull and TrunkM cast their hyperedge embedding to bf16; their first
# concatenation with ViSNet's f32 output promotes it: A in f32
for _p in VISNET_HYBRIDS_BF16:
    FWD_LAUNCHES[_p], BWD_LAUNCHES[_p] = dict(FWD_LAUNCHES[VISNET_BF16]), \
        dict(BWD_LAUNCHES[VISNET_BF16])
# with FAFormer's bf16 output the concatenations stay bf16: A in bf16
for _p in FAFORMER_HYBRIDS_BF16:
    FWD_LAUNCHES[_p], BWD_LAUNCHES[_p] = dict(FWD_LAUNCHES[FAFORMER_BF16]), \
        dict(BWD_LAUNCHES[FAFORMER_BF16])
LR = {"visnet_equihnns": "1e-4", "visnet_equihnn": "1e-4",
      "visnet_equihnnm": "1e-4"}  # the others train at 1e-3
# the MHNN family trains on the coordinate-free set, as users of those models do
TRAIN_DATA = {**dict.fromkeys(MHNN_METHODS, "synthetic_hg"),
              **dict.fromkeys(GRAPH_METHODS, "synthetic_g")}  # the others: synthetic_hg_3d
# the hybrids' encoders and kernels are held at full size by their *_equihnns
# paths, so they train on 4,800 molecules (5 steps an epoch), not 9,600 (10)
TRAIN_SIZE = dict.fromkeys(HYBRID_METHODS, "4800")  # the others: 9600
# gin, the slice's full-width path, trains on 9,600 molecules; gcn, gat and
# gatv2 share its data path and CLI, and take 4,800
TRAIN_SIZE.update(dict.fromkeys(GRAPH_METHODS[1:], "4800"))
# the hidden-64 bf16 SE(3)-Transformer takes 4,800 (the script's time limit)
TRAIN_SIZE[BF16_PATH] = "4800"
# the H100 SXM's published peaks: HBM3 bandwidth, dense f32, TF32 and bf16 rates
PEAK_BYTES_S, PEAK_F32_S, PEAK_TF32_S, PEAK_BF16_S = 3.35e12, 67e12, 495e12, 989e12
SFU_OPS_CLK = 16  # special-function operations (ex2, rcp) an H100 SM issues a clock
# kernels J's and K's route: their products on the tensor cores in 3xTF32
# (three TF32 products for each f32 one), `csrc/tf32_mma.cuh`
TF32_ROUTE = "3xTF32 (mma.sync.m16n8k8 tensor cores)"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def bench_batch():
    """(samples, batch): the BATCH synthetic molecules of every phase, seed 0,
    and their one padded batch with positions."""
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset

    samples = make_synthetic_dataset(BATCH, seed=0, num_targets=1)
    return samples, next(iter_batches(samples, spec_for_samples(samples, BATCH), with_pos=True))


def graph_samples():
    """The BATCH synthetic molecules of the 2-D paths, seed 0, as plain
    graphs without coordinates (`synthetic_g`'s kind)."""
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(BATCH, seed=0, hyper=False, with_pos=False, num_targets=1)


def pooled_mask(batch) -> torch.Tensor:
    """The neighbour mask [G, A, k] the SE(3)-Transformer's pooled units see,
    on the card: each slot's 16 nearest (fewer in a narrow batch) within 5 Å."""
    from equihgnn_tpu_torch.ops.knn import knn_dense

    dev = torch.device("cuda")
    sm = batch.slot_mask.to(dev)
    pd = batch.pos.to(dev)[batch.slot_index.to(dev)] * sm[..., None]
    _, mask, _ = knn_dense(pd, sm, min(16, sm.shape[1] - 1), valid_radius=5.0, exclude_self=True)
    return mask


# The CPU worker process of `main` (a future of its pid), stopped while the
# host times the card, so that no timed reading shares the host with it.
_WORKER = {"pid": None, "depth": 0}


@contextlib.contextmanager
def host_quiet():
    """Stops the CPU worker (SIGSTOP) for the block and lets it go on
    (SIGCONT) after; nested blocks stop it once."""
    pid = _WORKER["pid"].result() if _WORKER["pid"] is not None else None
    if pid is not None and _WORKER["depth"] == 0:
        os.kill(pid, signal.SIGSTOP)
    _WORKER["depth"] += 1
    try:
        yield
    finally:
        _WORKER["depth"] -= 1
        if pid is not None and _WORKER["depth"] == 0:
            os.kill(pid, signal.SIGCONT)


def quiet(fn):
    """`fn` run under `host_quiet`: every timing function and timed phase."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with host_quiet():
            return fn(*args, **kw)
    return run


@quiet
def median_ms(*fns, iters: int = 20, warmup_s: float = 0.3, reps: int = 1) -> list[float]:
    """Median device time in ms of each of `fns`, from CUDA events around
    each call. The card first runs `warmup_s` seconds of the same work, so
    that it leaves its idle clocks, and the functions then alternate call by
    call, so that a clock change affects each of them alike. With reps > 1 a
    sample is `reps` calls back to back, and gives their mean: there the
    host's work for a call overlaps the card's for the one before, which for
    calls of a fraction of a millisecond would otherwise be timed as well."""
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
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / reps)
    return [float(np.median(ts)) for ts in times]


PORT_KERNEL = "void (anonymous namespace)::"  # how the profiler names a csrc kernel


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


@quiet
def kernel_split(fn, calls: int = 3) -> dict[str, float]:
    """Device ms a launch of each kernel `fn` launches once a call
    (torch.profiler over `calls` calls), by the kernel's name without its
    template arguments and parameters. The mean over the launches the
    profiler recorded: it can drop a kernel's event in a long run, which a
    total over `calls` would count as 0."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or not evt.count:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        name = evt.key.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0].split("<")[0].split("::")[-1]
        split[name] = split.get(name, 0.0) + t / 1e3 / evt.count
    return split


@quiet
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


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_S, f32_flops: float = 0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type (f32 by default; with
    `f32_flops`, those at the f32 peak added to `flops` at `peak`),
    whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (flops / peak + f32_flops / PEAK_F32_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@functools.cache
def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def sfu_floor_ms(values: int, ops_each: int = 2) -> float:
    """The least time the special-function pipe takes for `values` SiLUs or
    sigmoids of `ops_each` operations each (ex2 and a reciprocal): an SM
    issues SFU_OPS_CLK of them a clock, at the card's highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return values * ops_each / (SFU_OPS_CLK * sms * sm_clock_hz()) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def alloc_mib(fn) -> float:
    """MiB a call of `fn` allocates at its peak, above what was allocated."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False; "
          "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False")
    return name, smi


def phase_build() -> None:
    import equihgnn_tpu_torch
    from equihgnn_tpu_torch.ops.kernels import build

    pkg = os.path.dirname(os.path.abspath(equihgnn_tpu_torch.__file__))
    check(pkg == os.path.join(ROOT, "equihgnn_tpu_torch"),
          f"equihgnn_tpu_torch imported from {pkg}, not from this checkout")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "frame_swiglu.o"), str(build.CSRC_DIR / "frame_swiglu.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        build.library()
        ptxas = report.communicate()[1]
    seconds = time.perf_counter() - t0
    check(report.returncode == 0, f"nvcc -Xptxas -v failed on frame_swiglu.cu:\n{ptxas}")
    print(f"build: {seconds:.2f} s, nvcc {' '.join(build.NVCC_FLAGS)} "
          f"-> {build.library_path().name} from {[s.name for s in build.sources()]}")
    check_frame_swiglu_f32_ptxas(ptxas)


# ptxas's report of the f32 kernels D ("fwd") and E ("bwd") of the parent
# commit 1723ae6 at the flags of `build.NVCC_FLAGS`, by (C, CPL): registers,
# stack frame, spill stores and spill loads (bytes). The f32 D and E of
# this commit's source are the parent's bodies, instantiated for float
# beside the bf16 ones, and must keep them.
FRAME_F32_PTXAS_BEFORE = {
    ("fwd", 4, 8): (255, 0, 0, 0), ("fwd", 4, 4): (128, 0, 0, 0),
    ("fwd", 4, 2): (120, 0, 0, 0), ("fwd", 4, 1): (64, 0, 0, 0),
    ("fwd", 3, 8): (255, 0, 0, 0), ("fwd", 3, 4): (128, 0, 0, 0),
    ("fwd", 3, 2): (107, 0, 0, 0), ("fwd", 3, 1): (64, 0, 0, 0),
    ("bwd", 4, 8): (254, 0, 0, 0), ("bwd", 4, 4): (128, 56, 56, 56),
    ("bwd", 4, 2): (80, 0, 0, 0), ("bwd", 4, 1): (91, 0, 0, 0),
    ("bwd", 3, 8): (255, 0, 0, 0), ("bwd", 3, 4): (128, 16, 12, 12),
    ("bwd", 3, 2): (80, 0, 0, 0), ("bwd", 3, 1): (95, 0, 0, 0),
}


def ptxas_usage(report: str, kernel: str) -> dict[tuple, tuple[str, tuple[int, ...]]]:
    """(fwd/bwd, C, CPL) → (element type, (registers, stack frame, spill
    stores, spill loads)) of each instance of `kernel` in a ptxas -v report:
    "f" or "13__nv_bfloat16", from the mangled name."""
    lines, out = report.splitlines(), {}
    name = re.compile(rf"{kernel}_(fwd|bwd)_kernelILi(\d+)ELi(\d+)E(\w+?)EEv")
    for i, line in enumerate(lines):
        m = name.search(line)
        if "Compiling entry function" not in line or not m:
            continue
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", info)
        check(regs is not None and spill is not None, f"no ptxas usage for {m.group(0)}")
        key = (m.group(1), int(m.group(2)), int(m.group(3)))
        out.setdefault(m.group(4), {})[key] = (int(regs.group(1)), *map(int, spill.groups()))
    return out


def check_frame_swiglu_f32_ptxas(report: str) -> None:
    usage = ptxas_usage(report, "frame_swiglu")
    for dtype, table in sorted(usage.items()):
        print(f"ptxas, frame_swiglu.cu {dtype} instances (registers, stack, spill stores, spill "
              f"loads): " + ", ".join(f"{k[0]} C={k[1]} CPL={k[2]} {v}"
                                      for k, v in sorted(table.items())))
    f32 = usage.get("f", {})
    check(f32 == FRAME_F32_PTXAS_BEFORE,
          f"the f32 D/E instances' registers or spills differ from the parent commit's: "
          f"{ {k: (f32.get(k), v) for k, v in FRAME_F32_PTXAS_BEFORE.items() if f32.get(k) != v} }")
    print("ptxas: the f32 D and E instances keep the parent commit's registers and spills")


def counters() -> dict:
    """name → (the launch-counted wrapper of a kernel, its counter's
    attribute): `launches` of every wrapper, in any dtype, and beside it
    `launches_bf16` of the wrappers of A-K, the bf16 launches alone (named
    "<wrapper> bf16")."""
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
        fused_edge_messages,
        fused_edge_messages_bwd,
    )
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
        fused_frame_swiglu,
        fused_frame_swiglu_bwd,
    )
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import pooled_conv, pooled_conv_bwd
    from equihgnn_tpu_torch.ops.kernels.pooled_m import pooled_m, pooled_m_bwd
    from equihgnn_tpu_torch.ops.kernels.segment_sum import sorted_segment_sum
    from equihgnn_tpu_torch.ops.kernels.vis_mix import (
        vis_vec_agg,
        vis_vec_agg_bwd,
        vis_wdot,
        vis_wdot_bwd,
    )

    fns = {"sorted_segment_sum": sorted_segment_sum,
           "fused_edge_messages": fused_edge_messages,
           "fused_edge_messages_bwd": fused_edge_messages_bwd,
           "fused_frame_swiglu": fused_frame_swiglu,
           "fused_frame_swiglu_bwd": fused_frame_swiglu_bwd,
           "vis_vec_agg": vis_vec_agg, "vis_vec_agg_bwd": vis_vec_agg_bwd,
           "vis_wdot": vis_wdot, "vis_wdot_bwd": vis_wdot_bwd,
           "pooled_conv": pooled_conv, "pooled_conv_bwd": pooled_conv_bwd,
           "pooled_m": pooled_m, "pooled_m_bwd": pooled_m_bwd}
    out = {name: (fn, "launches") for name, fn in fns.items()}
    for name in ("sorted_segment_sum", "fused_edge_messages", "fused_edge_messages_bwd",
                 "fused_frame_swiglu", "fused_frame_swiglu_bwd", "vis_vec_agg",
                 "vis_vec_agg_bwd", "vis_wdot", "vis_wdot_bwd", "pooled_conv",
                 "pooled_conv_bwd"):
        out[f"{name} bf16"] = (fns[name], "launches_bf16")
    return out


def expected_launches(path: str, forwards: int, backwards: int,
                      remat: bool = False) -> dict[str, int]:
    """Each kernel's launches over `forwards` forwards and `backwards`
    backward passes of `path`. With `remat` the checkpointed encoder's
    forward runs again in each backward pass: its kernels (all but the
    trunk's A) launch again there."""
    want = dict.fromkeys(counters(), 0)
    for name, n in FWD_LAUNCHES[path].items():
        want[name] += n * forwards
        if remat and not name.startswith("sorted_segment_sum"):
            want[name] += n * backwards
    for name, n in BWD_LAUNCHES[path].items():
        want[name] += n * backwards
    return want


def reset_launches() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def phase_kernels(batch) -> list[dict]:
    from equihgnn_tpu_torch.ops.kernels.segment_sum import (
        _launch,
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows = []

    # kernel A at the hyperedge-direction reduction of the trunk, then at its
    # edge cases (D = 256), each against the plain version and twice
    ids = batch.hedge_idx.to(dev)
    m, s = ids.shape[0], batch.num_hedges
    data = torch.randn(m, HIDDEN, generator=gen).to(dev)
    err = segment_sum_case("the batch's hedge_idx", data, ids, s)
    for name, (case_ids, case_s) in segment_sum_cases(gen).items():
        case_data = torch.randn(case_ids.shape[0], HIDDEN, generator=gen).to(dev)
        segment_sum_case(name, case_data, case_ids.to(dev), case_s)
    # The kernel's launch alone (no autograd dispatch in the timed window)
    # against the one PyTorch call that computes the same sum, `index_add_`
    # into zeros allocated once (the plain version adds its allocation and
    # the masking of ids outside [0, S)), under three methods: one call a
    # sample, samples of 10 calls back to back (the host's work for a call
    # overlaps the card's for the one before), and the device's kernel time
    # alone (torch.profiler, 20 calls)
    zeros = torch.zeros(s, HIDDEN, device=dev)
    fns = (lambda: _launch(data, ids, s), lambda: zeros.index_add_(0, ids, data),
           lambda: sorted_segment_sum(data, ids, s), lambda: sorted_segment_sum_plain(data, ids, s))
    ms, library_ms, wrapper_ms, plain_ms = median_ms(*fns)
    ms10, library_ms10 = median_ms(*fns[:2], reps=10)
    dev_ms, dev_library_ms = (profiled_device_ms(fn) for fn in fns[:2])
    host_us = host_us_per_call(fns[0])
    print(f"kernel A vs index_add_ (median of 20 samples, CUDA events): one call a sample "
          f"{ms:.4f} vs {library_ms:.4f} ms, 10 calls a sample {ms10:.4f} vs {library_ms10:.4f} "
          f"ms; device kernels alone (torch.profiler, 20 calls) {dev_ms:.4f} vs "
          f"{dev_library_ms:.4f} ms; the wrapper (autograd.Function) {wrapper_ms:.4f} ms, the "
          f"plain version {plain_ms:.4f} ms; the launch's host work alone {host_us:.1f} µs a call "
          f"(enqueue, no sync)")
    for what, a_ms, lib_ms in (("one call", ms, library_ms), ("10 calls", ms10, library_ms10),
                               ("device alone", dev_ms, dev_library_ms)):
        print(f"  kernel A {what}: {a_ms / lib_ms:.3f}x index_add_'s time "
              f"({'no slower' if a_ms <= lib_ms else 'SLOWER'})")
    rows.append(dict(
        name="sorted_segment_sum", route="cuda",
        source="equihgnn_tpu_torch/csrc/segment_sum.cu",
        replaces="equihgnn_tpu/ops/pallas/segment_sum.py:92",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(nbytes(data, ids, zeros), m * HIDDEN),
    ))

    args, pair_mask, pd, sm = edge_mlp_inputs(batch, gen)
    rows += edge_mlp_rows(args, pair_mask, gen)
    rows += bf16_kernel_rows(batch, args, pair_mask, gen)
    rows += frame_swiglu_rows(pd, sm, gen)
    check_frame_swiglu_f32_bits()
    rows += frame_swiglu_bf16_rows(pd, sm, gen)
    rows += vis_mix_rows(batch)
    rows += vis_mix_bf16_rows(batch)
    rows += pooled_conv_rows(batch, gen)
    check_pooled_conv_f32_bits()
    rows += pooled_conv_bf16_rows(batch, gen)
    rows += pooled_m_rows(batch, gen)
    for row in rows:
        print(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} (median, the two "
              f"alternating, CUDA events; D and E at the EdgeModule site, J and K at C = 1, "
              f"L and M at X = 64, over 10 calls back to back)")
    return rows


def edge_mlp_inputs(batch, gen):
    """Kernels B's and C's inputs on the card at the EGNN layer's shapes of
    the batch: its slot view's k = 16 neighbourhoods (within each molecule)
    and their squared distances, random u and weights at the width 256
    (F = 1026, m = 16). Returns (args, pair_mask, pd, sm): pair_mask the
    neighbours the model keeps, pd and sm the slot view's positions and
    mask."""
    from equihgnn_tpu_torch.ops.knn import knn_dense

    dev = torch.device("cuda")
    sm = batch.slot_mask.to(dev)
    pd = batch.pos.to(dev)[batch.slot_index.to(dev)] * sm[..., None]
    nbr_idx, pair_mask, _ = knn_dense(pd, sm, 16, slot_gid=batch.slot_gid.to(dev))
    r = torch.arange(pd.shape[0], device=dev)[:, None, None]
    rel = pd[:, :, None, :] - pd[r, nbr_idx]
    dist = torch.sum(rel * rel, dim=-1)
    g, a, k = nbr_idx.shape
    f, mo = 2 * (2 * HIDDEN + 1), 16
    ui = torch.randn(g, a, f, generator=gen).to(dev)
    ujn = torch.randn(g, a, f, generator=gen).to(dev)
    wd, b0 = (0.1 * torch.randn(f, generator=gen)).to(dev), (0.1 * torch.randn(f, generator=gen)).to(dev)
    w1, b1 = (0.1 * torch.randn(f, mo, generator=gen)).to(dev), (0.1 * torch.randn(mo, generator=gen)).to(dev)
    return (ui, ujn, dist, nbr_idx, wd, b0, w1, b1), pair_mask, pd, sm


def edge_mlp_rows(args, pair_mask, gen) -> list[dict]:
    """Kernel B in three modes: serving with the model's pair_mask (out
    only), training with it (z written too) and with no mask (every edge):
    each within atol 1e-5 + rtol 1e-4 of the plain version, the same bits
    twice; with the mask exactly 0 at every dead edge, and the same output
    bits at the live edges as without it, and with z written as without;
    each timed one call a sample and by its device time alone. Then kernel
    C with B's saved z, in case (a), an output gradient at O(1) on every
    edge, and case (b), the same gradient 0 where the model masks the edge
    (pair_mask), as the model passes it: C within 1e-4·max|ref| of the
    plain backward, the same bits twice, 0 in ddist at the masked edges,
    and in case (b) the same bits from the masked call's z (written at the
    live edges only); each case timed one call a sample and by its device
    time alone."""
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
        _launch_fwd,
        fused_edge_messages,
        fused_edge_messages_bwd,
        fused_edge_messages_bwd_plain,
        fused_edge_messages_plain,
    )

    ui, _, _, nbr_idx, *_ = args
    g, a, f = ui.shape
    k, mo = nbr_idx.shape[-1], 16
    modes = {  # mode -> (the mask, the call)
        "serving, pair_mask": (pair_mask, lambda: fused_edge_messages(*args, edge_mask=pair_mask)),
        "training, pair_mask, z written":
            (pair_mask, lambda: _launch_fwd(*args, edge_mask=pair_mask, want_z=True)[0]),
        "no mask, every edge": (None, lambda: fused_edge_messages(*args)),
    }
    calls = [call for _, call in modes.values()]
    outs, err = {}, 0.0
    for mode, (mask, call) in modes.items():
        got, again = call(), call()
        ref = fused_edge_messages_plain(*args, mask)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        err = max(err, float(diff.max()))
        rel_err = float((diff / ref.abs().clamp(min=1e-30)).max())
        ok = bool((diff <= 1e-5 + 1e-4 * ref.abs()).all())
        same = torch.equal(got, again)
        dead_zero = mask is None or bool((got[~mask] == 0).all())
        print(f"kernel B fused_edge_messages [G={g}, A={a}, k={k}, F={f}, m={mo}] {mode}: "
              f"max|d| {float(diff.max()):.3e}, max rel {rel_err:.3e} (atol 1e-5, rtol 1e-4): "
              f"{'ok' if ok else 'FAIL'}; {'the same bits twice' if same else 'OTHER BITS'}"
              + ("" if mask is None else f"; 0 at every dead edge: {dead_zero}"))
        check(ok, f"kernel B ({mode}) disagrees with its plain version")
        check(same, f"kernel B ({mode}) gave other bits on a second call")
        check(dead_zero, f"kernel B ({mode}) is not 0 at a dead edge")
        outs[mode] = got
    served, trained, every = outs.values()
    check(torch.equal(served, trained), "kernel B's output moved when it also wrote z")
    check(torch.equal(served[pair_mask], every[pair_mask]),
          "kernel B's output at the live edges moved with the mask")
    print("kernel B: the same output bits with z written as without, and at the live edges "
          "with the mask as without it")
    *b_ms, plain_ms = median_ms(*calls, lambda: fused_edge_messages_plain(*args))
    b_dev = [profiled_device_ms(call) for call in calls]
    _, z = _launch_fwd(*args, want_z=True)  # every edge's z, for kernel C's case (a)
    _, z_live = _launch_fwd(*args, edge_mask=pair_mask, want_z=True)
    # operations per edge and column f: the pre-activation (4) and its SiLU
    # (4) at the f32 peak, and the product with W1 (2m) at the TF32 peak,
    # three TF32 products each (B's route, as J's and K's); over every edge
    # (the row: the no-mask call) and over the kept ones (the masked calls).
    # Beside them the f32-peak bounds of PRs 1-10 (every product on the CUDA
    # cores) and the special-function floor of the SiLUs (two operations each)
    e_edges, e_live = g * a * k, int(pair_mask.sum())
    b_all, b_live = (bound(nbytes(*args, *mask_t, ref), 3 * n * f * 2 * mo, PEAK_TF32_S,
                           f32_flops=n * f * 8)
                     for n, mask_t in ((e_edges, ()), (e_live, (pair_mask,))))
    f32_all, f32_live = (bound(nbytes(*args, ref), n * f * (2 * mo + 8))["bound_ms"]
                         for n in (e_edges, e_live))
    for mode, ms, dev_ms in zip(modes, b_ms, b_dev):
        print(f"kernel B {mode}: {ms:.4f} ms one call a sample, {dev_ms:.4f} ms device alone "
              f"(torch.profiler, 20 calls)")
    print(f"kernel B: plain (no mask) {plain_ms:.4f} ms; bound {b_all['bound_ms']:.4f} ms over "
          f"all {e_edges} edges ({b_all['bound_by']}; the W1 products at the TF32 peak, 3 "
          f"products each), live bound {b_live['bound_ms']:.4f} ms over the {e_live} kept; at the "
          f"f32 peak {f32_all:.4f} / {f32_live:.4f} ms; special-function floor of the SiLUs "
          f"{sfu_floor_ms(e_edges * f):.4f} ms at every edge, {sfu_floor_ms(e_live * f):.4f} ms "
          f"at the kept ones ({SFU_OPS_CLK} a clock an SM at {sm_clock_hz() / 1e6:.0f} MHz) "
          f"(median of 20, CUDA events)")
    rows = [dict(  # the no-mask call, every edge, against the bound over every edge
        name="fused_edge_messages", route="cuda",
        source="equihgnn_tpu_torch/csrc/edge_mlp.cu",
        replaces="equihgnn_tpu/ops/pallas/edge_mlp.py:179",
        max_abs_err=err, ms=b_ms[2], plain_ms=plain_ms, library_ms=None, **b_all,
    )]

    # kernel C, for an output gradient at O(1), on every edge (a) and on the
    # edges the model keeps (b)
    dm = torch.randn(g, a, k, mo, generator=gen).to(pair_mask.device)
    cases = {"a": dm, "b": dm * pair_mask[..., None]}
    err, times = 0.0, {}
    for case, d in cases.items():
        got = fused_edge_messages_bwd(*args, d, z)
        again = fused_edge_messages_bwd(*args, d, z)
        ref = fused_edge_messages_bwd_plain(*args, d)
        torch.cuda.synchronize()
        for gname, x, y in zip(("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1"), got, ref):
            dd, scale = float((x - y).abs().max()), float(y.abs().max())
            err = max(err, dd)
            ok = dd <= 1e-4 * scale
            print(f"kernel C fused_edge_messages_bwd case ({case}) {gname} {tuple(x.shape)}: "
                  f"max|d| {dd:.3e}, max|ref| {scale:.3e}, rel {dd / scale:.3e} (limit 1e-4 * "
                  f"max|ref|): {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel C's {gname} disagrees with the plain backward in case ({case})")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"kernel C gave other bits on a second call in case ({case})")
        if case == "b":
            check(bool((got[2][~pair_mask] == 0).all()), "kernel C's ddist is not 0 at a masked edge")
            check(all(torch.equal(x, y) for x, y in zip(got, fused_edge_messages_bwd(*args, d, z_live))),
                  "kernel C gave other bits from the masked forward's z in case (b)")
        times[case] = (*median_ms(lambda: fused_edge_messages_bwd(*args, d, z),
                                  lambda: fused_edge_messages_bwd_plain(*args, d)),
                       profiled_device_ms(lambda: fused_edge_messages_bwd(*args, d, z)))
    print("kernel C: the same bits twice in both cases; 0 in ddist at every masked edge in "
          "case (b), and the same bits there from the masked forward's z")
    # operations per edge and column f, with z given (kernel B saved it):
    # the pre-activation, its SiLU and SiLU' (16), dz·W1ᵀ and dW1 (4m); the
    # bound over every edge, and over the edges with a gradient in case (b).
    # PRs 2-9 counted the forward's a1·W1 (2m) too, which C no longer does
    # (B's training forward carries it): that bound is printed for comparison
    c_bytes = nbytes(*args, dm, z, *ref)
    bc, bl = (bound(c_bytes, n * f * (4 * mo + 16)) for n in (e_edges, e_live))
    b_old = bound(nbytes(*args, dm, *ref), e_edges * f * (6 * mo + 16))
    for case, (c_ms, p_ms, dev_ms) in times.items():
        print(f"kernel C case ({case}): {c_ms:.4f} ms one call a sample, {dev_ms:.4f} ms device "
              f"alone (torch.profiler, 20 calls), plain {p_ms:.4f} ms; bound "
              f"{bc['bound_ms']:.4f} ms over all {e_edges} edges, live bound "
              f"{bl['bound_ms']:.4f} ms over the {e_live} kept ({bl['bound_by']}; PRs 2-9's "
              f"count with the forward's a1·W1: {b_old['bound_ms']:.4f} ms)")
    rows.append(dict(
        name="fused_edge_messages_bwd", route="cuda",
        source="equihgnn_tpu_torch/csrc/edge_mlp.cu",
        replaces="equihgnn_tpu/ops/pallas/edge_mlp.py:222",
        max_abs_err=err, ms=times["a"][0], plain_ms=times["a"][1], library_ms=None, **bc,
    ))
    return rows


def bf16_distance(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(the share of elements with the same bits, the largest |got − want|
    in bf16 ulps of max(|want|, max|want| / 256)): an ulp of the value,
    floored at the ulp of 1/256 of the tensor's largest, where an f32 sum
    that cancels is resolved in another sum order only to ~1e-6 of its
    terms."""
    if not want.numel():
        return 1.0, 0.0
    got, want = got.float(), want.float()
    same = float((got == want).float().mean())
    top = float(want.abs().max())
    if top == 0.0:
        return same, float((got - want).abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=top / 256))) - 7)
    return same, float(((got - want).abs() / ulp).max())


def check_bf16(what: str, got, want, ulps: float = 1, equal: float = 0.99,
               slack=None, rounded: str = "dz") -> float:
    """`got` within `ulps` bf16 ulps of `want` (`bf16_distance`) past a
    per-element `slack` (none by default: the bound of what rounding the
    operand `rounded` at another boundary can move it), at least `equal`
    of it the same bits; returns max|d|."""
    err = float((got.float() - want.float()).abs().max()) if want.numel() else 0.0
    same, far = bf16_distance(got, want)
    if slack is not None:
        excess = ((got.float() - want.float()).abs() - slack).clamp(min=0)
        far = bf16_distance(want.float() + excess, want.float())[1]
    ok = got.dtype == want.dtype == torch.bfloat16 and same >= equal and far <= ulps
    print(f"{what}: {same:.5f} the same bits, {far:.2f} bf16 ulps at most"
          f"{'' if slack is None else f' past the {rounded} rounding bound'} (limit {ulps}, at "
          f"least {equal} the same), max|d| {err:.3e}: {'ok' if ok else 'FAIL'}")
    check(ok, f"{what} disagrees with its plain version")
    return err


def bf16_kernel_rows(batch, args, pair_mask, gen) -> list[dict]:
    """Kernels A, B and C in bf16 (the bf16 paths' variants) at the batch-768
    shapes, each against its plain bf16 version (f32 sums rounded once, and
    for B and C a1, W1 and dz rounded to bf16 before an f32 product) and the
    same bits twice: A at the trunk's hyperedge reduction (D = 256) and at
    kernel A's edge cases, within one bf16 ulp, and timed against its
    library call, `index_add_` into f32 and a cast; B in the three modes of
    `edge_mlp_rows`, out within one ulp; C in cases (a) and (b), dui, dujn
    and ddist at least 99 % the same bits and within two ulps past
    `bwd_bf16_rounding_bound` (C rounds dz from B's z, the plain version
    from its own, f32 sums in other orders: a dz at a rounding boundary
    goes either way), the f32 parameter gradients within 1e-4·max|ref|. Each timed one call a sample
    and by device time alone; B's and C's products bound at the bf16 peak.
    Rows named "<wrapper> bf16"."""
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
        _launch_fwd,
        bwd_bf16_rounding_bound,
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

    bf16, dev = torch.bfloat16, torch.device("cuda")
    rows = []
    ids = batch.hedge_idx.to(dev)
    m, s = ids.shape[0], batch.num_hedges
    data = torch.randn(m, HIDDEN, generator=gen).to(bf16).to(dev)
    got = sorted_segment_sum(data, ids, s)
    err = check_bf16(f"kernel A bf16 [M={m}, D={HIDDEN}] -> [S={s}]", got,
                     sorted_segment_sum_plain(data, ids, s))
    check(torch.equal(got, sorted_segment_sum(data, ids, s)), "kernel A bf16: other bits twice")
    for name, (case_ids, case_s) in segment_sum_cases(gen).items():
        case_data = torch.randn(case_ids.shape[0], HIDDEN, generator=gen).to(bf16).to(dev)
        case_ids = case_ids.to(dev)
        case_got = sorted_segment_sum(case_data, case_ids, case_s)
        check_bf16(f"kernel A bf16, {name}", case_got,
                   sorted_segment_sum_plain(case_data, case_ids, case_s))
        check(torch.equal(case_got, sorted_segment_sum(case_data, case_ids, case_s)),
              f"kernel A bf16 gave other bits on a second call ({name})")
    data32, zeros = data.float(), torch.zeros(s, HIDDEN, device=dev)
    fns = (lambda: _launch(data, ids, s), lambda: zeros.index_add_(0, ids, data32).to(bf16),
           lambda: sorted_segment_sum_plain(data, ids, s))
    ms, library_ms, plain_ms = median_ms(*fns)
    dev_ms, dev_library_ms = (profiled_device_ms(fn) for fn in fns[:2])
    print(f"kernel A bf16 vs index_add_ into f32 and a cast (median of 20, CUDA events, one call "
          f"a sample): {ms:.4f} vs {library_ms:.4f} ms; device alone (torch.profiler, 20 calls) "
          f"{dev_ms:.4f} vs {dev_library_ms:.4f} ms; the plain version {plain_ms:.4f} ms")
    rows.append(dict(
        name="sorted_segment_sum bf16", route="cuda",
        source="equihgnn_tpu_torch/csrc/segment_sum.cu",
        replaces="equihgnn_tpu/ops/pallas/segment_sum.py:92",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(nbytes(data, ids, got), m * HIDDEN),
    ))

    ui, ujn, dist, nbr_idx, wd, b0, w1, b1 = args
    bargs = (ui.to(bf16), ujn.to(bf16), dist.to(bf16), nbr_idx, wd, b0, w1, b1)
    g, a, f = ui.shape
    k, mo = nbr_idx.shape[-1], 16
    modes = {
        "serving, pair_mask": (pair_mask, lambda: fused_edge_messages(*bargs, edge_mask=pair_mask)),
        "training, pair_mask, z written":
            (pair_mask, lambda: _launch_fwd(*bargs, edge_mask=pair_mask, want_z=True)[0]),
        "no mask, every edge": (None, lambda: fused_edge_messages(*bargs)),
    }
    calls = [call for _, call in modes.values()]
    outs, err = {}, 0.0
    for mode, (mask, call) in modes.items():
        got, again = call(), call()
        err = max(err, check_bf16(f"kernel B bf16 [G={g}, A={a}, k={k}, F={f}] {mode}", got,
                                  fused_edge_messages_plain(*bargs, mask)))
        check(torch.equal(got, again), f"kernel B bf16 ({mode}) gave other bits on a second call")
        check(mask is None or bool((got[~mask] == 0).all()),
              f"kernel B bf16 ({mode}) is not 0 at a dead edge")
        outs[mode] = got
    served, trained, every = outs.values()
    check(torch.equal(served, trained), "kernel B bf16's output moved when it also wrote z")
    check(torch.equal(served[pair_mask], every[pair_mask]),
          "kernel B bf16's output at the live edges moved with the mask")
    *b_ms, plain_ms = median_ms(*calls, lambda: fused_edge_messages_plain(*bargs))
    b_dev = [profiled_device_ms(call) for call in calls]
    e_edges, e_live = g * a * k, int(pair_mask.sum())
    # per edge and column f: pre and its SiLU (8) on the CUDA cores at the
    # f32 peak, the product with W1 (2m) on the tensor cores at the bf16 peak
    b_all, b_live = (bound(nbytes(*bargs, *mask_t, served), n * f * 2 * mo, PEAK_BF16_S,
                           f32_flops=n * f * 8)
                     for n, mask_t in ((e_edges, ()), (e_live, (pair_mask,))))
    for mode, t, dv in zip(modes, b_ms, b_dev):
        print(f"kernel B bf16 {mode}: {t:.4f} ms one call a sample, {dv:.4f} ms device alone")
    print(f"kernel B bf16: plain (no mask) {plain_ms:.4f} ms; bound {b_all['bound_ms']:.4f} ms "
          f"over all {e_edges} edges ({b_all['bound_by']}), live bound {b_live['bound_ms']:.4f} "
          f"ms over the {e_live} kept")
    rows.append(dict(
        name="fused_edge_messages bf16", route="cuda",
        source="equihgnn_tpu_torch/csrc/edge_mlp.cu",
        replaces="equihgnn_tpu/ops/pallas/edge_mlp.py:179",
        max_abs_err=err, ms=b_ms[2], plain_ms=plain_ms, library_ms=None, **b_all,
    ))

    _, z = _launch_fwd(*bargs, want_z=True)
    _, z_live = _launch_fwd(*bargs, edge_mask=pair_mask, want_z=True)
    dm = torch.randn(g, a, k, mo, generator=gen).to(bf16).to(dev)
    err, times = 0.0, {}
    for case, d in {"a": dm, "b": dm * pair_mask[..., None]}.items():
        got = fused_edge_messages_bwd(*bargs, d, z)
        ref = fused_edge_messages_bwd_plain(*bargs, d)
        slack = bwd_bf16_rounding_bound(*bargs, d, z)
        for gname, x, y, sl in zip(("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1"), got,
                                   ref, (*slack, None, None, None, None)):
            what = f"kernel C bf16 case ({case}) {gname} {tuple(x.shape)}"
            if x.dtype == bf16:
                err = max(err, check_bf16(what, x, y, ulps=2, slack=sl))
                continue
            dd, scale = float((x - y).abs().max()), float(y.abs().max())
            err = max(err, dd)
            print(f"{what}: max|d| {dd:.3e}, max|ref| {scale:.3e} (limit 1e-4 * max|ref|)")
            check(dd <= 1e-4 * scale, f"{what} disagrees with the plain backward")
        check(all(torch.equal(x, y) for x, y in zip(got, fused_edge_messages_bwd(*bargs, d, z))),
              f"kernel C bf16 gave other bits on a second call in case ({case})")
        if case == "b":
            check(bool((got[2][~pair_mask] == 0).all()), "kernel C bf16's ddist is not 0 at a "
                                                         "masked edge")
            check(all(torch.equal(x, y) for x, y in
                      zip(got, fused_edge_messages_bwd(*bargs, d, z_live))),
                  "kernel C bf16 gave other bits from the masked forward's z in case (b)")
        del ref, slack
        times[case] = (*median_ms(lambda: fused_edge_messages_bwd(*bargs, d, z),
                                  lambda: fused_edge_messages_bwd_plain(*bargs, d)),
                       profiled_device_ms(lambda: fused_edge_messages_bwd(*bargs, d, z)))
    # per edge and column f: pre, its SiLU and SiLU' (16) at the f32 peak,
    # dz·W1ᵀ and a1ᵀ·dz (4m) on the tensor cores at the bf16 peak
    c_bytes = nbytes(*bargs, dm, z, *got)
    bc, bl = (bound(c_bytes, n * f * 4 * mo, PEAK_BF16_S, f32_flops=n * f * 16)
              for n in (e_edges, e_live))
    for case, (c_ms, p_ms, dv) in times.items():
        print(f"kernel C bf16 case ({case}): {c_ms:.4f} ms one call a sample, {dv:.4f} ms device "
              f"alone, plain {p_ms:.4f} ms; bound {bc['bound_ms']:.4f} ms over all {e_edges} "
              f"edges ({bc['bound_by']}), live bound {bl['bound_ms']:.4f} ms over the {e_live} "
              f"kept")
    rows.append(dict(
        name="fused_edge_messages_bwd bf16", route="cuda",
        source="equihgnn_tpu_torch/csrc/edge_mlp.cu",
        replaces="equihgnn_tpu/ops/pallas/edge_mlp.py:222",
        max_abs_err=err, ms=times["a"][0], plain_ms=times["a"][1], library_ms=None, **bc,
    ))
    del bargs, z, z_live
    torch.cuda.empty_cache()
    return rows


@quiet
def host_us_per_call(fn, calls: int = 200) -> float:
    """µs of host time a call of `fn` takes to enqueue, without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def segment_sum_cases(gen) -> dict:
    """name → (ids, S): kernel A's edge cases (ids sorted, on the CPU)."""
    def rand(hi, n):
        return torch.sort(torch.randint(0, hi, (n,), generator=gen)).values

    return {
        "no rows (M = 0)": (torch.zeros(0, dtype=torch.int64), 50),
        "no segments (S = 0)": (rand(5, 300), 0),
        "empty segments at the start, in the middle and at the end": (7 + 3 * rand(129, 2000), 400),
        "one segment of 5,000 rows": (torch.cat([rand(20, 700), torch.full((5000,), 20),
                                                 21 + rand(600, 900)]), 700),
        "ids >= S": (rand(120, 3000), 80),
        "every id equal": (torch.full((4000,), 3), 9),
    }


def segment_sum_case(name: str, data, ids, s: int) -> float:
    """Kernel A against its plain version (1e-5 · max(1, max|ref|)), the same
    bits on a second call; returns max|d|."""
    from equihgnn_tpu_torch.ops.kernels.segment_sum import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    got = sorted_segment_sum(data, ids, s)
    ref = sorted_segment_sum_plain(data, ids, s)
    again = sorted_segment_sum(data, ids, s)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    scale = max(1.0, float(ref.abs().max()) if ref.numel() else 0.0)
    same = torch.equal(got, again)
    print(f"kernel A sorted_segment_sum, {name} [M={ids.shape[0]}, D={data.shape[1]}] -> "
          f"[S={s}]: max|d| {err:.3e} (limit 1e-5 * {scale:.3f}), "
          f"{'the same bits twice' if same else 'OTHER BITS on a second call'}")
    check(got.shape == ref.shape and err <= 1e-5 * scale,
          f"kernel A disagrees with its plain version ({name})")
    check(same, f"kernel A gave other bits on a second call ({name})")
    return err


def mask_probe(p: int, gen, dev, dtype=torch.float32) -> float:
    """Kernel D with dropout on inputs that make every mask bit visible:
    SwiGLU values in [1.5, 4.5] (never near 0) and distinct in each frame,
    so one kept value the kernel dropped (or the reverse), or a swap
    between frames, moves its output by > 1e-2. Agreement with the f32
    plain version within 1e-5 (in bf16, x rounded to bf16 and the output
    within half an ulp more) means the kernel's mask is the plain
    version's, bit for bit."""
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import frame_swiglu_plain, fused_frame_swiglu

    hh = HIDDEN // 2
    x = (0.5 + torch.rand(p, 4, generator=gen)).to(dtype).to(dev)
    w1 = torch.cat([0.2 * torch.rand(4, hh, generator=gen) + 0.1,
                    0.02 * torch.randn(4, hh, generator=gen)], 1).to(dev)
    b1 = torch.cat([torch.linspace(2.5, 3.5, hh), torch.ones(hh)]).to(dev)
    ls, lb = torch.ones(hh, device=dev), torch.zeros(hh, device=dev)
    got = fused_frame_swiglu(x, w1, b1, ls, lb, drop_rate=0.1, seed=13).float()
    ref = frame_swiglu_plain(x.float(), w1, b1, ls, lb, drop_rate=0.1, seed=13)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    if dtype != torch.float32:
        d = d - half_ulp(ref, 1e-5)
    d = float(d.max())
    other = float((frame_swiglu_plain(x.float(), w1, b1, ls, lb, drop_rate=0.1, seed=14)
                   - got).abs().max())
    what = "max|d|" if dtype == torch.float32 else "max(|d| - half a bf16 ulp)"
    print(f"kernel D {'' if dtype == torch.float32 else 'bf16 '}dropout mask probe [P={p}, C=4]: "
          f"{what} {d:.3e} against the plain version's mask (limit 1e-5; another seed's mask: "
          f"{other:.3e})")
    check(d <= 1e-5 and other > 1e-2, "kernel D's dropout mask differs from the plain version's")
    return d


def frame_swiglu_sites(pd, sm) -> tuple[dict, dict]:
    """(x, kept) of FAFormer's two frame sites for the slot view's positions
    pd and mask sm: x [P, C] the kernels' input, kept [P] the positions the
    model gives a gradient (the unmasked neighbours, the real slots)."""
    from equihgnn_tpu_torch.nn.faformer import create_frame_basis
    from equihgnn_tpu_torch.ops.gather import nbr_gather
    from equihgnn_tpu_torch.ops.knn import knn_dense

    idx, nmask, _ = knn_dense(pd, sm, 16, valid_radius=5.0, exclude_self=True)
    radial = pd[:, :, None, :] - nbr_gather(pd, idx, nmask)
    vbar, _ = create_frame_basis(radial, nmask)
    sites = {
        "EdgeModule": torch.cat([vbar, torch.sum(radial * radial, -1, keepdim=True)],
                                -1).reshape(-1, 4).contiguous(),
        "FAFFN": create_frame_basis(pd, sm)[0].reshape(-1, 3).contiguous(),
    }
    return sites, {"EdgeModule": nmask.reshape(-1), "FAFFN": sm.reshape(-1)}


def frame_swiglu_rows(pd, sm, gen) -> list[dict]:
    """Kernels D and E at FAFormer's two sites of the batch: the EdgeModule's
    coordinate MLP on [vbar ‖ |r|²] of each atom's k = 16 neighbourhood
    (P = G·A·k, C = 4) and the FAFFN's on the molecule frames (P = G·A,
    C = 3), with the batch's real projections; weights at the width 256.
    Kernel E in case (a), an output gradient at O(1) at every position, and
    case (b), the same gradient 0 at the positions the model gives none (the
    masked neighbours at the EdgeModule site, the padding slots at the
    FAFFN's)."""
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
        frame_swiglu_bwd_plain,
        frame_swiglu_plain,
        fused_frame_swiglu,
        fused_frame_swiglu_bwd,
    )

    dev = pd.device
    sites, kept = frame_swiglu_sites(pd, sm)
    err_d = err_e = 0.0
    times = {}
    for site, x in sites.items():
        p, c = x.shape
        params = frame_swiglu_params(c, gen)
        dout = torch.randn(p, HIDDEN // 2, generator=gen).to(dev)
        douts = {"a": dout, "b": dout * kept[site][:, None]}
        for rate in (0.0, 0.1):
            # dropout: at the FAFFN's P (the plain mask is [P, 8, H/2] int64)
            xs = x if rate == 0.0 else x[:sites["FAFFN"].shape[0]]
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
            for case, dcase in douts.items():
                ds = dcase[:xs.shape[0]]
                got = fused_frame_swiglu_bwd(xs, *params, ds, rate, 7)
                again = fused_frame_swiglu_bwd(xs, *params, ds, rate, 7)
                ref = frame_swiglu_bwd_plain(xs, *params, ds, rate, 7)
                torch.cuda.synchronize()
                for gname, a, b in zip(("dx", "dw1", "db1", "dls", "dlb"), got, ref):
                    d, scale = float((a - b).abs().max()), float(b.abs().max())
                    err_e = max(err_e, d)
                    ok = d <= 1e-4 * scale + 1e-6
                    print(f"kernel E fused_frame_swiglu_bwd {site} drop {rate} case ({case}) "
                          f"{gname} {tuple(a.shape)}: max|d| {d:.3e}, max|ref| {scale:.3e} "
                          f"(limit 1e-4 * max|ref| + 1e-6): {'ok' if ok else 'FAIL'}")
                    check(ok, f"kernel E's {gname} at {site}, drop {rate}, case ({case}), disagrees")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"kernel E gave other bits on a second call ({site}, drop {rate}, {case})")
                if case == "b":
                    zero = (ds == 0).all(-1)
                    check(bool((got[0][zero] == 0).all()),
                          "kernel E's dx is not 0 at a position of zero gradient")
        # the [P, 8, H] frames never reach device memory: a call allocates
        # its output (D) or its gradients and workspace (E), nothing more
        frames_mb = p * 8 * HIDDEN * 4 / 2**20
        for kname, call in (("D", lambda: fused_frame_swiglu(x, *params)),
                            ("E", lambda: fused_frame_swiglu_bwd(x, *params, dout))):
            extra_mb = alloc_mib(call)
            print(f"kernel {kname} at {site}: {extra_mb:.1f} MiB allocated at peak "
                  f"(the [P, 8, {HIDDEN}] frames would be {frames_mb:.1f} MiB)")
            check(extra_mb < frames_mb / 4, f"kernel {kname} allocated frame-sized memory")
        db = douts["b"]
        # D at dropout 0 and at the train step's 0.1 (the EdgeModule's plain
        # version at 0.1 would hold a [P, 8, H/2] int64 mask: 3.2 GB)
        d_calls = [lambda: fused_frame_swiglu(x, *params),
                   lambda: fused_frame_swiglu(x, *params, drop_rate=0.1, seed=7)]
        times[site] = (median_ms(*d_calls, lambda: frame_swiglu_plain(x, *params)),
                       median_ms(lambda: fused_frame_swiglu_bwd(x, *params, dout),
                                 lambda: frame_swiglu_bwd_plain(x, *params, dout),
                                 lambda: fused_frame_swiglu_bwd(x, *params, db)),
                       [profiled_device_ms(lambda dd=dd: fused_frame_swiglu_bwd(x, *params, dd))
                        for dd in (dout, db)],
                       [profiled_device_ms(call) for call in d_calls])
        (dk, dk1, dp), (ek, ep, ekb), (edev, edevb), (ddev, ddev1) = times[site]
        bd, be = frame_swiglu_bounds(x)
        n_live = int((db != 0).any(-1).sum())
        _, bel = frame_swiglu_bounds(x[:n_live])  # the same formula over the live positions
        print(f"kernel D at {site} [P={p}, C={c}]: dropout 0 {dk:.4f} ms one call a sample, "
              f"{ddev:.4f} ms device alone; dropout 0.1 {dk1:.4f} / {ddev1:.4f} ms; plain "
              f"{dp:.4f} ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}; special-function "
              f"floor of its {p * 8 * HIDDEN // 2} sigmoids {sfu_floor_ms(p * 8 * HIDDEN // 2):.4f} ms "
              f"({SFU_OPS_CLK} a clock an SM at {sm_clock_hz() / 1e6:.0f} MHz)")
        print(f"kernels D/E at {site} [P={p}, C={c}]: D {dk:.4f} ms vs plain {dp:.4f} ms "
              f"(bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}); E case (a) {ek:.4f} ms, "
              f"case (b) {ekb:.4f} ms one call a sample (device alone {edev:.4f} / {edevb:.4f} "
              f"ms, torch.profiler, 20 calls) vs plain backward {ep:.4f} ms (bound "
              f"{be['bound_ms']:.4f} ms by {be['bound_by']}; live bound {bel['bound_ms']:.4f} "
              f"ms over the {n_live} of {p} positions of case (b)) (median of 20, CUDA events)")
    err_d = max(err_d, mask_probe(sites["FAFFN"].shape[0], gen, dev))
    (dk, _, dp), (ek, ep, _), _, _ = times["EdgeModule"]
    src = "equihgnn_tpu_torch/csrc/frame_swiglu.cu"
    bd, be = frame_swiglu_bounds(sites["EdgeModule"])  # the site whose times the row carries
    return [
        dict(name="fused_frame_swiglu", route="cuda", source=src,
             replaces="equihgnn_tpu/ops/pallas/frame_swiglu.py:254",
             max_abs_err=err_d, ms=dk, plain_ms=dp, library_ms=None, **bd),
        dict(name="fused_frame_swiglu_bwd", route="cuda", source=src,
             replaces="equihgnn_tpu/ops/pallas/frame_swiglu.py:274",
             max_abs_err=err_e, ms=ek, plain_ms=ep, library_ms=None, **be),
    ]


def frame_swiglu_bounds(x: torch.Tensor) -> tuple[dict, dict]:
    """Kernels D's and E's bounds on the positions x [P, C] (f32 or bf16: x,
    out, dout and dx in x's dtype, the parameters f32). Operations per
    position and frame, at the f32 peak in either dtype (the bf16 kernels
    compute in f32): fc1 (2·C·H), SwiGLU, LayerNorm and mean (~7·H); the
    backward recomputes them and adds dx and dw1 (4·C·H) and ~13·H."""
    p, c = x.shape
    out_b = p * (HIDDEN // 2) * x.element_size()
    w_b = (c * HIDDEN + HIDDEN + HIDDEN) * 4
    return (bound(nbytes(x) + w_b + out_b, p * 8 * (2 * c * HIDDEN + 7 * HIDDEN)),
            bound(2 * nbytes(x) + 2 * w_b + out_b, p * 8 * (6 * c * HIDDEN + 20 * HIDDEN)))


def frame_swiglu_params(c: int, gen) -> list[torch.Tensor]:
    """w1, b1, γ and β of a frame site at the width 256 (f32, on the card)."""
    dev = torch.device("cuda")
    return [((torch.rand(c, HIDDEN, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
            ((torch.rand(HIDDEN, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
            (1.0 + 0.2 * torch.randn(HIDDEN // 2, generator=gen)).to(dev),
            (0.1 * torch.randn(HIDDEN // 2, generator=gen)).to(dev)]


def half_ulp(ref: torch.Tensor, slack: float) -> torch.Tensor:
    """Half a bf16 ulp of any f32 value within `slack` of `ref`: what
    rounding such a value to bf16 can move it."""
    return torch.exp2(torch.floor(torch.log2(ref.abs() + slack)) - 8)


def frame_swiglu_bf16_rows(pd, sm, gen) -> list[dict]:
    """Kernels D and E in bf16 (the bf16 FAFormer's variants: x, out, dout
    and dx bf16, the parameters and the arithmetic f32) at FAFormer's two
    sites of the batch (`frame_swiglu_sites`, x rounded to bf16), each
    against its plain bf16 version (the f32 function of x.float(), out and
    dx rounded once): out and dx within one bf16 ulp, out at least 99 % the
    same bits, and so dx at the positions the model gives a gradient
    (`frame_swiglu_sites`' kept); dx also within half an ulp of the plain
    version's f32 dx plus f32 E's gate (1e-4·max|ref| + 1e-6). At the
    positions the model masks, x's coordinate columns are 0, the 8 frames'
    terms cancel exactly, and dx's coordinate columns are f32 rounding
    noise around 0, whose bf16 bits differ between any two sum orders;
    the f32 parameter gradients within 1e-4·max|ref| + 1e-6, the same bits
    twice; D and E at dropout 0 and 0.1 (0.1 on the FAFFN's P of
    positions at both sites, as `frame_swiglu_rows`), E in cases (a) and (b)
    (dx 0 at the positions of zero gradient); the mask probe: bf16 D with
    dropout (`mask_probe`). Timed one call a sample
    (alternating with the plain version) and by device time alone; bound by
    the bf16 bytes and the f32 operations (`frame_swiglu_bounds`). Rows
    "<wrapper> bf16", with the EdgeModule site's times."""
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
        frame_swiglu_bwd_plain,
        frame_swiglu_plain,
        fused_frame_swiglu,
        fused_frame_swiglu_bwd,
    )

    bf16 = torch.bfloat16
    sites, kept = frame_swiglu_sites(pd, sm)
    n_drop = sites["FAFFN"].shape[0]
    err_d = err_e = 0.0
    times = {}
    for site, x32 in sites.items():
        x = x32.to(bf16)
        p, c = x.shape
        params = frame_swiglu_params(c, gen)
        dout = torch.randn(p, HIDDEN // 2, generator=gen).to(bf16).to(pd.device)
        douts = {"a": dout, "b": dout * kept[site][:, None]}
        for rate in (0.0, 0.1):
            xs = x if rate == 0.0 else x[:n_drop]
            tag = f"kernel D bf16 {site} [P={xs.shape[0]}, C={c}, H={HIDDEN}] drop {rate}"
            got = fused_frame_swiglu(xs, *params, drop_rate=rate, seed=7)
            err_d = max(err_d, check_bf16(tag, got,
                                          frame_swiglu_plain(xs, *params, drop_rate=rate, seed=7)))
            check(torch.equal(got, fused_frame_swiglu(xs, *params, drop_rate=rate, seed=7)),
                  f"{tag}: other bits on a second call")
            for case, dcase in douts.items():
                ds = dcase[:xs.shape[0]]
                got = fused_frame_swiglu_bwd(xs, *params, ds, rate, 7)
                again = fused_frame_swiglu_bwd(xs, *params, ds, rate, 7)
                ref = frame_swiglu_bwd_plain(xs, *params, ds, rate, 7)
                tag = f"kernel E bf16 {site} drop {rate} case ({case})"
                err_e = max(err_e, check_bf16(f"{tag} dx {tuple(got[0].shape)}", got[0], ref[0],
                                              equal=0.0))
                live = kept[site][:xs.shape[0]]
                check_bf16(f"{tag} dx at the {int(live.sum())} kept positions", got[0][live],
                           ref[0][live])
                dx32 = frame_swiglu_bwd_plain(xs.float(), *params, ds.float(), rate, 7)[0]
                slack = 1e-4 * float(dx32.abs().max()) + 1e-6
                excess = float(((got[0].float() - dx32).abs() - half_ulp(dx32, slack)
                                - slack).max())
                print(f"{tag} dx against the plain version's f32 dx: max(|d| - half an ulp - "
                      f"{slack:.3e}) {excess:.3e} (limit 0)")
                check(excess <= 0, f"{tag}: dx is not an f32 value within E's gate, rounded")
                for gname, a, b in zip(("dw1", "db1", "dls", "dlb"), got[1:], ref[1:]):
                    d, scale = float((a - b).abs().max()), float(b.abs().max())
                    err_e = max(err_e, d)
                    ok = a.dtype == torch.float32 and d <= 1e-4 * scale + 1e-6
                    print(f"{tag} {gname} {tuple(a.shape)}: max|d| {d:.3e}, max|ref| {scale:.3e} "
                          f"(limit 1e-4 * max|ref| + 1e-6): {'ok' if ok else 'FAIL'}")
                    check(ok, f"{tag}: {gname} disagrees with the plain backward")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{tag}: other bits on a second call")
                if case == "b":
                    check(bool((got[0][(ds == 0).all(-1)] == 0).all()),
                          f"{tag}: dx is not 0 at a position of zero gradient")
                del got, again, ref
        db = douts["b"]
        d_calls = [lambda: fused_frame_swiglu(x, *params),
                   lambda: fused_frame_swiglu(x, *params, drop_rate=0.1, seed=7)]
        e_calls = [lambda: fused_frame_swiglu_bwd(x, *params, dout),
                   lambda: fused_frame_swiglu_bwd(x, *params, db)]
        (dk, dk1, dp), (ek, ekb, ep) = (
            median_ms(*d_calls, lambda: frame_swiglu_plain(x, *params)),
            median_ms(*e_calls, lambda: frame_swiglu_bwd_plain(x, *params, dout)))
        ddev, ddev1, edev, edevb = (profiled_device_ms(call) for call in d_calls + e_calls)
        bd, be = frame_swiglu_bounds(x)
        times[site] = (dk, dp, ek, ep, bd, be)
        print(f"kernels D/E bf16 at {site} [P={p}, C={c}]: D dropout 0 {dk:.4f} ms one call a "
              f"sample, {ddev:.4f} ms device alone; dropout 0.1 {dk1:.4f} / {ddev1:.4f} ms; "
              f"plain {dp:.4f} ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}; E case (a) "
              f"{ek:.4f} ms, case (b) {ekb:.4f} ms one call a sample (device alone {edev:.4f} / "
              f"{edevb:.4f} ms, torch.profiler, 20 calls) vs plain backward {ep:.4f} ms (bound "
              f"{be['bound_ms']:.4f} ms by {be['bound_by']}) (median of 20, CUDA events)")
    mask_probe(n_drop, gen, pd.device, bf16)
    dk, dp, ek, ep, bd, be = times["EdgeModule"]
    src = "equihgnn_tpu_torch/csrc/frame_swiglu.cu"
    return [
        dict(name="fused_frame_swiglu bf16", route="cuda", source=src,
             replaces="equihgnn_tpu/ops/pallas/frame_swiglu.py:254",
             max_abs_err=err_d, ms=dk, plain_ms=dp, library_ms=None, **bd),
        dict(name="fused_frame_swiglu_bwd bf16", route="cuda", source=src,
             replaces="equihgnn_tpu/ops/pallas/frame_swiglu.py:274",
             max_abs_err=err_e, ms=ek, plain_ms=ep, library_ms=None, **be),
    ]


def frame_swiglu_digests() -> dict[str, str]:
    """`digest`s of the f32 kernels D's and E's outputs on inputs drawn on the
    CPU from seed 19 at FAFormer's two sites' shapes (P = 393,728, C = 4 and
    P = 24,608, C = 3; H = 256): D at dropout 0 and 0.1, E in case (a) at
    dropout 0.1 and in case (b) (half the rows of dout 0) at 0; and the
    inputs' own digest."""
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
        fused_frame_swiglu,
        fused_frame_swiglu_bwd,
    )

    gen = torch.Generator().manual_seed(19)
    dev = torch.device("cuda")
    inputs, out = [], {}
    for p, c in ((393_728, 4), (24_608, 3)):
        x = torch.randn(p, c, generator=gen).to(dev)
        params = frame_swiglu_params(c, gen)
        dout = torch.randn(p, HIDDEN // 2, generator=gen).to(dev)
        db = dout * (torch.rand(p, generator=gen) < 0.5).to(dev)[:, None]
        inputs += [x, *params, dout, db]
        out[f"D C={c}"] = digest(fused_frame_swiglu(x, *params),
                                 fused_frame_swiglu(x, *params, drop_rate=0.1, seed=7))
        out[f"E C={c}"] = digest(*fused_frame_swiglu_bwd(x, *params, dout, 0.1, 7),
                                 *fused_frame_swiglu_bwd(x, *params, db))
    return {"inputs": digest(*inputs), **out}


# The f32 kernels D's and E's outputs at `frame_swiglu_digests`' inputs, as
# the kernels of the parent commit 1723ae6 computed them on the card (its
# first 16 hex digits), beside the digest of those inputs: the f32 D and E
# must give the same bits from this commit's source, whose f32 kernels are
# the parent's bodies instantiated for float beside the bf16 ones. The
# inputs come from torch's CPU generator; a run whose inputs have another
# digest (another torch's generator) cannot compare and fails.
FRAME_F32_BEFORE = {"inputs": "ea8db4f57fe17a43", "D C=4": "05f676a373dc29d5",
                    "E C=4": "03d4a1788cb1e7eb", "D C=3": "97b69a1ad179f51b",
                    "E C=3": "1144681e2876c6fe"}


def check_frame_swiglu_f32_bits() -> None:
    got = frame_swiglu_digests()
    print(f"f32 D/E digests {got}; the parent's {FRAME_F32_BEFORE}")
    check(got["inputs"] == FRAME_F32_BEFORE["inputs"],
          "the f32 D/E digests' inputs differ from those recorded: nothing to compare with")
    for name, bits in got.items():
        check(bits == FRAME_F32_BEFORE[name],
              f"f32 kernel {name} gave other bits than the parent commit's")


def vis_mix_inputs(batch, gen, dtype=torch.float32) -> dict:
    """Kernels F-I's inputs at ViSNet's shapes of the batch, in `dtype`: the
    k = 17 neighbourhoods (self included, within 5 Å) of its slot view, d
    the SH (L = 8) of the real edge directions, h = 256; s1 a strided view
    of a [.., 2h] tensor, s2m masked, as ViS_MP passes them; gva and gw the
    output gradients of F and H."""
    from equihgnn_tpu_torch.nn.visnet import edge_geometry

    dev = torch.device("cuda")
    sm = batch.slot_mask.to(dev)
    pd = batch.pos.to(dev)[batch.slot_index.to(dev)] * sm[..., None]
    idx, mask, _, _, d = edge_geometry(pd, sm, 17, 5.0, 2, batch.slot_gid.to(dev))
    g, a, k = idx.shape
    L, h = d.shape[-1], HIDDEN
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev).to(dtype)  # noqa: E731
    vec, u, vv = rnd(g, a, L, h), rnd(g, a, L, h), rnd(g, a, L, h)
    s1 = rnd(g, a, k, 2 * h)[..., :h]
    s2m = rnd(g, a, k, h) * mask[..., None]
    return dict(vec=vec, s1=s1, s2m=s2m, d=d.to(dtype), idx=idx, mask=mask, u=u, vv=vv,
                gva=rnd(g, a, L, h), gw=rnd(g, a, k, h))


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order (a view: its elements)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


# The f32 kernels F-I's outputs at `vis_mix_inputs(batch, Generator(17))`,
# as the kernels of the parent commit 947d224 computed them (sha256 of
# `digest`, its first 16 hex digits), beside the digest of those inputs:
# the f32 F-I must give the same bits from this commit's source, whose
# f32 kernels are the parent's, kept apart from the bf16 ones. Compared
# where this run's inputs have the recorded digest (the same torch and
# card: the neighbourhoods come from the card's kNN).
F32_BEFORE = {"inputs": "a26ce47550a642e6", "vis_vec_agg": "c6221ab45e775200",
              "vis_vec_agg_bwd": "a1bb35ae208404bb", "vis_wdot": "4eecfd41d83d0295",
              "vis_wdot_bwd": "d70a0f50320ee24b"}


def vis_mix_case_table(x, bf16: bool) -> dict:
    """name → (letter, kernel call, plain call, input bytes, output bytes,
    operations, TPU kernel's line) of kernels F-I on the inputs `x`. s1
    (F, G) and gw (I) are read on the masked-in edges only, all they need."""
    from equihgnn_tpu_torch.ops.kernels.vis_mix import (
        vec_agg_bwd_plain,
        vec_agg_plain,
        vis_vec_agg,
        vis_vec_agg_bwd,
        vis_wdot,
        vis_wdot_bwd,
        wdot_bwd_plain,
        wdot_plain,
    )

    vec, s1, s2m, d, idx, mask = (x[n] for n in ("vec", "s1", "s2m", "d", "idx", "mask"))
    u, vv, gva, gw = x["u"], x["vv"], x["gva"], x["gw"]
    g, a, k = idx.shape
    L, h = d.shape[-1], vec.shape[-1]
    e_all, e_valid = g * a * k, int(mask.sum())
    live_b = e_valid * h * vec.element_size()
    sfx = " bf16" if bf16 else ""
    return {
        "vis_vec_agg" + sfx: ("F", lambda: vis_vec_agg(vec, s1, s2m, d, idx, mask),
                              lambda: vec_agg_plain(vec, s1, s2m, d, idx, mask),
                              nbytes(vec, s2m, d, idx, mask) + live_b, nbytes(vec),
                              (e_valid + e_all) * L * h * 2, ":437"),
        "vis_vec_agg_bwd" + sfx: ("G", lambda: vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, gva),
                                  lambda: vec_agg_bwd_plain(vec, s1, s2m, d, idx, mask, gva),
                                  nbytes(vec, s2m, d, idx, mask, gva) + live_b,
                                  nbytes(vec, s1, s2m, d), (2 * e_valid + 2 * e_all) * L * h * 2,
                                  ":461"),
        "vis_wdot" + sfx: ("H", lambda: vis_wdot(d, u, vv, idx, mask),
                           lambda: wdot_plain(d, u, vv, idx, mask),
                           nbytes(d, u, vv, idx, mask), nbytes(s2m),
                           (2 * e_valid + e_all) * L * h * 2 + e_all * h * 4, ":505"),
        "vis_wdot_bwd" + sfx: ("I", lambda: vis_wdot_bwd(d, u, vv, idx, mask, gw),
                               lambda: wdot_bwd_plain(d, u, vv, idx, mask, gw),
                               nbytes(d, u, vv, idx, mask) + live_b, nbytes(u, vv, d),
                               e_valid * 16 * L * h, ":528"),
    }


def vis_mix_rows(batch) -> list[dict]:
    """Kernels F-I at ViSNet's shapes of the batch (`vis_mix_inputs`, their
    own generator), each also against the parent commit's bits
    (F32_BEFORE)."""
    xs = vis_mix_inputs(batch, torch.Generator().manual_seed(17))
    idx, mask = xs["idx"], xs["mask"]
    g, a, k = idx.shape
    L, h = xs["d"].shape[-1], HIDDEN
    e_all, e_valid = g * a * k, int(mask.sum())
    print(f"ViSNet vector mix inputs: G={g}, A={a}, k={k}, L={L}, h={h}; {e_valid} of "
          f"{e_all} edges within 5 Å ({e_valid / e_all:.3f})")
    inputs = digest(*(xs[n] for n in ("vec", "s1", "s2m", "d", "idx", "mask", "u", "vv", "gva",
                                      "gw")))
    same_inputs = inputs == F32_BEFORE["inputs"]
    print(f"f32 F-I inputs' digest {inputs}, the recorded run's {F32_BEFORE['inputs']}"
          f"{'' if same_inputs else ': other inputs, the bits are not compared'}")
    rows = []
    cases = vis_mix_case_table(xs, False)
    for name, (letter, call, plain, in_b, out_b, ops, line) in cases.items():
        got, ref = call(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        bits = digest(*got)
        print(f"kernel {letter} {name} f32 outputs' digest {bits}; the parent's "
              f"{F32_BEFORE[name]}")
        check(not same_inputs or bits == F32_BEFORE[name],
              f"kernel {letter} ({name}) in f32 gave other bits than the parent commit's")
        limit = 1e-5 if letter in "FH" else 1e-4
        err = 0.0
        for x, y in zip(got, ref):
            dmax, scale = float((x - y).abs().max()), float(y.abs().max())
            err = max(err, dmax)
            ok = dmax <= limit * scale + 1e-6
            print(f"kernel {letter} {name} {tuple(x.shape)}: max|d| {dmax:.3e}, max|ref| "
                  f"{scale:.3e} (limit {limit:g} * max|ref| + 1e-6): {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel {letter} ({name}) disagrees with its plain version")
        again = call()
        again = again if isinstance(again, tuple) else (again,)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"kernel {letter} gave other bits on a second run")
        del got, ref, again
        mib, plain_mib = alloc_mib(call), alloc_mib(plain)
        ms, plain_ms = median_ms(call, plain)
        row = dict(name=name, route="cuda", source="equihgnn_tpu_torch/csrc/vis_mix.cu",
                   replaces=f"equihgnn_tpu/ops/pallas/vis_mix.py{line}", max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=None, **bound(in_b + out_b, ops))
        # one call a sample includes the wrapper's host work: the device time alone too
        alone = profiled_device_ms(call)
        print(f"kernel {letter} {name}: {ms:.4f} ms vs plain {plain_ms:.4f} ms (median of 20, "
              f"CUDA events); device alone {alone:.4f} ms (torch.profiler); bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({(in_b + out_b) / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP); a call allocates "
              f"{mib:.1f} MiB at peak, the plain version {plain_mib:.1f} MiB; deterministic")
        rows.append(row)
    return rows


def vis_mix_bf16_rows(batch) -> list[dict]:
    """Kernels F-I in bf16 (the bf16 ViSNet's variants) at ViSNet's shapes
    of the batch (`vis_mix_inputs` in bf16, s1 a strided view), each against
    its plain bf16 version on the card (f32 sums in the kernels' order,
    rounded once; G's and I's per-edge terms of dvec and dvv rounded first):
    within one bf16 ulp, at least 99 % the same bits, the same bits twice;
    timed one call a sample (alternating with the plain version) and by
    device time alone; bound by the bf16 bytes they must move at
    PEAK_BYTES_S, their f32 products at the f32 peak. Rows "<wrapper> bf16"."""
    x = vis_mix_inputs(batch, torch.Generator().manual_seed(18), torch.bfloat16)
    rows = []
    cases = vis_mix_case_table(x, True)
    for name, (letter, call, plain, in_b, out_b, ops, line) in cases.items():
        got, ref = call(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(check_bf16(f"kernel {letter} {name} {tuple(t.shape)}", t, r)
                  for t, r in zip(got, ref))
        again = call()
        again = again if isinstance(again, tuple) else (again,)
        check(all(torch.equal(t, r) for t, r in zip(got, again)),
              f"kernel {letter} bf16 gave other bits on a second run")
        del got, ref, again
        ms, plain_ms = median_ms(call, plain)
        alone = profiled_device_ms(call)
        row = dict(name=name, route="cuda", source="equihgnn_tpu_torch/csrc/vis_mix.cu",
                   replaces=f"equihgnn_tpu/ops/pallas/vis_mix.py{line}", max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=None, **bound(in_b + out_b, ops))
        print(f"kernel {letter} {name}: {ms:.4f} ms vs plain {plain_ms:.4f} ms (median of 20, "
              f"CUDA events); device alone {alone:.4f} ms (torch.profiler); bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({(in_b + out_b) / 1e9:.3f} GB, "
              f"{ops / 1e9:.2f} GFLOP); deterministic")
        rows.append(row)
    del x
    torch.cuda.empty_cache()
    return rows


def pooled_conv_rows(batch, gen) -> list[dict]:
    """Kernels J and K at the SE(3)-Transformer's pooled sites of the batch:
    h [G, A, 16, 128] (the radial hidden, zero on the neighbours the 5 Å
    radius masks), tc [G, A, 16, C·256], W [128, 256, 256]; C = 1 (conv_in
    0 → 0, conv_out 0 → 0 and 1 → 0) and C = 3 (conv_in 0 → 1). J is called
    as the model calls it, with the sites that have a neighbour as `live`,
    and without `live` (every site computed); both held to the plain
    version. Returns the rows at C = 1 (J: with `live`); C = 3 is printed."""
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
        live_sites,
        pooled_conv,
        pooled_conv_bwd,
        pooled_conv_bwd_plain,
        pooled_conv_plain,
    )

    dev = torch.device("cuda")
    mask = pooled_mask(batch)
    g, a, k = mask.shape
    f, i, o = 128, HIDDEN, HIDDEN
    s = g * a
    live = mask.any(-1)
    sites = live_sites(live)  # what `_ConvSE3Pair._pooled` passes, built once a conv
    # the function needs h and tc on the masked-in neighbours only, and the
    # projection and the output at the sites that have one: M is 0 elsewhere
    e_live, s_live = int(mask.sum()), int(live.sum())
    print(f"SE(3)-Transformer pooled sites: G={g}, A={a}, k={k}; {e_live} of {s * k} neighbour "
          f"slots within 5 Å ({e_live / (s * k):.3f}), {s_live} of {s} sites with one at least")
    rows = []
    for c in (1, 3):
        h = torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]
        tc = torch.randn(g, a, k, c * i, generator=gen).to(dev) * mask[..., None]
        w = (torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5
        dout = torch.randn(g, a, c, o, generator=gen).to(dev)
        m_mib = s * c * i * f * 4 / 2**20  # the M the plain version builds
        edge_b, w_b, out_b = e_live * (f + c * i) * 4, f * o * i * 4, s_live * c * o * 4
        m_ops, proj_ops = 2 * e_live * c * i * f, 2 * s_live * c * i * f * o
        # the M rebuild, dh and dtc (3 M-sized contractions), dM = dout·Wᵀ and dW
        k_ops = 3 * m_ops + 2 * proj_ops
        # J's and K's route runs three TF32 products for each f32 one; the
        # f32 bound (the CUDA cores' peak) is printed beside it
        j_bound = bound(edge_b + w_b + out_b, 3 * (m_ops + proj_ops), PEAK_TF32_S)
        k_bound = bound(2 * edge_b + 2 * w_b + out_b, 3 * k_ops, PEAK_TF32_S)
        f32_bound = {"J": bound(edge_b + w_b + out_b, m_ops + proj_ops)["bound_ms"],
                     "K": bound(2 * edge_b + 2 * w_b + out_b, k_ops)["bound_ms"]}
        cases = {
            # name: (letter, kernel call, plain call, library call, bound, operations, line)
            "pooled_conv": ("J", lambda: pooled_conv(h, tc, w, c, sites),
                            lambda: pooled_conv_plain(h, tc, w, c, live),
                            lambda: torch.einsum("gakf,gakci,foi->gaco", h,
                                                 tc.view(g, a, k, c, i), w),
                            j_bound, m_ops + proj_ops, ":200"),
            "pooled_conv (every site)": ("J", lambda: pooled_conv(h, tc, w, c),
                                         lambda: pooled_conv_plain(h, tc, w, c), None,
                                         j_bound, m_ops + proj_ops, ":200"),
            # K as the model's backward calls it, with the live sites J saved
            "pooled_conv_bwd": ("K", lambda: pooled_conv_bwd(h, tc, w, c, dout, sites),
                                lambda: pooled_conv_bwd_plain(h, tc, w, c, dout, live), None,
                                k_bound, k_ops, ":233"),
            "pooled_conv_bwd (every site)": ("K", lambda: pooled_conv_bwd(h, tc, w, c, dout),
                                             lambda: pooled_conv_bwd_plain(h, tc, w, c, dout),
                                             None, k_bound, k_ops, ":233"),
        }
        for name, (letter, call, plain, library, bnd, ops, line) in cases.items():
            with torch.no_grad():
                got, ref = call(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = 0.0
            for x, y in zip(got, ref):
                dmax, scale = float((x - y).abs().max()), float(y.abs().max())
                err = max(err, dmax)
                ok = dmax <= 1e-4 * scale + 1e-6
                print(f"kernel {letter} {name} C={c} {tuple(x.shape)}: max|d| {dmax:.3e}, max|ref| "
                      f"{scale:.3e} (limit 1e-4 * max|ref| + 1e-6): {'ok' if ok else 'FAIL'}")
                check(ok, f"kernel {letter} ({name}) at C = {c} disagrees with its plain version")
            with torch.no_grad():
                again = call()
            again = again if isinstance(again, tuple) else (again,)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"kernel {letter} ({name}) at C = {c} gave other bits on a second run")
            if name in ("pooled_conv", "pooled_conv_bwd"):  # dead: J's out, K's dh and dtc
                check(not any(x[~live].any() for x in got[:2 if letter == "K" else 1]),
                      f"kernel {letter} ({name}) is not 0 at the dead sites")
            del got, ref, again
            with torch.no_grad():
                mib = alloc_mib(call)
                check(mib < m_mib / 4, f"kernel {letter} allocated M-sized memory")
                fns = [call, plain] + ([library] if library else [])
                times = median_ms(*fns, iters=10)
            ms, plain_ms = times[:2]
            library_ms = times[2] if library else None
            src = "pooled_conv_fwd.cu" if letter == "J" else "pooled_conv.cu"
            row = dict(name=name, route="cuda", source=f"equihgnn_tpu_torch/csrc/{src}",
                       replaces=f"equihgnn_tpu/ops/pallas/pooled_conv.py{line}", max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)
            lib_txt = f", torch.einsum {library_ms:.4f} ms" if library else ""
            print(f"kernel {letter} {name} [G={g}, A={a}, k={k}, C={c}, I={i}, F={f}, O={o}]: "
                  f"{ms:.4f} ms vs plain {plain_ms:.4f} ms{lib_txt} (median of 10, CUDA events); "
                  f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; route {TF32_ROUTE}, "
                  f"bound {bnd['bound_ms']:.4f} ms at the TF32 peak (3 products each), "
                  f"{f32_bound[letter]:.4f} ms at the f32 peak; "
                  f"{ops / 1e12:.3f} TFLOP of live work, {ops / ms / 1e9:.1f} TFLOP/s achieved; "
                  f"a call allocates {mib:.1f} MiB at peak (M would be {m_mib:.1f} MiB); "
                  f"deterministic")
            if letter == "K":  # each of K's kernels' share of the call
                with torch.no_grad():
                    split = kernel_split(call)
                print(f"  kernel K {name} C={c} by kernel (torch.profiler, device time): " +
                      "; ".join(f"{kname} {t:.4f} ms ({t / sum(split.values()):.1%})"
                                for kname, t in split.items()))
            if c == 1 and "every site" not in name:
                rows.append(row)
        del h, tc, w, dout
        torch.cuda.empty_cache()
    return rows


def pooled_conv_bf16_rows(batch, gen) -> list[dict]:
    """Kernels J and K in bf16 (`csrc/pooled_conv_bf16.cu`, the bf16
    recipe's fused pooled units) at the pooled sites of the batch, as
    `pooled_conv_rows` (k = 16, F = 128, I = O = 256; C = 1 and 3; with the
    model's `live` and without), in bf16: each against its plain bf16
    version on the card within one bf16 ulp, at least 99 % the same bits
    (K's dh and dtc past `bwd_bf16_rounding_bound`: the two round dM from
    f32 sums in other orders, and dh, dtc sum 256 or 128 such terms that
    can cancel), the same bits twice, 0 (+0 for dh and dtc) at the dead
    sites; timed one call a sample (alternating with the plain version
    and, for J, the one bf16 `torch.einsum` call, for K with `live` its
    cuBLAS composition, `k_bf16_reference`; 10 samples, 5 for every
    site) and, with `live`, by device time alone and by kernel, which
    must show the TMA kernels (`fwd_tma_kernel`, `dm_tma_kernel`); bound at
    the bf16 peak (J 2(E·CIF + S'·CIFO), K 2(3E·CIF + 2S'·CIFO))
    or by the bf16 bytes. Rows "pooled_conv bf16" and "pooled_conv_bwd
    bf16" at C = 1 with `live`; the rest printed."""
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
        bwd_bf16_rounding_bound,
        live_sites,
        pooled_conv,
        pooled_conv_bwd,
        pooled_conv_bwd_plain,
        pooled_conv_plain,
    )

    dev = torch.device("cuda")
    mask = pooled_mask(batch)
    g, a, k = mask.shape
    f, i, o = 128, HIDDEN, HIDDEN
    live = mask.any(-1)
    sites = live_sites(live)
    e_live, s_live = int(mask.sum()), int(live.sum())
    rows = []
    for c in (1, 3):
        h = (torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]).bfloat16()
        tc = (torch.randn(g, a, k, c * i, generator=gen).to(dev) * mask[..., None]).bfloat16()
        w = ((torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5).bfloat16()
        dout = torch.randn(g, a, c, o, generator=gen).to(dev).bfloat16()
        edge_b, w_b, out_b = e_live * (f + c * i) * 2, f * o * i * 2, s_live * c * o * 2
        m_ops, proj_ops = 2 * e_live * c * i * f, 2 * s_live * c * i * f * o
        j_bytes, k_bytes = edge_b + w_b + out_b, 2 * edge_b + 2 * w_b + out_b
        j_bound = bound(j_bytes, m_ops + proj_ops, PEAK_BF16_S)
        # K reads h, tc, W and dout, writes dh, dtc and dW; the M rebuild, dh
        # and dtc (3 M-sized contractions), dM = dout·Wᵀ and dW
        k_bound = bound(k_bytes, 3 * m_ops + 2 * proj_ops, PEAK_BF16_S)
        cases = {
            # name: (letter, kernel call, plain call, library call, bound, operations, mask)
            "pooled_conv bf16": ("J", lambda: pooled_conv(h, tc, w, c, sites),
                                 lambda: pooled_conv_plain(h, tc, w, c, live),
                                 lambda: torch.einsum("gakf,gakci,foi->gaco", h,
                                                      tc.view(g, a, k, c, i), w),
                                 j_bound, j_bytes, m_ops + proj_ops, live),
            "pooled_conv bf16 (every site)": ("J", lambda: pooled_conv(h, tc, w, c),
                                              lambda: pooled_conv_plain(h, tc, w, c), None,
                                              j_bound, j_bytes, m_ops + proj_ops, None),
            "pooled_conv_bwd bf16": ("K", lambda: pooled_conv_bwd(h, tc, w, c, dout, sites),
                                     lambda: pooled_conv_bwd_plain(h, tc, w, c, dout, live),
                                     None, k_bound, k_bytes, 3 * m_ops + 2 * proj_ops, live),
            "pooled_conv_bwd bf16 (every site)": (
                "K", lambda: pooled_conv_bwd(h, tc, w, c, dout),
                lambda: pooled_conv_bwd_plain(h, tc, w, c, dout), None, k_bound, k_bytes,
                3 * m_ops + 2 * proj_ops, None),
        }
        for name, (letter, call, plain, library, bnd, nb, ops, lv) in cases.items():
            with torch.no_grad():
                got, ref = call(), plain()
                again = call()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            again = again if isinstance(again, tuple) else (again,)
            slack = (bwd_bf16_rounding_bound(h, tc, w, c, dout, lv) + (None,)
                     if letter == "K" else (None,))
            err = max(check_bf16(f"kernel {letter} {name} C={c} {out_name} "
                                 f"{tuple(x.shape)}", x, y, slack=sl, rounded="dM")
                      for out_name, x, y, sl in zip(("out",) if letter == "J" else
                                                    ("dh", "dtc", "dW"), got, ref, slack))
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"kernel {letter} ({name}) at C = {c} gave other bits on a second run")
            if lv is not None:  # J's out 0, K's dh and dtc +0 in every bit at the dead sites
                check(not any(x[~lv].view(torch.int16).any()
                              for x in got[:2 if letter == "K" else 1]),
                      f"kernel {letter} ({name}) is not +0 at the dead sites")
            del got, ref, again, slack
            torch.cuda.empty_cache()
            every = "every site" in name  # timed alongside only (the script's time limit)
            # K's yardstick: the cuBLAS composition of its function (a reference)
            reference = (k_bf16_reference(h, tc, w, c, dout, lv)
                         if letter == "K" and not every else None)
            with torch.no_grad():
                fns = [call, plain] + ([library] if library else []) + (
                    [reference] if reference else [])
                times = median_ms(*fns, iters=5 if every else 10)
                alone = None if every else profiled_device_ms(call, calls=5)
                lib_alone = profiled_device_ms(library, calls=5) if library else None
                ref_alone = profiled_device_ms(reference, calls=5) if reference else None
            ms, plain_ms = times[:2]
            library_ms = times[2] if library else None
            row = dict(name=name, route="cuda",
                       source="equihgnn_tpu_torch/csrc/pooled_conv_bf16.cu",
                       replaces="equihgnn_tpu/ops/pallas/pooled_conv.py"
                                + (":200" if letter == "J" else ":233"),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)
            lib_txt = (f", bf16 torch.einsum {library_ms:.4f} ms (device alone "
                       f"{lib_alone:.4f})" if library else "")
            alone_txt = "" if alone is None else f"; device alone {alone:.4f} ms (torch.profiler)"
            if reference:
                alone_txt += (f"; cuBLAS composition (a reference, not one call) {times[-1]:.4f} "
                              f"ms, device alone {ref_alone:.4f}")
            del reference
            print(f"kernel {letter} {name} [G={g}, A={a}, k={k}, C={c}, I={i}, F={f}, O={o}]: "
                  f"{ms:.4f} ms vs plain {plain_ms:.4f} ms{lib_txt} (median of "
                  f"{5 if every else 10}, CUDA events){alone_txt}; bound {row['bound_ms']:.4f} ms "
                  f"by {row['bound_by']} ({ops / PEAK_BF16_S * 1e3:.4f} ms of operations at the "
                  f"bf16 peak, {nb / PEAK_BYTES_S * 1e3:.4f} ms of bytes); {ops / 1e12:.3f} "
                  f"TFLOP of live work, {ops / ms / 1e9:.1f} TFLOP/s achieved; deterministic")
            if not every:
                with torch.no_grad():
                    split = kernel_split(call)
                print(f"  kernel {letter} {name} C={c} by kernel (torch.profiler, device time): "
                      + "; ".join(f"{kname} {t:.4f} ms ({t / sum(split.values()):.1%})"
                                  for kname, t in split.items()))
                # the model's shapes take the TMA kernels (the launch counters
                # count wrapper calls, not which kernel the C entry chose)
                fast = "fwd_tma_kernel" if letter == "J" else "dm_tma_kernel"
                check(fast in split, f"kernel {letter} ({name}) at C = {c} did not run {fast}")
            if c == 1 and not every:
                rows.append(row)
        del h, tc, w, dout
        torch.cuda.empty_cache()
    return rows


def k_bf16_reference(h, tc, w, c: int, dout, live):
    """The cuBLAS composition of kernel K's bf16 function at the live sites
    of `live` [G, A] (gathered here, once, with W re-laid as [O, I·F]): one
    bf16 matmul for dM, two `torch.bmm` for dh and dtc, M's `torch.bmm` and
    a matmul for dW. K's yardstick, not one call and not the port's: returns
    the function to time."""
    g, a, k, f = h.shape
    o, i = w.shape[1], w.shape[2]
    idx = live.reshape(-1).nonzero().squeeze(1)
    n = idx.numel()
    hl = h.reshape(g * a, k, f)[idx]
    tcl = tc.reshape(g * a, k, c * i)[idx]
    dl = dout.reshape(g * a, c, o)[idx].reshape(n * c, o)
    wr = w.permute(1, 2, 0).reshape(o, i * f)

    def run():
        dm = (dl @ wr).view(n, c * i, f)
        m = torch.bmm(tcl.transpose(1, 2), hl)
        return (torch.bmm(tcl, dm), torch.bmm(hl, dm.transpose(1, 2)),
                m.view(n * c, i * f).t() @ dl)
    return run


def pooled_conv_digests() -> dict[str, str]:
    """`digest`s of the f32 kernels J's and K's outputs on inputs drawn on
    the CPU from seed 20 (G = 64, A = 32, k = 16, F = 128, I = O = 256, a
    random live mask; C = 1 and 3): J with the live sites and without, K
    with them and without; and the inputs' own digest."""
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import pooled_conv, pooled_conv_bwd

    gen = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")
    g, a, k, f, i, o = 64, 32, 16, 128, HIDDEN, HIDDEN
    inputs, out = [], {}
    for c in (1, 3):
        live = (torch.rand(g, a, generator=gen) < 0.6).to(dev)
        h = torch.randn(g, a, k, f, generator=gen).to(dev)
        tc = torch.randn(g, a, k, c * i, generator=gen).to(dev)
        w = ((torch.rand(f, o, i, generator=gen) * 2 - 1) / f ** 0.5).to(dev)
        dout = torch.randn(g, a, c, o, generator=gen).to(dev)
        inputs += [live, h, tc, w, dout]
        with torch.no_grad():
            out[f"J C={c}"] = digest(pooled_conv(h, tc, w, c, live), pooled_conv(h, tc, w, c))
        out[f"K C={c}"] = digest(*pooled_conv_bwd(h, tc, w, c, dout, live),
                                 *pooled_conv_bwd(h, tc, w, c, dout))
    return {"inputs": digest(*inputs), **out}


# The f32 kernels J's and K's outputs at `pooled_conv_digests`' inputs, as
# the kernels of the parent commit 413d80c computed them on the card (its
# first 16 hex digits), beside the digest of those inputs: the f32 J and K
# (`pooled_conv_fwd.cu`, `pooled_conv.cu`) are the parent's source, the
# bf16 ones live apart. The inputs come from torch's CPU generator; a run
# whose inputs have another digest (another torch's generator) fails.
PC_F32_BEFORE = {"inputs": "7d85e3fb79b0d772", "J C=1": "b2ca57cd3e9a5f6b",
                 "K C=1": "141d4182eae509fa", "J C=3": "90e44e203a08218b",
                 "K C=3": "7a21de8a906df8ae"}


def check_pooled_conv_f32_bits() -> None:
    got = pooled_conv_digests()
    print(f"f32 J/K digests {got}; the parent's {PC_F32_BEFORE}")
    check(got["inputs"] == PC_F32_BEFORE["inputs"],
          "the f32 J/K digests' inputs differ from those recorded: nothing to compare with")
    for name, bits in got.items():
        check(bits == PC_F32_BEFORE[name], f"f32 kernel {name} gave other bits than the parent's")


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in bfloat16 ulps (bit patterns as ordered integers)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -32768 - bits, bits)
    return int((ordered(got) - ordered(want)).abs().max()) if want.numel() else 0


def pooled_m_rows(batch, gen) -> list[dict]:
    """Kernels L and M at the pooled sites of BF16_PATH (bf16, hidden 64):
    h [G, A, 16, 128] and tc [G, A, 16, X], zero on the neighbours the 5 Å
    radius masks; X = C·I = 64 (conv_in 0 → 0, conv_out 0 → 0 and 1 → 0)
    and 192 (conv_in 0 → 1); dM [G, A, X, 128]. Returns the rows at X = 64;
    X = 192 is printed. Then, recorded only, L in f32 at the recipe's C = 1
    unit (X = I = 256) with its projection as one cuBLAS product, against
    kernel J."""
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import pooled_conv
    from equihgnn_tpu_torch.ops.kernels.pooled_m import (
        pooled_m,
        pooled_m_bwd,
        pooled_m_bwd_plain,
        pooled_m_plain,
    )

    dev = torch.device("cuda")
    mask = pooled_mask(batch)
    g, a, k = mask.shape
    f, s = 128, g * a
    e_live, s_live = int(mask.sum()), int(mask.any(-1).sum())
    dead = ~mask.any(-1)  # the sites with no neighbour: h = tc = 0 there
    masked = lambda *shape: (torch.randn(*shape, generator=gen).to(dev)  # noqa: E731
                             * mask[..., None])
    rows = []
    for x in (64, 192):
        h, tc = masked(g, a, k, f).bfloat16(), masked(g, a, k, x).bfloat16()
        dm = torch.randn(g, a, x, f, generator=gen).to(dev).bfloat16()
        # what the function needs: h and tc on the masked-in neighbours and M
        # in full (L); those, dM at the sites with a neighbour, dh and dtc in
        # full (M); the products over the masked-in neighbours
        live_b = e_live * (f + x) * 2
        dms = dm.view(s, x, f)
        cases = {
            # name: (letter, kernel call, plain call, library call, reference call (timed,
            # not the library yardstick), bytes, operations, line)
            "pooled_m": ("L", lambda: pooled_m(h, tc), lambda: pooled_m_plain(h, tc),
                         lambda: torch.bmm(tc.view(s, k, x).transpose(1, 2), h.view(s, k, f)),
                         None, live_b + s * x * f * 2, 2 * e_live * x * f, ":109"),
            # M's two outputs as two torch.bmm calls: dh = tc·dM, dtc = h·dMᵀ
            "pooled_m_bwd": ("M", lambda: pooled_m_bwd(h, tc, dm),
                             lambda: pooled_m_bwd_plain(h, tc, dm), None,
                             lambda: (torch.bmm(tc.view(s, k, x), dms),
                                      torch.bmm(h.view(s, k, f), dms.transpose(1, 2))),
                             live_b + s_live * x * f * 2 + s * k * (f + x) * 2,
                             4 * e_live * x * f, ":130"),
        }
        for name, (letter, call, plain, library, reference, nb, ops, line) in cases.items():
            with torch.no_grad():
                got, ref = call(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = 0.0
            for t, y in zip(got, ref):
                equal, ulps = float((t == y).float().mean()), _bf16_ulps(t, y)
                err = max(err, float((t.float() - y.float()).abs().max()))
                ok = equal >= 0.99 and ulps <= 1
                print(f"kernel {letter} {name} X={x} {tuple(t.shape)} bf16: {equal:.6f} of the "
                      f"elements equal to the plain version's, {ulps} bf16 ulps at most (limits "
                      f"0.99, 1: both round an f32 sum once): {'ok' if ok else 'FAIL'}")
                check(ok, f"kernel {letter} ({name}) at X = {x} disagrees with its plain version")
                if letter == "M":
                    # M reads no dM at a site with no neighbour and writes +0 there, the
                    # plain version's value for a finite dM (random and non-zero here)
                    zero = not t[dead].view(torch.int16).any()
                    print(f"kernel M {name} X={x}: {int(dead.sum())} sites with no neighbour, "
                          f"dM there non-zero; their gradient +0 in every bit: "
                          f"{'ok' if zero else 'FAIL'}")
                    check(zero, f"kernel M at X = {x} wrote other than +0 at a dead site")
            with torch.no_grad():
                again = call()
            again = again if isinstance(again, tuple) else (again,)
            check(all(torch.equal(t, y) for t, y in zip(got, again)),
                  f"kernel {letter} at X = {x} gave other bits on a second run")
            del got, ref, again
            fns = [fn for fn in (call, plain, library, reference) if fn]
            with torch.no_grad():
                times = median_ms(*fns, reps=10)
                # and one call a sample, host launch work included (the older method)
                one = median_ms(*fns)
                # and the device time alone (torch.profiler), of the kernel and of the
                # library or reference calls
                alone = [profiled_device_ms(fn) for fn in (call, *fns[2:])]
            ms, plain_ms = times[:2]
            library_ms = times[2] if library else None
            row = dict(name=name, route="cuda", source="equihgnn_tpu_torch/csrc/pooled_m.cu",
                       replaces=f"equihgnn_tpu/ops/pallas/pooled_m.py{line}", max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       **bound(nb, ops, PEAK_BF16_S))
            bmm = "torch.bmm" if library else "two torch.bmm (dh, dtc)"
            one_txt = ", ".join(f"{t:.4f}" for t in one)
            print(f"kernel {letter} {name} [G={g}, A={a}, k={k}, F={f}, X={x}] bf16: {ms:.4f} ms vs "
                  f"plain {plain_ms:.4f} ms, {bmm} {times[2]:.4f} ms (median of 20 samples of 10 "
                  f"calls back to back, CUDA events; one call a sample: {one_txt} ms; device "
                  f"alone (torch.profiler): {alone[0]:.4f} ms, {bmm} {alone[1]:.4f} ms); bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({nb / 1e9:.3f} GB, "
                  f"{ops / 1e9:.2f} GFLOP at the bf16 peak); {nb / ms / 1e6:.1f} GB/s achieved; "
                  f"deterministic")
            if x == 64:
                rows.append(row)
        del h, tc, dm
        torch.cuda.empty_cache()

    # the per-J route in f32 at the recipe's C = 1 unit, against J (record only)
    i = o = HIDDEN
    h, tc = masked(g, a, k, f), masked(g, a, k, i)
    w = (torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5
    with torch.no_grad():
        route = lambda: torch.einsum("foi,gaif->gao", w, pooled_m(h, tc).view(g, a, i, f))  # noqa: E731
        fused = lambda: pooled_conv(h, tc, w, 1)  # noqa: E731
        d = float((route() - fused()[:, :, 0]).abs().max()) / float(fused().abs().max())
        l_ms, route_ms, j_ms = median_ms(lambda: pooled_m(h, tc), route, fused, iters=10)
    print(f"f32 at the recipe's C = 1 unit [G={g}, A={a}, k={k}, I=O={i}, F={f}], recorded only: "
          f"kernel L {l_ms:.4f} ms, L + the cuBLAS projection {route_ms:.4f} ms, kernel J "
          f"{j_ms:.4f} ms (median of 10, CUDA events); the two routes differ by {d:.3e} of "
          f"max|J|")
    del h, tc, w
    torch.cuda.empty_cache()
    return rows


def recipe(path: str | None = None):
    """The bench recipe, with `path`'s changes."""
    from equihgnn_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(mlp_hidden=HIDDEN, output_hidden=128, all_num_layers=3,
                      output_num_layers=3, aggregate="mean", normalization="ln")
    return dataclasses.replace(cfg, **PATHS[path][1]) if path else cfg


def live_branches(model):
    """`model`, with the Equiformer's zero-init output weights (each
    `attn_i.to_out` and `ff_i.project_out`) drawn at FiberLinear's non-zero
    init scale 1/√dim_in from seed 7: at zero both branches add exactly 0
    and their inner weights get exactly zero gradient, so a comparison
    would hold nothing of them. Other models are left as they are."""
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if re.fullmatch(r"equiformer_layer\.(attn_\d+\.to_out|ff_\d+\.project_out)\.w\d+",
                            name):
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[0] ** -0.5)
    return model


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


def phase_serve(path: str, samples, smi: str) -> dict[str, int]:
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.predict import build_parser, predict_samples, run, save_checkpoint

    method, cfg = PATHS[path][0], recipe(path)
    dev = torch.device("cuda")
    model = live_branches(create_model(method, num_target=1, cfg=cfg,
                                       generator=torch.Generator().manual_seed(0)))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "model.pt"), model, method, cfg, std=1.0)
        out_gpu, out_cpu = os.path.join(tmp, "gpu.csv"), os.path.join(tmp, "cpu.csv")

        reset_launches()
        with host_quiet():
            t0 = time.perf_counter()
            run(build_parser().parse_args(
                ["--ckpt", ckpt, "--sdf", SDF, "--out", out_gpu, "--device", "cuda"] +
                (["--compute_dtype", cfg.compute_dtype] if cfg.compute_dtype else [])))
            t_sdf = time.perf_counter() - t0
        model_gpu = model.to(dev).eval()
        preds = predict_samples(model_gpu, samples, BATCH, dev)
        launches = read_launches()
        print(f"{path} launches while serving (2 requests, 1 batch each): {launches}")
        check(launches == expected_launches(path, 2, 0),
              f"the served requests did not run through {path}'s kernels as expected")

        rows = read_csv(out_gpu)
        vals = np.array([float(r["prediction"]) for r in rows])
        print(f"serve {os.path.relpath(SDF, ROOT)} on cuda: {len(rows)} rows in "
              f"{t_sdf:.2f} s, predictions [{vals.min():.5f}, {vals.max():.5f}]")
        check(len(rows) == 20, "expected 20 prediction rows")
        check(bool(np.isfinite(vals).all()), "non-finite prediction in the SDF request")
        check(rows[4]["title"] == "benzene", f"row 4 is {rows[4]['title']!r}, not benzene")
        if cfg.compute_dtype:
            check_bf16_serve(model, method, cfg, vals, samples, preds,
                             BF16_SERVE_CUT.get(path, 64))
        else:
            check_serve_against_cpu(model, ckpt, out_cpu, vals, rows)
        model.to(dev)

    check(preds.shape == (BATCH,), f"batch-{BATCH} request gave shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), f"non-finite prediction in the batch-{BATCH} request")
    print(f"batch-{BATCH} request: {preds.shape[0]} finite predictions, "
          f"mean {preds.mean():.5f}, std {preds.std():.5f}")

    serve_rates(path, model_gpu, samples, smi)
    return launches


def request_batch(path: str, samples, target: int | None = None):
    """The one padded batch of `samples` (a BATCH spec) that `path`'s model
    reads: plain graphs for the 2-D baselines, else hypergraphs with
    positions."""
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples

    hyper = PATHS[path][0] not in GRAPH_METHODS
    return next(iter_batches(samples, spec_for_samples(samples, BATCH), hyper=hyper,
                             with_pos=hyper, target=target))


@quiet
def serve_rates(path: str, model_gpu, samples, smi: str) -> None:
    """The batch-768 request's throughput (host batching + copy + forward,
    median of 5 after a warm-up), the forward alone and its peak memory."""
    from equihgnn_tpu_torch.predict import predict_samples

    dev = torch.device("cuda")
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_samples(model_gpu, samples, BATCH, dev)
        torch.cuda.synchronize()
        if i:  # the first call is a warm-up
            times.append(time.perf_counter() - t0)
    t_req = float(np.median(times))
    batch_dev = request_batch(path, samples).to(dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms, = median_ms(lambda: model_gpu(batch_dev), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"{path} served: {BATCH / t_req:.1f} molecules/s end to end (batch {BATCH}, "
          f"median request {t_req * 1e3:.2f} ms incl. host batching); forward alone "
          f"{fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.1f} molecules/s; peak memory "
          f"{peak / 2**20:.1f} MiB; card: {smi}")


def phase_serve_2d(path: str, samples, smi: str) -> dict[str, int]:
    """A 2-D baseline saved as a port checkpoint, served through
    `predict.run` from the SDF and from a SMILES file (SMILES, one a line)
    on the card and on the CPU, molecule by molecule within rtol 1e-4 /
    atol 1e-5; then the batch-768 request of plain graphs. No kernel runs."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.predict import build_parser, predict_samples, run, save_checkpoint

    method, cfg = PATHS[path][0], recipe(path)
    dev = torch.device("cuda")
    model = create_model(method, num_target=1, cfg=cfg, gnn_type=method,
                         generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "model.pt"), model, method, cfg, std=1.0)
        smiles = os.path.join(tmp, "molecules.smi")
        with open(smiles, "w") as f:
            f.write("\n".join(SMILES) + "\n")
        outs = {}

        def serve(src: str, path_in: str, device: str) -> list[dict]:
            out = os.path.join(tmp, f"{src}-{device}.csv")
            run(build_parser().parse_args(["--ckpt", ckpt, f"--{src}", path_in, "--out", out,
                                           "--device", device]))
            return read_csv(out)

        reset_launches()
        with host_quiet():
            t0 = time.perf_counter()
            outs["sdf"] = serve("sdf", SDF, "cuda")
            t_sdf = time.perf_counter() - t0
        outs["smiles"] = serve("smiles", smiles, "cuda")
        model_gpu = model.to(dev).eval()
        preds = predict_samples(model_gpu, samples, BATCH, dev)
        launches = read_launches()
        print(f"{path} launches while serving (3 requests: SDF, SMILES, batch {BATCH}): "
              f"{launches}")
        check(launches == expected_launches(path, 3, 0),
              f"the served requests of {path} launched a kernel")
        for src, src_in, n in (("sdf", SDF, 20), ("smiles", smiles, len(SMILES))):
            rows = outs[src]
            vals = np.array([float(r["prediction"]) for r in rows])
            cpu = np.array([float(r["prediction"]) for r in serve(src, src_in, "cpu")])
            check(len(rows) == n, f"expected {n} prediction rows from the {src} request")
            nan = np.isnan(vals)
            check(bool((nan == np.isnan(cpu)).all()), f"{src}: card and CPU nan rows differ")
            check(int(nan.sum()) == (1 if src == "smiles" else 0), f"{src}: nan rows {nan}")
            d = np.abs(vals[~nan] - cpu[~nan])
            bad = d > 1e-5 + 1e-4 * np.abs(cpu[~nan])
            print(f"serve {src} on cuda: {len(rows)} rows ({int(nan.sum())} unparsed), "
                  f"predictions [{vals[~nan].min():.5f}, {vals[~nan].max():.5f}]; cuda vs cpu "
                  f"max|d| {d.max():.3e} (rtol 1e-4, atol 1e-5): {'FAIL' if bad.any() else 'ok'}")
            check(not bad.any(), f"{src}: card and CPU predictions disagree")
        check(outs["sdf"][4]["title"] == "benzene", "row 4 of the SDF is not benzene")
        benzene = [float(r["prediction"]) for r in outs["smiles"] if r["title"] == "c1ccccc1"]
        d = abs(benzene[0] - float(outs["sdf"][4]["prediction"]))
        print(f"benzene from its SMILES vs from the SDF on the card: |d| {d:.3e}")
        check(d <= 1e-5, "benzene's SMILES and SDF predictions differ")
        print(f"{path} served {os.path.relpath(SDF, ROOT)} in {t_sdf:.2f} s")

    check(preds.shape == (BATCH,), f"batch-{BATCH} request gave shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), f"non-finite prediction in the batch-{BATCH} request")
    print(f"batch-{BATCH} request: {preds.shape[0]} finite predictions, "
          f"mean {preds.mean():.5f}, std {preds.std():.5f}")
    serve_rates(path, model_gpu, samples, smi)
    return launches


def check_serve_against_cpu(model, ckpt: str, out_cpu: str, vals, rows) -> None:
    """The card's SDF predictions against the CPU's, molecule by molecule,
    where the CPU's prediction is well posed (FAFormer's frames)."""
    from equihgnn_tpu_torch.predict import build_parser, featurize_sdf, run

    run(build_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", SDF, "--out", out_cpu, "--device", "cpu",
         "--batch_size", "32"]))
    cpu_vals = np.array([float(r["prediction"]) for r in read_csv(out_cpu)])
    model_cpu = model.to("cpu").eval()
    # the CPU references in batches of the 20 molecules, not of 256: the
    # dense encoders compute every padding row, and each molecule's
    # prediction does not depend on the others
    spread = translation_spread(model_cpu, [m for _, m in featurize_sdf(SDF)], 32)
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


# A bf16 path's predictions on the card against the CPU's bf16 model (plain
# versions): max |card − CPU| at most this share of max |CPU bf16 − CPU f32|,
# i.e. the card's bf16 predictions lie nearer the CPU's than those lie to f32.
# At the init the bf16 predictions move with the order of their sums (the
# trunk's ReLU kinks, fed by a bf16 encoder): the first card run read 0.29
# (SDF) and 0.42 (64 molecules of the request) of that distance (se3 bf16);
# egnn bf16 0.21 / 0.69, mhnns bf16 0.23 / 0.83.
BF16_SERVE_SHARE = 1.0
# molecules of the request the CPU references of a bf16 path take (the others:
# 64); the SE(3)-Transformer's CPU runs at hidden 256 are slow
BF16_SERVE_CUT = {SE3_BF16: 16}


def check_bf16_serve(model, method: str, cfg, vals, samples, preds, n_ref: int = 64) -> None:
    """The bf16 model's predictions on the card against its CPU run (plain
    versions, which `tests/test_torch_se3_bf16.py` holds to JAX's bf16
    model), on the SDF and the first `n_ref` molecules of the batch-768 request,
    in batches of 32 on both: within BF16_SERVE_SHARE of the CPU's own
    bf16-vs-f32 distance at the same weights. Recorded beside it: max |bf16 − f32| / (mean |f32| + 1e-3) on
    the card, the measure of `tests/test_bf16.py:33-35`, whose bound of 0.1
    (set at hidden 16 on 6 molecules) JAX's own bf16 model exceeds at these
    widths (PERF.md)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.predict import featurize_sdf, predict_samples

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    f32 = create_model(method, num_target=1, cfg=dataclasses.replace(cfg, compute_dtype=None))
    f32.load_state_dict(model.state_dict())
    sets = {"SDF": ([m for _, m in featurize_sdf(SDF)], vals),
            f"batch-{BATCH} request": (samples, preds)}
    for what, (mols, card16) in sets.items():
        card32 = predict_samples(f32.to(dev).eval(), mols, BATCH, dev)
        ratio = float(np.abs(card16 - card32).max()) / (float(np.abs(card32).mean()) + 1e-3)
        print(f"{method} bf16 vs f32 at the same weights on the card, {what}: max|d| / "
              f"(mean|f32| + 1e-3) = {ratio:.4f} (recorded; tests/test_bf16.py holds hidden 16 "
              f"to 0.1)")
    # the same batches on both devices: in bf16 a molecule's prediction moves
    # with the batch's padding (other product shapes round otherwise)
    for what, mols in (("SDF", sets["SDF"][0]),
                       (f"the first {n_ref} of the request", samples[:n_ref])):
        card16 = predict_samples(model.to(dev).eval(), mols, 32, dev)
        cpu16 = predict_samples(model.to(cpu).eval(), mols, 32, cpu)
        cpu32 = predict_samples(f32.to(cpu).eval(), mols, 32, cpu)
        d, gap = float(np.abs(card16 - cpu16).max()), float(np.abs(cpu16 - cpu32).max())
        limit = BF16_SERVE_SHARE * gap
        print(f"{method} bf16 on the card vs bf16 on the CPU, {what} in batches of 32: max|d| "
              f"{d:.4e} (limit {BF16_SERVE_SHARE} * the CPU's bf16-vs-f32 distance {gap:.4e} = "
              f"{limit:.4e})")
        check(d <= limit, f"the card's bf16 predictions ({what}) disagree with the CPU's")


# Per-tensor limit on max|card − CPU| / max|CPU| of a train step's gradients,
# the CPU's run taking the card's ReLU pattern (below). FAFormer's is 1e-2:
# with its O(1) encoder outputs some ReLU inputs lie within ~1e-6 of the
# kink, and on the CPU alone one draw of a 1e-6 relative perturbation of the
# trunk's input moved trunk.conv.W2's gradient by 4.0e-3 of its max, another
# by 1e-6 (the phase prints the largest of four draws). The
# SE(3)-Transformer at full width and its init is ill-conditioned: its
# encoder's outputs reach ~2.6e3, and on the CPU alone a 1e-6 relative
# jitter of its atom embedding moved its encoder's gradients by 7.2e-4 of
# their max under the smooth loss, while the card's f32 sums differ from the
# CPU's by 1e-6-1e-5 relative (kernel J: 7.5e-6). Its sound runs read
# 1.990e-3 (step) and 2.991e-3 (encoder); both are held to 1e-2. Its CPU
# references at full width are slow (~17 s a step on 16 molecules), so it
# takes 16 molecules and one jitter draw (GRAD_CUT).
STEP_LIMIT = {"egnn_equihnns": 1e-4, "faformer_equihnns": 1e-2, "visnet_equihnns": 1e-4,
              "se3_transformer_equihnns": 1e-2, "equiformer_equihnns": 1e-4,
              **dict.fromkeys(MHNN_METHODS, 1e-4)}
STEP_LIMIT.update({m: STEP_LIMIT[enc] for m, enc in ENCODER_OF.items()})
STEP_LIMIT.update({CROSS_PATH: 1e-4, **dict.fromkeys(GRAPH_METHODS, 1e-4)})
ENCODER_LIMIT = {"se3_transformer_equihnns": 1e-2}  # the others: 1e-4
# (molecules, jitter draws); the others (32, 4). The hybrids' encoders are held
# by their *_equihnns paths (the encoder-alone check runs there only), so their
# CPU references take 16 molecules and one draw. The draws feed a printed
# reading only (the CPU's own spread); ViSNet's CPU step at full width takes
# ~10 s, so it takes one
# torch threads of the worker process that computes the f32 gradient phases'
# CPU references beside the card's phases (half the card machine's 8 cores)
CPU_WORKER_THREADS = 4
GRAD_CUT = {"se3_transformer_equihnns": (16, 1), BF16_PATH: (16, 0), SE3_BF16: (16, 0),
            **dict.fromkeys(BF16_HYPER_PATHS, (16, 0)), VISNET_BF16: (16, 0),
            FAFORMER_BF16: (16, 0),
            "visnet_equihnns": (32, 1), **dict.fromkeys(HYBRID_METHODS, (16, 1)),
            CROSS_PATH: (32, 1), **dict.fromkeys(GRAPH_METHODS, (64, 2))}
# A ReLU input on the other side of 0 on the card than on the CPU makes the
# step's gradient jump (a ViSNet trunk input 1.7e-6 from 0 moved its step
# gradients by 2.2e-2 of their max). So the phase records every ReLU input
# on both devices and holds the card to a CPU run that takes the card's
# pattern of signs (`relu_sites`). It fails if an input that changed sign
# lay farther from 0 than the card's f32 rounding can move it: KINK of the
# largest |input| of its ReLU call (the scale differs between calls: the
# SE(3)-Transformer's trunk takes its encoder's O(1e3) outputs into a
# Linear, and the ReLU after it sees O(1e3) inputs, where 1e-5 absolute is
# below rounding: it differed between card and CPU by 3.8e-2 there). 1e-5
# for all but the SE(3)-Transformer, whose ill-conditioned encoder (above)
# gets 1e-4.
KINK = {"se3_transformer_equihnns": 1e-4}  # the others: 1e-5
# a parameter of the encoder's first kernel site, its atom embedding, and
# the trunk's first weight: each must be reached on both devices
REACHED = {
    "egnn_equihnns": ("egnn_layer.edge_mlp_0.weight_i", "atom_encoder.atom.embedding"),
    "faformer_equihnns": ("fa_former.edge_module.coord_mlp.fc1.weight",
                          "atom_encoder.atom.embedding"),
    "visnet_equihnns": ("visnet_layer.vis_mp_layers_1.w_src_proj.weight",
                        "visnet_layer.embedding.atom.embedding"),
    "se3_transformer_equihnns": ("se3_transformer_layer.conv_in.pair_0_1.radial_out_W",
                                 "atom_encoder.atom.embedding"),
    # tp_in's 0 → 1 pair, the attention's logits and values, the feed-forward
    "equiformer_equihnns": ("equiformer_layer.tp_in.radial_0_1_out_W",
                            "equiformer_layer.attn_0.to_attn_logits_0.weight",
                            "equiformer_layer.attn_0.to_attn_and_v.radial_1_0_out_W",
                            "equiformer_layer.ff_0.project_out.w0",
                            "atom_encoder.atom.embedding"),
    **dict.fromkeys(MHNN_METHODS, ("atom_encoder.atom.embedding",)),
}
REACHED.update({m: REACHED[enc] for m, enc in ENCODER_OF.items()})


def trunk_reached(method: str) -> tuple[str, ...]:
    """The trunk's first weight, and the hyperedge table where it has one."""
    if method.endswith("s"):
        return ("trunk.conv.W1.lin_0.weight",)
    first = "trunk.layers_0" if method.endswith("m") else "trunk.conv"
    return (f"{first}.W1.lin_0.weight", "trunk.bond_encoder.embedding")


@contextlib.contextmanager
def relu_sites(record: list | None = None, signs: list | None = None):
    """Within it, `torch.nn.functional.relu`, which every ReLU of the port
    calls, and the `leaky_relu` of the 2-D baselines and the Equiformer's
    attention logits append each input to `record` (on the CPU), or, given
    the inputs an earlier run recorded in `signs`, return x · (its recorded
    input > 0), or for a LeakyReLU x where its recorded input ≥ 0 and
    slope · x elsewhere: that run's pattern, with the gradient through it."""
    import torch.nn.functional as F

    from equihgnn_tpu_torch.models import baseline_2d
    from equihgnn_tpu_torch.nn import equiformer

    relu, leaky = F.relu, baseline_2d.leaky_relu
    replay = iter(signs) if signs is not None else None

    def recorded(x):
        if record is not None:
            record.append(x.detach().cpu())
        if replay is None:
            return None
        ref = next(replay, None)
        check(ref is not None and ref.shape == x.shape, "the recorded ReLU pattern does not fit")
        return ref.to(x.device)

    def patched(x, inplace=False):
        ref = recorded(x)
        return relu(x, inplace=inplace) if ref is None else x * (ref > 0).to(x.dtype)

    def patched_leaky(x, negative_slope):
        ref = recorded(x)
        return leaky(x, negative_slope) if ref is None else torch.where(
            ref >= 0, x, x * negative_slope)

    F.relu, baseline_2d.leaky_relu, equiformer.leaky_relu = patched, patched_leaky, patched_leaky
    try:
        yield
    finally:
        F.relu, baseline_2d.leaky_relu, equiformer.leaky_relu = relu, leaky, leaky
    check(replay is None or next(replay, None) is None, "the recorded ReLU pattern was not used up")


def hold_relu_pattern(path: str, cpu_relu: list, card_relu: list, kink_limit: float) -> int:
    """Print the (Leaky)ReLU inputs that lie on the other side of 0 on the
    card than on the CPU, and fail if one lay farther from 0 than the card's
    rounding (`kink_limit` of its call's max |input|). The number of them."""
    check([a.shape for a in cpu_relu] == [b.shape for b in card_relu],
          "the card's ReLU calls differ from the CPU's")
    # per ReLU call: (its scale max|CPU input|, the inputs that changed sign)
    calls = [(float(a.abs().max()), a[(a > 0) != (b > 0)].abs()) for a, b in zip(cpu_relu, card_relu)]
    flipped = sum(x.numel() for _, x in calls)
    worst_flip = worst_diff = 0.0
    for n, ((scale, x), b) in enumerate(zip(calls, card_relu)):
        diff = float((cpu_relu[n] - b).abs().max()) / max(scale, 1e-30)
        worst_diff = max(worst_diff, diff)
        if x.numel():
            worst_flip = max(worst_flip, float(x.max()) / scale)
            print(f"  ReLU call {n} {tuple(b.shape)}: {x.numel()} inputs changed sign, the "
                  f"largest |CPU value| {float(x.max()):.3e} of the call's max|input| "
                  f"{scale:.3e}; max|card - CPU| {diff * scale:.3e}")
    print(f"{path} ReLU inputs on the other side of 0 on the card: {flipped} of "
          f"{sum(a.numel() for a in cpu_relu)} ({len(cpu_relu)} calls), the largest |CPU value| "
          f"among them {worst_flip:.3e} of its call's max|input| (limit {kink_limit:g}); the "
          f"largest |card - CPU| of a call's inputs {worst_diff:.3e} of its max|input|")
    check(worst_flip <= kink_limit, "a ReLU input away from 0 changed sign on the card")
    return flipped


def _grad_model(path: str, device):
    """`phase_grads`' model of `path` on `device` (its weights drawn on the
    CPU from seed 3: the same in every process), in eval mode."""
    from equihgnn_tpu_torch import create_model

    return live_branches(create_model(PATHS[path][0], num_target=1, cfg=recipe(path),
                                      device=device,
                                      generator=torch.Generator().manual_seed(3))).eval()


def _grad_losses(path: str, samples):
    """`phase_grads`' batch of `samples`, its two losses (one train step's
    masked MSE, with a relative jitter of the trunk's input; the encoder's
    output times a fixed random matrix, with a relative jitter of the atom
    embedding), the generator that drew that matrix and draws the jitters,
    and the gradients of a loss on a device. The same in every process."""
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import masked_mse

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

    def encoder_loss(model, b, emb_jitter=None):
        if emb_jitter is not None:  # a relative jitter of the atom embedding
            model.atom_encoder.register_forward_hook(lambda m, i, o: o * (1.0 + emb_jitter))
        return torch.sum(model.encode(b)[b.atom_mask] * proj.to(b.pos.device)[b.atom_mask])

    def grads(device, loss_fn, **kw):
        model = _grad_model(path, device)
        loss_fn(model, batch.to(device), **kw).backward()
        return {n: (p.grad.cpu() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    return batch, gen, step_loss, encoder_loss, grads


def _rel_spread(a, b):
    return max(float((a[n] - b[n]).abs().max()) / float(b[n].abs().max())
               for n in b if b[n] is not None and float(b[n].abs().max()) > 0)


def grads_cpu_refs(path: str, pool) -> dict:
    """The CPU side of `phase_grads` that needs no card: the molecules of
    `pool` whose CPU predictions are the least sensitive to rounding, the
    CPU's step gradients with its own ReLU pattern (recorded), their change
    under the jitter draws, and (an encoder path) the encoder's gradients
    and their change under a jitter. `main` runs it for every such path in a
    worker process, from the start, while the card works on earlier phases."""
    method = PATHS[path][0]
    n_mol, draws = GRAD_CUT.get(path, (32, 4))
    spread = translation_spread(_grad_model(path, "cpu"), pool, len(pool))
    pick = np.sort(np.argsort(spread, kind="stable")[:n_mol])
    out = dict(pick=pick, spread_max=float(spread[pick].max()), cpu_relu=[])
    batch, gen, step_loss, encoder_loss, grads = _grad_losses(path, [pool[i] for i in pick])
    with relu_sites(record=out["cpu_relu"]):
        out["want"] = grads("cpu", step_loss)
    out["cpu_spread"] = max(
        _rel_spread(grads("cpu", step_loss,
                          jitter=1e-6 * torch.randn(batch.num_atoms, HIDDEN, generator=gen)),
                    out["want"])
        for _ in range(draws))
    if method in ENCODER_METHODS:
        out["want_enc"] = grads("cpu", encoder_loss)
        if method in ENCODER_LIMIT:
            jitter = 1e-6 * torch.randn(batch.num_atoms, HIDDEN, generator=gen)
            out["enc_own"] = _rel_spread(grads("cpu", encoder_loss, emb_jitter=jitter),
                                         out["want_enc"])
    return _refs_as(out, lambda t: t.numpy())


def _refs_as(ref: dict, conv) -> dict:
    """`grads_cpu_refs`' result with `conv` applied to its tensors (the
    gradients and the recorded ReLU inputs). The worker returns numpy
    arrays, which its result queue pickles by value: a tensor would cross
    through shared memory, whose allocation failed on the card's machine
    when `host_quiet` stopped the worker."""
    out = dict(ref, cpu_relu=[conv(x) for x in ref["cpu_relu"]])
    for key in ("want", "want_enc"):
        if key in ref:
            out[key] = {n: None if g is None else conv(g) for n, g in ref[key].items()}
    return out


def phase_grads(path: str, pool, refs=None) -> None:
    """Gradients on the card (kernels) against the CPU (plain versions), full
    width, on the 32 (GRAD_CUT) molecules of `pool` whose CPU predictions are
    the least sensitive to rounding, in eval mode (dropout off, gradients
    on): of one train step (masked MSE), and of the encoder alone under a
    smooth loss. `refs`: `grads_cpu_refs`' result for it (a future of the
    worker's), else computed here."""
    method = PATHS[path][0]
    ref = _refs_as(refs.result() if refs is not None else grads_cpu_refs(path, pool),
                   torch.from_numpy)
    n_mol = GRAD_CUT.get(path, (32, 4))[0]
    check(ref["spread_max"] <= 1e-5, f"fewer than {n_mol} well-conditioned molecules")
    samples = [pool[i] for i in ref["pick"]]
    batch, _, step_loss, encoder_loss, grads = _grad_losses(path, samples)

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

    want, card_relu = ref["want"], []
    reset_launches()
    with relu_sites(record=card_relu):
        got = grads("cuda", step_loss)
    launches = read_launches()
    check(launches == expected_launches(path, 1, 1),
          f"the card's train step did not run through {path}'s kernels: {launches}")
    flipped = hold_relu_pattern(path, ref["cpu_relu"], card_relu, KINK.get(method, 1e-5))
    if flipped:
        own, _ = compare(want, got, math.inf, "train step, the CPU's own ReLU pattern")
        with relu_sites(signs=card_relu):
            want = grads("cpu", step_loss)
        print(f"{method} step gradients against the CPU's own ReLU pattern (not held): worst "
              f"max|d| / max|cpu| {own:.3e}")
    limit = STEP_LIMIT[path]
    worst, reached = compare(want, got, limit, "train step")
    for name in (*REACHED[method], *trunk_reached(method)):
        check(want[name] is not None and float(want[name].abs().max()) > 0, f"{name} unreached")
    print(f"{path} gradients, card vs cpu with the card's ReLU pattern, one train step at "
          f"full width on {len(samples)} molecules (CPU translation spread <= "
          f"{ref['spread_max']:.1e}): {reached} parameters reached on both (of {len(want)}), "
          f"worst max|d| / max|cpu| {worst:.3e} (limit {limit:g} per tensor; the CPU's own "
          f"change under a 1e-6 relative jitter of the trunk's input, largest of "
          f"{GRAD_CUT.get(path, (32, 4))[1]} draws: {ref['cpu_spread']:.3e}); launches {launches}")
    if method not in ENCODER_METHODS:
        return  # the MHNN family has no encoder; a hybrid's is held on its *_equihnns path
    enc_limit = ENCODER_LIMIT.get(method, 1e-4)
    worst, reached = compare(ref["want_enc"], grads("cuda", encoder_loss), enc_limit,
                             "encoder, smooth loss")
    own = ""
    if method in ENCODER_LIMIT:
        own = (f"; the CPU's own change under a 1e-6 relative jitter of the atom embedding: "
               f"{ref['enc_own']:.3e}")
    print(f"{method} encoder gradients under a smooth loss (sum of its output times a "
          f"fixed random matrix), card vs cpu: {reached} parameters reached on both, worst "
          f"max|d| / max|cpu| {worst:.3e} (limit {enc_limit:g} per tensor{own})")


def phase_grads_2d(path: str, pool) -> None:
    """A 2-D baseline's train-step gradients (masked MSE, eval mode: the
    masked BatchNorms normalize by their running statistics) at full width
    on GRAD_CUT molecules of `pool`, on the card against the CPU run that
    takes the card's ReLU and LeakyReLU signs: within STEP_LIMIT of a
    tensor's max |CPU| plus twice the CPU's own change under a 1e-6
    relative jitter of the atom embedding (the same signs; GRAD_CUT draws),
    every parameter reached on both; no kernel runs. The jitter term is for
    the attention softmaxes' gradients, which f32 resolves to ~2e-4 of
    their max in GATv2's last layer (an H100 read 1.95e-4 at
    `convs_4.att`; the CPU's own change under the jitter 1.4e-4-1.9e-4)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import masked_mse

    method, cfg = PATHS[path][0], recipe(path)
    samples = pool[:GRAD_CUT[path][0]]
    batch = next(iter_batches(samples, spec_for_samples(samples, len(samples)), hyper=False,
                              target=0))

    def grads(device, jitter=None):
        model = create_model(method, num_target=1, cfg=cfg, device=device, gnn_type=method,
                             generator=torch.Generator().manual_seed(3)).eval()
        if jitter is not None:  # a relative jitter of the atom embedding
            model.atom_encoder.register_forward_hook(lambda m, i, o: o * (1.0 + jitter))
        b = batch.to(device)
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        (sq / torch.clamp(cnt, min=1.0)).backward()
        return {n: p.grad.cpu() for n, p in model.named_parameters()}

    cpu_relu, card_relu = [], []
    with relu_sites(record=cpu_relu):
        want = grads("cpu")
    reset_launches()
    with relu_sites(record=card_relu):
        got = grads("cuda")
    launches = read_launches()
    check(launches == expected_launches(path, 1, 1), f"{path}'s train step launched a kernel")
    if hold_relu_pattern(path, cpu_relu, card_relu, KINK.get(method, 1e-5)):
        with relu_sites(signs=card_relu):
            want = grads("cpu")
    gen = torch.Generator().manual_seed(4)
    own = dict.fromkeys(want, 0.0)  # the CPU's own change, relative to max|CPU|
    for _ in range(GRAD_CUT[path][1]):
        jitter = 1e-6 * torch.randn(batch.num_atoms, cfg.gnn_emb_dim, generator=gen)
        with relu_sites(signs=card_relu):
            other = grads("cpu", jitter)
        for name, w in want.items():
            own[name] = max(own[name], float((other[name] - w).abs().max() / w.abs().max()))
    limit, worst, worst_own = STEP_LIMIT[path], (0.0, ""), 0.0
    for name, w in want.items():
        x = got[name]
        check(float(w.abs().max()) > 0 and float(x.abs().max()) > 0,
              f"{name} unreached on the CPU or on the card")
        rel = float((x - w).abs().max()) / float(w.abs().max())
        worst, worst_own = max(worst, (rel, name)), max(worst_own, own[name])
        check(rel <= limit + 2 * own[name],
              f"{name}: card and CPU gradients differ, rel {rel:.3e} > {limit:g} + 2 x the "
              f"CPU's own change {own[name]:.3e}")
    print(f"{path} gradients, card vs cpu with the card's ReLU pattern, one train step at "
          f"full width on {len(samples)} molecules: all {len(want)} parameters reached on "
          f"both, worst max|d| / max|cpu| {worst[0]:.3e} ({worst[1]}; limit {limit:g} per "
          f"tensor + 2 x the CPU's own change under a 1e-6 relative jitter of the atom "
          f"embedding with the card's signs, largest of {GRAD_CUT[path][1]} draws: at most "
          f"{worst_own:.3e}); launches {launches}")


# The bf16 path's gradients on the card against the CPU's bf16 model (plain
# versions), as relative L2 over all parameters, ‖card − CPU‖ / ‖CPU‖: at most
# this share of the CPU's own bf16-vs-f32 distance at the same weights (the
# card's bf16 gradients nearer the CPU's than those lie to f32), for a train
# step (the CPU runs taking the card's pattern of ReLU signs, as in
# `phase_grads`: bf16 moves the trunk's ReLU inputs by far more than the f32
# kink limit) and for the encoder under a smooth loss. Per-tensor limits are
# not held in bf16: at the init the encoder's first layers' bf16 gradients
# differ from their f32 ones by about their norm, in JAX as in the port
# (`tests/test_torch_se3_bf16.py`). The card read 0.38 (step) and 0.39
# (encoder) of that distance; padding a batch otherwise moved the encoder's
# bf16 gradients by 0.11-0.13 of it on the CPU alone (se3 bf16); egnn bf16
# 0.54 / 0.005, mhnns bf16 0.41 / 1e-7.
BF16_GRAD_SHARE = 1.0
# Each attention's query weights (`attn_*.to_q`) scaled by this before a
# path's gradients are compared (the others: as initialized). At the init the
# bf16 recipe's second attention block has logits up to ~2e3 (a row's range
# ~250): its softmax is saturated, what float32 passes through it is tiny
# and what bf16 passes is rounding, so the gradients of every parameter
# before it lie 0.6-0.9 of their norm from float32 on the CPU (those after it
# 0.02-0.08), and any other rounding (the card's) lies ~0.85 of that from
# the CPU's: the check could not tell bf16 from float32. At 0.1 the logits
# stay under ~160 and the gap is 0.08, resolved in every module
# (`se3_bf16_gap.py`).
GRAD_QUERY_SCALE = {SE3_BF16: 0.1}


def _rel_l2(got: dict, want: dict) -> float:
    names = [n for n, w in want.items() if w is not None]
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in names)
    return (num / sum(float((want[n].double() ** 2).sum()) for n in names)) ** 0.5


def phase_grads_bf16(path: str, pool) -> None:
    """A bf16 path's gradients on the card (se3 bf16: kernels L and M; egnn
    bf16: A, B and C; mhnns bf16: A) against the CPU's bf16 model (their
    plain versions), eval mode, on GRAD_CUT
    molecules, the queries scaled by GRAD_QUERY_SCALE: of a train step (masked MSE) and of the encoder under a
    smooth loss, each held to BF16_GRAD_SHARE of the CPU's bf16-vs-f32
    distance; every parameter the CPU reaches must be reached on the card."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import masked_mse

    method, cfg = PATHS[path][0], recipe(path)
    samples = pool[:GRAD_CUT[path][0]]
    batch = next(iter_batches(samples, spec_for_samples(samples, len(samples)),
                              with_pos=True, target=0))
    proj = torch.randn(batch.num_atoms, cfg.mlp_hidden, generator=torch.Generator().manual_seed(4))

    def step_loss(model, b):
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        return sq / torch.clamp(cnt, min=1.0)

    def encoder_loss(model, b):
        return torch.sum(model.encode(b)[b.atom_mask] * proj.to(b.pos.device)[b.atom_mask])

    def grads(device, loss_fn, dtype=cfg.compute_dtype):
        model = create_model(method, num_target=1, device=device,
                             cfg=dataclasses.replace(cfg, compute_dtype=dtype),
                             generator=torch.Generator().manual_seed(3)).eval()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".to_q." in name:
                    p.mul_(GRAD_QUERY_SCALE.get(path, 1.0))
        loss_fn(model, batch.to(device)).backward()
        return {n: (p.grad.cpu() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    card_relu = []
    reset_launches()
    with relu_sites(record=card_relu):
        got = grads("cuda", step_loss)
    launches = read_launches()
    check(launches == expected_launches(path, 1, 1),
          f"the card's train step did not run through {path}'s kernels: {launches}")
    runs = {}
    for dtype in (cfg.compute_dtype, None):
        with relu_sites(signs=card_relu):
            runs[dtype] = grads("cpu", step_loss, dtype)
    want = runs[cfg.compute_dtype]
    reached = [n for n, w in want.items() if w is not None and float(w.abs().max()) > 0]
    for name in reached:
        check(got[name] is not None and float(got[name].abs().max()) > 0,
              f"{name} has a gradient on the CPU and none on the card")
    for name in (*REACHED[method], *trunk_reached(method)):
        check(name in reached, f"{name} unreached")
    results = [("train step, the card's ReLU pattern", _rel_l2(got, want), _rel_l2(want, runs[None]))]
    want = grads("cpu", encoder_loss)
    results.append(("encoder, smooth loss", _rel_l2(grads("cuda", encoder_loss), want),
                    _rel_l2(want, grads("cpu", encoder_loss, None))))
    for what, err, gap in results:
        limit = BF16_GRAD_SHARE * gap
        print(f"{path} gradients on {len(samples)} molecules, card vs CPU (both bf16), {what}: "
              f"relative L2 over all parameters {err:.4e} (limit {BF16_GRAD_SHARE} * the CPU's "
              f"bf16-vs-f32 distance {gap:.4e} = {limit:.4e})")
        check(err <= limit, f"the card's bf16 gradients ({what}) disagree with the CPU's")
    print(f"{path}: {len(reached)} of {len(want)} parameters reached on both; launches {launches}")


@quiet
def phase_train(path: str, smi: str) -> dict[str, int]:
    """Train through `equihgnn_tpu_torch.main.run` at the recipe, batch 768."""
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.main import build_parser, load_splits, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import run as predict_run

    method, cfg = PATHS[path][0], recipe(path)
    hyper = method not in GRAPH_METHODS
    data = TRAIN_DATA.get(method, "synthetic_hg_3d")
    argv = ["--data", data, "--method", method, "--device", "cuda",
            "--batch_size", str(BATCH),
            "--synthetic_size", TRAIN_SIZE.get(path, TRAIN_SIZE.get(method, "9600")),
            "--epochs", "3",
            "--lr", LR.get(method, "1e-3"), "--MLP_hidden", str(cfg.mlp_hidden),
            "--output_hidden", str(cfg.output_hidden),
            "--All_num_layers", str(cfg.all_num_layers),
            "--output_num_layers", str(cfg.output_num_layers),
            "--aggregate", cfg.aggregate, "--normalization", cfg.normalization]
    if cfg.compute_dtype:
        argv += ["--compute_dtype", cfg.compute_dtype]
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    train_s, valid_s, test_s, _ = load_splits(args)
    print(f"train data: {data}, {len(train_s)}/{len(valid_s)}/{len(test_s)} molecules "
          f"generated in {time.perf_counter() - t0:.2f} s")
    with_pos = train_s[0].pos is not None
    for s in train_s + valid_s + test_s:  # learnable target: normalized atom count
        s.y = np.float32((s.n_atoms - 16.0) / 8.0)
    spec = spec_for_samples(train_s + valid_s + test_s, batch_size=BATCH)
    n_val = sum(1 for _ in iter_batches(valid_s, spec, hyper=hyper, with_pos=with_pos))
    n_test = sum(1 for _ in iter_batches(test_s, spec, hyper=hyper, with_pos=with_pos))

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
            print(f"{path} train: {len(hist)} epochs, {steps} steps, {evals} eval forwards; "
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
            check(launches == expected_launches(path, steps + evals, steps),
                  f"training did not run {path}'s kernels on every train step and "
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


@quiet
def phase_step(path: str, samples, smi: str) -> None:
    """One train step at batch 768: launches, device time (and the eval
    forward's), memory, profile."""
    from torch.profiler import ProfilerActivity, profile

    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    batch = request_batch(path, samples, target=0).to(dev)
    model = live_branches(create_model(PATHS[path][0], num_target=1, cfg=recipe(path),
                                       device=dev))
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
        fwd_ms, = median_ms(lambda: model(batch), iters=10)
    model.train()
    print(f"{path} launches of one train step: {step_launches}; of one eval forward: "
          f"{eval_launches}")
    print(f"{path} eval forward at batch {BATCH}: median {fwd_ms:.3f} ms device time (CUDA "
          f"events, 10 forwards); card: {smi}")
    check(step_launches == expected_launches(path, 1, 1), "train step launches")
    check(eval_launches == expected_launches(path, 1, 0), "eval forward launches")

    torch.cuda.reset_peak_memory_stats()
    step_ms, = median_ms(lambda: trainer.train_step(batch), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"{path} train step at batch {BATCH} (forward + backward + Adam): median "
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
    own = [(t, n, key) for t, n, key in kernels[12:] if key.startswith(PORT_KERNEL)]
    if own:  # the csrc kernels below the top 12 (their anonymous namespace)
        print("  the port's other kernels per step: " + "; ".join(
            f"{t:.3f} ms {n}x {key[len(PORT_KERNEL):].split('(')[0]}" for t, n, key in own))
    gradient_zero_shares(path, trainer, batch)
    if path == CROSS_PATH:
        knn_graph_reading(batch, smi)
    if path == EGNN_BF16:
        knn_bf16_reading(batch)


# the paths whose encoder `remat` checkpoints, held with it on the card
REMAT_PATHS = ENCODER_METHODS + (BF16_PATH, SE3_BF16, EGNN_BF16, VISNET_BF16, FAFORMER_BF16)
# the paths whose batch-768 train step's peak memory is read with and without remat
REMAT_MEMORY = ("se3_transformer_equihnns", "equiformer_equihnns")


@contextlib.contextmanager
def deterministic():
    """Within it, PyTorch's deterministic algorithms (`index_add_`,
    `scatter_add_` and the gathers' backward sum in a fixed order, not with
    atomics); an op with no such form warns and runs as it would."""
    import warnings

    was = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    for msg in sorted({str(w.message).splitlines()[0] for w in seen}):
        print(f"deterministic algorithms: {msg}")


def phase_remat(path: str, samples, smi: str) -> None:
    """`remat=True` (the encoder checkpointed) on the card: one train step in
    training mode (dropout on where the model has it, seed 5) on the
    gradient phase's first GRAD_CUT molecules, against the same step
    without remat. The steps run with PyTorch's deterministic algorithms
    (`deterministic`): with atomics, the trunk's pooling and the gathers'
    backward (`index_add_`) sum in no fixed order, and se3's gradients
    moved by ~1e-5 of a tensor's max between two steps (~1e-3 relative L2
    in bf16), now and then more under remat than between the two steps
    that set its limit. The first step after a model is built can round
    otherwise (bf16: cuBLAS's first call), so a warm-up step comes first
    and records the trunk's ReLU inputs; every later step takes its ReLU
    signs (a trunk ReLU input within ~1e-6 of 0 that flipped moved egnn's
    embedding gradient by ~1e-3 of its max). Each gradient tensor is held
    within 1e-5 of its max plus twice the card's own change between two
    steps without remat; the bf16 path as relative L2 over all parameters
    within twice its own plus 1e-6. The remat step's launches must show the
    encoder's kernels again in its backward. For REMAT_MEMORY, the
    batch-768 train step's time and peak memory with and without remat
    (recorded, not held)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer, masked_mse

    method = PATHS[path][0]
    dev = torch.device("cuda")
    n_mol = GRAD_CUT.get(path, (32,))[0]
    pool = samples[:n_mol]
    batch = next(iter_batches(pool, spec_for_samples(pool, n_mol), with_pos=True,
                              target=0)).to(dev)

    def make(remat):
        cfg = dataclasses.replace(recipe(path), remat=remat)
        return live_branches(create_model(method, num_target=1, cfg=cfg, device=dev,
                                          generator=torch.Generator().manual_seed(3)))

    def step(remat, record=None, signs=None):
        model = make(remat).train()
        trunk_forward = model.trunk.forward

        def trunk_with_signs(*args, **kw):  # the trunk's ReLUs only: it is never recomputed
            with relu_sites(record=record, signs=signs):
                return trunk_forward(*args, **kw)

        model.trunk.forward = trunk_with_signs
        torch.manual_seed(5)
        reset_launches()
        sq, cnt = masked_mse(model(batch), batch.y, batch.graph_mask)
        (sq / torch.clamp(cnt, min=1.0)).backward()
        torch.cuda.synchronize()
        return {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}, \
            read_launches()

    signs = []
    with deterministic():
        step(False, record=signs)  # warm-up
        plain, _ = step(False, signs=signs)
        again, _ = step(False, signs=signs)
        got, launches = step(True, signs=signs)
    check(launches == expected_launches(path, 1, 1, remat=True),
          f"the remat step did not run {path}'s kernels as expected: {launches}")
    check(set(got) == set(plain), "remat reaches other parameters")
    if PATHS[path][1].get("compute_dtype"):
        d, own = _rel_l2(got, plain), _rel_l2(again, plain)
        check(d <= 2 * own + 1e-6, f"remat moved the bf16 gradients by {d:.3e} (relative L2), "
                                   f"the card's own change {own:.3e}")
        print(f"{path} remat: one train step on {n_mol} molecules, relative L2 over all "
              f"parameters {d:.3e} (limit twice the card's own change between two steps "
              f"without remat, {own:.3e}, plus 1e-6); launches {launches}")
        return
    worst = own = 0.0
    for name, w in plain.items():
        top = float(w.abs().max())
        spread = float((again[name] - w).abs().max())
        d = float((got[name] - w).abs().max())
        check(d <= 1e-5 * top + 2 * spread, f"{name}: remat moved the gradient by {d:.3e} "
                                            f"(max {top:.3e}, the card's own change {spread:.3e})")
        if top > 0:
            worst, own = max(worst, d / top), max(own, spread / top)
    print(f"{path} remat: one train step on {n_mol} molecules, {len(plain)} gradients within "
          f"1e-5 of their max plus twice the card's own change (worst max|d| / max {worst:.3e}; "
          f"the card's own, two steps without remat: {own:.3e}); launches {launches}")
    if path not in REMAT_MEMORY:
        return
    big = request_batch(path, samples, target=0).to(dev)
    for remat in (False, True):
        trainer = Trainer(make(remat), TrainConfig(lr=1e-4), std=1.0, device=dev)
        trainer.train_step(big)  # warm-up: cuBLAS handles, Adam state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, = median_ms(lambda: trainer.train_step(big), iters=3)
        peak = torch.cuda.max_memory_allocated()
        print(f"{path} train step at batch {BATCH}, remat {remat}: median {ms:.3f} ms "
              f"(CUDA events, 3 steps), peak memory {peak / 2**20:.1f} MiB; card: {smi}")
        del trainer
        torch.cuda.empty_cache()


def knn_graph_reading(batch, smi: str) -> None:
    """The cross-molecule path's batch-wide kNN alone at batch 768: its
    device time (CUDA events, median of 10) and its peak allocation."""
    from equihgnn_tpu_torch.ops.knn import PAIRS_PER_CHUNK, knn_graph

    n = batch.num_atoms
    fn = functools.partial(knn_graph, batch.pos, 16, mask=batch.atom_mask, valid_radius=None,
                           squared_radius=True)
    ms, = median_ms(fn, iters=10)
    print(f"knn_graph over the batch's {n} atoms (k = 16, {n * n:,} pairs, "
          f"{max(1, PAIRS_PER_CHUNK // n)} rows a chunk): median {ms:.3f} ms device time, "
          f"peak allocation {alloc_mib(fn):.1f} MiB above its inputs; card: {smi}")


def knn_bf16_reading(batch) -> None:
    """The EGNN's kNN on the batch-768 slot view's bf16 positions (the bf16
    path's input) on the card and on the CPU: the slots whose neighbour set
    (its kept neighbours, as a set) differs, and those whose ranked list
    differs. bf16 squared distances tie often; a tie's order, or a squared
    distance rounded otherwise, can move the 16th neighbour. Recorded."""
    from equihgnn_tpu_torch.ops.knn import knn_dense

    sm = batch.slot_mask
    pd = (batch.pos[batch.slot_index] * sm[..., None]).to(torch.bfloat16)
    sets, lists = [], []
    for dev in ("cuda", "cpu"):
        idx, mask, _ = knn_dense(pd.to(dev), sm.to(dev), 16, slot_gid=batch.slot_gid.to(dev))
        idx, mask = idx.cpu(), mask.cpu()
        lists.append(idx)
        a = idx.shape[1]  # kept neighbours as a set; the dropped ones to a spare column
        member = torch.zeros(idx.shape[:2] + (a + 1,), dtype=torch.bool)
        member.scatter_(-1, torch.where(mask, idx, a), True)
        sets.append(member[..., :a])
    real = sm.bool().cpu()
    n_set = int(((sets[0] != sets[1]).any(-1) & real).sum())
    n_list = int(((lists[0] != lists[1]).any(-1) & real).sum())
    print(f"{EGNN_BF16} kNN on bf16 positions, card vs CPU: {n_set} of {int(real.sum())} real "
          f"slots with another neighbour set, {n_list} with another ranked list (recorded)")


def gradient_zero_shares(path: str, trainer, batch) -> None:
    """In one more train step, the rows of the output gradient that reach
    kernel C (egnn: dm, a row an edge) or E (faformer: dout, a row a
    position, at each EdgeModule and FAFFN site) that are exactly 0, beside
    the rows the model masks (egnn: pair_mask; the EdgeModule: the kNN mask;
    the FAFFN: the padding slots). Kernels C and E skip such rows. egnn's
    dm must be 0 on every masked edge (both consumers of the messages mask
    them)."""
    from equihgnn_tpu_torch.nn import egnn, faformer

    mod, kname = {"egnn_equihnns": (egnn, "fused_edge_messages"),
                  "faformer_equihnns": (faformer, "fused_frame_swiglu")}.get(path, (None, None))
    if mod is None:
        return
    kernel, knn = getattr(mod, kname), mod.knn_dense
    masks, grads = [], []

    def knn_hooked(*args, **kw):
        out = knn(*args, **kw)
        masks.append(out[1].reshape(-1))
        return out

    def kernel_hooked(x, *args, **kw):
        out = kernel(x, *args, **kw)
        site = "edge" if kname == "fused_edge_messages" else (
            "EdgeModule" if x.shape[-1] == 4 else "FAFFN")
        out.register_hook(lambda g, site=site: grads.append(
            (site, (g.reshape(-1, g.shape[-1]) == 0).all(-1))))
        return out

    setattr(mod, kname, kernel_hooked)
    mod.knn_dense = knn_hooked
    try:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    finally:
        setattr(mod, kname, kernel)
        mod.knn_dense = knn
    kept = {"edge": masks[0], "EdgeModule": masks[0], "FAFFN": batch.slot_mask.reshape(-1)}
    for site, zero in grads:
        live = kept[site]
        n, n_zero = zero.numel(), int(zero.sum())
        dead_nz, live_zero = int((~live & ~zero).sum()), int((live & zero).sum())
        print(f"{path} step: {'C' if site == 'edge' else 'E'} at {site}: output-gradient rows "
              f"exactly 0 {n_zero} of {n} ({n_zero / n:.4f}); masked {int((~live).sum())}, of "
              f"them not 0 {dead_nz}; kept but 0 {live_zero}")
        if site == "edge":
            check(dead_nz == 0, "egnn's dm is not 0 on a masked edge")


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

    samples, batch = bench_batch()
    graphs = graph_samples()
    # the f32 gradient phases' CPU references, in a worker process from now on
    # (stopped while the host times the card: `host_quiet`)
    cpu = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"),
        initializer=torch.set_num_threads, initargs=(CPU_WORKER_THREADS,))
    _WORKER["pid"] = cpu.submit(os.getpid)
    refs = {path: cpu.submit(grads_cpu_refs, path, samples[:2 * GRAD_CUT.get(path, (32,))[0]])
            for path in PATHS if path not in GRAPH_METHODS and path not in SERVE_ONLY
            and not PATHS[path][1].get("compute_dtype")}
    try:
        return drive(samples, batch, graphs, name, smi, refs)
    finally:
        cpu.shutdown(wait=True, cancel_futures=True)


def drive(samples, batch, graphs, name: str, smi: str, refs: dict) -> int:
    """The phases after the build: kernels, then every path's (`refs`: the
    worker's futures of `grads_cpu_refs` by path). The f32 gradient phases,
    which read the worker's references, come after every path's other
    phases: the worker, stopped while the host times the card, computes
    them in the untimed windows before."""
    kernels = timed("kernels", phase_kernels, batch)
    paths, later = {}, []
    for path in PATHS:
        if path in GRAPH_METHODS:
            paths[f"{path} serve"] = timed(f"{path} serve", phase_serve_2d, path, graphs, smi)
            timed(f"{path} gradients", phase_grads_2d, path, graphs)
        else:
            paths[f"{path} serve"] = timed(f"{path} serve", phase_serve, path, samples, smi)
            if path in SERVE_ONLY:
                continue
            if path in refs:
                later.append(path)
            else:
                timed(f"{path} gradients", phase_grads_bf16, path,
                      samples[:2 * GRAD_CUT.get(path, (32,))[0]])
        if path != CROSS_PATH:  # neither CLI sets cross_molecule_knn
            paths[f"{path} train"] = timed(f"{path} train", phase_train, path, smi)
        timed(f"{path} step", phase_step, path, graphs if path in GRAPH_METHODS else samples,
              smi)
        if path in REMAT_PATHS:
            timed(f"{path} remat", phase_remat, path, samples, smi)
    for path in later:
        timed(f"{path} gradients", phase_grads, path,
              samples[:2 * GRAD_CUT.get(path, (32,))[0]], refs[path])
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
