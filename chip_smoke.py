#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Refuses to run without CUDA (exit 1). Otherwise:
  0. reports the card (nvidia-smi name and power limit), torch, CUDA, nvcc
     and triton, and builds the CUDA kernels from `conditioned_nerf_gan_torch/csrc`
     (the study library in 8 parts), printing each library's build time, and
     each K1, K2 and study kernel's registers, spills and SASS size;
  1. holds the FiLM-SIREN kernel against its plain torch version
     (`film_siren_mlp_folded`, same bf16-operand math) at the thesis render
     shape, at the training chunk (12 x 49,152, where most of its main-path
     launches run), at stage 0's unchunked batch (24 x 49,152), at the
     serving ray chunk, at phase 15's shapes a rank (the data-parallel
     step's 6 x 49,152 and the two-rank eval's 16 and 8 x 1,572,864, whose
     plain versions run over slices of 2 views) and at a ragged N, and
     times both with CUDA events, each time beside its bound and kernel /
     bound;
 1b. the same at the voxel family's shape (Din 32, 8 layers) at 2 x 786,432,
     at the `dg` training chunk (12 x 49,152), at its serving ray chunk
     (2 x 49,152) and a ragged 2 x 1,000;
  2. drives the port's serving path: the thesis model (`thousand` preset +
     special.py: PointNet 512/512 under the presets' bf16 policy, SHORTSIREN
     z 512, 4 x 256) with seeded random weights is saved as a port
     checkpoint, loaded by `Inferencer`,
     and answers 4 requests (2 colored point clouds each) through
     `encode` -> `render_batched` at 128^2 with 48 + 48 samples. It checks
     finite output in range, that every render went through the kernel,
     and one render against the same render with the plain version in the
     kernel's place;
  3. profiles the last request once more: device busy time and share of
     the request's wall time, and the kernels that take the most of it;
  4. holds the FiLM-SIREN backward kernel against its plain torch version
     (`film_siren_mlp_folded_vjp`, same bf16 roundings) at the 1.57M-point
     study shape, at the training chunk the main path gives it, at stage
     0's unchunked batch (24 x 49,152), at the data-parallel step's 6 x
     49,152 a rank and at a ragged N: norm-relative error, a low-frequency max, distance to fp64
     sums against the plain version's, bitwise-equal repeats; and times both,
     beside the bound;
 4b. the same at the voxel family's shape (Din 32, 8 layers: TALLSIREN_FG's
     init) at the `dg` training chunk 12 x 49,152, at stage 0's 12 x 12,288
     and a ragged 2 x 1,000, with dpoints (the sampled features' cotangent)
     held like every other grad;
  5. drives the port's training path: the thesis model at stage 2 (step
     16000, fade-in alpha 0.5) at full width, PointNet and the
     discriminator (with R1) under the presets' bf16 policy, batch 12 at
     128^2, 48 + 48 samples, ray_chunks 16, through `make_train_step`: one
     warm-up step (whose layers' output dtypes are recorded by forward
     hooks: PointNet's blocks bf16, its latent fp32) and three timed steps
     (s/step, peak memory, kernel launches per step against the design's
     count), finite losses, all three nets moved, one step against the
     same step with the plain versions in both kernels' places (what is
     read through the bf16 D printed, the rest held), one profiled step;
     then, on a bench of its own with PointNet and D at compute_dtype None
     (the fp32 path), one step timed after a warm-up beside the policy's
     and the kernel step against the plain step, every loss and net's
     grads held at the same bounds;
  6. holds the trilinear-sampling kernel against its plain torch version
     (`border_trilerp_reference`, the same fp32 lerps) on a 2 x 64^3 x 32
     feature volume at 2 x 786,432 points, at a ragged 2 x 1,000, on points
     outside the cube and on its faces and at the `dg` serving ray chunk
     (2 x 49,152 ray samples), and on a 12 x 64^3 x 32 volume at the
     training ray chunk (12 x 49,152); times it beside the plain version
     and `F.grid_sample`; and holds the trilinear backward kernel
     at the same sets, adding dV into a buffer of seeded values: dcoords
     against
     `border_trilerp_vjp_reference`, dV against an fp64 sum of the buffer
     and the same contributions (and no farther from it than the plain
     `index_add_` is), timed beside the plain version, the bound (the
     coordinates and g read once, each distinct row read and written once)
     and `grid_sampler_3d_backward`, with the 16-byte reductions it issues
     and the first design's (counted in plain torch by
     `presummed_contributions`, a replica of its grouping);
  7. drives the voxel-conditioned serving path: the `dg` preset (UNet3D
     4 -> 32, f_maps 32, 4 levels, bf16 policy; TALLSIREN_FG, 8 x 256 on 32 sampled
     features) at step 30000 with seeded random weights, saved as a port
     run, loaded by `Inferencer`, answers 4 requests (2 voxelised point
     clouds at 64^3 each) through `encode` -> `render_batched` at 128^2 with
     48 + 48 samples: launches of both kernels per request against the
     design's count, finite output in range, one render against the same
     render with both plain versions in the kernels' places, and one
     profiled request;
  8. the FiLM-SIREN kernel study: holds each study kernel (K3 point-major,
     K4 v4 feature-major cooperative, K4 v5 feature-major ping-pong, all on
     the wgmma + TMA trunk) in each of its modes, at every tile the study
     tool launches it with and at T 128, against its plain version
     (`film_study_reference`) at the study shape (2 x 786,432, 4 x 256) and
     a ragged 2 x 1,000, times each mode and its plain version at T 128
     beside its bound, K1's phase-1 time at 2 x 786,432 and its first
     design's time, prints the split of K1's time (K3 nosin and nodot
     against single, K4 v5 against v4 sin7), then runs the study tool's
     variants (the default set, the tile sweeps, the other modes and K1 +
     K2's VJP) through `run_study`, counting launches;
  9. drives the voxel family's training path: the `dg` preset at stage 2
     (step 16000) at full width (UNet3D 4 -> 32, f_maps 32, 4 levels on 12
     voxel grids of 64^3 under the bf16 policy; TALLSIREN_FG 8 x 256 on 32
     sampled features; no discriminator), batch 12 at 128^2, 48 + 48
     samples, ray_chunks 16, through `make_train_step`: one warm-up step
     (hooks: the U-Net's block convs bf16, GroupNorm and its result fp32)
     and three timed steps (s/step,
     peak memory, launches of K1, K2 and both trilinear kernels per step
     against the design's count), finite losses, G and E moved (the U-Net's
     grads come back through the trilinear backward), one step against the
     same step with the plain versions in every kernel's place, one
     profiled step (the dV scatters' device time), one step whose ops on a
     tensor of dV's shape are counted (one zeroing a render with grad, no
     sum), the step's dV path (that zeroing and the scatters), and one
     step on a bench with the U-Net at compute_dtype None (fp32), timed;
 10. drives the train CLI (`conditioned_nerf_gan_torch.train.main`, the
     Trainer) on the card: writes the port's synthetic fixture on the card
     (6 cars x 8 views at 128^2, clouds of 65,536 points, 64^3 voxel
     grids), trains the thesis preset at full width through all four
     curriculum stages compressed to 3 steps each (32^2, 64^2, 128^2,
     128^2; every per-stage key the preset's own) to step 11 with stats,
     sample grids, val losses and checkpoints, printing each stage's
     s/step, peak memory and launches of K1 and K2 per step against the
     count derived from its config; resumes a second run from the step-5
     checkpoint to step 8 (its step, loader position and stage the
     uninterrupted run's, its losses within RESUME_LOSS_TOL); trains the
     dg preset across its first milestone (2 steps at stages 0 and 1,
     launches of all four kernels per step against the design); and
     renders one image grid from the thesis run's checkpoint through the
     infer CLI; the thesis run's eval_freq steps also run Trainer.evaluate;
 11. the eval on the card: a thesis run at full width on a fixture of 6
     cars x 12 views (oFID's 10-view minimum) written on the card, one step
     a stage to step 3, where Trainer.evaluate renders the `fid` subset (72
     views at 128^2, 96 + 96 samples, K1 launches against the count from
     the views, the render batch and the ray chunks) and writes FID, oFID,
     LPIPS and PSNR to fid.txt under its random-weights stamp; the eval's
     seconds split into real-image setup, render and metrics; the card's
     Inception 768 and 2048 features and LPIPS held against the same nets
     on the CPU for the same PNGs, and Newton-Schulz in fp32 on the card
     against scipy's sqrtm on a seeded well-conditioned covariance pair
     (on one car's singular oFID pair it is printed, not held);
 12. the rest of inference on the card, through the infer CLI: on phase
     10's thesis checkpoint the fixed-camera grid, the 240-frame orbit video
     (an uncompressed AVI), the colored point clouds from 20 random cameras
     and from the dataset's views masked by the GT depth (on a copy of the
     checkpoint with more sigma bias: the trained one's clouds are empty,
     no depth inside the ray's range), the density voxel
     at 48^3 and 64^3 (K1 at B 1 and 110,592 or 262,144 points) and the
     latent interpolation between two fixture cars; on phase 11's the
     metrics into fid_inference.txt; on phase 10's dg checkpoint the voxel
     and the video (K1 at Din 32 behind the trilinear kernel). Each mode's
     seconds, launches against the design count and output (read back: the
     .mrc header and values, the AVI's frames, the .obj's points, the
     metric line), then the 64^3 sigma grid of each model against the same
     grid with the plain K1, at phase 1's (1b's) bounds, and K1 at the
     grids' shapes on seeded inputs, held and timed.
 13. the rest of the voxel family (PyramidUNet3D, ResidualUNet3D and the
     SIRENs new to PR 12) on the card: K1 and K2 at Din 224 / L 2
     (DOUBLESIREN_FG on a pyramid's 128 + 64 + 32 features), Din 224 / L 4
     (SHORTSIREN_FG_Pyrmd) and Din 35 / L 8 (TALLSIREN_dgx) against their
     plain versions at the training chunk and a ragged N (phases 1b's and
     4b's bounds), K5 and its backward on each pyramid level at the
     training chunk and on volumes with a side of 1 (phase 6's), each timed
     beside its bound; then at full width, each with every kernel's
     launches against the count derived from its config, finite losses,
     each net moved and one step against the same step with the plain
     versions: the `doublesiren_dis_featurepyramid` stage-2 step (one dV
     zeroing a level a render, counted on each level's shape), the `dRes`
     stage-2 step (and its dV), `dg` with `unet.type` ResidualUNet3D, `dg`
     with TALLSIREN_dgx, the pyramid with SHORTSIREN_FG_Pyrmd; the
     pyramid's no-grad render of 2 views at 128^2 and `dRes`'s 4 requests
     through the Inferencer, each against the plain render; and the train
     CLI on the pyramid preset across its first milestone on phase 10's
     fixture, with sample grids, val losses and one Trainer.evaluate.
 14. the remaining models on the card: at full width, as phase 13 runs
     its paths, the stage-2 steps of `cond_nearest` (the InputCat D on the
     conditioning views, K1/K2 at Din 32 / L 8), `proj_random` (the
     Projection D, its ResNet18 on 12 views of 256^2) and `indirect_dis`
     (TALLSIREN's per-point mapping: no K1/K2, K5 and the trilinear
     backward on its lookups, batch_split 12); the train CLI on
     `cond_nearest` across its first milestone on phase 10's fixture, the
     loader's views in every step; the Encoder, Strided, CCS and
     CCSEncoder discriminators at 128^2 (heads, R1, grads) and a render of
     SPATIALSIRENBASELINE and EmbeddingPiGAN128/256 (2 views at 128^2),
     each against the same module on the CPU.
 15. data parallelism, the ray-sharded render and the tools on the card
     (one card: NCCL refuses two ranks on one device, so two ranks share it
     over gloo, which takes CUDA tensors): (a) two spawned ranks train the
     thesis stage-2 step at full width, 6 views a rank (global 12): a
     warm-up and 2 timed steps, s/step and the all-reduces' ms (CUDA
     events) a rank, K1/K2 at the design count a rank a step, the replicas
     bit-equal after every step, then the fp32 twins' averaged grads and
     metrics against a one-process reference (the two half batches in two
     threads, their grads averaged, the same ClippedAdam steps) at phase
     5's bounds; (b) the train CLI with --distributed at world size 1 on
     NCCL, thesis stages 0 and 1 of phase 10's curriculum, the all-reduces
     a step against one per optimizer step, the losses within
     RESUME_LOSS_TOL of phase 10's run without the flags; (c) the train
     CLI on two ranks (gloo) across stage 0 -> 1 with one eval: fid.txt's
     one line from rank 0 over both ranks' image shards, each checkpoint
     written once, and a two-rank resume that replays the next step; (d)
     `render_ray_sharded` over [cuda:0, cuda:0] bit-equal to the unsharded
     render, K1 at two slabs' count, the same from a generator held on the
     CPU (the slabs on a replica, refreshed after a param changes), and the
     infer CLI with --shard_rays, unsharded on one card and through
     `render_ray_sharded` with the card named twice, the grids' bytes equal;
     (e) the tools: chamfer over 2 x 65,536 points against scipy's cKDTree,
     the first-hit voxel render and the pcl2voxel orbit AVI's frame 0
     against the CPU, the geometry-loss replay (K1) against the plain K1,
     the fixture exporter's render against the CPU. Every spawned rank's
     exit code is checked, and every (B, N) at which a rank launched K1 or
     K2 must be one that phase 1 or 4 held against the plain version.
Phases 2, 5, 7, 9, 10 and 11 each print a precision line: which nets run
the bf16 policy and the process's TF32 and bf16-reduction flags.
Prints one JSON line of kernel results (each kernel's time beside its plain
version's, the least time the card could take for the same work, and the
one PyTorch call that computes the same function where there is one; K1 and
K2 and the trilinear kernels at the training chunk, the other shapes under
`ms_by_shape`, phase 13's shapes among them; the launches of every path,
those of phases 14 and 15 among them), then
the last line {"ok": true, "device": {...}}. Any failed check raises
(non-zero exit); checks of phases 1b and 4-15 raise after phase 15, so one
run reports them all.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Phase 1 bounds, each about twice the sound kernel's reading on the H100
# (in brackets: the largest over the three shapes), far below the O(0.1-1)
# error of a layout or indexing fault. The plain comparator
# `film_siren_mlp_folded` has the same bf16-operand math and sums in fp32 in
# another order.
# freq/30, max|kernel - folded|: nothing amplifies a rounding flip [1.37e-3]
KERNEL_LOW_TOL = 3e-3
# freq 25-45 (the model's range): a summation-order difference that flips a
# bf16 rounding of h grows ~2x per layer, so the max is set by the plain
# version's own fp32 noise (3.4e-2 from fp64 sums at the thesis shape, as
# far as the kernel's 3.5e-2); held instead:
KERNEL_MEAN_TOL = 3e-4  # mean|kernel - folded| [1.21e-4]
KERNEL_Q999_TOL = 1.5e-2  # 99.9th percentile of |kernel - folded| [7.92e-3]
KERNEL_VS_PLAIN = 1.25  # max|kernel - fp64 sums| / max|folded - fp64 sums| [1.040]
# one 128^2 render, kernel vs plain folded in its place. With random weights
# sigma sits near 0, and the last sample's 1e10 delta turns any sign flip of
# relu(sigma) there into a whole-pixel change, so the bound is on the mean
# and on the share of pixels off by more than RENDER_TOL, not on the max.
RENDER_TOL = 2e-2
RENDER_MEAN_TOL = 2e-4  # [5.2e-7; 3.2e-5 with one flipped pixel]
RENDER_OVER_SHARE = 3e-4  # [0; 3.1e-5 = 1 pixel of 32,768]
THESIS_STEP = 30000  # a step in the last curriculum stage: ray_chunks 16
# Phase 1b bounds: K1 at Din 32 and L 8 against `film_siren_mlp_folded`
# (inputs at TALLSIREN_FG's init, whose head is 10x smaller than phase 1's),
# in phase 1's style, each about twice the kernel's H100 reading [in
# brackets: the larger of the two shapes]. As in phase 1 the max at freq
# 25-45 is set by the plain version's own fp32 noise (3.1e-3 from fp64 sums
# at 2 x 786,432, as far as the kernel's).
DIN32_LOW_TOL = 5e-5  # freq/30, max|kernel - folded| [2.21e-5]
DIN32_MEAN_TOL = 5e-5  # freq 25-45, mean|kernel - folded| [2.36e-5]
DIN32_Q999_TOL = 2e-3  # 99.9th percentile of |kernel - folded| [9.36e-4]
DIN32_VS_PLAIN = 1.25  # max|kernel - fp64 sums| / max|folded - fp64 sums| [1.000]
# Phase 6: the kernel and `border_trilerp_reference` round the same fp32
# lerps in the same order, so they should agree to the bit; the bound is
# relative to the volume's largest value.
TRILERP_TOL = 1e-5  # max|kernel - plain| / max|volume|
VOXEL_RES = 64
DG_STEP = 30000  # stage 3 of the dg curriculum: ray_chunks 16
# Phase 4 bounds for each of the nine grads of the backward kernel against
# `film_siren_mlp_folded_vjp` (same bf16 roundings of h, cos7, g and dpre;
# fp32 sums in another order), each about twice the sound kernel's H100
# reading or above it by a fifth [in brackets: the largest over the nine
# grads and three shapes]. As in phase 1, a summation-order difference flips
# a bf16 rounding, which grows through the layers at freq 25-45; a layout or
# indexing fault reads O(0.1-1).
BWD_NORM_TOL = 3e-3  # |K2 - plain|_2 / |plain|_2 at freq 25-45 [1.39e-3]
BWD_LOW_TOL = 7e-3  # max|K2 - plain| / max|plain| at freq/30 [3.57e-3]
# Distance to the same math with fp64 sums, against the plain version's:
# |K2 - fp64|_2 <= BWD_VS_PLAIN * |plain - fp64|_2 [1.182], and the max,
# whose ratio swings with the few points that dominate it, <= BWD_VS_PLAIN_MAX
# times [1.380]; each plus BWD_ULPS roundings of the grad's largest value (an
# fp32 result is that far from the fp64 sums whatever the order of its sums).
BWD_VS_PLAIN = 1.25
BWD_VS_PLAIN_MAX = 1.6
BWD_ULPS = 8 * 2.0 ** -24
# Phase 4b: K2 at Din 32 and L 8 (TALLSIREN_FG's init) in phase 4's style,
# each bound about twice the sound kernel's H100 reading or above it by a
# third [in brackets: the largest over the nine grads and three shapes].
# Over 8 layers a flipped bf16 rounding grows through twice as many
# products as at L 4, so the readings are ~3x phase 4's; the ratios to the
# fp64 sums, plus BWD_ULPS roundings of the grad's largest value, are about
# phase 4's.
DIN32_BWD_NORM_TOL = 1e-2  # |K2 - plain|_2 / |plain|_2 at freq 25-45 [5.11e-3]
DIN32_BWD_LOW_TOL = 1e-2  # max|K2 - plain| / max|plain| at freq/30 [4.52e-3]
DIN32_BWD_VS_PLAIN = 1.5  # |K2 - fp64|_2 / |plain - fp64|_2 [1.269]
DIN32_BWD_VS_PLAIN_MAX = 2.0  # max|K2 - fp64| / max|plain - fp64| [1.507]
# Phase 6, the trilinear backward. dcoords: the kernel and the plain version
# sum the same fp32 products over the channels in another order; bound
# relative to the plain version's largest dcoord. dV: fp32 atomics in a
# launch's own order; each voxel of it is within k_v fp32 roundings of the
# per-voxel sum of |contributions| from their fp64 sum (k_v contributions:
# any order of fp32 sums is), and its L2 distance to the fp64 sum is no
# more than TRI_BWD_VS_PLAIN times the plain fp32 `index_add_`'s.
TRI_DCOORDS_TOL = 1e-5
TRI_BWD_VS_PLAIN = 2.0
# the trilinear backward's first design (a fresh, zeroed dV a call and one
# 16-byte atomic a live corner and channel quad) at the training chunk, by
# the profiler's device time on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# printed beside this design's time
FIRST_BWD_MS = 0.3028
FIRST_SCATTER_MS = 0.1941
# Phase 5: one train step with the kernels against the same step with the
# plain versions in their places (same state, batch and random numbers). A
# flipped pixel (sign of relu(sigma) at the last sample) moves a loss by
# ~2e-5 and the grads by ~1e-3.
STEP_LOSS_TOL = 1e-4  # |kernel - plain| / |plain| for each loss [1.06e-6]
STEP_GRAD_TOL = 5e-3  # |kernel - plain|_2 / |plain|_2 over a net's grads [8.75e-5]
# Under the presets' bf16 policy D's activations and logits are bf16
# roundings: the fake images' kernel-vs-plain differences flip some of them,
# so what is read through D (d_loss, g_loss, D's grads) is printed for the
# policy step, and held at the bounds above on the same comparison with the
# encoder and D at compute_dtype None (the fp32 path the bounds were set on)
THROUGH_D = ("d_loss", "g_loss", "D")
TRAIN_STEP = 16000  # stage 2 of the thesis curriculum, fade-in alpha 0.5
TRAIN_TIMED_STEPS = 3
# Phase 9: the dg step with the kernels against the same step with the
# plain versions of K1, K2 and both trilinear kernels in their places, in
# phase 5's style
DG_STEP_LOSS_TOL = 1e-4
DG_STEP_GRAD_TOL = 5e-3
DG_TRAIN_STEP = 16000  # stage 2 of the dg curriculum
# Phase 8 bounds for each study kernel against its plain version
# `film_study_reference` (same bf16 operands, fp32 sums in another order),
# on phase 1's inputs, in phase 1's style; relative to max(1, max|plain|)
# (the `nosin` modes' outputs reach ~900). Each is about twice the largest
# H100 reading over the nine (kernel, mode) pairs, their tiles and both
# shapes [in brackets], far below the O(0.1-1) of a layout or masking fault.
STUDY_LOW_TOL = 2e-3  # freq/30: max|kernel - plain| [9.65e-4, v3 nosin]
STUDY_MEAN_TOL = 7e-5  # freq 25-45: mean|kernel - plain| [3.34e-5, v3/v4 single ragged]
STUDY_Q999_TOL = 4e-3  # 99.9th percentile of |kernel - plain| [2.03e-3, the same]
# max|kernel - fp64 sums| <= STUDY_VS_PLAIN x max|plain - fp64 sums| + 8
# fp32 roundings of max|fp64 sums|, as in phase 1 [1.112, v3 nosin ragged]
STUDY_VS_PLAIN = 1.25
STUDY_TILE = 128  # points per CTA of the timed modes: K1's tile
# each (kernel, mode) of the study at T 128 in its first design (mma.sync, a
# cp.async ring, one CTA a tile), built from the parent commit's source by
# tools/time_study_designs.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# printed beside this design's time
EARLIER_STUDY_MS = {("v3", "single"): 3.7009, ("v3", "nosin"): 3.0281,
                    ("v3", "nodot"): 1.7508, ("v3", "jnpsin"): 10.1633,
                    ("v4", "full"): 3.6314, ("v4", "sin7"): 3.5545, ("v4", "nosin"): 2.7972,
                    ("v4", "nodot"): 1.6987, ("v5", "interleave"): 4.2102}
# peaks of an H100 SXM (NVIDIA's data sheet) for the bounds: dense bf16 on
# the tensor cores, FP32 instructions on the CUDA cores (67 TFLOP/s counts
# an FMA as two), HBM3
H100_BF16_FLOPS = 989e12
H100_FP32_INSTRUCTIONS = 33.5e12
H100_HBM_BYTES = 3.35e12
# FP32 instructions per activation element, the bias add included:
# fast_sin (range reduction 4, square 1, 5 FMAs, 1 multiply), sin7 (4, 1, 3,
# 1), accurate sinf (its fast path, about 20), 0.9 v (2)
ACT_INSTRUCTIONS = {"fast_sin": 12, "sin7": 10, "sin": 20, "affine": 2}
REQUESTS = 4
BATCH = 2
IMAGE_SIZE = 128
# the thesis curriculum's stage 0: batch 24 at 32^2, 48 + 48 samples,
# unchunked, so K1 and K2 take 24 x 49,152 points a call
STAGE0_N = 32 * 32 * 48
CHUNK_N = IMAGE_SIZE * IMAGE_SIZE // 16 * 48  # a ray chunk of a 128^2 step: 16 chunks
# Trainer.evaluate's render (128^2, 96 + 96 samples) under stage 0's
# ray_chunks (none): a whole view's points a call
EVAL_N = IMAGE_SIZE * IMAGE_SIZE * 96
DP_RANK_BATCH = 6  # 15a: the thesis stage-2 step's batch a rank (global 12)
# K1's shapes held against its plain version in phase 1 (label, B, N; Din
# 3, L 4): every (B, N) a main path gives it, phase 15's ranks included
# (`check_film_shapes` holds their launches to this list)
FWD_SHAPES = [
    ("thesis render", 2, IMAGE_SIZE * IMAGE_SIZE * 48),
    ("training chunk", 12, CHUNK_N),  # also stage 0 a rank in 15c: 12 x 32^2 x 48
    ("stage-0 batch", 24, STAGE0_N),
    ("main-path ray chunk", 2, CHUNK_N),
    # 15a's step and stage 1 a rank in 15c (6 views, 64^2 in 4 chunks)
    ("data-parallel rank chunk", DP_RANK_BATCH, CHUNK_N),
    # 15c's eval at stage 0: each rank's 24 views of the fid subset in
    # render batches of 16 and 8
    ("data-parallel eval", 16, EVAL_N),
    ("data-parallel eval tail", 8, EVAL_N),
    ("ragged", 2, 1000)]
# K2's, in phase 4: the steps' shapes of FWD_SHAPES (the eval takes no grad)
BWD_SHAPES = [
    ("study", 2, IMAGE_SIZE * IMAGE_SIZE * 48), ("training chunk", 12, CHUNK_N),
    ("stage-0 batch", 24, STAGE0_N), ("data-parallel rank chunk", DP_RANK_BATCH, CHUNK_N),
    ("ragged", 2, 1000)]
# the plain versions past this many points a call run over slices of the
# batch (the fp64 sums of 16 x EVAL_N points would not fit on the card)
PLAIN_SLICE_POINTS = 4 * IMAGE_SIZE * IMAGE_SIZE * 48
PCL_POINTS = 2048
# Phase 10: the fixture the trainer reads (the port's writer, on the card):
# 65,536 points a cloud, so num_points_ratio 1.0 gives the stage-2 bench's
# 65,536, and the voxel family's 64^3 grids
TRAINER_FIXTURE = dict(n_cars=6, n_views=8, img_size=128, n_points=65536,
                       voxel_resolutions=(64,))
THESIS_STAGE_STEPS = 3  # milestones at steps 0, 3, 6 and 9
THESIS_STOP = 11
DG_STAGE_STEPS = 2  # the dg run: stages 0 and 1, 2 steps each
# the resumed run's losses at steps 6-8 against the uninterrupted run's,
# relative; twice the largest difference observed on the H100 [in brackets]
RESUME_LOSS_TOL = 5.5e-4  # [2.74e-4; 1.94e-4 in another run]


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def print_code_size(library) -> None:
    """Each kernel's SASS instruction count in a built library (cuobjdump):
    a kernel whose code outgrows the instruction cache runs at the rate its
    code is fetched."""
    import re
    from pathlib import Path

    from conditioned_nerf_gan_torch.ops.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        print(f"  SASS: {tool} not found; code size not measured")
        return
    sass = run([str(tool), "-sass", str(library)])
    for body in sass.split("Function : ")[1:]:
        mangled = body.split()[0]
        name = re.search(r"\d(film_siren_[a-z0-9_]+?)(?:E|I)", mangled)
        din = re.search(r"ILi(\d+)E", mangled)
        label = (name.group(1) if name else mangled[:60]) + (f"<{din.group(1)}>" if din else "")
        if "film_study_kernel" in mangled:
            label = "film_study_kernel " + study_label(mangled)
        count = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", body))
        print(f"  SASS: {label}: {count} instructions")


def study_label(mangled: str) -> str:
    """`film_study_kernel<layout, T, act0, act, products>` of a mangled study
    kernel name, in the wrapper's names ("v3 T128 fast_sin/affine dot")."""
    import re

    from conditioned_nerf_gan_torch.ops.kernels.film_study import ACT_IDS, LAYOUT_IDS

    found = re.search(r"film_study_kernelILi(\d)ELi(\d+)ELi(\d)ELi(\d)ELb([01])E", mangled)
    if not found:
        return mangled[:60]
    layout, tile, act0, act, dot = (int(v) for v in found.groups())
    layouts = {v: k for k, v in LAYOUT_IDS.items()}
    acts = {v: k for k, v in ACT_IDS.items()}
    return f"{layouts[layout]} T{tile} {acts[act0]}/{acts[act]} {'dot' if dot else 'nodot'}"


def print_ptxas(library) -> None:
    """Each part's compile time, and each study kernel's registers, stack
    frame, spills and how often ptxas noted that it serialised (C7520) or
    fenced (C7519) its wgmmas, from the build log (ptxas -v)."""
    import re

    function, frame, notes = None, "", {}  # notes: (function, code) -> count
    for line in library.log.splitlines():
        if line.startswith("part "):
            print(f"  nvcc {line.strip()}")
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            function, frame = entry.group(1), ""
        found = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", line)
        if found:
            frame = "stack {} B, spill stores {} B, spill loads {} B".format(*found.groups())
        note = re.search(r"\((C75\d\d)\).* in function '(\S+)'", line)
        if note:  # ptxas names the function; its notes come before its entry
            key = (note.group(2), note.group(1))
            notes[key] = notes.get(key, 0) + 1
        used = re.search(r"Used (\d+) registers", line)
        if used and function:
            counted = ", ".join(f"{code} x{n}" for (fn, code), n in sorted(notes.items())
                                if fn == function)
            print(f"  ptxas: {study_label(function)}: {used.group(1)} registers, {frame}"
                  + (f"; {counted}" if counted else ""))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, bf16_flop: float, fp32_instructions: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: the
    bytes over HBM's rate, or the operations over their units' peaks (the
    tensor cores and the FP32 pipes overlapping perfectly)."""
    t_bytes = n_bytes / H100_HBM_BYTES * 1e3
    t_ops = max(bf16_flop / H100_BF16_FLOPS, fp32_instructions / H100_FP32_INSTRUCTIONS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def film_bound(B: int, N: int, L: int, din: int, act0: str = "sin7", act: str = "sin7",
               dot: bool = True, backward: bool = False) -> tuple[float, str]:
    """`bound` of a FiLM-SIREN forward (or its VJP, `backward`) of B x N
    points, H 256, 4 outputs: every product a bf16 product (layer 0, the
    trunk unless `dot` is off, the head; the VJP recomputes the trunk, and
    takes dX and dW of every layer), every activation element on the FP32
    pipes (the VJP's sin7, cos7 and dpre: 20 instructions); the bytes of
    each input read once and each output written once (points, cotangent,
    folded weights; outputs, dX, weight grads)."""
    H, C = 256, 4
    weights = B * ((din * H + (L - 1) * H * H) * 2 + L * H * 4) + H * C * 2 + C * 4
    trunk = (L - 1) * H * H if dot else 0
    if backward:
        macs = din * H + trunk + 2 * H * C + 2 * trunk + 2 * din * H
        instructions = L * H * 20
        grads = 2 * B * L * H + din * H + (L - 1) * H * H + L * H + H * C + C
        n_bytes = B * N * (2 * din + C) * 4 + weights + 4 * grads
    else:
        macs = din * H + trunk + H * C
        instructions = H * (ACT_INSTRUCTIONS[act0] + (L - 1) * ACT_INSTRUCTIONS[act])
        n_bytes = B * N * (din + C) * 4 + weights
    return bound(n_bytes, 2.0 * B * N * macs, float(B * N * instructions))


def kernel_inputs(B: int, N: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded inputs as in scripts/check_kernel_tpu_parity.py (H 256, L 4)."""
    H, L, C, DIN = 256, 4, 4, 3
    rng = np.random.default_rng(seed)
    arrays = dict(
        points=rng.uniform(-0.3, 0.3, (B, N, DIN)),
        freq=rng.uniform(25, 45, (B, L * H)),
        phase=rng.uniform(-1, 1, (B, L * H)),
        w0=rng.normal(0, 0.5, (DIN, H)),
        b0=rng.normal(0, 0.1, (H,)),
        ws=rng.normal(0, 1.0, (L - 1, H, H)) * np.sqrt(6 / H) / 30,
        bs=rng.normal(0, 0.1, (L - 1, H)),
        wf=rng.normal(0, 0.1, (H, C)),
        bf=rng.normal(0, 0.1, (C,)),
    )
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrays.items()}


def voxel_kernel_inputs(B: int, N: int, seed: int, device, din: int = 32, L: int = 8,
                        freq_init: float = 25.0) -> dict[str, torch.Tensor]:
    """Seeded inputs at a voxel-family SIREN's shape and init (by default
    TALLSIREN_FG: 32 sampled features in, 8 layers of 256; first layer
    U(+-1/din), the rest U(+-sqrt(6/256)/freq_init), the head likewise),
    features in [-1, 1]."""
    H, C, DIN = 256, 4, din
    trunk = np.sqrt(6 / H) / freq_init
    rng = np.random.default_rng(seed)
    arrays = dict(
        points=rng.uniform(-1, 1, (B, N, DIN)),
        freq=rng.uniform(25, 45, (B, L * H)),
        phase=rng.uniform(-1, 1, (B, L * H)),
        w0=rng.uniform(-1 / DIN, 1 / DIN, (DIN, H)),
        b0=rng.uniform(-1 / np.sqrt(DIN), 1 / np.sqrt(DIN), (H,)),
        ws=rng.uniform(-trunk, trunk, (L - 1, H, H)),
        bs=rng.uniform(-1 / 16, 1 / 16, (L - 1, H)),
        wf=rng.uniform(-trunk, trunk, (H, C)),
        bf=rng.uniform(-1 / 16, 1 / 16, (C,)),
    )
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrays.items()}


def batch_slices(inp: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """`inp` cut along the batch into slices of at most PLAIN_SLICE_POINTS
    points (one slice when it is smaller): the per-view inputs sliced, the
    weights shared."""
    B, N, _ = inp["points"].shape
    step = max(1, min(B, PLAIN_SLICE_POINTS // N))
    return [{k: v[lo:lo + step] if k in ("points", "freq", "phase") else v
             for k, v in inp.items()} for lo in range(0, B, step)]


def check_kernel(label: str, inp: dict[str, torch.Tensor], phase: str = "phase 1",
                 bounds=(KERNEL_LOW_TOL, KERNEL_MEAN_TOL, KERNEL_Q999_TOL,
                         KERNEL_VS_PLAIN)) -> tuple[float, str | None]:
    """Hold the kernel against `film_siren_mlp_folded` (same bf16 operands,
    fp32 sums in another order); returns max|kernel - folded| at freq 25-45
    and a failure message (None when every bound holds).

    At freq 25-45 the max over ~1e6 points is set by the plain version's
    own summation noise, so the script also sums the same bf16-rounded math
    in fp64 and holds the kernel no further from it than the fp32 plain
    version is (see the bounds at the top). The kernel runs on the whole
    batch; past PLAIN_SLICE_POINTS points the plain versions run over
    slices of it (`batch_slices`), and the readings join: the max and the
    mean over all points (the slices are equal), the largest slice's
    p99.9.
    """
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
        film_siren_mlp_reference,
    )

    out = film_siren_mlp(*inp.values())
    low = dict(inp, freq=inp["freq"] / 30.0)
    out_low = film_siren_mlp(*low.values())
    finite = bool(torch.isfinite(out).all())
    worst = dict(err=0.0, q999=0.0, k64=0.0, p64=0.0, err_ref=0.0, err_low=0.0)
    means, lo = [], 0
    for part in batch_slices(inp):
        b = part["points"].shape[0]
        k, k_low = out[lo:lo + b], out_low[lo:lo + b]
        lo += b
        plain = film_siren_mlp_folded(*part.values())
        err = (k - plain).abs().flatten()
        means.append(err.mean().item())
        exact = film_siren_mlp_folded(*part.values(), accum_dtype=torch.float64)
        reading = dict(
            err=err.max().item(), q999=torch.quantile(err[:16_000_000], 0.999).item(),
            k64=(k - exact).abs().max().item(), p64=(plain - exact).abs().max().item(),
            err_ref=(k - film_siren_mlp_reference(*part.values())).abs().max().item(),
            err_low=(k_low - film_siren_mlp_folded(*dict(
                part, freq=part["freq"] / 30.0).values())).abs().max().item())
        worst = {name: max(worst[name], value) for name, value in reading.items()}
        del plain, err, exact
    mean = float(np.mean(means))
    B, N, din = inp["points"].shape
    low_tol, mean_tol, q999_tol, vs_plain = bounds
    sliced = f", plain versions over {len(means)} slices" if len(means) > 1 else ""
    print(f"{phase} [{label}] B={B} N={N} Din={din} L={inp['freq'].shape[1] // 256}{sliced}: "
          f"freq/30: max|kernel - folded| "
          f"{worst['err_low']:.3e} (bound {low_tol}); freq 25-45: max|kernel - folded| "
          f"{worst['err']:.3e}, mean {mean:.3e} (bound "
          f"{mean_tol}), p99.9 {worst['q999']:.3e} (bound {q999_tol}), "
          f"max|kernel - fp64-sum| {worst['k64']:.3e} vs max|folded - fp64-sum| "
          f"{worst['p64']:.3e} (ratio {worst['k64'] / worst['p64']:.3f}, bound {vs_plain}), "
          f"max|kernel - fp32 exact-sin ref| {worst['err_ref']:.3e}")
    failure = None
    if not (finite and worst["err_low"] < low_tol and mean < mean_tol
            and worst["q999"] < q999_tol and worst["k64"] <= vs_plain * worst["p64"]):
        failure = f"{phase}: kernel disagrees with its plain version at {label}"
    return worst["err"], failure


def timed_row(phase: str, label: str, B: int, N: int, fn, plain_fn, bound_ms: float,
              bound_by: str, iters: int) -> dict:
    """Time a kernel and its plain version at one shape (CUDA events) and
    print both beside the bound; returns the shape's numbers."""
    ms = cuda_ms(fn, iters)
    plain_ms = cuda_ms(plain_fn, max(3, iters // 5))
    print(f"{phase} [{label}] time at {B} x {N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), kernel / bound {ms / bound_ms:.2f} "
          f"({B * N / ms / 1e3:.1f} Mpoints/s kernel)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def shape_row(timed: dict, main: str) -> dict:
    """The JSON row's numbers at the main path's shape `main`, the other
    shapes' under ms_by_shape."""
    row = {"library_ms": None, **timed[main], "shape": main}
    row["ms_by_shape"] = {label: t for label, t in timed.items() if label != main}
    return row


def phase1_kernel(device) -> dict:
    """Kernel vs plain folded at the main paths' shapes (FWD_SHAPES; the
    plain version's time past PLAIN_SLICE_POINTS is that of its slices);
    returns the JSON row (times at the training chunk, where most of K1's
    launches run)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    worst, timed = 0.0, {}
    with torch.no_grad():
        for label, B, N in FWD_SHAPES:
            inp = kernel_inputs(B, N, seed=0, device=device)
            err, failure = check_kernel(label, inp)
            if failure:
                raise AssertionError(failure)
            worst = max(worst, err)
            parts = batch_slices(inp)
            timed[label] = timed_row(
                "phase 1", label, B, N, lambda: film_siren_mlp(*inp.values()),
                lambda: [film_siren_mlp_folded(*part.values()) for part in parts],
                *film_bound(B, N, 4, 3), 20 if B * N > 100_000 else 50)
            del inp, parts
            torch.cuda.empty_cache()
    return dict(name="film_siren_fwd", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_fwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:156",
                launches=0, max_abs_err=worst, **shape_row(timed, "training chunk"))


def phase1b_kernel_din32(device, failures: list) -> dict:
    """K1 at the voxel family's shape (32 sampled features, 8 layers) vs
    plain folded, at the study size, the `dg` training chunk, its serving
    ray chunk and a ragged N; returns the JSON row (times at the training
    chunk, where most of its main-path launches run)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    chunk_n = IMAGE_SIZE * IMAGE_SIZE // 16 * 48
    shapes = [("study", 2, IMAGE_SIZE * IMAGE_SIZE * 48), ("training chunk", 12, chunk_n),
              ("dg ray chunk", 2, chunk_n), ("ragged", 2, 1000)]
    bounds = (DIN32_LOW_TOL, DIN32_MEAN_TOL, DIN32_Q999_TOL, DIN32_VS_PLAIN)
    worst, timed = 0.0, {}
    with torch.no_grad():
        for label, B, N in shapes:
            inp = voxel_kernel_inputs(B, N, seed=1, device=device)
            err, failure = check_kernel(label, inp, "phase 1b", bounds)
            if failure:
                failures.append(failure)
            worst = max(worst, err)
            timed[label] = timed_row(
                "phase 1b", label, B, N, lambda: film_siren_mlp(*inp.values()),
                lambda: film_siren_mlp_folded(*inp.values()), *film_bound(B, N, 8, 32),
                10 if B * N > 100_000 else 50)
            flop = 2 * B * N * 256 * (32 + 7 * 256 + 4)
            print(f"phase 1b [{label}] {flop / timed[label]['ms'] / 1e9:.1f} TFLOP/s kernel")
            del inp
            torch.cuda.empty_cache()
    return dict(name="film_siren_fwd_din32", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_fwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:156",
                launches=0, max_abs_err=worst, **shape_row(timed, "training chunk"))


def make_requests(meta: dict, n: int, seed: int):
    """n requests of BATCH colored point clouds (numpy, from the seed) with
    cameras from the port's sampler."""
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        sample_camera_positions,
    )
    from conditioned_nerf_gan_torch.training.bench_setup import make_pcl

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    requests = []
    for _ in range(n):
        pcl = np.stack([make_pcl(rng, n_points=PCL_POINTS) for _ in range(BATCH)])
        origins = sample_camera_positions(BATCH, generator=gen,
                                          cam_r_start=meta["cam_r_start"],
                                          cam_r_end=meta["cam_r_end"])
        requests.append(({"pcl": pcl}, create_cam2world_matrix(origins).numpy()))
    return requests


def serve(inf, cond, cams):
    """One request through the main path: encode the conditioning ({"pcl"}
    or {"voxel"}), then render; returns the encode and render seconds (host
    clock to a device sync), the conditioning and the render."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = inf.encode(cond)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rgb, depth = inf.render_batched(z, cams, z_batched=True)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, z, rgb, depth


def phase2_serve(device, build_dir):
    """Serve REQUESTS requests through the port's Inferencer; returns the
    kernel launches the main path made, the Inferencer, and the last request
    with its seconds."""
    import conditioned_nerf_gan_torch.models.siren as siren_module
    from conditioned_nerf_gan_torch.infer import (
        Inferencer,
        build_models,
        load_metadata,
        save_checkpoint,
    )
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    meta = load_metadata(THESIS_STEP)
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        G, E = build_models(meta, generator=torch.Generator().manual_seed(0))
        ckpt = save_checkpoint(f"{tmp}/run/checkpoints/{THESIS_STEP}.pt",
                               THESIS_STEP, G, E)
        inf = Inferencer(ckpt, num_imgs=BATCH, image_size=IMAGE_SIZE,
                         load_dataset=False, seed=0, device=device)
    chunks = inf.curriculum.get("ray_chunks", 0)
    print(f"phase 2: thesis model, step {THESIS_STEP}: {IMAGE_SIZE}^2, "
          f"{inf.curriculum['num_steps']}+{inf.curriculum['num_steps']} samples, "
          f"ray_chunks {chunks}, white_back {inf.curriculum['white_back']}, "
          f"fov {inf.curriculum['fov']}")
    precision_line("phase 2", dict(PointNet=inf.encoder))
    requests = make_requests(inf.curriculum, REQUESTS, seed=0)

    torch.cuda.reset_peak_memory_stats()
    outputs = []
    film_siren_mlp.launches = 0
    for i, (cond, cams) in enumerate(requests):
        t_enc, t_render, z, rgb, depth = serve(inf, cond, cams)
        dt = t_enc + t_render
        print(f"phase 2 request {i}: {dt:.4f} s (encode {t_enc * 1e3:.3f} ms, "
              f"render {t_render * 1e3:.3f} ms), "
              f"{BATCH * IMAGE_SIZE * IMAGE_SIZE / dt:.1f} rays/s, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        outputs.append((z, cams, rgb, depth))
    launches = film_siren_mlp.launches

    expected = REQUESTS * 2 * max(chunks, 1)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    for z, cams, rgb, depth in outputs:
        if rgb.shape != (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) or depth.shape != (
                BATCH, IMAGE_SIZE, IMAGE_SIZE):
            raise AssertionError(f"output shapes {rgb.shape}, {depth.shape}")
        if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
            raise AssertionError("non-finite render output")
        if rgb.min() < -1 - 1e-5 or rgb.max() > 1 + 1e-5:
            raise AssertionError(f"pixels outside [-1, 1]: {rgb.min()}, {rgb.max()}")
    print(f"phase 2: pixels in [{min(o[2].min() for o in outputs):.4f}, "
          f"{max(o[2].max() for o in outputs):.4f}], depth in "
          f"[{min(o[3].min() for o in outputs):.4f}, {max(o[3].max() for o in outputs):.4f}]")

    # the same first render with the plain version in the kernel's place
    z, cams, rgb, depth = outputs[0]
    siren_module.film_siren_mlp = film_siren_mlp_folded
    try:
        rgb_plain, depth_plain = inf.render_batched(z, cams, z_batched=True)
    finally:
        siren_module.film_siren_mlp = film_siren_mlp
    diff = np.abs(rgb - rgb_plain).max(axis=-1)
    over = float((diff > RENDER_TOL).mean())
    print(f"phase 2: render vs plain-folded render: mean|pixel| {diff.mean():.3e} "
          f"(bound {RENDER_MEAN_TOL}), share of pixels off by > {RENDER_TOL}: "
          f"{over:.3e} (bound {RENDER_OVER_SHARE}), max|pixel| {diff.max():.3e}, "
          f"max|depth| {np.abs(depth - depth_plain).max():.3e}")
    if diff.mean() > RENDER_MEAN_TOL or over > RENDER_OVER_SHARE:
        raise AssertionError("kernel render disagrees with the plain render")
    return launches, inf, requests[-1], dt


def profile_device(fn):
    """Run fn under torch.profiler (device activity only); returns the
    number of device activities, device busy ms (union of their intervals)
    and {name: [us, count]}, or None when the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    busy_us, end = 0.0, -float("inf")
    by_name: dict[str, list[float]] = {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))  # union of the device intervals
        end = max(end, t)
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += t - s
        entry[1] += 1
    return len(device), busy_us / 1e3, by_name


def ops_on_shapes(fn, shapes: list) -> list[dict]:
    """Run fn under the profiler (host ops, with their input shapes); returns
    for each of `shapes` {op name: count} of the aten ops that take a tensor
    of that shape."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    counts: list[dict[str, int]] = [{} for _ in shapes]
    for e in prof.events():
        inputs = [list(t) for t in e.input_shapes]
        for shape, found in zip(shapes, counts):
            if list(shape) in inputs:
                found[e.name] = found.get(e.name, 0) + 1
    return counts


def print_top(phase: str, by_name: dict, n: int = 8) -> None:
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]:
        print(f"{phase}:   {us / 1e3:9.3f} ms in {count:4d} x {name[:90]}")


def phase3_profile(inf, request, unprofiled_s: float, phase: str = "phase 3") -> None:
    """The last request once more under torch.profiler (device activity
    only): device busy time, its share of that request's wall time with and
    without the profiler (the serving phase's run of it), and the largest
    kernels. The profiler slows the host, not the device, so the share
    against the unprofiled wall time is the estimate; the other bounds it
    from below."""
    times = []
    profiled = profile_device(lambda: times.append(serve(inf, *request)))
    if profiled is None:
        print(f"{phase}: the profiler recorded no device activity; busy share "
              "not measured")
        return
    n_events, busy_ms, by_name = profiled
    t_enc, t_render, *_ = times[0]
    wall_ms = (t_enc + t_render) * 1e3
    print(f"{phase}: {n_events} device activities, device busy {busy_ms:.3f} ms; "
          f"busy share {busy_ms / (unprofiled_s * 1e3):.4f} of the unprofiled "
          f"{unprofiled_s * 1e3:.3f} ms (idle {1 - busy_ms / (unprofiled_s * 1e3):.4f}), "
          f"{busy_ms / wall_ms:.4f} of the profiled {wall_ms:.3f} ms "
          f"(encode {t_enc * 1e3:.3f} ms)")
    print_top(phase, by_name, n=12)


def bwd_inputs(B: int, N: int, seed: int, device, make_inputs=None):
    """kernel_inputs (or `make_inputs`'s) and a cotangent g (B, N, 4) ~
    N(0, 1), from the seed."""
    inp = (make_inputs or kernel_inputs)(B, N, seed, device)
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.normal(0, 1, (B, N, 4)).astype(np.float32)).to(device)
    return inp, g


def vjp_fp64(inp: dict, g: torch.Tensor, chunk: int = 16384):
    """`film_siren_mlp_folded_vjp` with fp64 sums, over chunks of N: the
    folded grads are sums over points, so the chunks' grads add."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_folded_grads,
        unfold_film_grads,
    )

    args = list(inp.values())
    N = args[0].shape[1]
    parts = []
    for lo in range(0, N, chunk):
        sl = slice(lo, lo + chunk)
        parts.append(film_siren_folded_grads(args[0][:, sl], *args[1:], g[:, sl],
                                             accum_dtype=torch.float64))
    dpoints = torch.cat([p[0] for p in parts], dim=1)
    dw0f, dc0, dwsf, dcs, dwf_b, dbf_b = (sum(p[i] for p in parts) for i in range(1, 7))
    rest = unfold_film_grads(dw0f, dc0, dwsf, dcs, *[args[i] for i in (1, 3, 4, 5, 6)])
    grads = (dpoints, *rest, dwf_b.sum(0), dbf_b.sum(0))
    return tuple(t.float() for t in grads)


GRAD_NAMES = ("dpoints", "dfreq", "dphase", "dw0", "db0", "dws", "dbs", "dwf", "dbf")


def check_bwd(label: str, inp: dict, g: torch.Tensor, failures: list, phase: str = "phase 4",
              bounds=(BWD_NORM_TOL, BWD_LOW_TOL, BWD_VS_PLAIN, BWD_VS_PLAIN_MAX)) -> float:
    """Hold the backward kernel against the plain VJP at one shape; returns
    the largest max|K2 - plain| over the nine grads at freq 25-45."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp_bwd,
        film_siren_mlp_folded_vjp,
    )

    out = film_siren_mlp_bwd(*inp.values(), g)
    again = film_siren_mlp_bwd(*inp.values(), g)
    equal = all(torch.equal(a, b) for a, b in zip(out, again))
    del again
    plain = film_siren_mlp_folded_vjp(*inp.values(), g)
    exact = vjp_fp64(inp, g)
    low = dict(inp, freq=inp["freq"] / 30.0)
    out_low = film_siren_mlp_bwd(*low.values(), g)
    plain_low = film_siren_mlp_folded_vjp(*low.values(), g)
    B, N, din = inp["points"].shape
    norm_tol, low_tol, vs_plain, vs_plain_max = bounds
    print(f"{phase} [{label}] B={B} N={N} Din={din} L={inp['freq'].shape[1] // 256}: "
          f"two launches bitwise equal: {equal}")
    if not equal:
        failures.append(f"{phase} [{label}]: two launches differ")
    worst = 0.0
    for name, k, p, e, kl, pl in zip(GRAD_NAMES, out, plain, exact, out_low, plain_low):
        if not torch.isfinite(k).all():
            failures.append(f"{phase} [{label}] {name}: non-finite")
        err = (k - p).abs().max().item()
        worst = max(worst, err)
        norm = ((k - p).norm() / p.norm()).item()
        low_max = ((kl - pl).abs().max() / pl.abs().max()).item()
        k64 = (k - e).abs().max().item()
        p64 = (p - e).abs().max().item()
        k64_2 = (k - e).norm().item()
        p64_2 = (p - e).norm().item()
        floor = BWD_ULPS * e.abs().max().item()
        floor_2 = BWD_ULPS * e.norm().item()
        print(f"{phase} [{label}] {name:7s} max|plain| {p.abs().max().item():.3e}: "
              f"|K2-plain|_2/|plain|_2 {norm:.3e} (bound {norm_tol}); freq/30 "
              f"max|K2-plain|/max|plain| {low_max:.3e} (bound {low_tol}); "
              f"|K2-fp64|_2 {k64_2:.3e} vs |plain-fp64|_2 {p64_2:.3e} (ratio "
              f"{k64_2 / max(p64_2, 1e-30):.3f}, bound {vs_plain} + {floor_2:.1e}); "
              f"max|K2-fp64| {k64:.3e} vs max|plain-fp64| {p64:.3e} (ratio "
              f"{k64 / max(p64, 1e-30):.3f}, bound {vs_plain_max} + {floor:.1e}); "
              f"max|K2-plain| {err:.3e}")
        if not (norm < norm_tol and low_max < low_tol
                and k64_2 <= vs_plain * p64_2 + floor_2
                and k64 <= vs_plain_max * p64 + floor):
            failures.append(f"{phase} [{label}] {name}: K2 disagrees with the plain VJP")
    return worst


def phase4_bwd(device, failures: list) -> dict:
    """Backward kernel vs the plain VJP at the steps' shapes (BWD_SHAPES);
    returns the JSON row (times at the training chunk, the main path's
    shape)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp_bwd,
        film_siren_mlp_folded_vjp,
    )

    worst, timed = 0.0, {}
    for label, B, N in BWD_SHAPES:
        inp, g = bwd_inputs(B, N, seed=0, device=device)
        worst = max(worst, check_bwd(label, inp, g, failures))
        timed[label] = timed_row(
            "phase 4", label, B, N, lambda: film_siren_mlp_bwd(*inp.values(), g),
            lambda: film_siren_mlp_folded_vjp(*inp.values(), g),
            *film_bound(B, N, 4, 3, backward=True), 10 if B * N > 100_000 else 50)
        del inp, g
        torch.cuda.empty_cache()
    return dict(name="film_siren_bwd", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_bwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:232",
                launches=0, max_abs_err=worst, **shape_row(timed, "training chunk"))


def phase4b_bwd_din32(device, failures: list) -> dict:
    """K2 at the voxel family's shape (32 sampled features, 8 layers) vs the
    plain VJP at the dg training chunk, stage 0's chunk and a ragged N;
    returns the shapes' times (the training chunk is the main path's)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp_bwd,
        film_siren_mlp_folded_vjp,
    )

    chunk = IMAGE_SIZE * IMAGE_SIZE // 16 * 48
    shapes = [("Din 32 L 8 training chunk", 12, chunk),
              ("Din 32 L 8 stage-0 chunk", 12, 32 * 32 // 4 * 48),
              ("Din 32 L 8 ragged", 2, 1000)]
    bounds = (DIN32_BWD_NORM_TOL, DIN32_BWD_LOW_TOL, DIN32_BWD_VS_PLAIN, DIN32_BWD_VS_PLAIN_MAX)
    worst, timed = 0.0, {}
    for label, B, N in shapes:
        inp, g = bwd_inputs(B, N, seed=1, device=device, make_inputs=voxel_kernel_inputs)
        worst = max(worst, check_bwd(label, inp, g, failures, "phase 4b", bounds))
        timed[label] = timed_row(
            "phase 4b", label, B, N, lambda: film_siren_mlp_bwd(*inp.values(), g),
            lambda: film_siren_mlp_folded_vjp(*inp.values(), g),
            *film_bound(B, N, 8, 32, backward=True), 10 if B * N > 100_000 else 50)
        del inp, g
        torch.cuda.empty_cache()
    return dict(worst=worst, timed=timed)


class PlainFilmSiren(torch.autograd.Function):
    """Both kernels' plain versions as one differentiable op: the forward is
    `film_siren_mlp_folded`, the backward `film_siren_mlp_folded_vjp`."""

    @staticmethod
    def forward(ctx, *args):
        from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
            film_siren_mlp_folded,
        )

        ctx.save_for_backward(*args)
        return film_siren_mlp_folded(*args)

    @staticmethod
    def backward(ctx, g):
        from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
            film_siren_mlp_folded_vjp,
        )

        return film_siren_mlp_folded_vjp(*ctx.saved_tensors, g)


class PlainTrilinear(torch.autograd.Function):
    """Both trilinear kernels' plain versions as one differentiable op: the
    forward is `border_trilerp_reference`, the backward
    `border_trilerp_vjp_reference`."""

    @staticmethod
    def forward(ctx, volume, coords):
        from conditioned_nerf_gan_torch.ops.grid_sample import border_trilerp_reference

        ctx.save_for_backward(volume, coords)
        return border_trilerp_reference(volume, coords)

    @staticmethod
    def backward(ctx, g):
        from conditioned_nerf_gan_torch.ops.grid_sample import border_trilerp_vjp_reference

        volume, coords = ctx.saved_tensors
        return border_trilerp_vjp_reference(volume, coords, g, ctx.needs_input_grad[1])


def record_grads(state) -> dict:
    """Wrap the optimizers' step to keep each net's grads as they arrive
    (before the clip); returns {net: flat grads}, filled per step."""
    grads = {}
    for net in ("G", "E", "D"):
        opt = getattr(state, f"opt_{net}")
        if opt is None:  # no discriminator
            continue
        step = opt.step

        def recording(*args, _net=net, _opt=opt, _step=step, **kwargs):
            grads[_net] = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
                for group in _opt.param_groups for p in group["params"]])
            return _step(*args, **kwargs)

        opt.step = recording
    return grads


def precision_line(phase: str, nets: dict) -> None:
    """Print which of `nets` ({label: module or None}) run a bf16 policy
    (their layers' `compute_dtype`), beside the process's TF32 and
    bf16-reduction flags."""
    def policy(module):
        dtypes = {str(m.compute_dtype).replace("torch.", "") for m in module.modules()
                  if getattr(m, "compute_dtype", None) is not None}
        return "/".join(sorted(dtypes)) or "fp32"

    b = torch.backends
    print(f"{phase}: precision: " + ", ".join(
        f"{label} {policy(net)}" for label, net in nets.items() if net is not None)
        + " (params fp32); the SIRENs through K1 and K2 (bf16 products, fp32 sums); "
        f"process flags: matmul.allow_tf32 {b.cuda.matmul.allow_tf32}, cudnn.allow_tf32 "
        f"{b.cudnn.allow_tf32}, matmul.allow_bf16_reduced_precision_reduction "
        f"{b.cuda.matmul.allow_bf16_reduced_precision_reduction}")


class PolicyProbe:
    """Forward hooks on an encoder that record the dtypes its layers put
    out: PointNet's blocks and the U-Net's block convs must be bf16 under
    the policy, GroupNorm and the encoder's result fp32."""

    def __init__(self, encoder):
        from conditioned_nerf_gan_torch.models.pointnet import ResnetBlockFC
        from conditioned_nerf_gan_torch.models.unet3d import Conv3d, GroupNorm

        self.seen: dict[str, set] = {}
        self.expect: dict[str, torch.dtype] = {}
        self.handles = []
        for name, module in encoder.named_modules():
            if isinstance(module, ResnetBlockFC):
                self._watch(module, "PointNet block", torch.bfloat16)
            elif isinstance(module, Conv3d) and name != "final_conv":
                self._watch(module, "U-Net conv", torch.bfloat16)
            elif isinstance(module, GroupNorm):
                self._watch(module, "GroupNorm", torch.float32)
        self._watch(encoder, "encoder result", torch.float32)

    def _watch(self, module, kind, dtype):
        self.expect[kind] = dtype

        def record(_module, _args, out):
            for t in (out if isinstance(out, tuple) else (out,)):
                self.seen.setdefault(kind, set()).add(t.dtype)

        self.handles.append(module.register_forward_hook(record))

    def check(self, phase: str, failures: list) -> None:
        for handle in self.handles:
            handle.remove()
        seen = {k: sorted(str(d).replace("torch.", "") for d in v) for k, v in self.seen.items()}
        print(f"{phase}: output dtypes in the step, by layer kind: {seen}")
        for kind, dtype in self.expect.items():
            if self.seen.get(kind) != {dtype}:
                failures.append(f"{phase}: {kind} put out {seen.get(kind)}, not {dtype} "
                                "(the bf16 policy is not live)")


def step_against_plain(phase: str, state, train_step, batch, rng, alpha, nerf_noise,
                       plain: dict, loss_tol: float, grad_tol: float, failures: list,
                       unheld: tuple = (), grad_tols: dict | None = None) -> None:
    """One more step with the kernels and the same step (state, batch,
    random numbers) with `plain` ({name in the SIREN module: plain
    version}) in the kernels' places; each loss and each net's grads are
    held at the bounds (a net's own in `grad_tols`, else `grad_tol`),
    except the names in `unheld`, which are printed."""
    import conditioned_nerf_gan_torch.models.siren as siren_module

    snapshot, rng_state = copy.deepcopy(state), rng.get_state()
    kernels = {name: getattr(siren_module, name) for name in plain}
    runs = {}
    for label in ("kernels", "plain"):
        trial = copy.deepcopy(snapshot)
        grads = record_grads(trial)
        rng.set_state(rng_state)
        if label == "plain":
            for name, fn in plain.items():
                setattr(siren_module, name, fn)
        try:
            _, metrics = train_step(trial, batch, rng, alpha, nerf_noise)
        finally:
            for name, fn in kernels.items():
                setattr(siren_module, name, fn)
        runs[label] = ({k: float(v) for k, v in metrics.items()}, grads)
        del trial
        torch.cuda.empty_cache()
    (loss_k, grad_k), (loss_p, grad_p) = runs["kernels"], runs["plain"]
    readings = [(k, abs(loss_k[k] - loss_p[k]) / max(abs(loss_p[k]), 1e-30), loss_tol,
                 f"{k} kernels {loss_k[k]:.7f} plain {loss_p[k]:.7f}") for k in loss_k]
    readings += [(net, ((grad_k[net] - grad_p[net]).norm() / grad_p[net].norm()).item(),
                  (grad_tols or {}).get(net, grad_tol),
                  f"{net} grads |kernels - plain|_2/|plain|_2, |plain|_2 "
                  f"{grad_p[net].norm().item():.3e},") for net in grad_k]
    for name, rel, tol, text in readings:
        held = name not in unheld
        print(f"{phase}: {text} rel {rel:.3e} "
              + (f"(bound {tol})" if held else "(through the bf16 D: printed; held on the "
                                               "fp32 path's step)"))
        if held and not rel <= tol:
            failures.append(f"{phase}: " + (f"{name} grads differ" if name in grad_k
                                            else f"{name} differs") + " from the plain step")


def fp32_bench_step(phase: str, preset: str, step: int, device, failures: list,
                    plain: dict | None = None, overrides: dict | None = None,
                    grad_tols: dict | None = None) -> None:
    """The same stage's step with the encoder and D at compute_dtype None
    (the fp32 path; G keeps the policy, which routes its SIREN to K1 and
    K2), on a bench of its own: one step timed after a warm-up (seconds and
    peak memory); with `plain`, then the kernels against the plain versions
    at phase 5's bounds, every number held."""
    from conditioned_nerf_gan_torch.infer import build_models
    from conditioned_nerf_gan_torch.models import make_discriminator
    from conditioned_nerf_gan_torch.training import (
        build_stage_bench,
        create_train_state,
        make_train_step,
    )

    bench = build_stage_bench(preset, stage=2, step=step, meta_overrides=overrides)
    # fp32 twins of the bench's encoder and D, with its weights
    encoder = build_models(dict(bench.meta, compute_dtype=None))[1]
    encoder.load_state_dict(bench.encoder.state_dict())
    disc = None
    if bench.discriminator is not None:
        disc = make_discriminator(bench.meta["discriminator"])
        disc.load_state_dict(bench.discriminator.state_dict())
    nets = [bench.generator, encoder, disc]
    for net in nets:
        if net is not None:
            net.to(device)
    state = create_train_state(*nets, bench.config)
    train_step = make_train_step(bench.config)
    batch = {k: torch.from_numpy(v).to(device) for k, v in bench.batch.items()}
    rng = torch.Generator(device=device).manual_seed(0)
    precision_line(phase, dict(encoder=encoder, D=disc))
    train_step(state, batch, rng, bench.alpha, bench.nerf_noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step(state, batch, rng, bench.alpha, bench.nerf_noise)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{phase}: the encoder" + (" and D" if disc is not None else "")
          + f" at compute_dtype None (fp32), one step after a warm-up: {seconds:.4f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if plain is not None:
        step_against_plain(phase + " (fp32 path)", state, train_step, batch, rng, bench.alpha,
                           bench.nerf_noise, plain, STEP_LOSS_TOL, STEP_GRAD_TOL, failures,
                           grad_tols=grad_tols)
    del state, batch, nets, encoder, disc, bench
    torch.cuda.empty_cache()


def phase5_train(device, failures: list) -> tuple[int, int]:
    """The stage-2 train step at full width; returns the two kernels'
    launches over the warm-up and timed steps (the main path's run; the
    comparison and profiled steps after it are not counted)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_bwd,
    )
    from conditioned_nerf_gan_torch.training import (
        build_stage_bench,
        create_train_state,
        make_train_step,
    )

    t0 = time.perf_counter()
    bench = build_stage_bench(stage=2, step=TRAIN_STEP)
    cfg, meta = bench.config, bench.meta
    nets = dict(G=bench.generator, E=bench.encoder, D=bench.discriminator)
    for net in nets.values():
        net.to(device)
    state = create_train_state(nets["G"], nets["E"], nets["D"], cfg)
    train_step = make_train_step(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in bench.batch.items()}
    rng = torch.Generator(device=device).manual_seed(0)
    r = cfg.render
    chunks = max(r.ray_chunks, 1)
    evals = 2 if r.hierarchical_sample else 1
    # per step: D render, G render and the G backward's recompute, each
    # `evals` SIREN calls per ray chunk; one backward per G-render call
    expect_fwd, expect_bwd = 3 * evals * chunks, evals * chunks
    print(f"phase 5: thesis model, step {TRAIN_STEP}: batch {meta['batch_size']}, "
          f"{r.img_size}^2, {r.num_steps}+{r.num_steps} samples, ray_chunks "
          f"{r.ray_chunks}, {meta['discriminator']} R1 {cfg.r1_lambda}, alpha "
          f"{bench.alpha}, nerf_noise {bench.nerf_noise}, pcl "
          f"{tuple(batch['pcl'].shape)}; set-up {time.perf_counter() - t0:.2f} s")
    precision_line("phase 5", dict(PointNet=nets["E"], D=nets["D"]))
    before = {name: [p.detach().clone() for p in net.parameters()]
              for name, net in nets.items()}

    torch.cuda.reset_peak_memory_stats()
    film_siren_mlp.launches = film_siren_mlp_bwd.launches = 0
    fwd_total = bwd_total = 0
    step_s = []
    for i in range(1 + TRAIN_TIMED_STEPS):
        probe = PolicyProbe(nets["E"]) if i == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, rng, bench.alpha, bench.nerf_noise)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if probe is not None:
            probe.check("phase 5", failures)
        fwd, bwd = film_siren_mlp.launches, film_siren_mlp_bwd.launches
        fwd_total, bwd_total = fwd_total + fwd, bwd_total + bwd
        film_siren_mlp.launches = film_siren_mlp_bwd.launches = 0
        losses = {k: float(v) for k, v in metrics.items()}
        print(f"phase 5 step {i}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.4f} s, "
              f"launches K1 {fwd} (design {expect_fwd}), K2 {bwd} (design "
              f"{expect_bwd}), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              + ", ".join(f"{k} {v:.6f}" for k, v in losses.items()))
        if (fwd, bwd) != (expect_fwd, expect_bwd):
            failures.append(f"phase 5 step {i}: launches {fwd}/{bwd}, design "
                            f"{expect_fwd}/{expect_bwd}")
        if not all(np.isfinite(v) for v in losses.values()):
            failures.append(f"phase 5 step {i}: non-finite losses {losses}")
    timed = step_s[1:]
    print(f"phase 5: {np.mean(timed):.4f} s/step (steps {', '.join(f'{t:.4f}' for t in timed)}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, net in nets.items():
        moved = max((p.detach() - q).abs().max().item()
                    for p, q in zip(net.parameters(), before[name]))
        print(f"phase 5: {name} params moved by up to {moved:.3e}")
        if not moved > 0:
            failures.append(f"phase 5: {name} did not move")
    del before

    # one more step with the kernels, and the same step (state, batch, random
    # numbers) with the plain versions in both kernels' places
    step_against_plain("phase 5", state, train_step, batch, rng, bench.alpha, bench.nerf_noise,
                       dict(film_siren_mlp=PlainFilmSiren.apply), STEP_LOSS_TOL, STEP_GRAD_TOL,
                       failures, unheld=THROUGH_D)

    # one profiled step: device busy share against the timed steps' mean
    profiled = profile_device(
        lambda: train_step(state, batch, rng, bench.alpha, bench.nerf_noise))
    if profiled is None:
        print("phase 5: the profiler recorded no device activity; busy share "
              "not measured")
    else:
        n_events, busy_ms, by_name = profiled
        mean_ms = np.mean(timed) * 1e3
        print(f"phase 5: profiled step: {n_events} device activities, device busy "
              f"{busy_ms:.3f} ms; busy share {busy_ms / mean_ms:.4f} of the timed "
              f"steps' mean {mean_ms:.3f} ms (idle {1 - busy_ms / mean_ms:.4f})")
        print_top("phase 5", by_name, n=12)
    del state, batch, nets, bench
    torch.cuda.empty_cache()
    fp32_bench_step("phase 5", "thousand", TRAIN_STEP, device, failures,
                    plain=dict(film_siren_mlp=PlainFilmSiren.apply))
    return fwd_total, bwd_total


def trilerp_points(B: int, N: int, seed: int, device, border: bool = False):
    """(B, N, 3) world points, uniform in the +-0.6 cube from the seed; with
    `border`, a third of them as far as +-0.9 (outside the cube: the border
    clamp) and a third with one coordinate exactly on a face (+-0.6)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.6, 0.6, (B, N, 3))
    if border:
        third = N // 3
        pts[:, :third] = rng.uniform(-0.9, 0.9, (B, third, 3))
        axis = rng.integers(0, 3, (B, third))
        face = rng.choice([-0.6, 0.6], (B, third))
        rows = pts[:, third:2 * third]
        np.put_along_axis(rows, axis[..., None], face[..., None], axis=-1)
    return torch.from_numpy(pts.astype(np.float32)).to(device)


def ray_points(B: int, seed: int, device) -> torch.Tensor:
    """The coarse samples of one ray chunk of a 128^2 render with 48 samples
    (the 16 chunks' middle one: 8 image rows through the object, ray-major
    as the generator lays them out) from B cameras on the shell, drawn from
    the seed, in the sampler's normalized coordinates: (B, 8 * 128 * 48, 3)."""
    from conditioned_nerf_gan_torch.models.siren import VOXEL_LENGTH
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        get_initial_rays,
        sample_camera_positions,
        transform_rays,
    )

    u = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (B, 3)).astype(np.float32))
    cams = create_cam2world_matrix(sample_camera_positions(
        B, cam_r_start=0.7, cam_r_end=1.5, uniforms=u)).to(device)
    rows = IMAGE_SIZE // 16
    points, z_vals, rays_d = get_initial_rays(
        B, 48, 49.134342641202636, (IMAGE_SIZE, rows), 0.25, 1.95,
        row_offset=IMAGE_SIZE // 2, full_height=IMAGE_SIZE, device=device)
    points = transform_rays(points, z_vals, rays_d, cams)[0]
    return (points.reshape(B, -1, 3) / (VOXEL_LENGTH / 2.0)).contiguous()


def device_ms(fn, names: tuple, iters: int = 20) -> float:
    """fn's device time per call in ms: the device time of the kernels whose
    names hold one of `names`, over `iters` calls under torch.profiler,
    over iters (NaN when the profiler sees no device work). A small kernel
    takes less than its wrapper's host time, which an event-timed loop of
    calls measures instead."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # the profiler has once seen no device work in a run
        profiled = profile_device(lambda: [fn() for _ in range(iters)])
        if profiled is not None:
            break
    else:
        return float("nan")
    by_name = profiled[2]
    us = sum(t for name, (t, _) in by_name.items() if any(n in name for n in names))
    return us / iters / 1e3


def touched_rows(volume: torch.Tensor, coords: torch.Tensor) -> int:
    """Distinct corner rows (voxels) the points read: the data-dependent part
    of a gather's compulsory bytes."""
    from conditioned_nerf_gan_torch.ops.grid_sample import corner_contributions

    g = torch.zeros(*coords.shape[:2], 4, device=coords.device)
    rows, _ = corner_contributions(volume[..., :4], coords, g)
    return int(torch.unique(rows).numel())


def check_trilinear_bwd(label: str, volume, coords, g, failures: list,
                        phase: str = "phase 6") -> float:
    """Hold the trilinear backward kernel, adding dV into a buffer that holds
    seeded N(0, 1) values, against `border_trilerp_vjp_reference` (dcoords)
    and against an fp64 sum of the buffer and the same contributions (each
    voxel within k_v fp32 roundings of its sum of |terms|, k_v the buffer's
    value and its contributions; by L2 distance no farther than
    TRI_BWD_VS_PLAIN x the plain fp32 `index_add_` added to the buffer);
    returns max|dV - plain|."""
    from conditioned_nerf_gan_torch.ops.grid_sample import (
        border_trilerp_vjp_reference,
        corner_contributions,
    )
    from conditioned_nerf_gan_torch.ops.kernels.trilinear import trilinear_bwd

    start = torch.randn(tuple(volume.shape), device=volume.device,
                        generator=torch.Generator(volume.device).manual_seed(8))
    dvol = start.clone()
    dcoords = trilinear_bwd(volume, coords, g, dvol, need_coords=True)
    pvol, pcoords = border_trilerp_vjp_reference(volume, coords, g, True)
    pvol.add_(start)
    rows, parts = corner_contributions(volume, coords, g)
    C = volume.shape[-1]
    exact = start.double().reshape(-1, C).index_add_(0, rows, parts.double())
    magnitude = start.double().abs().reshape(-1, C).index_add_(0, rows, parts.double().abs())
    count = torch.ones(exact.shape[0], dtype=torch.float64, device=volume.device)
    count.index_add_(0, rows, (parts != 0).any(-1).double())
    del parts, rows, start
    dflat, pflat = dvol.reshape(-1, C).double(), pvol.reshape(-1, C).double()
    k64, p64 = (dflat - exact).norm().item(), (pflat - exact).norm().item()
    ulp = 2.0 ** -24
    roundings = ((dflat - exact).abs() / (ulp * magnitude).clamp_min(1e-300))
    within = bool(((dflat - exact).abs() <= count[:, None] * ulp * magnitude).all())
    floor = ulp * exact.norm().item()
    c_err = (dcoords - pcoords).abs().max().item()
    c_max = pcoords.abs().max().item()
    err = (dvol - pvol).abs().max().item()
    print(f"{phase} [{label}] backward, into a buffer of N(0, 1): dcoords "
          f"max|kernel - plain| {c_err:.3e} (bound {TRI_DCOORDS_TOL} x max|plain| "
          f"{c_max:.3e}); dV max|kernel - plain| {err:.3e}, |kernel - fp64|_2 {k64:.3e} vs "
          f"|index_add - fp64|_2 {p64:.3e} (ratio {k64 / max(p64, 1e-300):.3f}, bound "
          f"{TRI_BWD_VS_PLAIN} + {floor:.1e}); every voxel within k_v roundings of "
          f"sum|terms|: {within} (largest {roundings.max().item():.2f} roundings; k_v up "
          f"to {int(count.max().item())})")
    if not (torch.isfinite(dvol).all() and torch.isfinite(dcoords).all()
            and c_err <= TRI_DCOORDS_TOL * c_max and within
            and k64 <= TRI_BWD_VS_PLAIN * p64 + floor):
        failures.append(f"{phase} [{label}]: the backward kernel disagrees with its plain version")
    return err


PRESUM_TILE = 256  # csrc/trilinear_bwd.cu's TILE: the points one CTA pre-sums


def presummed_contributions(volume, coords, g):
    """The backward kernel's pre-sums in plain torch: (rows (M,), sums (M,
    C)), one for each distinct row of a (B * D * H * W, C) view of dV that
    the live corners (weight not exactly zero) of one tile touch, with that
    tile's contributions to the row summed in fp32. A tile is the kernel's
    CTA: PRESUM_TILE consecutive points of one batch element. dV is the sums
    added at their rows. The kernel issues M x C / 4 16-byte reductions,
    and one more a channel quad for each row that its sum loop's equal runs
    cut (at most PRESUM_TILE / min(C / 4, 8) - 1 a tile and quad)."""
    from conditioned_nerf_gan_torch.ops.grid_sample import corner_contributions

    B, N, _ = coords.shape
    n_rows = volume.numel() // volume.shape[-1]
    rows, parts = corner_contributions(volume, coords, g)
    _, weights = corner_contributions(volume[..., :1], coords, torch.ones_like(g[..., :1]))
    live = weights[:, 0] != 0
    # each point's tile, numbered (b, tile) as the kernel's CTAs; the rows
    # are corner-major, (8, B * N)
    tiles = -(-N // PRESUM_TILE)
    tile = (torch.arange(B, device=coords.device)[:, None] * tiles
            + torch.arange(N, device=coords.device) // PRESUM_TILE)
    key = tile.reshape(-1).repeat(8)[live] * n_rows + rows[live]
    groups, which = torch.unique(key, return_inverse=True)
    sums = torch.zeros(groups.numel(), parts.shape[1], dtype=parts.dtype, device=parts.device)
    sums.index_add_(0, which, parts[live])
    return groups % n_rows, sums


def scatter_counts(volume, coords) -> dict:
    """What a dV launch moves, from the points alone (g ~ N(0, 1) has no
    zero), counted in plain torch, not by the kernel: the live (point,
    corner) pairs (weight not exactly zero), the distinct rows they touch,
    and the 16-byte reductions issued: by the kernel, one a (tile, distinct
    row) of its grouping (`presummed_contributions`) and channel quad, plus
    at most one a quad for each cut of its sum loop's runs that falls inside
    a row (`reductions_max`: every cut does); by the first design, one a
    live pair and quad. Printed, and `pairs` and `rows` set the bound; none
    goes into the kernels line."""
    from conditioned_nerf_gan_torch.ops.grid_sample import corner_contributions

    B, N, _ = coords.shape
    quads = volume.shape[-1] // 4
    ones = torch.ones(B, N, 1, device=coords.device)
    rows, weights = corner_contributions(volume[..., :1], coords, ones)
    live = weights[:, 0] != 0
    groups, _ = presummed_contributions(volume[..., :4], coords, ones.expand(-1, -1, 4))
    tiles = B * -(-N // PRESUM_TILE)
    # per pass of up to 8 quads, PRESUM_TILE / quads runs of the tile's pairs
    passes = [min(8, quads - q0) for q0 in range(0, quads, 8)]
    cuts = tiles * sum((PRESUM_TILE // nq - 1) * nq for nq in passes)
    return dict(pairs=int(live.sum()), rows=int(torch.unique(rows[live]).numel()),
                reductions=groups.numel() * quads,
                reductions_max=groups.numel() * quads + cuts,
                reductions_first=int(live.sum()) * quads)


def phase6_trilinear(device, failures: list) -> tuple[dict, dict]:
    """Both trilinear kernels vs their plain versions on a 2 x 64^3 x 32
    volume (the dg feature volume's shape) at five point sets and on a 12 x
    64^3 x 32 volume at the training ray chunk; returns the forward's and
    the backward's JSON rows (times at the training chunk, where most of
    their main-path launches run)."""
    import torch.nn.functional as F

    from conditioned_nerf_gan_torch.models.siren import VOXEL_LENGTH
    from conditioned_nerf_gan_torch.ops.grid_sample import (
        border_trilerp_reference,
        border_trilerp_vjp_reference,
        trilinear_point_features,
    )
    from conditioned_nerf_gan_torch.ops.kernels.trilinear import trilinear_bwd

    C = 32
    rng = np.random.default_rng(2)
    volumes = {B: torch.from_numpy(rng.normal(0, 1, (B, VOXEL_RES, VOXEL_RES, VOXEL_RES, C))
                                   .astype(np.float32)).to(device) for B in (2, 12)}
    chunk = IMAGE_SIZE * IMAGE_SIZE // 16 * 48
    cube = lambda B, N, border=False: trilerp_points(B, N, 3, device, border) / (VOXEL_LENGTH / 2.0)
    sets = [("study", 2, lambda: cube(2, IMAGE_SIZE * IMAGE_SIZE * 48)),
            ("ragged", 2, lambda: cube(2, 1000)),
            ("border", 2, lambda: cube(2, 300_000, border=True)),
            ("dg ray chunk", 2, lambda: ray_points(2, 4, device)),
            ("training chunk", 12, lambda: ray_points(12, 5, device))]
    worst = worst_bwd = 0.0
    fwd_rows, bwd_rows = {}, {}
    for label, B, make in sets:
        volume = volumes[B]
        vol_max = volume.abs().max().item()
        volume_ncdhw = volume.permute(0, 4, 1, 2, 3).contiguous()
        coords = make()
        N = coords.shape[1]
        assert coords.shape == (B, N, 3) and (label != "training chunk" or N == chunk)
        with torch.no_grad():
            out = trilinear_point_features(volume, coords)
            plain = border_trilerp_reference(volume, coords)
            err = (out - plain).abs().max().item()
            worst = max(worst, err)
            grid = coords[:, None, None]  # (B, 1, 1, N, 3)
            gs = F.grid_sample(volume_ncdhw, grid, mode="bilinear", padding_mode="border",
                               align_corners=False)[:, :, 0, 0].transpose(1, 2)
            gs_err = (out - gs).abs().max().item()
            outside = (coords.abs() > 1).any(-1).float().mean().item()
            rows = touched_rows(volume, coords)
            print(f"phase 6 [{label}] B={B} N={N} volume {VOXEL_RES}^3 x {C}: "
                  f"max|kernel - plain| {err:.3e} (bound {TRILERP_TOL} x "
                  f"max|volume| {vol_max:.3f}), max|kernel - F.grid_sample| {gs_err:.3e}, share "
                  f"of points outside the cube {outside:.4f}, distinct corner rows read "
                  f"{rows} ({rows / volume.numel() * C:.4f} of the volume's)")
            if not (torch.isfinite(out).all() and err <= TRILERP_TOL * vol_max):
                failures.append(f"phase 6 [{label}]: kernel disagrees with its plain version")
            del out, plain, gs
            iters = 20 if B * N > 100_000 else 50
            main = lambda: trilinear_point_features(volume, coords)
            event_ms = cuda_ms(main, iters)
            span_ms = device_ms(main, ("trilinear_fwd_kernel",))
            ms = graph_ms(main)
            plain_ms = cuda_ms(lambda: border_trilerp_reference(volume, coords),
                               max(3, iters // 5))
            gs_ms = cuda_ms(lambda: F.grid_sample(volume_ncdhw, grid, mode="bilinear",
                                                  padding_mode="border",
                                                  align_corners=False), iters)
            gathered = B * N * 8 * C * 4
            # the coordinates read and the output written once, and each
            # distinct corner row the points touch read once; per point 7
            # lerps of C channels (a subtract and an FMA each) and ~30
            # instructions of anchors and weights
            bound_ms, bound_by = bound(B * N * (3 + C) * 4 + rows * C * 4, 0.0,
                                       float(B * N * (14 * C + 30)))
            print(f"phase 6 [{label}] time: kernel {ms:.4f} ms a call back to back (a CUDA "
                  f"graph of 20); its device span {span_ms:.4f} ms (profiler), a call "
                  f"of the wrapper {event_ms:.4f} ms (events), plain {plain_ms:.4f} ms, "
                  f"F.grid_sample (NCDHW, yardstick) {gs_ms:.4f} ms; bound {bound_ms:.4f} ms "
                  f"({bound_by}), kernel at {bound_ms / ms:.3f} of it; "
                  f"{B * N / ms / 1e3:.1f} Mpoints/s, {gathered / ms / 1e6:.1f} GB/s of "
                  "corner reads")
            fwd_rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=gs_ms, call_ms=event_ms, span_ms=span_ms)

        # the backward at the same points, cotangent ~ N(0, 1)
        g = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (B, N, C))
                             .astype(np.float32)).to(device)
        worst_bwd = max(worst_bwd, check_trilinear_bwd(label, volume, coords, g, failures))
        grad_ncdhw = g.transpose(1, 2)[:, :, None, None, :].contiguous()
        buf = torch.zeros_like(volume)
        main = lambda: trilinear_bwd(volume, coords, g, buf)
        event_ms = cuda_ms(main, iters)
        span_ms = device_ms(main, ("trilinear_bwd_presum_kernel",))
        ms = graph_ms(main)
        plain_ms = cuda_ms(lambda: buf.add_(border_trilerp_vjp_reference(volume, coords, g,
                                                                          False)[0]),
                           max(3, iters // 5))
        lib_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
            grad_ncdhw, volume_ncdhw, grid, 0, 1, False, [True, False]), iters)
        counts = scatter_counts(volume, coords)
        # coordinates and cotangent read once, each distinct row the live
        # corners touch read and written once; 3 products and an add a live
        # pair and channel
        bound_ms, bound_by = bound(B * N * (3 + C) * 4 + counts["rows"] * C * 4 * 2, 0.0,
                                   float(counts["pairs"] * 4 * C))
        print(f"phase 6 [{label}] backward time (dV into the caller's buffer, as on the main "
              f"path, no zeroing): kernel {ms:.4f} ms a call back to back (a CUDA graph of 20); "
              f"its device span {span_ms:.4f} ms (profiler), a call of the wrapper "
              f"{event_ms:.4f} ms (events), plain (its dV added to the buffer) {plain_ms:.4f} ms, "
              f"grid_sampler_3d_backward (NCDHW; yardstick, which also allocates and zeroes a "
              f"fresh dV) {lib_ms:.4f} ms; counted in plain torch: live pairs {counts['pairs']}, "
              f"distinct rows {counts['rows']} "
              f"({counts['rows'] / (volume.numel() // C):.4f} of the volume's), 16-byte "
              f"reductions issued {counts['reductions']} to {counts['reductions_max']} (one a "
              f"live pair and quad, as the first design issued: {counts['reductions_first']}, "
              f"{counts['reductions_first'] / counts['reductions']:.2f}x to "
              f"{counts['reductions_first'] / counts['reductions_max']:.2f}x more); bound "
              f"{bound_ms:.4f} ms ({bound_by}), kernel at {bound_ms / ms:.3f} of it")
        bwd_rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms, call_ms=event_ms, span_ms=span_ms)
        if label == "training chunk":
            share = bwd_rows[label]["bound_ms"]
            print(f"phase 6 [{label}] the first design (PERF.md, an H100 at 700 W): its scatter "
                  f"{FIRST_SCATTER_MS:.4f} ms a call, at {share / FIRST_SCATTER_MS:.3f} of this "
                  f"bound, and a fresh dV's zeroing {FIRST_BWD_MS - FIRST_SCATTER_MS:.4f} ms "
                  f"in each call ({FIRST_BWD_MS:.4f} together), which this design leaves to "
                  f"the render, once a step; scatter to scatter, device span to device span, "
                  f"this design is {FIRST_SCATTER_MS / span_ms:.2f}x faster a call")
        del coords, g, grad_ncdhw, volume_ncdhw, grid, buf
        torch.cuda.empty_cache()
    del volumes
    torch.cuda.empty_cache()
    fwd = dict(name="trilinear_fwd", route="cuda",
               source="conditioned_nerf_gan_torch/csrc/trilinear_fwd.cu",
               replaces="scripts/bench_pallas_gather.py:42", launches=0, max_abs_err=worst,
               **shape_row(fwd_rows, "training chunk"))
    bwd = dict(name="trilinear_bwd", route="cuda",
               source="conditioned_nerf_gan_torch/csrc/trilinear_bwd.cu",
               replaces="conditioned_nerf_gan_tpu/ops/grid_sample.py:128 (_expanded_bwd, the "
                        "custom VJP of _border_trilerp; XLA, no pl.pallas_call)",
               launches=0, max_abs_err=worst_bwd, **shape_row(bwd_rows, "training chunk"))
    return fwd, bwd


def make_voxel_requests(meta: dict, n: int, seed: int):
    """n requests of BATCH voxel grids (seeded `make_pcl` clouds voxelised
    at 64^3, in the U-Net's NDHWC layout: the bench's `make_voxel_grids`)
    with cameras."""
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        sample_camera_positions,
    )
    from conditioned_nerf_gan_torch.training.bench_setup import make_voxel_grids

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    requests = []
    for _ in range(n):
        voxel = make_voxel_grids(rng, BATCH, VOXEL_RES)
        origins = sample_camera_positions(BATCH, generator=gen,
                                          cam_r_start=meta["cam_r_start"],
                                          cam_r_end=meta["cam_r_end"])
        requests.append(({"voxel": voxel}, create_cam2world_matrix(origins).numpy()))
    return requests


def phase7_dg_serve(device, build_dir, failures: list):
    """Serve REQUESTS requests of the dg preset through the port's
    Inferencer; returns the two kernels' launches in the main path's run,
    the Inferencer, and the last request with its seconds."""
    from conditioned_nerf_gan_torch.infer import (
        Inferencer,
        build_models,
        load_metadata,
        save_checkpoint,
    )
    from conditioned_nerf_gan_torch.ops.grid_sample import trilinear_point_features
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import film_siren_mlp

    meta = load_metadata(DG_STEP, config="dg")
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        G, E = build_models(meta, generator=torch.Generator().manual_seed(0))
        ckpt = save_checkpoint(f"{tmp}/run/checkpoints/{DG_STEP}.pt", DG_STEP, G, E,
                               config="dg")
        inf = Inferencer(ckpt, num_imgs=BATCH, image_size=IMAGE_SIZE,
                         input_voxel_resolution=VOXEL_RES, load_dataset=False, seed=0,
                         device=device)
    cur = inf.curriculum
    chunks = cur.get("ray_chunks", 0)
    print(f"phase 7: dg preset, step {DG_STEP}: {cur['unet']} -> "
          f"{cur['generator']}, {IMAGE_SIZE}^2, {cur['num_steps']}+{cur['num_steps']} "
          f"samples, ray_chunks {chunks}, white_back {cur['white_back']}, fov "
          f"{cur['fov']}")
    precision_line("phase 7", dict(UNet3D=inf.encoder))
    requests = make_voxel_requests(cur, REQUESTS, seed=0)
    occupancy = [float(c["voxel"][..., 0].mean()) for c, _ in requests]
    print(f"phase 7: {REQUESTS} requests of {BATCH} grids {VOXEL_RES}^3 x 4 "
          f"(occupied share {min(occupancy):.4f}-{max(occupancy):.4f})")

    expected = 2 * max(chunks, 1)  # coarse + fine per ray chunk
    torch.cuda.reset_peak_memory_stats()
    outputs = []
    film_siren_mlp.launches = trilinear_point_features.launches = 0
    for i, (cond, cams) in enumerate(requests):
        before = film_siren_mlp.launches, trilinear_point_features.launches
        t_enc, t_render, z, rgb, depth = serve(inf, cond, cams)
        k1 = film_siren_mlp.launches - before[0]
        tri = trilinear_point_features.launches - before[1]
        dt = t_enc + t_render
        print(f"phase 7 request {i}: {dt:.4f} s (encode {t_enc * 1e3:.3f} ms, "
              f"render {t_render * 1e3:.3f} ms), "
              f"{BATCH * IMAGE_SIZE * IMAGE_SIZE / dt:.1f} rays/s, launches K1 {k1} "
              f"and trilinear {tri} (design {expected} each), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if (k1, tri) != (expected, expected):
            failures.append(f"phase 7 request {i}: launches K1 {k1}, trilinear {tri}, "
                            f"design {expected} each")
        outputs.append((z, cams, rgb, depth))
    launches = film_siren_mlp.launches, trilinear_point_features.launches

    for z, cams, rgb, depth in outputs:
        if rgb.shape != (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) or depth.shape != (
                BATCH, IMAGE_SIZE, IMAGE_SIZE):
            failures.append(f"phase 7: output shapes {rgb.shape}, {depth.shape}")
        elif not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
            failures.append("phase 7: non-finite render output")
        elif rgb.min() < -1 - 1e-5 or rgb.max() > 1 + 1e-5:
            failures.append(f"phase 7: pixels outside [-1, 1]: {rgb.min()}, {rgb.max()}")
    volume, global_feature = outputs[0][0]
    print(f"phase 7: feature volume {tuple(volume.shape)} contiguous "
          f"{volume.is_contiguous()}, |volume| max {volume.abs().max().item():.4f}, "
          f"global {tuple(global_feature.shape)}; pixels in "
          f"[{min(o[2].min() for o in outputs):.4f}, {max(o[2].max() for o in outputs):.4f}]"
          f" (std {np.std([o[2] for o in outputs]):.4f}), depth in "
          f"[{min(o[3].min() for o in outputs):.4f}, {max(o[3].max() for o in outputs):.4f}]")

    # the same first render with both plain versions in the kernels' places
    z, cams, rgb, depth = outputs[0]
    with PlainVersions():
        rgb_plain, depth_plain = inf.render_batched(z, cams, z_batched=True)
    diff = np.abs(rgb - rgb_plain).max(axis=-1)
    over = float((diff > RENDER_TOL).mean())
    print(f"phase 7: render vs plain render: mean|pixel| {diff.mean():.3e} "
          f"(bound {RENDER_MEAN_TOL}), share of pixels off by > {RENDER_TOL}: "
          f"{over:.3e} (bound {RENDER_OVER_SHARE}), max|pixel| {diff.max():.3e}, "
          f"max|depth| {np.abs(depth - depth_plain).max():.3e}")
    if diff.mean() > RENDER_MEAN_TOL or over > RENDER_OVER_SHARE:
        failures.append("phase 7: kernel render disagrees with the plain render")
    return launches, inf, requests[-1], dt


def phase9_dg_train(device, failures: list) -> dict:
    """The voxel family's stage-2 train step at full width; returns the four
    kernels' launches per step in the main path's run (warm-up and timed
    steps; the comparison and profiled steps after it are not counted)."""
    from conditioned_nerf_gan_torch.training import (
        build_stage_bench,
        create_train_state,
        make_train_step,
    )

    counters = kernel_counters()
    t0 = time.perf_counter()
    bench = build_stage_bench("dg", stage=2, step=DG_TRAIN_STEP)
    cfg, meta = bench.config, bench.meta
    nets = dict(G=bench.generator, E=bench.encoder)
    for net in nets.values():
        net.to(device)
    state = create_train_state(nets["G"], nets["E"], None, cfg)
    train_step = make_train_step(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in bench.batch.items()}
    rng = torch.Generator(device=device).manual_seed(0)
    r = cfg.render
    chunks = max(r.ray_chunks, 1)
    evals = 2 if r.hierarchical_sample else 1
    calls = evals * chunks  # SIREN calls (each a trilinear lookup first) per render
    # per step: the G render (with grad) and its per-chunk recompute in the
    # backward, plus the D step's render when D is on; one backward of each
    # kernel per call of the G render
    renders = 2 + (1 if cfg.enable_discriminator else 0)
    design = (renders * calls, calls, renders * calls, calls)
    print(f"phase 9: dg preset, step {DG_TRAIN_STEP}: batch {meta['batch_size']}, "
          f"{meta['unet']['type']} f_maps {meta['unet']['f_maps']} x "
          f"{meta['unet']['num_levels']} levels on {tuple(batch['voxel'].shape)}, "
          f"{meta['generator']['siren_type']}, {r.img_size}^2, {r.num_steps}+{r.num_steps} "
          f"samples, ray_chunks {r.ray_chunks}, discriminator {cfg.enable_discriminator}, "
          f"grad_accum_scale {cfg.grad_accum_scale}; design launches per step K1 {design[0]}, "
          f"K2 {design[1]}, trilinear {design[2]}, trilinear backward {design[3]}; set-up "
          f"{time.perf_counter() - t0:.2f} s")
    precision_line("phase 9", dict(UNet3D=nets["E"]))
    before = {name: [p.detach().clone() for p in net.parameters()]
              for name, net in nets.items()}

    torch.cuda.reset_peak_memory_stats()
    take_counts(counters)
    step_s, totals = [], [0, 0, 0, 0]
    for i in range(1 + TRAIN_TIMED_STEPS):
        probe = PolicyProbe(nets["E"]) if i == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, rng, bench.alpha, bench.nerf_noise)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if probe is not None:
            probe.check("phase 9", failures)
        counts = take_counts(counters)
        totals = [t + c for t, c in zip(totals, counts)]
        losses = {k: float(v) for k, v in metrics.items()}
        print(f"phase 9 step {i}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.4f} s, launches "
              f"K1 {counts[0]}, K2 {counts[1]}, trilinear {counts[2]}, trilinear backward "
              f"{counts[3]} (design {design}), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              + ", ".join(f"{k} {v:.6f}" for k, v in losses.items()))
        if counts != design:
            failures.append(f"phase 9 step {i}: launches {counts}, design {design}")
        if not all(np.isfinite(v) for v in losses.values()):
            failures.append(f"phase 9 step {i}: non-finite losses {losses}")
    timed = step_s[1:]
    print(f"phase 9: {np.mean(timed):.4f} s/step (steps {', '.join(f'{t:.4f}' for t in timed)}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, net in nets.items():
        moved = max((p.detach() - q).abs().max().item()
                    for p, q in zip(net.parameters(), before[name]))
        print(f"phase 9: {name} params moved by up to {moved:.3e}")
        if not moved > 0:
            failures.append(f"phase 9: {name} did not move")
    del before

    # one more step with the kernels, and the same step (state, batch, random
    # numbers) with the plain versions in all four kernels' places
    step_against_plain(
        "phase 9", state, train_step, batch, rng, bench.alpha, bench.nerf_noise,
        PLAIN_KERNELS, DG_STEP_LOSS_TOL, DG_STEP_GRAD_TOL, failures)
    take_counts(counters)

    # one profiled step: device busy share against the timed steps' mean
    profiled = profile_device(
        lambda: train_step(state, batch, rng, bench.alpha, bench.nerf_noise))
    take_counts(counters)
    scatter_ms = float("nan")
    if profiled is None:
        print("phase 9: the profiler recorded no device activity; busy share not measured")
    else:
        n_events, busy_ms, by_name = profiled
        mean_ms = np.mean(timed) * 1e3
        print(f"phase 9: profiled step: {n_events} device activities, device busy "
              f"{busy_ms:.3f} ms; busy share {busy_ms / mean_ms:.4f} of the timed steps' mean "
              f"{mean_ms:.3f} ms (idle {1 - busy_ms / mean_ms:.4f})")
        print_top("phase 9", by_name, n=16)
        scatters = [(us, n) for name, (us, n) in by_name.items()
                    if "trilinear_bwd_presum_kernel" in name]
        scatter_ms = sum(us for us, _ in scatters) / 1e3
        if sum(n for _, n in scatters) != design[3]:
            failures.append(f"phase 9: the profiled step ran {scatters} dV scatters, design "
                            f"{design[3]}")

    # the ops of one more step that take a full-size dV: its render zeroes one
    # buffer (the G step's renders with grad: one a batch split) and sums none
    dv_shape = (*batch["voxel"].shape[:4], meta["unet"]["out_channels"])
    on_dv = ops_on_shapes(lambda: train_step(state, batch, rng, bench.alpha, bench.nerf_noise),
                          [dv_shape])[0]
    take_counts(counters)
    zeroings = on_dv.get("aten::zero_", 0)
    sums = {name: n for name, n in on_dv.items() if "add" in name}
    print(f"phase 9: ops of one step on a tensor of dV's shape {dv_shape}: {on_dv}; "
          f"zeroings {zeroings} (design {cfg.batch_split}: one a render with grad), sums {sums} "
          "(design none)")
    if zeroings != cfg.batch_split or sums:
        failures.append(f"phase 9: {zeroings} dV zeroings and sums {sums} a step, design "
                        f"{cfg.batch_split} and none")
    del state, batch, nets, bench
    torch.cuda.empty_cache()
    fp32_bench_step("phase 9", "dg", DG_TRAIN_STEP, device, failures)
    take_counts(counters)

    # the step's dV path: one zeroing a render with grad and the lookups'
    # scatters into it (the profiled step's kernel time), no sums
    zero_ms = cuda_ms(lambda: torch.zeros(dv_shape, device=device), iters=10)
    dv_mb = float(np.prod(dv_shape)) * 4 / 1e6
    print(f"phase 9: the step's dV path: {cfg.batch_split} zeroing of one dV {dv_shape} "
          f"({dv_mb:.1f} MB) {zero_ms:.4f} ms, {design[3]} scatters {scatter_ms:.4f} ms "
          f"(profiled step; {scatter_ms / design[3]:.4f} ms a call), no sums: "
          f"{cfg.batch_split * zero_ms + scatter_ms:.4f} ms a step (the first design, a dV a "
          f"chunk: 32 scatters of 0.1941 ms, 32 zeroings and 31 sums 17.122 ms, ~23.3 ms a "
          f"step; PERF.md)")
    torch.cuda.empty_cache()
    return dict(zip(("k1", "k2", "trilinear", "trilinear_bwd"), totals))


def check_study(kernel: str, mode: str, tiles: list[int], label: str, inp: dict,
                failures: list) -> float:
    """Hold one study kernel in one mode, at each of its tiles (points per
    CTA), against `film_study_reference` in phase 1's style (freq/30 max; at
    freq 25-45 mean, p99.9 and distance to fp64 sums against the plain
    version's), each relative to max(1, max|plain|); returns the largest
    max|kernel - plain| at freq 25-45."""
    from conditioned_nerf_gan_torch.ops.kernels.film_study import (
        film_siren_study,
        film_study_reference,
    )

    low_inp = dict(inp, freq=inp["freq"] / 30.0)
    plain = film_study_reference(*inp.values(), kernel=kernel, mode=mode)
    exact = film_study_reference(*inp.values(), kernel=kernel, mode=mode,
                                 accum_dtype=torch.float64)
    plain_low = film_study_reference(*low_inp.values(), kernel=kernel, mode=mode)
    scale = max(1.0, plain.abs().max().item())
    p64 = (plain - exact).abs().max().item()
    floor = BWD_ULPS * exact.abs().max().item()
    B, N, _ = inp["points"].shape
    worst = 0.0
    for tile in tiles:
        out = film_siren_study(*inp.values(), kernel=kernel, mode=mode, tile=tile)
        out_low = film_siren_study(*low_inp.values(), kernel=kernel, mode=mode, tile=tile)
        err = (out - plain).abs().flatten()
        worst = max(worst, err.max().item())
        mean = err.mean().item() / scale
        q999 = torch.quantile(err[:16_000_000], 0.999).item() / scale
        k64 = (out - exact).abs().max().item()
        low = ((out_low - plain_low).abs().max()
               / max(1.0, plain_low.abs().max().item())).item()
        print(f"phase 8 [{kernel} {mode} T={tile}, {label}] B={B} N={N}: max|plain| "
              f"{plain.abs().max().item():.3e}; relative to max(1, max|plain|): freq/30 "
              f"max {low:.3e} (bound {STUDY_LOW_TOL}); freq 25-45 mean {mean:.3e} (bound "
              f"{STUDY_MEAN_TOL}), p99.9 {q999:.3e} (bound {STUDY_Q999_TOL}); max|kernel "
              f"- fp64-sum| {k64:.3e} vs max|plain - fp64-sum| {p64:.3e} (ratio "
              f"{k64 / max(p64, 1e-30):.3f}, bound {STUDY_VS_PLAIN} + {floor:.1e})")
        if not (torch.isfinite(out).all() and low < STUDY_LOW_TOL and mean < STUDY_MEAN_TOL
                and q999 < STUDY_Q999_TOL and k64 <= STUDY_VS_PLAIN * p64 + floor):
            failures.append(f"phase 8 [{kernel} {mode} T={tile}, {label}]: kernel "
                            "disagrees with its plain version")
        del out, out_low, err
    return worst


def phase8_study(device, failures: list, k1_ms: float) -> tuple[list, dict]:
    """The kernel study: every instance the study tool launches (and every
    mode at T 128) checked at the study shape and a ragged N, each mode timed
    at T 128 beside its bound, K1's phase-1 time `k1_ms` at the study shape
    and its first design's time, the split of K1's time (K3 nosin and nodot
    against single; K4 v5 against v4 sin7), then the study tool's variants
    through its own function; returns the JSON rows of K3, K4 v4 and K4 v5
    and the launches of every kernel counter in the tool's run."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_bwd,
    )
    from conditioned_nerf_gan_torch.ops.kernels.film_study import (
        STUDY_MODES,
        film_siren_study,
        film_study_reference,
    )
    from conditioned_nerf_gan_torch.tools import bench_film_kernel as study

    sources = dict(v3=("film_siren_study_v3", "scripts/bench_film_kernel.py:75"),
                   v4=("film_siren_study_v4", "scripts/bench_film_kernel.py:135"),
                   v5=("film_siren_study_v5", "scripts/bench_film_kernel.py:164"))
    tiles: dict[tuple[str, str], list[int]] = {}
    for kernel, mode, tile in study.kernel_instances():
        tiles.setdefault((kernel, mode), []).append(tile)
    rows = []
    with torch.no_grad():
        for kernel, modes in STUDY_MODES.items():
            worst, timed = 0.0, {}
            for mode, (act0, act, dot) in modes.items():
                for label, N in (("study", IMAGE_SIZE * IMAGE_SIZE * 48), ("ragged", 1000)):
                    inp = kernel_inputs(2, N, seed=0, device=device)
                    worst = max(worst, check_study(kernel, mode, tiles[(kernel, mode)],
                                                   label, inp, failures))
                    if label == "study":
                        ms = cuda_ms(lambda: film_siren_study(
                            *inp.values(), kernel=kernel, mode=mode, tile=STUDY_TILE), 20)
                        plain_ms = cuda_ms(lambda: film_study_reference(
                            *inp.values(), kernel=kernel, mode=mode), 4)
                        bound_ms, bound_by = film_bound(2, N, 4, 3, act0, act, dot)
                        timed[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                           bound_by=bound_by)
                        print(f"phase 8 [{kernel} {mode}] time at 2 x {N}, T={STUDY_TILE}: "
                              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                              f"{bound_ms:.4f} ms ({bound_by}; kernel at "
                              f"{bound_ms / ms:.3f} of it), K1 {k1_ms:.4f} ms (phase 1; "
                              f"kernel / K1 {ms / k1_ms:.3f}), first design "
                              f"{EARLIER_STUDY_MS[(kernel, mode)]:.4f} ms")
                    del inp
                    torch.cuda.empty_cache()
            name, replaces = sources[kernel]
            first = timed[next(iter(modes))]
            rows.append(dict(name=name, route="cuda",
                             source="conditioned_nerf_gan_torch/csrc/film_siren_study.cu",
                             replaces=replaces, launches=0, max_abs_err=worst,
                             ms=first["ms"], plain_ms=first["plain_ms"],
                             bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                             library_ms=None, mode=next(iter(modes)), modes=timed))

    ms = {(r["name"][-2:], mode): t["ms"] for r in rows for mode, t in r["modes"].items()}
    single, sin7 = ms[("v3", "single")], ms[("v4", "sin7")]
    print(f"phase 8: the split of K1's time at 2 x {IMAGE_SIZE * IMAGE_SIZE * 48}, T "
          f"{STUDY_TILE}, the same run: K1 {k1_ms:.4f} ms (phase 1), K3 single (K1 with "
          f"fast_sin) {single:.4f} ms (K3 single / K1 {single / k1_ms:.3f}); K3 nosin / "
          f"single {ms[('v3', 'nosin')] / single:.3f} (the products and the weight stream), "
          f"K3 nodot / single {ms[('v3', 'nodot')] / single:.3f} (the sins), overlap "
          f"(nosin + nodot - single) / single "
          f"{(ms[('v3', 'nosin')] + ms[('v3', 'nodot')] - single) / single:.3f}; K4 v5 / v4 "
          f"sin7 {ms[('v5', 'interleave')] / sin7:.3f} (ping-pong against cooperative), v4 "
          f"sin7 / K1 {sin7 / k1_ms:.3f} (K1's function feature-major)")

    # the main path: the study tool's variants, through its own function
    names = (list(study.DEFAULT_VARIANTS) + list(study.SWEEPS)
             + ["jnpsin", "v4_nosin", "v4_nodot", "v4_sin7", "vjp_kernel"])
    print("phase 8: " + study.header("cuda"))
    for kernel in film_siren_study.launches:
        film_siren_study.launches[kernel] = 0
    film_siren_mlp.launches = film_siren_mlp_bwd.launches = 0
    t0 = time.perf_counter()
    study.run_study(names, "cuda")
    launches = dict(film_siren_study.launches, k1=film_siren_mlp.launches,
                    k2=film_siren_mlp_bwd.launches)
    print(f"phase 8: {len(names)} variants in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    for kernel in STUDY_MODES:
        if not launches[kernel]:
            failures.append(f"phase 8: the study launched no {kernel} kernel")
    torch.cuda.empty_cache()
    return rows, launches


def design_launches(cfg, levels: int = 1, film: bool = True) -> tuple[int, int, int, int]:
    """Launches per train step of K1, K2, the trilinear kernel and its
    backward, from a TrainStepConfig: each render makes `calls` SIREN calls
    (coarse and fine per ray chunk; each reads the feature volume first in
    the voxel family, `levels` lookups where it is a pyramid). The D step
    renders once without grad; each of the G step's batch splits renders
    with grad, and a chunked render recomputes every chunk in the backward
    (checkpoint); one backward a G-render call. A SIREN off the fused
    kernels (`film` False: SIREN and residual layers) launches no K1/K2."""
    r = cfg.render
    chunks = max(r.ray_chunks, 1)
    calls = chunks * (2 if r.hierarchical_sample else 1)
    g_forward = calls * (2 if chunks > 1 else 1)
    k1 = (calls if cfg.enable_discriminator else 0) + cfg.batch_split * g_forward
    k2 = cfg.batch_split * calls
    voxel = cfg.load_voxel and not cfg.load_pcl
    tri = (k1 * levels, k2 * levels) if voxel else (0, 0)
    return (k1, k2, *tri) if film else (0, 0, *tri)


def voxel_design(meta: dict) -> tuple[int, bool]:
    """(feature lookups a SIREN call makes, whether the SIREN runs on K1 and
    K2) of a curriculum's metadata: a PyramidUNet3D's levels are its
    num_levels - 1 decoder outputs (TALLSIREN's one lookup feeds its
    mapping); the kernel gate takes an all-FiLM stack of 2 or more layers
    with freq per batch element under the bf16 + fast_sin policy."""
    from conditioned_nerf_gan_torch.config.presets import resolve_siren_alias
    from conditioned_nerf_gan_torch.models.siren import SIREN_SPECS

    spec = SIREN_SPECS[resolve_siren_alias(meta["generator"]["siren_type"])]
    unet = meta.get("unet") or {}
    levels = unet.get("num_levels", 4) - 1 if unet.get("type") == "PyramidUNet3D" else 1
    film = (all(k == "film" for k in spec.layers) and len(spec.layers) >= 2
            and spec.mapping != "pointfeat"  # freq per point (TALLSIREN): the gate's ndim 2
            and bool(meta.get("use_pallas")) and bool(meta.get("use_fast_sin"))
            and meta.get("compute_dtype") == "bfloat16")
    return levels, film


def compressed_curriculum(config: str | None, steps_per_stage: int, dataset: Path) -> dict:
    """The preset's curriculum with its milestones at 0, steps_per_stage,
    2 x steps_per_stage, ... and every per-stage key its own (as
    scripts/regression_curriculum.py compresses it), reading `dataset`."""
    from conditioned_nerf_gan_torch.config import load_curriculum

    cur = load_curriculum(config_base="thousand", config=config)
    stages = sorted(k for k in cur if isinstance(k, int))
    cur.update({i * steps_per_stage: cur.pop(k) for i, k in enumerate(stages)})
    cur["dataset"]["path"] = str(dataset)
    return cur


class TrainerProbe:
    """Records each Trainer train step: its step, stage image size, loader
    position, synchronised seconds, peak memory (reset before the step) and
    the launches of each kernel counter in it, with the design's count for
    the stage; and the Trainer objects a run builds."""

    def __init__(self, counters, design=design_launches):
        from conditioned_nerf_gan_torch.training import trainer as trainer_module

        self.module, self.counters, self.design = trainer_module, counters, design
        self.steps: list[dict] = []
        self.trainers: list = []

    def __enter__(self):
        Trainer = self.module.Trainer
        self._saved = (Trainer.train_step, Trainer.load_models)
        train_step, load_models = self._saved
        probe = self

        def probed_step(trainer, batch):
            before = [c.launches for c in probe.counters]
            position = (trainer._loader_epoch, trainer._batch_offset)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_step(trainer, batch)
            torch.cuda.synchronize()
            probe.steps.append(dict(
                step=trainer.step, img=trainer.metadata["img_size"], position=position,
                s=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=tuple(c.launches - b for c, b in zip(probe.counters, before)),
                design=probe.design(trainer.step_config)))

        def probed_load(trainer):
            probe.trainers.append(trainer)
            return load_models(trainer)

        Trainer.train_step, Trainer.load_models = probed_step, probed_load
        return self

    def __exit__(self, *exc):
        self.module.Trainer.train_step, self.module.Trainer.load_models = self._saved
        return False


def print_stages(label: str, steps: list[dict], milestones: list[int], failures: list,
                 names=("K1", "K2")) -> list[dict]:
    """Per stage: s/step (the stage's first step, and the mean of the
    rest), peak memory, launches per step against the design; every step's
    launches must equal the design's."""
    rows = []
    for i, start in enumerate(milestones):
        end = milestones[i + 1] if i + 1 < len(milestones) else 1 << 30
        stage = [s for s in steps if start <= s["step"] < end]
        if not stage:
            continue
        rest = [s["s"] for s in stage[1:]] or [stage[0]["s"]]
        launches = stage[-1]["launches"][:len(names)]
        row = dict(stage=i, img=stage[0]["img"], steps=len(stage), first_s=stage[0]["s"],
                   s_per_step=float(np.mean(rest)), peak_gib=max(s["peak"] for s in stage),
                   launches=dict(zip(names, launches)))
        rows.append(row)
        print(f"{label} stage {i} (steps {stage[0]['step']}-{stage[-1]['step']}, "
              f"{row['img']}^2): {row['s_per_step']:.4f} s/step (mean of steps after the "
              f"first; first {row['first_s']:.4f} s), peak {row['peak_gib']:.3f} GiB, "
              "launches per step " + ", ".join(
                  f"{n} {c}" for n, c in zip(names, launches))
              + " (design " + ", ".join(
                  f"{n} {c}" for n, c in zip(names, stage[-1]["design"])) + ")")
        for s in stage:
            if s["launches"][:len(names)] != s["design"][:len(names)]:
                failures.append(f"{label} step {s['step']}: launches {s['launches']}, "
                                f"design {s['design']}")
    return rows


def phase10_trainer(device, work: Path, failures: list) -> dict:
    """The train CLI on the card: the port's fixture written on the card,
    the thesis preset through all four curriculum stages (compressed to
    THESIS_STAGE_STEPS steps a stage), a resume from its step-5 checkpoint,
    the dg preset across its first milestone, and one image grid through
    the infer CLI from a trainer checkpoint, all under `work` (phase 12
    reads the runs). Returns the kernels' launches of each run (the
    counters set to 0 just before it) and the thesis and dg run dirs."""
    from conditioned_nerf_gan_torch import train
    from conditioned_nerf_gan_torch.config import curriculum_to_json
    from conditioned_nerf_gan_torch.data.synthetic import make_synthetic_shapenet
    from conditioned_nerf_gan_torch.infer.__main__ import main as infer_main
    from conditioned_nerf_gan_torch.utils.png import read_png

    counters = kernel_counters()

    print("phase 10: precision: the presets' policy (compute_dtype bfloat16): PointNet, "
          "D and the U-Net's block convs in bf16 with fp32 params, GroupNorm and the "
          "U-Net's final conv fp32, the SIRENs through K1 and K2 (bf16 products, fp32 "
          "sums, sin7); TF32 off for fp32 products (this script's comparator setting, for "
          "the whole process; the trainer itself leaves TF32 at PyTorch's default), "
          "matmul.allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    tmp = work / "phase10"
    tmp.mkdir()
    t0 = time.perf_counter()
    ds_root = make_synthetic_shapenet(tmp / "data", **TRAINER_FIXTURE, device=device)
    print(f"phase 10: fixture {TRAINER_FIXTURE} written on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # the thesis preset through its four stages
    sps = THESIS_STAGE_STEPS
    run1 = tmp / "thesis"
    run1.mkdir()
    cur = compressed_curriculum(None, sps, ds_root)
    curriculum_to_json(cur, run1 / "curriculum.json")
    milestones = sorted(k for k in cur if isinstance(k, int))
    flags = ["-p", str(sps), "-s", str(2 * sps), "-e", str(2 * sps), "--device", str(device)]
    take_counts(counters)
    t0 = time.perf_counter()
    with TrainerProbe(counters) as probe:
        rc = train.main(["-o", str(run1), "--stop_step", str(THESIS_STOP), *flags])
    thesis_counts = take_counts(counters)
    print(f"phase 10: thesis run, milestones {milestones}, stop_step {THESIS_STOP}: "
          f"rc {rc} in {time.perf_counter() - t0:.2f} s; launches over the run (the "
          f"steps, sample grids and val losses) K1 {thesis_counts[0]}, K2 "
          f"{thesis_counts[1]}")
    if rc != 0:
        failures.append(f"phase 10: the thesis run returned {rc}")
    stages = print_stages("phase 10 thesis", probe.steps, milestones, failures)
    first = probe.trainers[0]
    sizes = [s["img"] for s in stages]
    if sizes != [32, 64, 128, 128]:
        failures.append(f"phase 10: the thesis run's stages ran at {sizes}, not "
                        "32, 64, 128, 128")
    if [s["step"] for s in probe.steps] != list(range(THESIS_STOP + 1)):
        failures.append(f"phase 10: the thesis run took steps "
                        f"{[s['step'] for s in probe.steps]}")
    saves = sorted(int(p.stem) for p in (run1 / "checkpoints").glob("*.pt"))
    layout = {name: (run1 / name).exists() for name in (
        "curriculum.json", "train_spec.txt", "logs", "evaluation",
        "samples/trainview", "samples/valview", "samples/testview")}
    grids = sorted(p.name for p in (run1 / "samples" / "valview").glob("*.png"))
    val = first.histories["photometry_losses_val"]
    print(f"phase 10: output dir {layout}; checkpoints {saves}; valview grids {grids}; "
          f"val losses {val}; histories: {len(first.histories['photometry_losses'])} "
          "photo, "
          f"{len(first.histories['generator_losses'])} G, "
          f"{len(first.histories['discriminator_losses'])} D")
    if not all(layout.values()) or len(saves) < 2 or not grids or not val:
        failures.append("phase 10: the thesis run's output dir lacks a part")
    losses = [v for k in ("photometry_losses", "generator_losses", "discriminator_losses")
              for v in first.histories[k]]
    if len(losses) != 3 * (THESIS_STOP + 1) or not np.all(np.isfinite(losses)):
        failures.append("phase 10: the thesis run's losses are missing or not finite")
    ref = {s["step"]: s for s in probe.steps}
    ref_hist = {k: list(first.histories[k]) for k in (
        "photometry_losses", "generator_losses", "discriminator_losses")}
    del first, probe
    torch.cuda.empty_cache()

    # a resume from the step-5 checkpoint to step 8
    run2 = tmp / "resumed"
    take_counts(counters)
    with TrainerProbe(counters) as probe:
        rc = train.main(["-o", str(run2), "-l", str(run1 / "checkpoints" / "5.pt"),
                         "--stop_step", "8", *flags])
    resume_counts = take_counts(counters)
    resumed = probe.trainers[0]
    worst = 0.0
    for s in probe.steps:
        r = ref[s["step"]]
        same = (s["position"], s["img"]) == (r["position"], r["img"])
        print(f"phase 10 resume step {s['step']}: loader {s['position']} (uninterrupted "
              f"{r['position']}), image size {s['img']} ({r['img']})")
        if not same:
            failures.append(f"phase 10: the resumed run's step {s['step']} is not the "
                            "uninterrupted run's")
    for k, values in ref_hist.items():
        got = resumed.histories[k]
        for step in range(6, 9):
            rel = abs(got[step] - values[step]) / max(abs(values[step]), 1e-30)
            worst = max(worst, rel)
            print(f"phase 10 resume {k}[{step}]: {got[step]:.7f} uninterrupted "
                  f"{values[step]:.7f} (rel {rel:.3e})")
    print(f"phase 10: resumed run rc {rc}, steps {[s['step'] for s in probe.steps]}; "
          f"largest relative loss difference {worst:.3e} (bound {RESUME_LOSS_TOL})")
    if (rc != 0 or [s["step"] for s in probe.steps] != [6, 7, 8]
            or not worst <= RESUME_LOSS_TOL):
        failures.append(f"phase 10: the resumed run does not replay the uninterrupted "
                        f"one (rc {rc}, largest loss difference {worst:.3e})")
    del resumed, probe
    torch.cuda.empty_cache()

    # the dg preset across its first milestone
    run3 = tmp / "dg"
    run3.mkdir()
    cur = compressed_curriculum("dg", DG_STAGE_STEPS, ds_root)
    curriculum_to_json(cur, run3 / "curriculum.json")
    dg_milestones = sorted(k for k in cur if isinstance(k, int))
    take_counts(counters)
    t0 = time.perf_counter()
    with TrainerProbe(counters) as probe:
        rc = train.main(["-o", str(run3), "--stop_step", str(2 * DG_STAGE_STEPS - 1),
                         "-p", str(DG_STAGE_STEPS), "-s", "1000", "-e", "1000",
                         "--device", str(device)])
    dg_counts = take_counts(counters)
    print(f"phase 10: dg run, milestones {dg_milestones[:2]}, rc {rc} in "
          f"{time.perf_counter() - t0:.2f} s; launches over the run K1 {dg_counts[0]}, "
          f"K2 {dg_counts[1]}, trilinear {dg_counts[2]}, trilinear backward "
          f"{dg_counts[3]}")
    dg_stages = print_stages("phase 10 dg", probe.steps, dg_milestones, failures,
                             names=("K1", "K2", "trilinear", "trilinear backward"))
    if rc != 0 or [s["img"] for s in dg_stages] != [32, 64]:
        failures.append(f"phase 10: the dg run (rc {rc}) ran stages "
                        f"{[s['img'] for s in dg_stages]}, not 32 and 64")
    del probe
    torch.cuda.empty_cache()

    # one image grid from a trainer checkpoint, through the infer CLI
    take_counts(counters)
    rc = infer_main([str(run1 / "checkpoints" / f"{THESIS_STOP}.pt"), "--images",
                     "--num_imgs", "4", "--device", str(device)])
    infer_counts = take_counts(counters)
    out = sorted((run1 / "inference").glob("*.png"))
    shape = read_png(out[0]).shape if out else None
    print(f"phase 10: infer CLI on checkpoint {THESIS_STOP}: rc {rc}, wrote "
          f"{[p.name for p in out]} of {shape}; K1 launches {infer_counts[0]}")
    if rc != 0 or shape != (4 * 128, 4 * 128, 3) or not infer_counts[0]:
        failures.append("phase 10: the infer CLI did not render the trainer checkpoint")
    torch.cuda.empty_cache()
    return dict(trainer=thesis_counts, resumed=resume_counts, dg_trainer=dg_counts,
                trainer_infer=infer_counts, stages=stages, dg_stages=dg_stages,
                thesis_run=run1, dg_run=run3, dataset=ds_root, thesis_losses=ref_hist)


EVAL_FIXTURE = dict(n_cars=6, n_views=12, img_size=128, n_points=65536,
                    voxel_resolutions=(64,))  # 12 views a car: oFID needs 10
EVAL_STEP = 3  # milestones at 0, 1, 2, 3: the eval runs at stage 3 (128^2, ray_chunks 16)
EVAL_CPU_VIEWS = 4  # views of the first val car recomputed on the CPU
# card against CPU, the same nets on the same PNGs: fp32 convs (TF32 off) in
# other orders and algorithms; bound on max|card - CPU| / max|CPU| of each
# feature set [3.17e-6, 768; 2.01e-6, 2048] and on the relative LPIPS
# difference [1.37e-7] (H100, PR 10)
EVAL_FEATURE_TOL = 1e-5
EVAL_LPIPS_TOL = 1e-6
# Newton-Schulz (50 iterations) in fp32, the dtype the oFID path
# (`compute_ofid_from_batch(exact=False)`) hands it, as the JAX package's
# does, on the card against scipy's sqrtm: a seeded well-conditioned 768^2
# covariance pair (eigenvalues of the product 0.09-14.3), relative trace
# difference [3.2e-7 on the CPU]. On the oFID covariances of random-weight
# features (singular: dead channels) the fp32 iteration diverges, in both
# packages: the exact=False path is unsupported there; those readings, fp32
# and fp64, are printed, not held
EVAL_NS_TOL = 1e-5


def phase11_eval(device, work: Path, failures: list) -> dict:
    """Trainer.evaluate on the card: a thesis run at full width on a fixture
    of EVAL_FIXTURE written on the card, the curriculum compressed to one
    step a stage, eval_freq EVAL_STEP + 1: at step EVAL_STEP the Trainer
    saves, renders the `fid` subset (every view of the val cars) at 128^2
    with 96 + 96 samples through K1 and scores FID, oFID, LPIPS and PSNR.
    The run stays under `work` (phase 12 reads it). Returns the K1 launches
    of the eval's render, its seconds and the run dir."""
    import os

    import conditioned_nerf_gan_torch.eval.fid_evaluation as fid_evaluation
    from conditioned_nerf_gan_torch import train
    from conditioned_nerf_gan_torch.config import curriculum_to_json
    from conditioned_nerf_gan_torch.data.synthetic import make_synthetic_shapenet
    from conditioned_nerf_gan_torch.eval.metrics import (
        _inception_features,
        compute_lpips_batch,
        newton_schulz_sqrt_trace,
        read_rgb,
    )
    from conditioned_nerf_gan_torch.eval.weights import RANDOM_INIT_STAMP_PREFIX
    from conditioned_nerf_gan_torch.models.generator import RenderConfig
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import film_siren_mlp
    from scipy import linalg

    seconds: dict[str, float] = {}
    launches: dict[str, int] = {}
    saved = {name: getattr(fid_evaluation, name) for name in (
        "setup_evaluation", "output_images", "compute_metrics_from_dirs")}

    def timed(name):
        def wrapper(*args, **kwargs):
            before = film_siren_mlp.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = film_siren_mlp.launches - before
            return out
        return wrapper

    env = os.environ.get("CNG_EVAL_IMAGES")
    tmp = work / "phase11"
    tmp.mkdir()
    t0 = time.perf_counter()
    ds_root = make_synthetic_shapenet(tmp / "data", **EVAL_FIXTURE, device=device)
    print(f"phase 11: fixture {EVAL_FIXTURE} written on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    run = tmp / "thesis"
    run.mkdir()
    cur = compressed_curriculum(None, 1, ds_root)
    curriculum_to_json(cur, run / "curriculum.json")
    os.environ["CNG_EVAL_IMAGES"] = str(tmp / "eval_images")
    for name in saved:
        setattr(fid_evaluation, name, timed(name))
    film_siren_mlp.launches = 0
    try:
        with TrainerProbe((film_siren_mlp,)) as probe:
            t0 = time.perf_counter()
            rc = train.main(["-o", str(run), "--stop_step", str(EVAL_STEP), "-p", "1000",
                             "-s", "1000", "-e", str(EVAL_STEP + 1),
                             "--device", str(device)])
            run_s = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(fid_evaluation, name, fn)
        if env is None:
            os.environ.pop("CNG_EVAL_IMAGES", None)
        else:
            os.environ["CNG_EVAL_IMAGES"] = env
    trainer = probe.trainers[0]
    precision_line("phase 11", dict(PointNet=trainer.state.encoder,
                                    D=trainer.state.discriminator))
    meta = trainer._eval_metadata(img_size=128, num_steps=96)
    render = RenderConfig.from_metadata(meta, perturb=False)
    n_views = len(trainer.fidset)
    batch = meta["fid"]["render_batch"]
    design = (-(-n_views // batch) * max(render.ray_chunks, 1)
              * (2 if render.hierarchical_sample else 1))
    print(f"phase 11: thesis run to step {EVAL_STEP} (rc {rc}) in {run_s:.2f} s; eval at "
          f"step {EVAL_STEP}: the fid subset {n_views} views at "
          f"{meta['fid']['target_size']}^2, {meta['num_steps']}+{meta['num_steps']} "
          f"samples, render batch {batch}, ray_chunks {render.ray_chunks}; seconds: "
          f"real-image setup {seconds.get('setup_evaluation', float('nan')):.3f}, render "
          f"{seconds.get('output_images', float('nan')):.3f}, metrics "
          f"{seconds.get('compute_metrics_from_dirs', float('nan')):.3f}; K1 launches in "
          f"the render {launches.get('output_images')} (design {design})")
    if rc != 0 or launches.get("output_images") != design:
        failures.append(f"phase 11: the run returned {rc}; K1 launches in the eval "
                        f"render {launches.get('output_images')}, design {design}")
    lines = (run / "fid.txt").read_text().splitlines() if (run / "fid.txt").exists() else []
    rows = [line.split() for line in lines if line.strip() and not line.startswith("#")]
    print(f"phase 11: fid.txt: {lines}")
    if (not lines or not lines[0].startswith(RANDOM_INIT_STAMP_PREFIX) or len(rows) != 1
            or len(rows[0]) != 5 or rows[0][0] != str(EVAL_STEP)
            or not all(np.isfinite(float(v)) for v in rows[0][1:])):
        failures.append("phase 11: fid.txt lacks its stamp or one line of four finite "
                        "metrics")

    # the card's nets against the same nets on the CPU, on the same PNGs
    car = sorted((run / "evaluation").glob("*.png"))[0].name.rsplit("_", 1)[0]
    real_dir = tmp / "eval_images" / ds_root.stem / f"{meta['fid']['subset']}_128"
    names = [f"{car}_{i:04}.png" for i in range(EVAL_FIXTURE["n_views"])]
    real = np.stack([read_rgb(real_dir / n) for n in names]).astype(np.float32) / 255
    gen = np.stack([read_rgb(run / "evaluation" / n) for n in names]).astype(np.float32) / 255
    card = _inception_features(np.concatenate([real, gen]), device)
    k = EVAL_CPU_VIEWS
    cpu = _inception_features(np.concatenate([real[:k], gen[:k]]), "cpu")
    for dim, c, h in ((768, card[0], cpu[0]), (2048, card[1], cpu[1])):
        c = np.concatenate([c[:k], c[len(names):len(names) + k]])
        err = float(np.abs(c - h).max() / np.abs(h).max())
        print(f"phase 11: Inception {dim} features of {2 * k} PNGs, card against CPU: "
              f"max|card - CPU| / max|CPU| {err:.3e} (bound {EVAL_FEATURE_TOL})")
        if not err <= EVAL_FEATURE_TOL:
            failures.append(f"phase 11: the card's Inception {dim} features differ from "
                            "the CPU's")
    l_card = compute_lpips_batch(real[:k], gen[:k], device)
    l_cpu = compute_lpips_batch(real[:k], gen[:k], "cpu")
    err = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"phase 11: LPIPS of {k} pairs, card {l_card:.7f} CPU {l_cpu:.7f} (rel "
          f"{err:.3e}, bound {EVAL_LPIPS_TOL})")
    if not err <= EVAL_LPIPS_TOL:
        failures.append("phase 11: the card's LPIPS differs from the CPU's")
    rng = np.random.default_rng(11)
    pair = []
    for _ in range(2):
        q, _ = np.linalg.qr(rng.normal(size=(768, 768)))
        mix = q * rng.uniform(0.5, 2.0, 768)
        x = rng.normal(size=(4096, 768)) @ mix.T
        pair.append(np.cov(x, rowvar=False))
    prod = pair[0] @ pair[1]
    exact = float(np.trace(linalg.sqrtm(prod)).real)
    ns32 = float(newton_schulz_sqrt_trace(torch.as_tensor(prod, dtype=torch.float32,
                                                          device=device)))
    err = abs(ns32 - exact) / abs(exact)
    print(f"phase 11: Newton-Schulz in fp32 on the card, a seeded 768^2 covariance pair: "
          f"{ns32:.7f}, scipy sqrtm {exact:.7f} (rel {err:.3e}, bound {EVAL_NS_TOL})")
    if not err <= EVAL_NS_TOL:
        failures.append("phase 11: the card's Newton-Schulz trace differs from scipy's")
    f_real = card[0][:len(names)].reshape(-1, 768).astype(np.float64)
    f_gen = card[0][len(names):].reshape(-1, 768).astype(np.float64)
    # random-weight features leave channels dead, so the covariances are
    # singular: the pair with frechet_distance's own fallback offset, 1e-6
    # on the diagonal
    offset = np.eye(768) * 1e-6
    prod = (np.cov(f_real, rowvar=False) + offset) @ (np.cov(f_gen, rowvar=False) + offset)
    exact = float(np.trace(linalg.sqrtm(prod)).real)
    readings = {str(dtype).replace("torch.", ""): float(newton_schulz_sqrt_trace(
        torch.as_tensor(prod, dtype=dtype, device=device)))
        for dtype in (torch.float32, torch.float64)}
    print(f"phase 11: Newton-Schulz on {car}'s oFID covariance pair (768^2, singular) on "
          f"the card, printed, not held (the exact=False oFID path is unsupported on "
          f"random-weight features): {readings}, scipy sqrtm {exact:.10f} (fp64 rel "
          f"{abs(readings['float64'] - exact) / abs(exact):.3e})")
    fid_history = trainer.histories["fid_history"]
    del trainer, probe
    torch.cuda.empty_cache()
    return dict(k1=launches.get("output_images", 0), seconds=seconds, fid_history=fid_history,
                run=run)


# Phase 12: the rest of inference through the infer CLI. The video at the
# JAX CLI's defaults (240 frames at 24 fps, blocks of 16), the point clouds
# from 20 views, the density voxel at 48^3 (the CLI's default) and 64^3
INFER_FRAMES = 240
INFER_FPS = 24
INFER_PCL_VIEWS = 20
INFER_VOXELS = (48, 64)
INFER_INTERPOLATE_N = 8  # Inferencer.interpolate_latent_codes' default
# the checkpoints of phase 10 render so little density that no depth lands
# inside (ray_start, ray_end), the point clouds come out empty and the images
# flat: the modes run on copies whose SIREN head has this much more sigma
# bias (every other weight the same), so what they check has structure
DENSE_SIGMA_BIAS = 3.0


class InferencerProbe:
    """Records the Inferencers the infer CLI builds, the seconds spent
    building them and rendering (`generate_img`, and `sample_sigma_grid`
    for the voxels; each call ends in a device sync), and the first
    `render_batched` call's arguments and rgb."""

    def __enter__(self):
        from conditioned_nerf_gan_torch.infer import inference

        self.module, self.cls = inference, inference.Inferencer
        self.saved = {name: getattr(self.cls, name)
                      for name in ("__init__", "generate_img", "render_batched")}
        self.saved_grid = inference.sample_sigma_grid
        self.built, self.seconds, self.first_render = [], {"build": 0.0, "render": 0.0}, None
        probe = self

        def timed(key, fn):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                probe.seconds[key] += time.perf_counter() - t0
                return out
            return wrapper

        init, render_batched = timed("build", self.saved["__init__"]), self.saved["render_batched"]

        def probed_init(inf, *args, **kwargs):
            init(inf, *args, **kwargs)
            probe.built.append(inf)

        def probed_render_batched(inf, z, cams, **kwargs):
            out = render_batched(inf, z, cams, **kwargs)
            if probe.first_render is None:
                probe.first_render = (z, np.asarray(cams), kwargs, out[0])
            return out

        self.cls.__init__ = probed_init
        self.cls.generate_img = timed("render", self.saved["generate_img"])
        self.cls.render_batched = probed_render_batched
        self.module.sample_sigma_grid = timed("render", self.saved_grid)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)
        self.module.sample_sigma_grid = self.saved_grid
        return False


class PlainVersions:
    """The generator's SIREN with both plain versions in the kernels'
    places: `film_siren_mlp_folded` for K1, `border_trilerp_reference` for
    K5 (phase 7's swap)."""

    def __enter__(self):
        import conditioned_nerf_gan_torch.models.siren as siren_module
        from conditioned_nerf_gan_torch.ops.grid_sample import border_trilerp_reference
        from conditioned_nerf_gan_torch.ops.kernels.film_siren import film_siren_mlp_folded

        self.module = siren_module
        self.saved = siren_module.film_siren_mlp, siren_module.trilinear_point_features
        siren_module.film_siren_mlp = film_siren_mlp_folded
        siren_module.trilinear_point_features = (
            lambda volume, coords, **_: border_trilerp_reference(volume, coords))
        return self

    def __exit__(self, *exc):
        self.module.film_siren_mlp, self.module.trilinear_point_features = self.saved
        return False


def render_launches(meta: dict, views: int, block: int) -> int:
    """K1 launches of `views` rendered `block` at a time: each block's
    render makes coarse and fine SIREN calls per ray chunk."""
    from conditioned_nerf_gan_torch.models.generator import RenderConfig

    r = RenderConfig.from_metadata(meta)
    return -(-views // block) * max(r.ray_chunks, 1) * (2 if r.hierarchical_sample else 1)


def read_obj_points(path: Path) -> np.ndarray:
    """(n, 6) xyz + rgb of an .obj of `v x y z r g b` lines."""
    rows = [line.split()[1:] for line in path.read_text().splitlines()]
    if not all(len(r) == 6 for r in rows):
        raise ValueError(f"{path}: not `v x y z r g b` lines")
    return np.asarray(rows, np.float64).reshape(-1, 6)


def check_mrc(path: Path, n: int) -> str | None:
    """None when the file reads back as an (n, n, n) finite mode-2 volume."""
    import struct

    from conditioned_nerf_gan_torch.infer.mrc import read_mrc

    raw = path.read_bytes()
    dims = struct.unpack_from("<3i", raw, 0)
    mode = struct.unpack_from("<i", raw, 12)[0]
    vol = read_mrc(path)
    if dims != (n, n, n) or mode != 2 or raw[208:212] != b"MAP " or not np.isfinite(vol).all():
        return f"dims {dims}, mode {mode}, stamp {raw[208:212]!r}, finite {np.isfinite(vol).all()}"
    return None


def dense_copy(run: Path, checkpoint: Path) -> Path:
    """A sibling run of `run` (its curriculum, so its dataset) holding
    `checkpoint` with DENSE_SIGMA_BIAS added to the SIREN head's sigma bias."""
    import shutil

    dense = run.parent / f"{run.name}_dense"
    (dense / "checkpoints").mkdir(parents=True)
    shutil.copy(run / "curriculum.json", dense / "curriculum.json")
    ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
    ckpt["params_G"]["siren.final_layer.bias"][3] += DENSE_SIGMA_BIAS
    torch.save(ckpt, dense / "checkpoints" / checkpoint.name)
    return dense


def grid_against_plain(label: str, inf, n: int, bounds: tuple, failures: list) -> None:
    """The n^3 sigma grid of valset[0]'s conditioning through the kernels
    against the same grid with the plain versions in their places
    (`PlainVersions`): the mean and 99.9th percentile of |kernel - plain|
    at phase 1's (or 1b's) bounds, on the model's own weights."""
    from conditioned_nerf_gan_torch.infer.extract_shapes import sample_sigma_grid

    z = inf.encode(inf._cond_batch(inf.valset[0]))
    grid = dict(cube_length=1.2, max_points=min(64 ** 3, n ** 3), device=inf.device)
    kernel = sample_sigma_grid(inf.generator.eval_points, z, n, **grid)
    with PlainVersions():
        plain = sample_sigma_grid(inf.generator.eval_points, z, n, **grid)
    err = np.abs(kernel - plain).ravel()
    mean_tol, q999_tol = bounds
    q999 = float(np.quantile(err, 0.999))
    print(f"phase 12 [{label}] {n}^3 sigma grid (B 1, N {n ** 3}), kernels against plain: "
          f"max|sigma| {np.abs(plain).max():.3e}, share of sigma > 0 {(plain > 0).mean():.4f}, "
          f"max|kernel - plain| {err.max():.3e}, mean {err.mean():.3e} (bound {mean_tol}), "
          f"p99.9 {q999:.3e} (bound {q999_tol})")
    if not (np.isfinite(kernel).all() and err.mean() < mean_tol and q999 < q999_tol):
        failures.append(f"phase 12: the {label} sigma grid through the kernels disagrees "
                        "with its plain version")


def block_against_plain(label: str, inf, first_render, failures: list) -> None:
    """The first block of a mode's first `render_batched` call (16 frames
    for the video) rendered again with the plain versions in the kernels'
    places, held at phase 7's render bounds."""
    z, cams, kwargs, rgb = first_render
    chunk = kwargs.get("chunk", 8)
    fov = kwargs.get("fov")
    if kwargs.get("z_batched"):
        z = tuple(p[:chunk] for p in z) if isinstance(z, (tuple, list)) else z[:chunk]
    with PlainVersions():
        rgb_plain, _ = inf.render_batched(
            z, cams[:chunk], **{**kwargs, "fov": None if fov is None else fov[:chunk]})
    diff = np.abs(rgb[:chunk] - rgb_plain).max(axis=-1)
    over = float((diff > RENDER_TOL).mean())
    print(f"phase 12 [{label}] first block ({chunk} views) against the plain render: "
          f"pixel std {rgb_plain.std():.4f}, mean|pixel| {diff.mean():.3e} (bound "
          f"{RENDER_MEAN_TOL}), share of pixels off by > {RENDER_TOL}: {over:.3e} (bound "
          f"{RENDER_OVER_SHARE}), max|pixel| {diff.max():.3e}")
    if diff.mean() > RENDER_MEAN_TOL or over > RENDER_OVER_SHARE:
        failures.append(f"phase 12 [{label}]: the kernel render disagrees with the plain render")


def trilinear_at_grids(device, failures: list) -> None:
    """K5 at the voxel modes' shapes (B 1, N 48^3 and 64^3: the grid's
    points scaled as the SIREN scales them) on a seeded 64^3 x 32 volume
    against `border_trilerp_reference` at phase 6's bound; not counted."""
    from conditioned_nerf_gan_torch.infer.extract_shapes import create_samples
    from conditioned_nerf_gan_torch.models.siren import VOXEL_LENGTH
    from conditioned_nerf_gan_torch.ops.grid_sample import (
        border_trilerp_reference,
        trilinear_point_features,
    )

    rng = np.random.default_rng(3)
    volume = torch.from_numpy(rng.normal(0, 1, (1, VOXEL_RES, VOXEL_RES, VOXEL_RES, 32))
                              .astype(np.float32)).to(device)
    vol_max = volume.abs().max().item()
    for n in INFER_VOXELS:
        coords = torch.from_numpy(create_samples(n, cube_length=1.2)[0]).to(device) / (
            VOXEL_LENGTH / 2.0)
        with torch.no_grad():
            out = trilinear_point_features(volume, coords, align_corners=False,
                                           padding_mode="border")
            plain = border_trilerp_reference(volume, coords)
            err = (out - plain).abs().max().item()
            ms = cuda_ms(lambda: trilinear_point_features(volume, coords), 20)
            plain_ms = cuda_ms(lambda: border_trilerp_reference(volume, coords), 5)
        print(f"phase 12 [trilinear at the {n}^3 grid] B=1 N={n ** 3} volume {VOXEL_RES}^3 x "
              f"32: max|kernel - plain| {err:.3e} (bound {TRILERP_TOL} x max|volume| "
              f"{vol_max:.3f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (events)")
        if not (torch.isfinite(out).all() and err <= TRILERP_TOL * vol_max):
            failures.append(f"phase 12: K5 at the {n}^3 grid disagrees with its plain version")


def phase12_infer(device, trainer: dict, evaluation: dict, failures: list) -> dict:
    """The rest of inference on the card, through the infer CLI's `main`
    with --device cuda: on `dense_copy` of phase 10's thesis checkpoint
    (so the renders, clouds and grids hold density) the fixed-camera grid,
    the orbit video, the colored point clouds (random cameras and the
    dataset's views, masked by the GT depth), the density voxel at 48^3
    and 64^3 and the latent interpolation between two fixture cars; on
    phase 11's (12 views a car, oFID's minimum 10) the metrics; on the
    dense copy of phase 10's dg checkpoint the voxel and the video (K1 at
    Din 32 behind the trilinear kernel). Each mode's seconds (split into
    the Inferencer's build, the render and the rest: host work and file
    writes), launches against the design count and output are printed and
    its output read back; both videos' first block is held against the
    plain render, the thesis 64^3 grid and the dg 48^3 and 64^3 grids
    against their plain versions, K1 and K5 at the grids' shapes against
    theirs, K1 timed there. Returns each path's launches and the timed
    shapes."""
    from conditioned_nerf_gan_torch.config import curriculum_from_json
    from conditioned_nerf_gan_torch.eval.weights import RANDOM_INIT_STAMP_PREFIX
    from conditioned_nerf_gan_torch.infer import Inferencer
    from conditioned_nerf_gan_torch.infer.__main__ import main as infer_main
    from conditioned_nerf_gan_torch.ops.grid_sample import trilinear_point_features
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )
    from conditioned_nerf_gan_torch.utils.png import read_png
    from conditioned_nerf_gan_torch.utils.video import read_avi

    counters = (film_siren_mlp, trilinear_point_features)
    t_phase = time.perf_counter()

    def last_checkpoint(run: Path) -> Path:
        return max((run / "checkpoints").glob("*.pt"), key=lambda q: int(q.stem))

    thesis_run, dg_run = (dense_copy(trainer[key], last_checkpoint(trainer[key]))
                          for key in ("thesis_run", "dg_run"))
    eval_run = evaluation["run"]

    def newest(run: Path, pattern: str, since: float) -> Path | None:
        found = [q for q in run.glob(pattern) if q.stat().st_mtime >= since]
        return max(found, key=lambda q: q.stat().st_mtime) if found else None

    totals = {"K1": 0, "K1 dg": 0, "trilinear dg": 0}
    seconds_by_mode = {}

    def drive(label: str, run: Path, flags: list, design, check, dg: bool = False,
              hold_first_block: bool = False):
        ckpt = last_checkpoint(run)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        since = time.time() - 1
        t0 = time.perf_counter()
        with InferencerProbe() as probe:
            rc = infer_main([str(ckpt), *flags, "--device", str(device)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, tri = (c.launches for c in counters)
        inf = probe.built[0] if probe.built else None
        want = design(inf) if inf is not None else None
        out, problem = check(run, since) if rc == 0 else (None, f"rc {rc}")
        size = out.stat().st_size if out is not None and out.exists() else None
        build, render = probe.seconds["build"], probe.seconds["render"]
        print(f"phase 12 [{label}] checkpoint {ckpt.name}: rc {rc} in {seconds:.3f} s (build "
              f"{build:.3f}, render {render:.3f}, rest {seconds - build - render:.3f}); "
              f"launches K1 {k1}" + (f", trilinear {tri}" if dg else "")
              + f" (design {want}{', both' if dg else ''}); wrote "
              f"{out.relative_to(run) if out is not None else None} ({size} bytes)"
              + (f"; {problem}" if problem else ""))
        totals["K1 dg" if dg else "K1"] += k1
        if dg:
            totals["trilinear dg"] += tri
        if rc != 0 or problem or k1 != want or (dg and tri != want):
            failures.append(f"phase 12 [{label}]: rc {rc}, K1 {k1}, trilinear {tri}, design "
                            f"{want}; {problem}")
        seconds_by_mode[label] = (seconds, build, render)
        if hold_first_block and inf is not None and probe.first_render is not None:
            block_against_plain(label, inf, probe.first_render, failures)
        del inf, probe

    def png_check(pattern: str, shape_of):
        def check(run, since):
            out = newest(run, pattern, since)
            if out is None:
                return None, f"no {pattern}"
            shape = read_png(out).shape
            return out, None if shape == shape_of else f"shape {shape}, want {shape_of}"
        return check

    def video_check(run, since):
        out = newest(run, "inference/video/*.avi", since)
        if out is None:
            return None, "no .avi"
        frames, fps = read_avi(out)
        want = (INFER_FRAMES, IMAGE_SIZE, IMAGE_SIZE, 3)
        return out, None if (frames.shape, fps) == (want, INFER_FPS) else \
            f"{frames.shape} at {fps} fps, want {want} at {INFER_FPS}"

    def obj_check(pattern):
        def check(run, since):
            out = newest(run, pattern, since)
            if out is None:
                return None, f"no {pattern}"
            pts = read_obj_points(out)
            print(f"phase 12: {out.name}: {len(pts)} points, xyz in "
                  f"[{pts[:, :3].min() if len(pts) else 0:.3f}, "
                  f"{pts[:, :3].max() if len(pts) else 0:.3f}]")
            return out, None if len(pts) and np.isfinite(pts).all() else \
                f"{len(pts)} points, not all finite or none"
        return check

    def mrc_check(n):
        def check(run, since):
            out = newest(run, "inference/*.mrc", since)
            return out, check_mrc(out, n) if out is not None else "no .mrc"
        return check

    def metrics_check(run, since):
        out = run / "fid_inference.txt"
        lines = out.read_text().splitlines() if out.exists() else []
        fields = [line.split() for line in lines if line.strip() and not line.startswith("#")]
        print(f"phase 12: fid_inference.txt: {lines}")
        ok = (lines and lines[0].startswith(RANDOM_INIT_STAMP_PREFIX) and fields
              and len(fields[-1]) == 7 and all(np.isfinite(float(v)) for v in fields[-1]))
        return out, None if ok else "fid_inference.txt lacks its stamp or a 7-field line"

    views = TRAINER_FIXTURE["n_views"]
    n_imgs = 4
    drive("images, fixed cameras", thesis_run,
          ["--images", "--cam_fixed", "--num_imgs", str(n_imgs)],
          lambda inf: render_launches(inf.curriculum, min(n_imgs, len(inf.valset)), 8),
          png_check("inference/*_fixed_*.png", (4 * IMAGE_SIZE, n_imgs * IMAGE_SIZE, 3)))
    video = ["--video", "--num_frames", str(INFER_FRAMES), "--fps", str(INFER_FPS)]
    drive("video", thesis_run, video,
          lambda inf: render_launches(inf.curriculum, INFER_FRAMES, 16), video_check,
          hold_first_block=True)
    drive("pcl", thesis_run, ["--pcl", "--pcl_views", str(INFER_PCL_VIEWS)],
          lambda inf: render_launches(inf.curriculum, INFER_PCL_VIEWS, 8),
          obj_check("inference/*_car*[0-9]_[0-9]*.obj"))
    drive("pcl masked", thesis_run, ["--pcl_masked", "--pcl_views", str(INFER_PCL_VIEWS)],
          lambda inf: render_launches(inf.curriculum, min(INFER_PCL_VIEWS, views), 8),
          obj_check("inference/*_masked_*.obj"))
    for n in INFER_VOXELS:
        drive(f"voxel {n}^3", thesis_run, ["--voxel", "--voxel_resolution", str(n)],
              lambda inf, n=n: -(-n ** 3 // min(64 ** 3, n ** 3)), mrc_check(n))
    ds_path = Path(curriculum_from_json(thesis_run / "curriculum.json")["dataset"]["path"])
    src, tgt = sorted(q.name for q in ds_path.iterdir() if (q / "cameras.npz").exists())[:2]
    drive("interpolate", thesis_run,
          ["--interpolate", "--interpolate_src", src, "--interpolate_tgt", tgt],
          lambda inf: render_launches(inf.curriculum, INFER_INTERPOLATE_N + 1, 8),
          png_check(f"inference/{src}_to_{tgt}_fz.png",
                    (IMAGE_SIZE, (INFER_INTERPOLATE_N + 1) * IMAGE_SIZE, 3)))

    def metrics_design(inf):  # eval.output_images' render batch
        block = (inf.curriculum["fid"].get("render_batch")
                 or (2 if inf.curriculum["num_steps"] > 48 else 8))
        return render_launches(inf.curriculum, len(inf.fidset), block)

    drive("metrics", eval_run, ["--metrics"], metrics_design, metrics_check)
    drive("dg voxel 48^3", dg_run, ["--voxel"], lambda inf: -(-48 ** 3 // 48 ** 3),
          mrc_check(48), dg=True)
    drive("dg video", dg_run, video,
          lambda inf: render_launches(inf.curriculum, INFER_FRAMES, 16), video_check, dg=True,
          hold_first_block=True)
    infer_s = time.perf_counter() - t_phase

    # the grids through the kernels against their plain versions, on the
    # models' own weights; K1 and K5 at the grids' shapes against theirs,
    # on seeded inputs (K1 timed); none of these counts
    timed = {}
    with torch.no_grad():
        for label, run, sizes, bounds in (
                ("thesis", thesis_run, (64,), (KERNEL_MEAN_TOL, KERNEL_Q999_TOL)),
                ("dg", dg_run, INFER_VOXELS, (DIN32_MEAN_TOL, DIN32_Q999_TOL))):
            inf = Inferencer(last_checkpoint(run), device=device)
            for n in sizes:
                grid_against_plain(label, inf, n, bounds, failures)
            del inf
            torch.cuda.empty_cache()
        trilinear_at_grids(device, failures)
        for label, n, din, make in (("voxel grid 64^3", 64, 3, kernel_inputs),
                                    ("dg voxel grid 48^3", 48, 32, voxel_kernel_inputs)):
            inp = make(1, n ** 3, seed=2, device=device)
            err, failure = check_kernel(label, inp, "phase 12", (
                (KERNEL_LOW_TOL, KERNEL_MEAN_TOL, KERNEL_Q999_TOL, KERNEL_VS_PLAIN) if din == 3
                else (DIN32_LOW_TOL, DIN32_MEAN_TOL, DIN32_Q999_TOL, DIN32_VS_PLAIN)))
            if failure:
                failures.append(failure)
            timed[label] = timed_row("phase 12", label, 1, n ** 3,
                                     lambda: film_siren_mlp(*inp.values()),
                                     lambda: film_siren_mlp_folded(*inp.values()),
                                     *film_bound(1, n ** 3, 4 if din == 3 else 8, din), 20)
            del inp
    print("phase 12: seconds by mode (build / render / rest): "
          + ", ".join(f"{mode} {t:.3f} ({b:.3f} / {r:.3f} / {t - b - r:.3f})"
                      for mode, (t, b, r) in seconds_by_mode.items())
          + f"; the modes {infer_s:.2f} s, the phase {time.perf_counter() - t_phase:.2f} s")
    return dict(k1=totals["K1"], dg_k1=totals["K1 dg"], dg_trilinear=totals["trilinear dg"],
                timed=timed)


# Phase 13: the rest of the voxel family. The kernel checks hold K1/K2 at
# the new input widths on inputs drawn as phase 1b draws them, each width
# at its own spec's init (trunk and head weights U(+-sqrt(6/256)/freq_init)),
# at phases 1b's and 4b's bounds (DIN32_*), and K5 and its backward at
# phase 6's.
PYRAMID = "doublesiren_dis_featurepyramid"
WIDE_SHAPES = [("DOUBLESIREN_FG", 224, 2), ("SHORTSIREN_FG_Pyrmd", 224, 4),
               ("TALLSIREN_dgx", 35, 8)]  # (spec, Din, L)
# At freq/30 K1 is held first against the same math with fp64 sums, no
# farther from them than the plain version is (DIN32_VS_PLAIN), as at freq
# 25-45. Its max against the plain version there is the one bound of phases
# 1b/4b/6 that Din 224 does not meet: both Din-224 specs initialise at
# freq_init 12, so their trunk and head weights are twice TALLSIREN_FG's and
# a flipped bf16 rounding of h moves the output twice as far, and layer 0
# sums 224 bf16 products where 1b's sums 32, so a summation-order
# difference flips more of them. About twice the H100 readings at that init
# [1.233e-4 at L 2 and 1.215e-4 at L 4, 12 x 49,152; PERF.md]; 1b's 5e-5
# stays for Din 35 (TALLSIREN_dgx, freq_init 25).
WIDE_LOW_TOL = 2.5e-4
# The encoder's grads of a pyramid step against the plain step: the
# U-Net's grads are K2's dpoints (the 224-wide cotangent of the pyramid's
# features, by L2 2.7e-4 from the plain VJP's at L 2 and 2.2e-3 at L 4 on
# the specs' own init, each within 1.25x of the plain VJP's distance to
# fp64 sums) scattered into three levels. On SHORTSIREN_FG_Pyrmd every H100
# reading sits at phase 9's 5e-3 itself, from 4.717e-3 to 4.867e-3 on the
# fp32 path and 4.540e-3 to 5.104e-3 on the policy path (PERF.md), so that
# bound would be decided by the run-to-run spread; held instead, as this
# file's other bounds are, at about twice the largest reading of the path
# it holds. Phase 9's 5e-3 holds every other net and path.
PYRAMID_E_GRAD_TOL = 1e-2
PATH_TIMED_STEPS = 2
PYRAMID_STAGE_STEPS = 2  # the pyramid's CLI run: stages 0 and 1, 2 steps each


def phase13_kernels(device, failures: list) -> dict:
    """K1 and K2 at Din 224 / L 2 (DOUBLESIREN_FG on a pyramid), Din 224 / L 4
    (SHORTSIREN_FG_Pyrmd) and Din 35 / L 8 (TALLSIREN_dgx), each on inputs
    at its spec's init, at the training chunk and a ragged N; K5 and the trilinear backward on each pyramid
    level at the training chunk and on volumes with a side of 1. Returns
    each kernel's new shapes' times and its largest error."""
    import torch.nn.functional as F

    from conditioned_nerf_gan_torch.models.siren import SIREN_SPECS
    from conditioned_nerf_gan_torch.ops.grid_sample import (
        border_trilerp_reference,
        border_trilerp_vjp_reference,
        trilinear_point_features,
    )
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_bwd,
        film_siren_mlp_folded,
        film_siren_mlp_folded_vjp,
    )
    from conditioned_nerf_gan_torch.ops.kernels.trilinear import trilinear_bwd

    chunk = IMAGE_SIZE * IMAGE_SIZE // 16 * 48
    out = dict(k1={}, k2={}, tri={}, tri_bwd={}, k1_err=0.0, k2_err=0.0, tri_err=0.0,
               tri_bwd_err=0.0)
    fwd_bounds = (DIN32_LOW_TOL, DIN32_MEAN_TOL, DIN32_Q999_TOL, DIN32_VS_PLAIN)
    bwd_bounds = (DIN32_BWD_NORM_TOL, DIN32_BWD_LOW_TOL, DIN32_BWD_VS_PLAIN,
                  DIN32_BWD_VS_PLAIN_MAX)
    for spec, din, L in WIDE_SHAPES:
        freq_init = SIREN_SPECS[spec].freq_init
        for where, B, N in (("training chunk", 12, chunk), ("ragged", 2, 1000)):
            label = f"Din {din} L {L} {where}"
            make = lambda B, N, seed, dev: voxel_kernel_inputs(B, N, seed, dev, din, L,
                                                               freq_init)
            inp, g = bwd_inputs(B, N, seed=13, device=device, make_inputs=make)
            bounds = (WIDE_LOW_TOL, *fwd_bounds[1:]) if din == 224 else fwd_bounds
            with torch.no_grad():
                err, failure = check_kernel(f"{label} ({spec}, freq_init {freq_init:g})",
                                            inp, "phase 13", bounds)
                low = dict(inp, freq=inp["freq"] / 30.0)
                exact = film_siren_mlp_folded(*low.values(), accum_dtype=torch.float64)
                k64 = (film_siren_mlp(*low.values()) - exact).abs().max().item()
                p64 = (film_siren_mlp_folded(*low.values()) - exact).abs().max().item()
                del low, exact
            print(f"phase 13 [{label}] freq/30: max|kernel - fp64-sum| {k64:.3e} vs "
                  f"max|folded - fp64-sum| {p64:.3e} (ratio {k64 / p64:.3f}, bound "
                  f"{DIN32_VS_PLAIN})")
            if k64 > DIN32_VS_PLAIN * p64:
                failures.append(f"phase 13: kernel farther from the fp64 sums than its plain "
                                f"version at {label}, freq/30")
            if failure:
                failures.append(failure)
            out["k1_err"] = max(out["k1_err"], err)
            iters = 10 if B * N > 100_000 else 50
            with torch.no_grad():
                out["k1"][label] = timed_row(
                    "phase 13", label, B, N, lambda: film_siren_mlp(*inp.values()),
                    lambda: film_siren_mlp_folded(*inp.values()), *film_bound(B, N, L, din),
                    iters)
            out["k2_err"] = max(out["k2_err"],
                                check_bwd(label, inp, g, failures, "phase 13", bwd_bounds))
            out["k2"][label] = timed_row(
                "phase 13", label + " backward", B, N,
                lambda: film_siren_mlp_bwd(*inp.values(), g),
                lambda: film_siren_mlp_folded_vjp(*inp.values(), g),
                *film_bound(B, N, L, din, backward=True), iters)
            del inp, g
            torch.cuda.empty_cache()

    # the pyramid's levels at the training chunk (PyramidUNet3D 4 -> f_maps
    # 32, 4 levels, 64^3 grids), and volumes with a side of 1
    rng = np.random.default_rng(14)
    sets = [("pyramid level 16^3 x 128", (12, 16, 16, 16, 128), 12),
            ("pyramid level 32^3 x 64", (12, 32, 32, 32, 64), 12),
            ("pyramid level 64^3 x 32", (12, 64, 64, 64, 32), 12),
            ("side 1: 1 x 64^2 x 32", (2, 1, 64, 64, 32), 2),
            ("side 1: 1^3 x 128", (2, 1, 1, 1, 128), 2)]
    for label, shape, B in sets:
        volume = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)
        coords = ray_points(B, 15, device)
        N, C = coords.shape[1], shape[-1]
        vol_max = volume.abs().max().item()
        volume_ncdhw = volume.permute(0, 4, 1, 2, 3).contiguous()
        grid = coords[:, None, None]
        with torch.no_grad():
            got = trilinear_point_features(volume, coords)
            err = (got - border_trilerp_reference(volume, coords)).abs().max().item()
            gs = F.grid_sample(volume_ncdhw, grid, mode="bilinear", padding_mode="border",
                               align_corners=False)[:, :, 0, 0].transpose(1, 2)
            gs_err = (got - gs).abs().max().item()
        out["tri_err"] = max(out["tri_err"], err)
        print(f"phase 13 [{label}] B={B} N={N} volume {tuple(shape)}: max|kernel - plain| "
              f"{err:.3e} (bound {TRILERP_TOL} x max|volume| {vol_max:.3f}), max|kernel - "
              f"F.grid_sample| {gs_err:.3e}")
        if not (torch.isfinite(got).all() and err <= TRILERP_TOL * vol_max):
            failures.append(f"phase 13 [{label}]: K5 disagrees with its plain version")
        del got, gs
        main = lambda: trilinear_point_features(volume, coords)
        span_ms = device_ms(main, ("trilinear_fwd_kernel",))
        call_ms = cuda_ms(main, 20)
        ms = graph_ms(main)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: border_trilerp_reference(volume, coords), 4)
            gs_ms = cuda_ms(lambda: F.grid_sample(volume_ncdhw, grid, mode="bilinear",
                                                  padding_mode="border",
                                                  align_corners=False), 20)
        rows = touched_rows(volume, coords)
        bound_ms, bound_by = bound(B * N * (3 + C) * 4 + rows * C * 4, 0.0,
                                   float(B * N * (14 * C + 30)))
        print(f"phase 13 [{label}] time: kernel {ms:.4f} ms a call back to back (a CUDA "
              f"graph of 20); its device span {span_ms:.4f} ms (profiler), a call of the "
              f"wrapper {call_ms:.4f} ms (events); plain {plain_ms:.4f} ms, F.grid_sample "
              f"{gs_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{bound_ms / ms:.3f} of it")
        out["tri"][label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=gs_ms, call_ms=call_ms,
                                 span_ms=span_ms)

        g = torch.from_numpy(np.random.default_rng(16).normal(0, 1, (B, N, C))
                             .astype(np.float32)).to(device)
        out["tri_bwd_err"] = max(out["tri_bwd_err"], check_trilinear_bwd(
            label, volume, coords, g, failures, phase="phase 13"))
        buf = torch.zeros_like(volume)
        main = lambda: trilinear_bwd(volume, coords, g, buf)
        span_ms = device_ms(main, ("trilinear_bwd_presum_kernel",))
        call_ms = cuda_ms(main, 20)
        ms = graph_ms(main)
        plain_ms = cuda_ms(lambda: buf.add_(border_trilerp_vjp_reference(volume, coords, g,
                                                                          False)[0]), 4)
        grad_ncdhw = g.transpose(1, 2)[:, :, None, None, :].contiguous()
        lib_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
            grad_ncdhw, volume_ncdhw, grid, 0, 1, False, [True, False]), 20)
        counts = scatter_counts(volume, coords)
        bound_ms, bound_by = bound(B * N * (3 + C) * 4 + counts["rows"] * C * 4 * 2, 0.0,
                                   float(counts["pairs"] * 4 * C))
        print(f"phase 13 [{label}] backward time: kernel {ms:.4f} ms a call back to back (a "
              f"CUDA graph of 20); its device span {span_ms:.4f} ms (profiler), a call of the "
              f"wrapper {call_ms:.4f} ms (events); plain "
              f"{plain_ms:.4f} ms, grid_sampler_3d_backward {lib_ms:.4f} ms; live pairs "
              f"{counts['pairs']}, distinct rows {counts['rows']}; bound {bound_ms:.4f} ms "
              f"({bound_by}), kernel at {bound_ms / ms:.3f} of it")
        out["tri_bwd"][label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, library_ms=lib_ms, call_ms=call_ms,
                                     span_ms=span_ms)
        del volume, volume_ncdhw, grid, coords, g, buf, grad_ncdhw
        torch.cuda.empty_cache()
    return out


def graph_ms(fn, iters: int = 20) -> float:
    """fn's time a call with its calls back to back on the card: `iters`
    calls captured in one CUDA graph, the graph replayed and timed with
    events, so that the host's time a call leaves no gaps between them (in
    those gaps a kernel's writes drain from L2, and its own device span
    undercounts them)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, 3, warmup=1) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def kernel_counters():
    from conditioned_nerf_gan_torch.ops.grid_sample import trilinear_point_features
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_bwd,
    )
    from conditioned_nerf_gan_torch.ops.kernels.trilinear import trilinear_bwd

    return film_siren_mlp, film_siren_mlp_bwd, trilinear_point_features, trilinear_bwd


def take_counts(counters) -> tuple:
    """The counters' launches since the last call; sets them to 0."""
    counts = tuple(c.launches for c in counters)
    for c in counters:
        c.launches = 0
    return counts


PLAIN_KERNELS = dict(
    film_siren_mlp=PlainFilmSiren.apply,
    trilinear_point_features=lambda volume, coords, **_: PlainTrilinear.apply(volume, coords))


def with_overrides(preset: str, **changes) -> dict:
    """meta_overrides for `build_stage_bench`: the preset's `generator` or
    `unet` block with the given keys changed ({"generator": {"siren_type":
    ...}})."""
    from conditioned_nerf_gan_torch.config import load_curriculum

    cur = load_curriculum(config_base="thousand", config=preset)
    return {block: dict(cur[block], **keys) for block, keys in changes.items()}


def phase13_step(label: str, preset: str, device, failures: list, overrides=None,
                 dv_ops: bool = False, profile: bool = False, phase_no: int = 13) -> tuple:
    """One voxel-family path's stage-2 train step at full width
    (`build_stage_bench`, step DG_TRAIN_STEP): a warm-up and PATH_TIMED_STEPS
    timed steps (s/step, peak memory, every kernel's launches against the
    design derived from the config), finite losses, each net moved, one
    step against the same step with every kernel's plain version in its
    place and with `dv_ops` the ops of one step on a tensor of each feature
    volume's shape (one zeroing a render with grad, no sum); with `profile`
    one profiled step (busy share, the largest kernels). With D, under
    the bf16 policy, what is read through D (d_loss, g_loss, D's grads and
    the encoder's, whose g_loss term comes through D) is printed, and every
    number held on a bench with fp32 twins of E and D (`fp32_bench_step`),
    as phase 5 does. Returns the launches over the warm-up and timed steps
    and the s/step."""
    from conditioned_nerf_gan_torch.training import (
        build_stage_bench,
        create_train_state,
        make_train_step,
    )

    counters = kernel_counters()
    phase = f"phase {phase_no} [{label}]"
    t0 = time.perf_counter()
    bench = build_stage_bench(preset, stage=2, step=DG_TRAIN_STEP, meta_overrides=overrides)
    cfg, meta = bench.config, bench.meta
    nets = dict(G=bench.generator, E=bench.encoder, D=bench.discriminator)
    nets = {k: v.to(device) for k, v in nets.items() if v is not None}
    state = create_train_state(nets["G"], nets["E"], nets.get("D"), cfg)
    train_step = make_train_step(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in bench.batch.items()}
    rng = torch.Generator(device=device).manual_seed(0)
    levels, film = voxel_design(meta)
    design = design_launches(cfg, levels, film)
    r = cfg.render
    print(f"{phase}: {preset} step {DG_TRAIN_STEP}: batch {meta['batch_size']} (split "
          f"{cfg.batch_split}), {meta['unet'].get('type', 'UNet3D')} f_maps "
          f"{meta['unet']['f_maps']} x {meta['unet']['num_levels']} levels on "
          f"{tuple(batch['voxel'].shape)} (global {meta['unet']['return_global']}), "
          f"{meta['generator']['siren_type']} (kernels: {film}, {levels} lookups a call), "
          f"{r.img_size}^2, {r.num_steps}+{r.num_steps} samples, ray_chunks {r.ray_chunks}, "
          f"discriminator {meta['discriminator'] if cfg.enable_discriminator else None}"
          + (f" (cond views {tuple(batch['cond'].shape)})" if "cond" in batch else "")
          + f"; design launches per step K1 {design[0]}, "
          f"K2 {design[1]}, trilinear {design[2]}, trilinear backward {design[3]}; set-up "
          f"{time.perf_counter() - t0:.2f} s")
    before = {name: [p.detach().clone() for p in net.parameters()]
              for name, net in nets.items()}
    torch.cuda.reset_peak_memory_stats()
    take_counts(counters)
    step_s, totals = [], [0, 0, 0, 0]
    for i in range(1 + PATH_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, rng, bench.alpha, bench.nerf_noise)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        counts = take_counts(counters)
        totals = [t + c for t, c in zip(totals, counts)]
        losses = {k: float(v) for k, v in metrics.items()}
        print(f"{phase} step {i}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.4f} s, launches "
              f"{counts} (design {design}), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              + ", ".join(f"{k} {v:.6f}" for k, v in losses.items()))
        if counts != design:
            failures.append(f"{phase} step {i}: launches {counts}, design {design}")
        if not all(np.isfinite(v) for v in losses.values()):
            failures.append(f"{phase} step {i}: non-finite losses {losses}")
    s_per_step = float(np.mean(step_s[1:]))
    print(f"{phase}: {s_per_step:.4f} s/step (steps "
          f"{', '.join(f'{t:.4f}' for t in step_s[1:])}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, net in nets.items():
        moved = max((p.detach() - q).abs().max().item()
                    for p, q in zip(net.parameters(), before[name]))
        print(f"{phase}: {name} params moved by up to {moved:.3e}")
        if not moved > 0:
            failures.append(f"{phase}: {name} did not move")
    del before
    grad_tols = {"E": PYRAMID_E_GRAD_TOL} if levels > 1 else None
    step_against_plain(phase, state, train_step, batch, rng, bench.alpha, bench.nerf_noise,
                       PLAIN_KERNELS, DG_STEP_LOSS_TOL, DG_STEP_GRAD_TOL, failures,
                       unheld=(*THROUGH_D, "E") if "D" in nets else (), grad_tols=grad_tols)
    take_counts(counters)
    if profile:
        profiled = profile_device(
            lambda: train_step(state, batch, rng, bench.alpha, bench.nerf_noise))
        take_counts(counters)
        if profiled is None:
            print(f"{phase}: the profiler recorded no device activity; busy share not measured")
        else:
            n_events, busy_ms, by_name = profiled
            print(f"{phase}: profiled step: {n_events} device activities, device busy "
                  f"{busy_ms:.3f} ms, {busy_ms / (s_per_step * 1e3):.4f} of the timed steps' "
                  f"mean")
            print_top(phase, by_name, n=12)
    if dv_ops:
        # each feature volume of a G render (a split of the batch): its dV
        # buffer is zeroed once a render with grad and never summed
        b = batch["voxel"].shape[0] // cfg.batch_split
        with torch.no_grad():
            z = nets["E"](batch["voxel"][:b])
        flat = [z] if isinstance(z, torch.Tensor) else [
            t for part in z for t in (part if isinstance(part, (list, tuple)) else [part])]
        shapes = [tuple(t.shape) for t in flat if t.ndim == 5]
        found = ops_on_shapes(
            lambda: train_step(state, batch, rng, bench.alpha, bench.nerf_noise), shapes)
        take_counts(counters)
        for shape, ops in zip(shapes, found):
            zeroings = ops.get("aten::zero_", 0)
            sums = {n: c for n, c in ops.items() if "add" in n}
            print(f"{phase}: ops of one step on a tensor of dV's shape {shape}: {ops}; "
                  f"zeroings {zeroings} (design {cfg.batch_split}: one a render with grad), "
                  f"sums {sums} (design none)")
            if zeroings != cfg.batch_split or sums:
                failures.append(f"{phase}: {zeroings} zeroings and sums {sums} of dV "
                                f"{shape} a step, design {cfg.batch_split} and none")
    with_d = "D" in nets
    del state, batch, nets, bench
    torch.cuda.empty_cache()
    if with_d:
        fp32_bench_step(phase, preset, DG_TRAIN_STEP, device, failures, plain=PLAIN_KERNELS,
                        overrides=overrides, grad_tols=grad_tols)
        take_counts(counters)
    return tuple(totals), s_per_step


def phase13_pyramid_render(device, failures: list) -> tuple:
    """The pyramid's no-grad render of BATCH views at 128^2 through
    ImplicitGenerator3d (the preset at step DG_STEP, seeded weights, the
    U-Net's encode of BATCH grids): ms, launches against the design, finite
    output in range, and the render against the same render with both plain
    versions. Returns the launches and the render's ms."""
    from conditioned_nerf_gan_torch.infer import build_models, load_metadata
    from conditioned_nerf_gan_torch.models.generator import RenderConfig

    counters = kernel_counters()
    meta = load_metadata(DG_STEP, config=PYRAMID)
    G, E = build_models(meta, generator=torch.Generator().manual_seed(0))
    G.to(device).eval()
    E.to(device).eval()
    cond, cams = make_voxel_requests(meta, 1, seed=3)[0]
    cams = torch.from_numpy(cams).to(device)
    cfg = RenderConfig.from_metadata(meta, perturb=False)
    levels, film = voxel_design(meta)
    calls = max(cfg.ray_chunks, 1) * 2
    design = (calls if film else 0, 0, calls * levels, 0)
    with torch.no_grad():
        z = E(torch.from_numpy(cond["voxel"]).to(device))
        G(z, cams, cfg)  # warm-up
        take_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, depth = G(z, cams, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = take_counts(counters)
        with PlainVersions():
            rgb_plain, _ = G(z, cams, cfg)
    rgb, rgb_plain = rgb.cpu().numpy(), rgb_plain.cpu().numpy()
    levels_shape = [tuple(v.shape) for v in z[0]]
    diff = np.abs(rgb - rgb_plain).max(axis=-1)
    over = float((diff > RENDER_TOL).mean())
    print(f"phase 13 [pyramid render]: {PYRAMID} at step {DG_STEP}, levels {levels_shape}, "
          f"global {tuple(z[1].shape)}; {BATCH} views at {cfg.img_size}^2, "
          f"{cfg.num_steps}+{cfg.num_steps} samples, ray_chunks {cfg.ray_chunks}: {ms:.3f} ms, "
          f"launches {counts} (design {design}); pixels in [{rgb.min():.4f}, {rgb.max():.4f}] "
          f"(std {rgb.std():.4f}); against the plain render mean|pixel| {diff.mean():.3e} "
          f"(bound {RENDER_MEAN_TOL}), share over {RENDER_TOL} {over:.3e} (bound "
          f"{RENDER_OVER_SHARE})")
    if counts != design:
        failures.append(f"phase 13 [pyramid render]: launches {counts}, design {design}")
    if not (np.isfinite(rgb).all() and torch.isfinite(depth).all()
            and rgb.min() >= -1 - 1e-5 and rgb.max() <= 1 + 1e-5):
        failures.append("phase 13 [pyramid render]: output not finite or out of range")
    if diff.mean() > RENDER_MEAN_TOL or over > RENDER_OVER_SHARE:
        failures.append("phase 13 [pyramid render]: the render disagrees with the plain render")
    del G, E, z
    torch.cuda.empty_cache()
    return counts, ms


def phase13_dres_serve(device, build_dir, failures: list) -> tuple:
    """REQUESTS requests of the `dRes` preset through the Inferencer, as
    phase 7 serves `dg`: the bare feature volume goes to the SIREN's plain
    SIREN and residual layers (no K1), every lookup through K5; the output
    finite (its rgb is raw, so pixels may leave [-1, 1]). Returns the
    launches over the requests."""
    from conditioned_nerf_gan_torch.infer import (
        Inferencer,
        build_models,
        load_metadata,
        save_checkpoint,
    )

    counters = kernel_counters()
    meta = load_metadata(DG_STEP, config="dRes")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        G, E = build_models(meta, generator=torch.Generator().manual_seed(0))
        ckpt = save_checkpoint(f"{tmp}/run/checkpoints/{DG_STEP}.pt", DG_STEP, G, E,
                               config="dRes")
        inf = Inferencer(ckpt, num_imgs=BATCH, image_size=IMAGE_SIZE,
                         input_voxel_resolution=VOXEL_RES, load_dataset=False, seed=0,
                         device=device)
    cur = inf.curriculum
    calls = 2 * max(cur.get("ray_chunks", 0), 1)
    design = (0, 0, calls, 0)
    requests = make_voxel_requests(cur, REQUESTS, seed=4)
    take_counts(counters)
    totals, outputs = [0, 0, 0, 0], []
    for i, (cond, cams) in enumerate(requests):
        t_enc, t_render, z, rgb, depth = serve(inf, cond, cams)
        counts = take_counts(counters)
        totals = [t + c for t, c in zip(totals, counts)]
        print(f"phase 13 [dRes serve] request {i}: {t_enc + t_render:.4f} s (encode "
              f"{t_enc * 1e3:.3f} ms, render {t_render * 1e3:.3f} ms), z {tuple(z.shape)}, "
              f"launches {counts} (design {design}), pixels in [{rgb.min():.4f}, "
              f"{rgb.max():.4f}]")
        if counts != design:
            failures.append(f"phase 13 [dRes serve] request {i}: launches {counts}, "
                            f"design {design}")
        # TALLSIREN_dRes puts out raw rgb (no sigmoid): pixels are not held to [-1, 1]
        if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
            failures.append(f"phase 13 [dRes serve] request {i}: output not finite")
        outputs.append((z, cams, rgb))
    z, cams, rgb = outputs[0]
    with PlainVersions():
        rgb_plain, _ = inf.render_batched(z, cams, z_batched=True)
    take_counts(counters)
    diff = np.abs(rgb - rgb_plain).max(axis=-1)
    over = float((diff > RENDER_TOL).mean())
    print(f"phase 13 [dRes serve]: render vs plain render mean|pixel| {diff.mean():.3e} "
          f"(bound {RENDER_MEAN_TOL}), share over {RENDER_TOL} {over:.3e} (bound "
          f"{RENDER_OVER_SHARE}), max {diff.max():.3e}")
    if diff.mean() > RENDER_MEAN_TOL or over > RENDER_OVER_SHARE:
        failures.append("phase 13 [dRes serve]: the render disagrees with the plain render")
    del inf, outputs
    torch.cuda.empty_cache()
    return tuple(totals)


def phase13_pyramid_trainer(device, dataset: Path, work: Path, failures: list) -> tuple:
    """The train CLI on the pyramid preset across its first milestone
    (PYRAMID_STAGE_STEPS steps at stages 0 and 1) on phase 10's fixture:
    sample grids and val losses at every second step, one Trainer.evaluate
    at the last step; each stage's s/step, peak memory and every kernel's
    launches a step against the design. Returns the launches over the run."""
    from conditioned_nerf_gan_torch import train
    from conditioned_nerf_gan_torch.config import curriculum_to_json

    counters = kernel_counters()
    run = work / "pyramid"
    run.mkdir()
    cur = compressed_curriculum(PYRAMID, PYRAMID_STAGE_STEPS, dataset)
    curriculum_to_json(cur, run / "curriculum.json")
    milestones = sorted(k for k in cur if isinstance(k, int))
    meta = dict(cur, **cur[milestones[0]])
    levels, film = voxel_design(meta)
    stop = 2 * PYRAMID_STAGE_STEPS - 1
    take_counts(counters)
    t0 = time.perf_counter()
    with TrainerProbe(counters, design=lambda cfg: design_launches(cfg, levels, film)) as probe:
        rc = train.main(["-o", str(run), "--stop_step", str(stop), "-p", "1",
                         "-s", str(PYRAMID_STAGE_STEPS), "-e", str(stop + 1),
                         "--device", str(device)])
    counts = take_counts(counters)
    seconds = time.perf_counter() - t0
    trainer = probe.trainers[0]
    stages = print_stages("phase 13 [pyramid trainer]", probe.steps, milestones, failures,
                          names=("K1", "K2", "trilinear", "trilinear backward"))
    fid = (run / "fid.txt").read_text() if (run / "fid.txt").exists() else ""
    grids = sorted(p.name for p in (run / "samples" / "valview").glob("*.png"))
    val = trainer.histories["photometry_losses_val"]
    losses = [v for k in ("photometry_losses", "generator_losses", "discriminator_losses")
              for v in trainer.histories[k]]
    print(f"phase 13 [pyramid trainer]: milestones {milestones[:2]}, rc {rc} in {seconds:.2f} s; "
          f"launches over the run (steps, samples, val losses, eval) {counts}; valview grids "
          f"{grids}; val losses {val}; fid.txt {fid.strip().splitlines()[-1:] if fid else None}")
    if (rc != 0 or [s["img"] for s in stages] != [32, 64] or not grids or not val
            or not fid or len(losses) != 3 * (stop + 1) or not np.all(np.isfinite(losses))):
        failures.append(f"phase 13 [pyramid trainer]: the run (rc {rc}) lacks a part: stages "
                        f"{[s['img'] for s in stages]}, grids {grids}, val {val}, fid "
                        f"{bool(fid)}, losses {len(losses)}")
    del probe, trainer
    torch.cuda.empty_cache()
    return counts, stages


def phase13_voxel_variants(device, dataset: Path, work: Path, build_dir: Path,
                           failures: list) -> dict:
    """The rest of the voxel family on the card: the kernels at its shapes,
    then each path at full width (the counters set to 0 just before each
    and read just after). Returns every number the kernels line takes."""
    t0 = time.perf_counter()
    out = dict(kernels=phase13_kernels(device, failures))
    print(f"phase 13: kernel checks {time.perf_counter() - t0:.2f} s")
    # (label, preset, meta_overrides, count the ops on dV's shapes, profile a step)
    paths = [
        ("pyramid_train", PYRAMID, None, True, True),
        # dRes's profile (busy 0.992, ~6.5 s of unfused elementwise ops,
        # PERF.md §5) is not repeated: the script's time goes to phase 14
        ("dres_train", "dRes", None, True, False),
        ("residual_train", "dg", with_overrides("dg", unet={"type": "ResidualUNet3D"}), False,
         False),
        ("dgx_train", "dg", with_overrides("dg", generator={"siren_type": "TALLSIREN_dgx"}),
         False, False),
        ("pyrmd_train", PYRAMID,
         with_overrides(PYRAMID, generator={"siren_type": "SHORTSIREN_FG_Pyrmd"}), False, False),
    ]
    out["steps"] = {}
    for label, preset, overrides, dv_ops, profile in paths:
        t1 = time.perf_counter()
        out["steps"][label] = phase13_step(label, preset, device, failures, overrides, dv_ops,
                                           profile)
        print(f"phase 13 [{label}]: {time.perf_counter() - t1:.2f} s")
    out["pyramid_serve"] = phase13_pyramid_render(device, failures)
    out["dres_serve"] = phase13_dres_serve(device, build_dir, failures)
    t1 = time.perf_counter()
    out["pyramid_trainer"] = phase13_pyramid_trainer(device, dataset, work, failures)
    print(f"phase 13 [pyramid trainer]: {time.perf_counter() - t1:.2f} s")
    print(f"phase 13: {time.perf_counter() - t0:.2f} s")
    return out


# (label, preset, profile one step). indirect_dis's profile (its ~23 s
# step: 0.94 busy, ~15 s elementwise, ~5.6 s fp32 GEMMs, PERF.md §5) takes
# ~90 s of the script's time, most of it reading 346k device events: set
# True to take it again
COND_PATHS = (("cond_nearest", "cond_nearest", False), ("proj_random", "proj_random", False),
              ("indirect_dis", "indirect_dis", False))
COND_CLI = "cond_nearest"
COND_STAGE_STEPS = 2  # the CLI run: stages 0 and 1, 2 steps each
LEGACY_DS = ("ProgressiveEncoderDiscriminator", "StridedDiscriminator", "CCSDiscriminator",
             "CCSEncoderDiscriminator")
LEGACY_D_BATCH = 4
LEGACY_SIRENS = ("SPATIALSIRENBASELINE", "EmbeddingPiGAN128", "EmbeddingPiGAN256")
LEGACY_VIEWS = 2
LEGACY_CPU_ROWS = 4  # rows of each 128^2 view rendered again on the CPU


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase14_cond_trainer(device, dataset: Path, work: Path, failures: list) -> tuple:
    """The train CLI on `cond_nearest` across its first milestone
    (COND_STAGE_STEPS steps at stages 0 and 1) on phase 10's fixture: the
    InputCat D reads the loader's nearest views; sample grids and val
    losses at every second step; each stage's s/step, peak memory and every
    kernel's launches a step against the design. Returns the launches over
    the run and the stages."""
    from conditioned_nerf_gan_torch import train
    from conditioned_nerf_gan_torch.config import curriculum_to_json

    counters = kernel_counters()
    run = work / "cond"
    run.mkdir()
    cur = compressed_curriculum(COND_CLI, COND_STAGE_STEPS, dataset)
    curriculum_to_json(cur, run / "curriculum.json")
    milestones = sorted(k for k in cur if isinstance(k, int))
    meta = dict(cur, **cur[milestones[0]])
    levels, film = voxel_design(meta)
    stop = 2 * COND_STAGE_STEPS - 1
    seen = []
    from conditioned_nerf_gan_torch.training import trainer as trainer_module

    make_step = trainer_module.make_train_step

    def spying_make_step(config, **kwargs):
        step = make_step(config, **kwargs)

        def spied(state, batch, *args):
            seen.append(tuple(batch["cond"].shape) if "cond" in batch else None)
            return step(state, batch, *args)

        return spied

    trainer_module.make_train_step = spying_make_step
    take_counts(counters)
    t0 = time.perf_counter()
    try:
        with TrainerProbe(counters,
                          design=lambda cfg: design_launches(cfg, levels, film)) as probe:
            rc = train.main(["-o", str(run), "--stop_step", str(stop), "-p", "1",
                             "-s", str(COND_STAGE_STEPS), "-e", "1000000",
                             "--device", str(device)])
    finally:
        trainer_module.make_train_step = make_step
    counts = take_counts(counters)
    seconds = time.perf_counter() - t0
    trainer = probe.trainers[0]
    stages = print_stages("phase 14 [cond trainer]", probe.steps, milestones, failures,
                          names=("K1", "K2", "trilinear", "trilinear backward"))
    grids = sorted(p.name for p in (run / "samples" / "valview").glob("*.png"))
    val = trainer.histories["photometry_losses_val"]
    losses = [v for k in ("photometry_losses", "generator_losses", "discriminator_losses")
              for v in trainer.histories[k]]
    print(f"phase 14 [cond trainer]: {COND_CLI} milestones {milestones[:2]}, rc {rc} in "
          f"{seconds:.2f} s; D {type(trainer.state.discriminator).__name__}; the cond views "
          f"each step took (from the loader) {seen}; launches over the run (steps, samples, "
          f"val losses) {counts}; valview grids {grids}; val losses {val}")
    sizes = [s["img"] for s in stages]
    views_ok = len(seen) == stop + 1 and all(
        v is not None and v[1:] == (img, img, 3) for v, img in
        zip(seen, [s["img"] for s in probe.steps]))
    if (rc != 0 or sizes != [32, 64] or not grids or not val or not views_ok
            or len(losses) != 3 * (stop + 1) or not np.all(np.isfinite(losses))):
        failures.append(f"phase 14 [cond trainer]: the run (rc {rc}) lacks a part: stages "
                        f"{sizes}, grids {grids}, val {val}, cond views {seen}, losses "
                        f"{len(losses)}")
    del probe, trainer
    torch.cuda.empty_cache()
    return counts, stages


def phase14_legacy_discriminators(device, failures: list) -> dict:
    """Each discriminator new to the card's paths (Encoder, Strided, CCS,
    CCSEncoder) at 128^2 in fp32: the heads, R1 and the grads of the
    logits' sum plus R1, on the card against the same module on the CPU,
    each by L2 within phase 5's D bound (STEP_GRAD_TOL). Returns the
    readings."""
    from conditioned_nerf_gan_torch.models import make_discriminator
    from conditioned_nerf_gan_torch.training import r1_penalty

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.uniform(-1, 1, (LEGACY_D_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3))
                         .astype(np.float32))
    out = {}
    for name in LEGACY_DS:
        D = make_discriminator(name, generator=torch.Generator().manual_seed(14))
        runs = {}
        for dev in ("cpu", device):
            net = copy.deepcopy(D).to(dev)
            real = x.to(dev).requires_grad_()
            heads = net(real, 0.5)
            heads = heads if isinstance(heads, tuple) else (heads,)
            r1 = r1_penalty(heads, real)
            (heads[0].sum() + r1).backward()
            runs[str(dev)] = ([h for h in heads if h is not None], r1,
                              torch.cat([p.grad.flatten() for p in net.parameters()
                                         if p.grad is not None]))
        (h_c, r1_c, g_c), (h_g, r1_g, g_g) = runs["cpu"], runs[str(device)]
        readings = dict(heads=max(rel_l2(a, b) for a, b in zip(h_g, h_c)),
                        r1=abs(r1_g.item() - r1_c.item()) / abs(r1_c.item()),
                        grads=rel_l2(g_g, g_c))
        out[name] = readings
        print(f"phase 14 [{name}]: {LEGACY_D_BATCH} images at {IMAGE_SIZE}^2, fp32, card "
              f"against CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
              + f" (bound {STEP_GRAD_TOL}); heads {[tuple(h.shape) for h in h_g]}")
        if not all(v <= STEP_GRAD_TOL for v in readings.values()):
            failures.append(f"phase 14 [{name}]: the card disagrees with the CPU: {readings}")
    return out


def phase14_legacy_sirens(device, failures: list) -> dict:
    """SPATIALSIRENBASELINE and EmbeddingPiGAN128/256 through
    ImplicitGenerator3d: one no-grad render of LEGACY_VIEWS views at
    IMAGE_SIZE^2 on the card (the thesis preset's render settings,
    deterministic, fp32, sigma's bias raised by DENSE_SIGMA_BIAS so the
    views are not empty): ms, output finite and in range, no kernel launch
    (these SIRENs take none, as in JAX), and the first LEGACY_CPU_ROWS rows
    of each view against the same rows rendered on the CPU (phase 7's
    render bounds). Returns the ms."""
    from conditioned_nerf_gan_torch.infer import load_metadata
    from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        sample_camera_positions,
    )

    counters = kernel_counters()
    meta = load_metadata(THESIS_STEP)
    cfg = RenderConfig.from_metadata(meta, perturb=False, img_size=IMAGE_SIZE)
    rng = np.random.default_rng(15)
    z = torch.from_numpy(rng.normal(size=(LEGACY_VIEWS, 256)).astype(np.float32))
    cams = create_cam2world_matrix(sample_camera_positions(
        LEGACY_VIEWS, generator=torch.Generator().manual_seed(16),
        cam_r_start=meta["cam_r_start"], cam_r_end=meta["cam_r_end"]))
    out = {}
    for name in LEGACY_SIRENS:
        G = ImplicitGenerator3d(siren_type=name, z_dim=256,
                                generator=torch.Generator().manual_seed(15))
        with torch.no_grad():
            G.siren.final_layer.bias += DENSE_SIGMA_BIAS
        G.eval()
        with torch.no_grad():
            G_dev = copy.deepcopy(G).to(device)
            G_dev(z.to(device), cams.to(device), cfg)  # warm-up
            take_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rgb, depth = G_dev(z.to(device), cams.to(device), cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = take_counts(counters)
            rgb_cpu, _ = G(z, cams, cfg, row_offset=0, render_rows=LEGACY_CPU_ROWS)
        rgb = rgb.cpu()
        diff = (rgb[:, :LEGACY_CPU_ROWS] - rgb_cpu).abs().amax(-1)
        over = float((diff > RENDER_TOL).float().mean())
        out[name] = ms
        print(f"phase 14 [{name} render]: {LEGACY_VIEWS} views at {cfg.img_size}^2, "
              f"{cfg.num_steps}+{cfg.num_steps} samples, ray_chunks {cfg.ray_chunks}: "
              f"{ms:.3f} ms, launches {counts} (design (0, 0, 0, 0)); pixels in "
              f"[{rgb.min():.4f}, {rgb.max():.4f}] (std {rgb.std():.4f}); rows 0-"
              f"{LEGACY_CPU_ROWS - 1} against the CPU: mean|pixel| {diff.mean():.3e} (bound "
              f"{RENDER_MEAN_TOL}), max {diff.max():.3e}, share over {RENDER_TOL} {over:.3e}")
        if counts != (0, 0, 0, 0):
            failures.append(f"phase 14 [{name} render]: launches {counts}, design none")
        if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()
                and rgb.min() >= -1 - 1e-5 and rgb.max() <= 1 + 1e-5):
            failures.append(f"phase 14 [{name} render]: output not finite or out of range")
        if diff.mean() > RENDER_MEAN_TOL or diff.max() > RENDER_TOL:
            failures.append(f"phase 14 [{name} render]: the card disagrees with the CPU")
        del G, G_dev
        torch.cuda.empty_cache()
    return out


def phase14_remaining_models(device, dataset: Path, work: Path, failures: list) -> dict:
    """The remaining models on the card: the conditional discriminators'
    and TALLSIREN's stage-2 steps at full width (`phase13_step`: warm-up,
    timed steps, launches against the design, nets moved, the kernels
    against their plain versions, every number held on fp32 twins of E and
    D), the train CLI on `cond_nearest`, then the other discriminators and
    the legacy SIRENs against the CPU (the counters set to 0 just before
    each path and read just after)."""
    t0 = time.perf_counter()
    out = dict(steps={})
    for label, preset, profile in COND_PATHS:
        t1 = time.perf_counter()
        out["steps"][label] = phase13_step(label, preset, device, failures, profile=profile,
                                           phase_no=14)
        print(f"phase 14 [{label}]: {time.perf_counter() - t1:.2f} s")
    t1 = time.perf_counter()
    out["cond_trainer"] = phase14_cond_trainer(device, dataset, work, failures)
    print(f"phase 14 [cond trainer]: {time.perf_counter() - t1:.2f} s")
    t1 = time.perf_counter()
    out["legacy_discriminators"] = phase14_legacy_discriminators(device, failures)
    out["legacy_sirens"] = phase14_legacy_sirens(device, failures)
    print(f"phase 14 [legacy models]: {time.perf_counter() - t1:.2f} s")
    print(f"phase 14: {time.perf_counter() - t0:.2f} s")
    return out


DP_TIMED_STEPS = 2
DP_STAGE_STEPS = 3  # 15b, 15c: phase 10's compressed thesis curriculum
DP_RANK_TIMEOUT = 600  # seconds a spawned rank may take
SHARD_SLABS = 2  # 15d: slabs of 64 rows at 128^2, both on the one card
CHAMFER_POINTS = 65536
VOXEL_RENDER = dict(side=64, img=128, steps=256)
ORBIT_FRAMES = 8
TOOL_PIXELS_APART = 0.01  # share of pixels a near-face nearest lookup may flip [0 on the CPU]
GEOLOSS_TOL = 1e-3  # |kernel - plain| / |plain| of the replayed loss


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world: int, *args) -> None:
    """fn(rank, world, port, *args) in `world` spawned processes; raises if
    a rank fails or outlasts DP_RANK_TIMEOUT (then every rank is killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, free_port(), *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + DP_RANK_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running after "
                                   f"{DP_RANK_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in ctx.processes]
    if any(codes):
        raise RuntimeError(f"{fn.__name__}: rank exit codes {codes}")


def record_film_shapes() -> dict:
    """From now on note the (B, N, L, Din) of every K1 and K2 launch in this
    process (the launchers' C functions wrapped); returns the sets, by
    kernel."""
    from conditioned_nerf_gan_torch.ops.kernels import film_siren

    shapes = {"film_siren_fwd": set(), "film_siren_bwd": set()}
    c_function = film_siren._c_function

    def recording(library, symbol, n_pointers, n_ints):
        fn = c_function(library, symbol, n_pointers, n_ints)
        if symbol not in shapes:
            return fn

        def launch(*args):  # the pointers, then B, N, L, Din, ...
            shapes[symbol].add(tuple(args[n_pointers:n_pointers + 4]))
            return fn(*args)

        return launch

    film_siren._c_function = recording
    return shapes


def check_film_shapes(phase: str, recorded: list, failures: list) -> None:
    """Every (B, N) at which a rank launched K1 or K2 (`record_film_shapes`,
    as JSON lists) is one phase 1 or phase 4 held against the plain version
    (FWD_SHAPES, BWD_SHAPES at Din 3, L 4)."""
    checked = {"film_siren_fwd": {(B, N, 4, 3) for _, B, N in FWD_SHAPES},
               "film_siren_bwd": {(B, N, 4, 3) for _, B, N in BWD_SHAPES}}
    for kernel, allowed in checked.items():
        seen = sorted({tuple(shape) for shapes in recorded for shape in shapes[kernel]})
        print(f"{phase}: {kernel} launched at (B, N, L, Din) {seen}, each checked against "
              f"its plain version: {set(seen) <= allowed}")
        if not set(seen) <= allowed:
            failures.append(f"{phase}: {kernel} launched at unchecked shapes "
                            f"{sorted(set(seen) - allowed)}")


class AllReduceCounter:
    """`average_gradients`'s calls as a launch counter (`take_counts`,
    `TrainerProbe`): one all-reduce a call."""

    @property
    def launches(self) -> int:
        from conditioned_nerf_gan_torch.parallel import mesh

        return mesh.average_gradients.calls

    @launches.setter
    def launches(self, value: int) -> None:
        from conditioned_nerf_gan_torch.parallel import mesh

        mesh.average_gradients.calls = value


def replicas_equal(nets, group) -> bool:
    """Every rank's params of `nets` bit-equal to rank 0's (a broadcast of
    rank 0's and a comparison on each rank, the verdicts min-reduced)."""
    import torch.distributed as dist

    flags = []
    for net in nets:
        flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
        ref = flat.clone()
        dist.broadcast(ref, src=0, group=group)
        flags.append(torch.equal(flat, ref))
    verdict = torch.tensor([float(all(flags))], device=flat.device)
    dist.all_reduce(verdict, op=dist.ReduceOp.MIN, group=group)
    return bool(verdict.item() == 1.0)


def fp32_twins(bench, init: dict, device):
    """G with its initial weights under the policy, E and D at
    compute_dtype None (phase 5's fp32 path) with theirs, on `device`."""
    from conditioned_nerf_gan_torch.infer import build_models
    from conditioned_nerf_gan_torch.models import make_discriminator

    G = copy.deepcopy(bench.generator)
    G.load_state_dict(init["G"])
    E = build_models(dict(bench.meta, compute_dtype=None))[1]
    E.load_state_dict(init["E"])
    D = make_discriminator(bench.meta["discriminator"])
    D.load_state_dict(init["D"])
    return [net.to(device) for net in (G, E, D)]


def phase15_step_rank(rank: int, world: int, port: int, work: str, device: str) -> None:
    """15a, one rank: the thesis stage-2 step on its shard (DP_RANK_BATCH)
    at full width, gloo over CUDA tensors on the one card: a warm-up and
    DP_TIMED_STEPS timed steps (s/step, K1/K2 launches, the all-reduces'
    calls, floats and ms by CUDA events, the replicas bit-equal after each),
    then one step of the fp32 twins whose averaged pre-clip grads and
    metrics rank 0 saves for the one-process reference. `device` is every
    rank's (one card named for all: the ranks share it)."""
    import torch.distributed as dist

    from conditioned_nerf_gan_torch.parallel import (
        initialize_distributed,
        replicate,
        shutdown_distributed,
    )
    from conditioned_nerf_gan_torch.training import (
        build_stage_bench,
        create_train_state,
        make_train_step,
    )
    from conditioned_nerf_gan_torch.training.trainer import step_seed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    context = initialize_distributed(f"localhost:{port}", world, rank, device=device)
    device, group = context.device, dist.group.WORLD
    all_reduce, events = dist.all_reduce, []

    def timed_all_reduce(tensor, *args, **kwargs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = all_reduce(tensor, *args, **kwargs)
        stop.record()
        events.append((start, stop, tensor.numel()))
        return out

    dist.all_reduce = timed_all_reduce
    counters = kernel_counters()[:2]
    shapes = record_film_shapes()
    bench = build_stage_bench(stage=2, step=TRAIN_STEP)
    cfg = bench.config
    nets = dict(G=bench.generator, E=bench.encoder, D=bench.discriminator)
    init = {k: copy.deepcopy(net.state_dict()) for k, net in nets.items()}
    for net in nets.values():
        net.to(device)
    state = create_train_state(nets["G"], nets["E"], nets["D"], cfg)
    replicate(state, group)
    step = make_train_step(cfg, group=group)
    b = DP_RANK_BATCH
    shard = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(device)
             for k, v in bench.batch.items()}
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + DP_TIMED_STEPS):
        rng = torch.Generator(device=device).manual_seed(step_seed(0, i, rank))
        take_counts(counters)
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, shard, rng, bench.alpha, bench.nerf_noise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = take_counts(counters)
        ar = [(a.elapsed_time(z), n) for a, z, n in events]
        dist.all_reduce = all_reduce
        equal = replicas_equal(nets.values(), group)
        dist.all_reduce = timed_all_reduce
        rows.append(dict(step=i, s=seconds, launches=launches,
                         design=design_launches(cfg)[:2], all_reduce_ms=[m for m, _ in ar],
                         all_reduce_floats=[n for _, n in ar], equal=equal,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         losses={k: float(v) for k, v in metrics.items()}))
        print(f"phase 15a rank {rank} step {i}{' (warm-up)' if i == 0 else ''}: "
              f"{seconds:.4f} s, K1 {launches[0]} K2 {launches[1]} (design "
              f"{rows[-1]['design']}), {len(ar)} all-reduces of "
              f"{[n for _, n in ar]} floats in {sum(m for m, _ in ar):.3f} ms "
              f"({', '.join(f'{m:.3f}' for m, _ in ar)}), replicas bit-equal {equal}, "
              + ", ".join(f"{k} {v:.6f}" for k, v in rows[-1]["losses"].items()), flush=True)
    del state, step
    torch.cuda.empty_cache()

    # the fp32 twins' one step: averaged pre-clip grads and metrics
    twins = fp32_twins(bench, init, device)
    state = create_train_state(*twins, cfg)
    replicate(state, group)
    grads = record_grads(state)
    rng = torch.Generator(device=device).manual_seed(step_seed(0, 0, rank))
    _, metrics = make_train_step(cfg, group=group)(state, shard, rng, bench.alpha,
                                                     bench.nerf_noise)
    if rank == 0:
        torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   Path(work) / "fp32_ranks.pt")
    (Path(work) / f"rank{rank}.json").write_text(json.dumps(rows))
    (Path(work) / f"shapes{rank}.json").write_text(
        json.dumps({k: sorted(v) for k, v in shapes.items()}))
    shutdown_distributed()


def thread_reference_step(cfg, nets_by_rank: list, shards: list, seeds: list, alpha: float,
                          nerf_noise: float) -> tuple[dict, dict]:
    """The one-process reference of a data-parallel step: each rank's state
    and shard in a thread of its own, the grads of each optimizer (and the
    metrics riding with them) summed in rank order and divided by the
    world size where the step would all-reduce them, the same ClippedAdam
    steps; returns rank 0's pre-clip grads and metrics."""
    import threading

    from conditioned_nerf_gan_torch.training import create_train_state, make_train_step
    from conditioned_nerf_gan_torch.training import train_step as train_step_module

    world = len(nets_by_rank)
    barrier, slots = threading.Barrier(world), [None] * world

    @torch.no_grad()
    def average_in_threads(optimizer, rank, extras=()):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        slots[rank] = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
             for p in params] + [e.detach().reshape(-1).float() for e in extras])
        barrier.wait()
        total = slots[0]
        for other in slots[1:]:
            total = total + other
        flat = total / world
        barrier.wait()
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
            offset += p.numel()
        return list(flat[offset:].clone().unbind())

    states = [create_train_state(*nets, cfg) for nets in nets_by_rank]
    grads = record_grads(states[0])
    results, errors = [None] * world, []

    def run(rank):
        try:
            rng = torch.Generator(device=shards[rank]["img"].device).manual_seed(seeds[rank])
            results[rank] = make_train_step(cfg, group=rank)(states[rank], shards[rank], rng,
                                                            alpha, nerf_noise)[1]
            torch.cuda.synchronize()
        except BaseException as exc:  # re-raised in the caller's thread
            errors.append(exc)
            barrier.abort()

    saved = train_step_module.average_gradients
    train_step_module.average_gradients = average_in_threads
    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        train_step_module.average_gradients = saved
    if errors:
        raise errors[0]
    return grads, {k: float(v) for k, v in results[0].items()}


def phase15_two_ranks(device, work: Path, failures: list) -> tuple:
    """15a: two ranks on the one card, gloo over CUDA tensors (NCCL
    refuses two ranks on one device): the ranks' readings, their replicas
    bit-equal after each step, K1/K2 at the design count a rank a step,
    then the fp32 twins' averaged grads and metrics against the
    one-process reference at phase 5's bounds. Returns the ranks' K1 and
    K2 launches over the warm-up and timed steps."""
    from conditioned_nerf_gan_torch.training import build_stage_bench
    from conditioned_nerf_gan_torch.training.trainer import step_seed

    out = work / "15a"
    out.mkdir()
    t0 = time.perf_counter()
    spawn_ranks(phase15_step_rank, 2, str(out), f"{device.type}:0")
    print(f"phase 15a: two ranks ran in {time.perf_counter() - t0:.2f} s (start-up, bench "
          "builds and steps)")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    k1 = k2 = 0
    for r, rows in enumerate(ranks):
        timed = rows[1:]
        ms = [sum(row["all_reduce_ms"]) for row in timed]
        steps = ", ".join(f"{row['s']:.4f}" for row in timed)
        print(f"phase 15a rank {r}: {np.mean([row['s'] for row in timed]):.4f} s/step "
              f"(steps {steps}), all-reduce "
              f"{np.mean(ms):.3f} ms a step ({len(timed[0]['all_reduce_ms'])} calls, "
              f"{sum(timed[0]['all_reduce_floats'])} floats), peak "
              f"{max(row['peak_gib'] for row in rows):.3f} GiB")
        for row in rows:
            k1, k2 = k1 + row["launches"][0], k2 + row["launches"][1]
            if list(row["launches"]) != list(row["design"]):
                failures.append(f"phase 15a rank {r} step {row['step']}: launches "
                                f"{row['launches']}, design {row['design']}")
            if not row["equal"]:
                failures.append(f"phase 15a: the replicas differ after step {row['step']}")
            if len(row["all_reduce_ms"]) != 3:
                failures.append(f"phase 15a rank {r} step {row['step']}: "
                                f"{len(row['all_reduce_ms'])} all-reduces, design 3")
            if not all(np.isfinite(v) for v in row["losses"].values()):
                failures.append(f"phase 15a rank {r}: non-finite losses {row['losses']}")
    if ranks[0][-1]["losses"] != ranks[1][-1]["losses"]:
        failures.append("phase 15a: the ranks' averaged metrics differ")
    check_film_shapes("phase 15a", [json.loads((out / f"shapes{r}.json").read_text())
                                    for r in range(2)], failures)

    # the fp32 twins against the one-process reference
    t0 = time.perf_counter()
    bench = build_stage_bench(stage=2, step=TRAIN_STEP)
    init = {"G": bench.generator.state_dict(), "E": bench.encoder.state_dict(),
            "D": bench.discriminator.state_dict()}
    b = DP_RANK_BATCH
    shards = [{k: torch.from_numpy(v[r * b:(r + 1) * b]).to(device)
               for k, v in bench.batch.items()} for r in range(2)]
    grads, metrics = thread_reference_step(
        bench.config, [fp32_twins(bench, init, device) for _ in range(2)], shards,
        [step_seed(0, 0, r) for r in range(2)], bench.alpha, bench.nerf_noise)
    got = torch.load(out / "fp32_ranks.pt", weights_only=True)
    print(f"phase 15a: the one-process reference (two threads, fp32 twins) in "
          f"{time.perf_counter() - t0:.2f} s")
    for k, ref in metrics.items():
        rel = abs(got["metrics"][k] - ref) / max(abs(ref), 1e-30)
        print(f"phase 15a (fp32 path): {k} two ranks {got['metrics'][k]:.7f} one process "
              f"{ref:.7f} rel {rel:.3e} (bound {STEP_LOSS_TOL})")
        if not rel <= STEP_LOSS_TOL:
            failures.append(f"phase 15a: {k} differs from the one-process reference")
    for net, ref in grads.items():
        rel = ((got["grads"][net].to(device) - ref).norm() / ref.norm()).item()
        print(f"phase 15a (fp32 path): {net} grads |two ranks - one process|_2/|one "
              f"process|_2 {rel:.3e} (bound {STEP_GRAD_TOL})")
        if not rel <= STEP_GRAD_TOL:
            failures.append(f"phase 15a: {net} grads differ from the one-process reference")
    del bench, shards, grads
    torch.cuda.empty_cache()
    return k1, k2


def phase15_nccl_world1(device, trainer: dict, work: Path, failures: list) -> tuple:
    """15b: the train CLI with --distributed at world size 1 (NCCL on the
    card, in this process): thesis stages 0 and 1 of phase 10's
    curriculum, DP_STAGE_STEPS steps each; K1/K2 and the all-reduces a
    step against the design (one per optimizer step), the losses against
    phase 10's run without the flags. Returns the launches over the run."""
    import shutil

    from conditioned_nerf_gan_torch import train

    run = work / "15b"
    run.mkdir()
    shutil.copy(trainer["thesis_run"] / "curriculum.json", run / "curriculum.json")
    counters = (*kernel_counters()[:2], AllReduceCounter())
    stop = 2 * DP_STAGE_STEPS - 1

    def design(cfg):
        return (*design_launches(cfg)[:2], 3 if cfg.enable_discriminator else 2)

    take_counts(counters)
    t0 = time.perf_counter()
    with TrainerProbe(counters, design=design) as probe:
        rc = train.main(["-o", str(run), "--distributed", "--coordinator",
                         f"localhost:{free_port()}", "--num_processes", "1", "--process_id",
                         "0", "--stop_step", str(stop), "-p", str(DP_STAGE_STEPS), "-s", "1000",
                         "-e", "1000", "--device", str(device)])
    counts = take_counts(counters)
    seconds = time.perf_counter() - t0
    stages = print_stages("phase 15b", probe.steps, [0, DP_STAGE_STEPS], failures,
                          names=("K1", "K2", "all-reduces"))
    hist = probe.trainers[0].histories
    worst = 0.0
    for k, ref in trainer["thesis_losses"].items():
        for s in range(stop + 1):
            worst = max(worst, abs(hist[k][s] - ref[s]) / max(abs(ref[s]), 1e-30))
    print(f"phase 15b: NCCL at world size 1: rc {rc} in {seconds:.2f} s; launches over the "
          f"run K1 {counts[0]}, K2 {counts[1]}, all-reduces {counts[2]} ({counts[2] / (stop + 1):.1f} "
          f"a step, design 3: one per optimizer step); largest relative loss difference "
          f"from phase 10's run without the flags {worst:.3e} (bound {RESUME_LOSS_TOL})")
    if rc != 0 or not worst <= RESUME_LOSS_TOL or len(stages) != 2:
        failures.append(f"phase 15b: rc {rc}, {len(stages)} stages, losses {worst:.3e} from "
                        "phase 10's run")
    del probe, hist
    torch.cuda.empty_cache()
    return counts


def phase15_cli_rank(rank: int, world: int, port: int, work: str, argv: list) -> None:
    """15c, one rank of the train CLI (gloo, both ranks on the one card):
    the steps' K1/K2 and all-reduce launches against the design and this
    rank's checkpoint saves, into work/{rank}.json."""
    from conditioned_nerf_gan_torch import train
    from conditioned_nerf_gan_torch.training import trainer as trainer_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    save, saves = trainer_module.save_checkpoint, []

    def counted_save(path, step, *args, **kwargs):
        saves.append(step)
        return save(path, step, *args, **kwargs)

    trainer_module.save_checkpoint = counted_save
    counters = (*kernel_counters()[:2], AllReduceCounter())
    shapes = record_film_shapes()
    with TrainerProbe(counters, design=lambda cfg: (*design_launches(cfg)[:2], 3)) as probe:
        rc = train.main([*argv, "--coordinator", f"localhost:{port}", "--num_processes",
                         str(world), "--process_id", str(rank)])
    (Path(work) / f"{rank}.json").write_text(json.dumps(dict(
        rc=rc, saves=saves, steps=[dict(step=s["step"], s=s["s"], launches=s["launches"],
                                        design=s["design"]) for s in probe.steps],
        shapes={k: sorted(v) for k, v in shapes.items()})))
    if rc:
        raise SystemExit(rc)


def phase15_two_rank_cli(device, trainer: dict, work: Path, failures: list) -> tuple:
    """15c: the train CLI on two ranks on the card (gloo): the thesis preset
    (phase 10's curriculum at half its batch a rank) across stage 0 -> 1
    with one eval (fid.txt's one line from rank 0,
    scored over both ranks' image shards), each checkpoint written once,
    then a two-rank resume from the eval's checkpoint that replays the next
    step within RESUME_LOSS_TOL. Returns K1 and K2 over both runs' ranks."""
    from conditioned_nerf_gan_torch.config import (
        curriculum_from_json,
        curriculum_to_json,
        extract_metadata,
    )
    from conditioned_nerf_gan_torch.data import ShapeNetDataset

    first, resumed = work / "15c", work / "15c_resumed"
    first.mkdir()
    # phase 10's curriculum with each stage's batch a rank halved: the
    # global batch stays the preset's, and each rank's shard of the fixture
    # (42 training views) still fills a batch
    cur = curriculum_from_json(trainer["thesis_run"] / "curriculum.json")
    for key in [k for k in cur if isinstance(k, int)]:
        cur[key]["batch_size"] //= 2
    curriculum_to_json(cur, first / "curriculum.json")
    stop = DP_STAGE_STEPS  # stage 0's steps, then stage 1's first
    flags = ["--stop_step", str(stop), "-p", "1", "-s", "1000", "--device", str(device)]
    runs = ((first, ["-o", str(first), "-e", str(DP_STAGE_STEPS), *flags]),
            (resumed, ["-o", str(resumed), "-l",
                       str(first / "checkpoints" / f"{DP_STAGE_STEPS - 1}.pt"), "-e", "1000",
                       *flags]))
    k1 = k2 = 0
    reports = {}
    for run, argv in runs:
        logs = work / f"{run.name}_ranks"
        logs.mkdir()
        t0 = time.perf_counter()
        spawn_ranks(phase15_cli_rank, 2, str(logs), argv)
        reports[run.name] = [json.loads((logs / f"{r}.json").read_text()) for r in range(2)]
        print(f"phase 15c [{run.name}]: two ranks in {time.perf_counter() - t0:.2f} s")
        expect_steps = list(range(stop + 1)) if run is first else [stop]
        for r, report in enumerate(reports[run.name]):
            if [s["step"] for s in report["steps"]] != expect_steps:
                failures.append(f"phase 15c [{run.name}] rank {r}: steps "
                                f"{[s['step'] for s in report['steps']]}, not {expect_steps}")
            for s in report["steps"]:
                k1, k2 = k1 + s["launches"][0], k2 + s["launches"][1]
                if list(s["launches"]) != list(s["design"]):
                    failures.append(f"phase 15c [{run.name}] rank {r} step {s['step']}: "
                                    f"launches {s['launches']}, design {s['design']}")
            steps = ", ".join(f"{s['step']} {s['s']:.4f} s K1/K2/all-reduces "
                              + "/".join(map(str, s["launches"])) for s in report["steps"])
            print(f"phase 15c [{run.name}] rank {r}: steps {steps}; checkpoints saved "
                  f"{report['saves']}")
    check_film_shapes("phase 15c", [report["shapes"] for run in reports.values()
                                    for report in run], failures)
    saves = [report["saves"] for report in reports[first.name]]
    written = sorted(p.name for p in (first / "checkpoints").iterdir())
    meta = extract_metadata(curriculum_from_json(first / "curriculum.json"), 0)
    fidset = ShapeNetDataset(meta["dataset"]["path"], meta["fid"]["target_size"],
                             meta["fid"]["subset"], meta, load_voxel=False, load_pcl=False,
                             dataset_mode="test", load_img=False, load_depth=False,
                             load_cam=True, shuffle=False)
    lines = [line.split() for line in (first / "fid.txt").read_text().splitlines()
             if line and not line.startswith("#")]
    shards = len(list((first / "evaluation").glob("*.png")))
    print(f"phase 15c: checkpoints {written}, saved by rank 0 {saves[0]} and rank 1 "
          f"{saves[1]}; fid.txt lines {lines}; evaluation PNGs {shards} of the fid "
          f"subset's {len(fidset)}")
    expect = [DP_STAGE_STEPS - 1, stop]
    if (saves != [expect, []] or written != sorted(f"{s}.{x}" for s in expect
                                                     for x in ("json", "pt"))):
        failures.append(f"phase 15c: checkpoints {written} saved {saves}, not once each at "
                        f"{expect} by rank 0")
    if (len(lines) != 1 or int(lines[0][0]) != DP_STAGE_STEPS - 1
            or not np.isfinite(float(lines[0][1])) or shards != len(fidset)):
        failures.append(f"phase 15c: fid.txt {lines}, {shards} PNGs of {len(fidset)}")
    a = json.loads((first / "checkpoints" / f"{stop}.json").read_text())
    b = json.loads((resumed / "checkpoints" / f"{stop}.json").read_text())
    worst = 0.0
    for k in ("photometry_losses", "generator_losses", "discriminator_losses"):
        rel = abs(b[k][stop] - a[k][stop]) / max(abs(a[k][stop]), 1e-30)
        worst = max(worst, rel)
        print(f"phase 15c resume {k}[{stop}]: {b[k][stop]:.7f} uninterrupted "
              f"{a[k][stop]:.7f} (rel {rel:.3e})")
    if not worst <= RESUME_LOSS_TOL:
        failures.append(f"phase 15c: the two-rank resume's step {stop} is {worst:.3e} from "
                        "the uninterrupted run's")
    return k1, k2


def newest_png(directory: Path) -> bytes:
    """The newest PNG's bytes in `directory`; the file is removed (the infer
    CLI stamps its names to the second)."""
    newest = max(directory.glob("*.png"), key=lambda p: p.stat().st_mtime)
    data = newest.read_bytes()
    newest.unlink()
    return data


def phase15_sharded_render(device, trainer: dict, failures: list) -> tuple:
    """15d: `render_ray_sharded` over [cuda:0] * SHARD_SLABS (slabs of 64
    rows at 128^2, 48 + 48 samples) against the unsharded render on the
    dense copy of phase 10's thesis checkpoint: bit-equal, K1 at the slabs'
    design count; the same with the generator held on the CPU, so that the
    slabs run on a replica on the card (a multi-card render's path), then
    again after a param of the held generator changes (the replica
    refreshed); then the infer CLI with --shard_rays --images on phase 10's
    checkpoint, with one card unsharded, and with `shard_devices` naming
    the card twice, through `render_ray_sharded`: the same grid bytes.
    Returns the K1 launches of the library render and of the sharded CLI."""
    from conditioned_nerf_gan_torch.infer import Inferencer, inference
    from conditioned_nerf_gan_torch.infer.__main__ import main as infer_main
    from conditioned_nerf_gan_torch.models.generator import RenderConfig
    from conditioned_nerf_gan_torch.parallel import render, render_ray_sharded

    counters = kernel_counters()[:1]
    run = trainer["thesis_run"]
    checkpoint = run / "checkpoints" / f"{THESIS_STOP}.pt"
    dense = run.parent / f"{run.name}_dense"
    if not dense.exists():
        dense_copy(run, checkpoint)
    inf = Inferencer(dense / "checkpoints" / checkpoint.name, device=device)
    cfg = RenderConfig.from_metadata(inf.curriculum, perturb=False)
    samples = [inf.valset[i] for i in range(2)]
    z = inf.encode({"pcl": np.stack([s["pcl"] for s in samples])})
    cams = torch.as_tensor(np.stack([s["cam2world"] for s in samples]), device=device)
    slabs = [device] * SHARD_SLABS
    held = copy.deepcopy(inf.generator).cpu()
    with torch.no_grad():
        take_counts(counters)
        plain = inf.generator(z, cams, cfg, generator=None)
        (k1_plain,) = take_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = render_ray_sharded(inf.generator, z, cams, cfg, slabs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        (k1_sharded,) = take_counts(counters)
        replicated = render_ray_sharded(held, z, cams, cfg, slabs)
        (k1_replica,) = take_counts(counters)
        replica = render._REPLICAS[(id(held), str(torch.device(device.type, 0)))][1]
        for net in (held, inf.generator):
            net.siren.final_layer.bias[0] += 0.25
        changed = inf.generator(z, cams, cfg, generator=None)
        refreshed = render_ray_sharded(held, z, cams, cfg, slabs)
        reused = render._REPLICAS[(id(held), str(torch.device(device.type, 0)))][1] is replica
        take_counts(counters)
    chunks = max(cfg.ray_chunks, 1) * 2
    readings = {"sharded": (sharded, plain), "replica": (replicated, plain),
                "replica refreshed": (refreshed, changed)}
    equal = {k: [torch.equal(a, b) for a, b in zip(*pair)] for k, pair in readings.items()}
    diff = {k: [(a - b).abs().max().item() for a, b in zip(*pair)]
            for k, pair in readings.items()}
    moved = (changed[0] - plain[0]).abs().max().item()
    print(f"phase 15d: {SHARD_SLABS} slabs of {cfg.img_size // SHARD_SLABS} rows at "
          f"{cfg.img_size}^2, {cfg.num_steps}+{cfg.num_steps} samples, ray_chunks "
          f"{cfg.ray_chunks}: {seconds:.4f} s; bit-equal to the unsharded render: pixels "
          f"{equal['sharded'][0]}, depth {equal['sharded'][1]} (max |sharded - unsharded| "
          f"{diff['sharded'][0]:.3e}, {diff['sharded'][1]:.3e}); K1 {k1_sharded} (design "
          f"{SHARD_SLABS * chunks}; unsharded {k1_plain}, design {chunks})")
    print(f"phase 15d: the generator held on the CPU, the slabs on a replica on the card: "
          f"bit-equal {equal['replica']} (max {diff['replica']}), K1 {k1_replica}; after a "
          f"change of the held generator's head bias (the render moved by {moved:.3e}): "
          f"bit-equal to the changed unsharded render {equal['replica refreshed']} (max "
          f"{diff['replica refreshed']}), the replica reused {reused}")
    for k, flags in equal.items():
        if not all(flags):
            failures.append(f"phase 15d: the {k} render is {diff[k]} from the unsharded one")
    if (k1_sharded, k1_replica, k1_plain) != (SHARD_SLABS * chunks, SHARD_SLABS * chunks,
                                              chunks):
        failures.append(f"phase 15d: K1 launches {k1_sharded}/{k1_replica}/{k1_plain}")
    if not (reused and moved > 0):
        failures.append(f"phase 15d: replica reused {reused}, the change moved {moved}")
    del inf, held, replica, plain, sharded, replicated, changed, refreshed
    render._REPLICAS.clear()
    torch.cuda.empty_cache()

    argv = [str(checkpoint), "--images", "--num_imgs", "4", "--shard_rays", "--device",
            str(device)]
    grids, k1_cli = [], []
    shard_devices = inference.shard_devices
    try:
        for devices in (None, slabs):
            if devices:
                inference.shard_devices = lambda device, img_size: devices
            take_counts(counters)
            rc = infer_main(argv)
            k1_cli.append(take_counts(counters)[0])
            grids.append(newest_png(run / "inference") if rc == 0 else b"")
            if rc != 0:
                failures.append(f"phase 15d: the --shard_rays CLI rc {rc}")
    finally:
        inference.shard_devices = shard_devices
    print(f"phase 15d: infer CLI --shard_rays --images on checkpoint {THESIS_STOP}: "
          f"{torch.cuda.device_count()} card, rendered unsharded: K1 {k1_cli[0]} (without the "
          f"flag, phase 10: {trainer['trainer_infer'][0]}); with `shard_devices` naming the "
          f"card twice: K1 {k1_cli[1]} (design {2 * trainer['trainer_infer'][0]}), the grid "
          f"bytes equal {grids[0] == grids[1]}")
    if (k1_cli != [trainer["trainer_infer"][0], 2 * trainer["trainer_infer"][0]]
            or grids[0] != grids[1] or not grids[0]):
        failures.append(f"phase 15d: the --shard_rays CLI K1 {k1_cli}, grids equal "
                        f"{grids[0] == grids[1]}")
    return k1_sharded, k1_cli[1]


def phase15_tools(device, trainer: dict, failures: list) -> int:
    """15e: the tools of A15 on the card against the host: chamfer over
    2 x CHAMFER_POINTS points against scipy's cKDTree, the first-hit voxel
    render of a 64^3 grid at 128^2 and 256 steps and the pcl2voxel orbit
    AVI's frame 0 against the CPU, the geometry-loss replay on the dense
    thesis checkpoint (K1) against the same replay with the plain K1, the
    fixture exporter's render against the CPU. Returns geoloss's K1
    launches."""
    from scipy.spatial import cKDTree

    from conditioned_nerf_gan_torch.data.synthetic import _make_car
    from conditioned_nerf_gan_torch.tools import geoloss, geometry, pcl2voxel, voxel_render
    from conditioned_nerf_gan_torch.tools.blender import fixture
    from conditioned_nerf_gan_torch.tools.blender.camera_utils import (
        BLENDER_CAM_FLIP,
        blender_cam_pose,
        sample_cam,
    )
    from conditioned_nerf_gan_torch.utils.video import read_avi

    rng = np.random.default_rng(15)
    a, b = (rng.uniform(-0.6, 0.6, (CHAMFER_POINTS, 3)).astype(np.float32) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = geometry.chamfer_distance(a, b, device=device)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = (cKDTree(b).query(a)[0] ** 2).mean() + (cKDTree(a).query(b)[0] ** 2).mean()
    host_s = time.perf_counter() - t0
    rel = abs(got - ref) / ref
    print(f"phase 15e: chamfer 2 x {CHAMFER_POINTS}: card {got:.9e} in {seconds:.4f} s, "
          f"cKDTree (fp64, host) {ref:.9e} in {host_s:.4f} s, rel {rel:.3e} (bound 1e-5)")
    if not rel <= 1e-5:
        failures.append(f"phase 15e: chamfer {got} against cKDTree's {ref}")

    ds = trainer["dataset"]
    car = sorted(p for p in ds.iterdir() if p.is_dir())[0]
    vox = np.load(car / "voxel.npz")["voxel"].astype(np.float32)
    cams = np.load(car / "cameras.npz")
    cam = np.stack([cams["world_mat_inv_0"]]).astype(np.float32)
    vol = np.ascontiguousarray(vox.transpose(2, 1, 0, 3))[None]
    args = (VOXEL_RENDER["img"], 49.134342641202636, 0.2, 2.0, VOXEL_RENDER["steps"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = voxel_render.voxel_surface_render(torch.from_numpy(vol).to(device),
                                             torch.from_numpy(cam).to(device), *args).cpu()
    seconds = time.perf_counter() - t0
    host = voxel_render.voxel_surface_render(torch.from_numpy(vol), torch.from_numpy(cam),
                                             *args)
    apart = ((card - host).abs().amax(-1) > 1e-6).float().mean().item()
    print(f"phase 15e: voxel render of a {vox.shape[0]}^3 grid at {args[0]}^2, {args[-1]} "
          f"steps: {seconds:.4f} s on the card; pixels apart from the CPU's {apart:.3e} "
          f"(bound {TOOL_PIXELS_APART}); covered {(host < 0.97).any(-1).float().mean():.3f}")
    if not apart <= TOOL_PIXELS_APART:
        failures.append(f"phase 15e: the voxel render is {apart} of pixels from the CPU's")

    out = ds.parent / "orbit.avi"
    t0 = time.perf_counter()
    pcl2voxel.voxel_orbit_video(vox, out, img_size=256, num_frames=ORBIT_FRAMES, device=device)
    seconds = time.perf_counter() - t0
    frames, _ = read_avi(out)
    host0 = pcl2voxel.voxel_orbit_frames(vox, 256, 1, device="cpu")[0]
    from conditioned_nerf_gan_torch.utils.image import to_uint8

    apart = (np.abs(frames[0].astype(int) - to_uint8(host0)[..., ::-1]).max(-1) > 1).mean()
    print(f"phase 15e: pcl2voxel orbit AVI, {len(frames)} frames of {frames.shape[1:]}: "
          f"{seconds:.4f} s; frame 0 pixels apart from the CPU's {apart:.3e} (bound "
          f"{TOOL_PIXELS_APART})")
    if len(frames) != ORBIT_FRAMES or not apart <= TOOL_PIXELS_APART:
        failures.append(f"phase 15e: the orbit AVI ({len(frames)} frames) is {apart} apart")

    run = trainer["thesis_run"]
    checkpoint = run / "checkpoints" / f"{THESIS_STOP}.pt"
    dense = run.parent / f"{run.name}_dense"
    if not dense.exists():
        dense_copy(run, checkpoint)
    counters = kernel_counters()[:1]
    take_counts(counters)
    t0 = time.perf_counter()
    loss = geoloss.replay_geometry_loss(dense / "checkpoints" / checkpoint.name, device=device)
    seconds = time.perf_counter() - t0
    (k1,) = take_counts(counters)
    with PlainVersions():
        plain = geoloss.replay_geometry_loss(dense / "checkpoints" / checkpoint.name,
                                             device=device)
    take_counts(counters)
    rel = abs(loss - plain) / abs(plain)
    print(f"phase 15e: geoloss on the dense thesis checkpoint: {loss:.7f} in {seconds:.4f} s "
          f"(K1 {k1}), with the plain K1 {plain:.7f}, rel {rel:.3e} (bound {GEOLOSS_TOL})")
    if not (k1 >= 1 and rel <= GEOLOSS_TOL):
        failures.append(f"phase 15e: geoloss {loss} (K1 {k1}) against the plain {plain}")

    boxes = _make_car(np.random.default_rng(16))
    cams = np.stack([blender_cam_pose(o) @ BLENDER_CAM_FLIP
                     for o in sample_cam(4, 1.1, 1.1, 17)]).astype(np.float32)
    render = (boxes, cams, 128, 49.134342641202636, 0.25, 1.95)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pix, depth = fixture.render_views(*render, device=device)
    seconds = time.perf_counter() - t0
    h_pix, h_depth = fixture.render_views(*render, device="cpu")
    same_bg = (np.isinf(depth) == np.isinf(h_depth)).mean()
    hit = np.isfinite(depth) & np.isfinite(h_depth)
    pix_d = float(np.abs(pix - h_pix).max())
    depth_d = float(np.abs(depth[hit] - h_depth[hit]).max()) if hit.any() else float("nan")
    print(f"phase 15e: the fixture exporter's render, 4 views at 128^2: {seconds:.4f} s; "
          f"max |card - CPU| pixels {pix_d:.3e}, depth {depth_d:.3e} where both hit "
          f"({hit.mean():.3f} of pixels), background agreement {same_bg:.4f} (bounds 1e-3, "
          "1e-3, 0.99)")
    if not (pix_d <= 1e-3 and depth_d <= 1e-3 and same_bg >= 0.99):
        failures.append("phase 15e: the fixture render differs from the CPU's")
    return k1


def phase15_data_parallel(device, trainer: dict, work: Path, failures: list) -> dict:
    """Phase 15: data parallelism and the ray-sharded render (15a-15d) and
    the tools (15e) on the card, on phase 10's fixture and checkpoints;
    each path's launches, its counters set to 0 just before it."""
    t0 = time.perf_counter()
    out = {}
    work = work / "phase15"
    work.mkdir()
    for key, fn, args in (("two_ranks", phase15_two_ranks, (device, work, failures)),
                          ("nccl", phase15_nccl_world1, (device, trainer, work, failures)),
                          ("cli", phase15_two_rank_cli, (device, trainer, work, failures)),
                          ("sharded", phase15_sharded_render, (device, trainer, failures)),
                          ("tools", phase15_tools, (device, trainer, failures))):
        t1 = time.perf_counter()
        out[key] = fn(*args)
        print(f"phase 15 [{key}]: {time.perf_counter() - t1:.2f} s")
        torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t0:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    from conditioned_nerf_gan_torch.ops.kernels import build

    # the plain versions are the comparators: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    # the card's name and power limit, on a line of their own as nvidia-smi prints them
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("nvcc:", run([build._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton
        print("triton:", triton.__version__)
    except ImportError as exc:
        print("triton: not importable:", exc)

    t0 = time.perf_counter()
    libs = build.load_libraries("film_siren_fwd", "film_siren_bwd", "trilinear_fwd",
                                "trilinear_bwd", "film_siren_study")
    print(f"built {len(libs)} kernel libraries in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"built {lib.path.name} in {lib.build_seconds:.2f} s")
        if lib.name == "film_siren_study":
            print_ptxas(lib)
        else:
            for line in lib.log.splitlines():
                if (("Used" in line and "registers" in line) or "spill" in line
                        or "bytes stack" in line or "C7520" in line or "C7512" in line):
                    print("  ptxas:", line.strip()[:240])
        if lib.name in ("film_siren_fwd", "film_siren_bwd", "film_siren_study"):
            print_code_size(lib.path)

    failures: list[str] = []
    fwd = phase1_kernel(device)
    fwd32 = phase1b_kernel_din32(device, failures)
    serve_launches, inf, last_request, last_s = phase2_serve(device, Path(build.BUILD_DIR))
    phase3_profile(inf, last_request, last_s)
    del inf
    torch.cuda.empty_cache()
    bwd = phase4_bwd(device, failures)
    bwd32 = phase4b_bwd_din32(device, failures)
    train_fwd, train_bwd = phase5_train(device, failures)
    torch.cuda.empty_cache()
    tri, tri_bwd = phase6_trilinear(device, failures)
    (dg_k1, dg_tri), inf, last_request, last_s = phase7_dg_serve(
        device, Path(build.BUILD_DIR), failures)
    phase3_profile(inf, last_request, last_s, phase="phase 7 profile")
    del inf
    torch.cuda.empty_cache()
    study_rows, study = phase8_study(device, failures,
                                     fwd["ms_by_shape"]["thesis render"]["ms"])
    dg = phase9_dg_train(device, failures)
    # phase 12 reads the runs of phases 10 and 11
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        trainer = phase10_trainer(device, Path(work), failures)
        evaluation = phase11_eval(device, Path(work), failures)
        inference = phase12_infer(device, trainer, evaluation, failures)
        variants = phase13_voxel_variants(device, trainer["dataset"], Path(work),
                                          Path(build.BUILD_DIR), failures)
        remaining = phase14_remaining_models(device, trainer["dataset"], Path(work), failures)
        parallel = phase15_data_parallel(device, trainer, Path(work), failures)
    if failures:
        raise AssertionError("failed checks:\n  " + "\n  ".join(failures))
    thesis, dg_run = trainer["trainer"], trainer["dg_trainer"]
    fwd["launches_by_path"] = {"serve": serve_launches, "train": train_fwd,
                               "film_study": study["k1"], "trainer": thesis[0],
                               "trainer_resumed": trainer["resumed"][0],
                               "trainer_infer": trainer["trainer_infer"][0],
                               "trainer_eval": evaluation["k1"],
                               "infer_modes": inference["k1"],
                               # phase 15: both ranks' steps, the world-1 NCCL run, both
                               # ranks of both CLI runs, the two-slab render and the
                               # --shard_rays CLI, the geometry-loss replay
                               "dp_two_ranks": parallel["two_ranks"][0],
                               "dp_nccl_trainer": parallel["nccl"][0],
                               "dp_trainer": parallel["cli"][0],
                               "sharded_render": parallel["sharded"][0],
                               "sharded_infer": parallel["sharded"][1],
                               "tools_geoloss": parallel["tools"]}
    fwd["ms_by_shape"]["voxel grid 64^3"] = inference["timed"]["voxel grid 64^3"]
    fwd["launches"] = sum(fwd["launches_by_path"].values())
    # phase 13's paths: each step path's launches over its warm-up and timed
    # steps, the pyramid's render and CLI run, the dRes requests
    new_paths = {label: counts for label, (counts, _) in variants["steps"].items()}
    new_paths.update(pyramid_serve=variants["pyramid_serve"][0],
                     dres_serve=variants["dres_serve"],
                     pyramid_trainer=variants["pyramid_trainer"][0])
    # phase 14's paths: the conditional and TALLSIREN steps, the cond CLI run
    new_paths.update({f"{label}_train": counts
                      for label, (counts, _) in remaining["steps"].items()})
    new_paths["cond_trainer"] = remaining["cond_trainer"][0]
    new_k = variants["kernels"]
    fwd32["launches_by_path"] = {"dg_serve": dg_k1, "dg_train": dg["k1"],
                                 "dg_trainer": dg_run[0], "dg_infer_modes": inference["dg_k1"],
                                 **{k: c[0] for k, c in new_paths.items()}}
    fwd32["ms_by_shape"]["dg voxel grid 48^3"] = inference["timed"]["dg voxel grid 48^3"]
    fwd32["ms_by_shape"].update(new_k["k1"])
    fwd32["max_abs_err"] = max(fwd32["max_abs_err"], new_k["k1_err"])
    fwd32["launches"] = sum(fwd32["launches_by_path"].values())
    bwd["launches_by_path"] = {"train": train_bwd, "film_study": study["k2"],
                               "dg_train": dg["k2"], "trainer": thesis[1],
                               "trainer_resumed": trainer["resumed"][1],
                               "dg_trainer": dg_run[1], **{k: c[1] for k, c in new_paths.items()},
                               "dp_two_ranks": parallel["two_ranks"][1],
                               "dp_nccl_trainer": parallel["nccl"][1],
                               "dp_trainer": parallel["cli"][1]}
    bwd["launches"] = sum(bwd["launches_by_path"].values())
    bwd["ms_by_shape"].update(bwd32["timed"])
    bwd["ms_by_shape"].update(new_k["k2"])
    bwd["max_abs_err"] = max(bwd["max_abs_err"], bwd32["worst"], new_k["k2_err"])
    tri["launches_by_path"] = {"dg_serve": dg_tri, "dg_train": dg["trilinear"],
                               "dg_trainer": dg_run[2], "dg_infer_modes": inference["dg_trilinear"],
                               **{k: c[2] for k, c in new_paths.items()}}
    tri["launches"] = sum(tri["launches_by_path"].values())
    tri["ms_by_shape"].update(new_k["tri"])
    tri["max_abs_err"] = max(tri["max_abs_err"], new_k["tri_err"])
    tri_bwd["launches_by_path"] = {"dg_train": dg["trilinear_bwd"], "dg_trainer": dg_run[3],
                                   **{k: c[3] for k, c in new_paths.items()}}
    tri_bwd["launches"] = sum(tri_bwd["launches_by_path"].values())
    tri_bwd["ms_by_shape"].update(new_k["tri_bwd"])
    tri_bwd["max_abs_err"] = max(tri_bwd["max_abs_err"], new_k["tri_bwd_err"])
    for row, kernel in zip(study_rows, ("v3", "v4", "v5")):
        row["launches"] = study[kernel]
        row["launches_by_path"] = {"film_study": study[kernel]}
    print(json.dumps({"kernels": [fwd, fwd32, bwd, tri, tri_bwd, *study_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
