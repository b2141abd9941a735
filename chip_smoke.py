#!/usr/bin/env python3
"""Drive the PyTorch port (nbody_tpu_torch) once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. find the card; print its name and nvidia-smi's name and power limit;
  2. build the CUDA kernels from nbody_tpu_torch/csrc with nvcc, one nvcc
     per source, all started together;
  3. hold kernel A's two entries and kernels B-C against their plain
     PyTorch versions on the card, at the main path's shapes (32^3
     particles, batch 4, K 14, window 2): lattice_knn bit-equal at windows
     2 and 3 on the main path's positions and on the undisplaced grid;
     topk_min bit-equal; the gather bit-equal; the segment sum over the
     card's graph plan bit-equal to the CPU plain version at widths 1, 3,
     16, 32 and 64 in f32 and bf16, and identical across two launches; the
     two autograd Functions' gradients bit-equal to the CPU's; time kernel,
     plain version and the one PyTorch call for the same function (torch.
     topk, index_select, index_add_) with CUDA events, and compute each
     kernel's bound from its shapes;
  4. drive the main path through its entry points: Dataset (16 synthetic
     32^3 cubes), Trainer with the coverage guard, 5 bf16 fit steps and
     evaluate on the test split, counting kernel launches; then one train
     step alone, which must launch lattice_knn once, the segment sum 11
     times, the 4-op epilogue's forward and backward 6 times each and
     topk_min never; then time the train step and read the peak
     device memory;
  5. one f32 forward + loss of the same params and cube on the card and on
     the CPU (plain versions) must agree to rtol 1e-4;
  6. hold kernels D-G against their plain versions at the 64^3 index
     route's shapes (cores (4,8,8) and (8,8,8)) and the 32^3 block route's,
     for every width the layers give them: the block plans built on the
     card equal the CPU's; the gathers D/F bit-equal (F in f32 and bf16,
     fast on and off; C 3 too) and identical across two launches, and
     bit-equal on ragged shapes off their 16-byte paths; the segment sums E
     (f32 and bf16 input) and G (f32 and bf16, fast on and off) bit-equal
     to their CPU plain versions and identical across two launches; both
     autograd pairs bit-equal to the CPU's; time kernel (events and device
     time), plain version and library call at every width, with the bound;
     lattice_knn bit-equal to its plain version at 64^3 b1;
  7. the 64^3 shiftinv_vel path through its entry points: Dataset with
     velocities (6 synthetic 64^3 cubes), Trainer with the coverage guard
     (the host k-d tree search), 4 bf16 fit steps at batch 1 on
     --mask_dtype index and evaluate, counting launches (D and E run, B
     and C do not); one train step must launch lattice_knn once, D 12
     times, E 11 times, the 4-op epilogue's forward and backward 6 times
     each (as on every 4-op route below), block_patches and patches_fold
     12 times each (as on the block and int8 routes) and nothing else;
     step time and
     peak memory, also for core (8,8,8);
  8. the --impl block route at 32^3 b4: 3 bf16 fit steps on F and G; one
     train step must launch lattice_knn once, F 12 times, G 11 times and
     nothing else;
  9. the same params and 32^3 batch through the index route (D/E) and the
     direct route (B/C) in bf16: loss within rtol 3e-2, gradient cosine
     above 0.998;
 10. hold kernels H/I (the int8 / packed-int4 mask-dot pair) against their
     plain versions at the 32^3 b4 core (4,8,8) shapes, on masks that
     block_masks builds from the main path's graph, for every width
     (gathers bit-equal, scatters within 1e-5 of the summed |terms|, both
     identical across two launches); then general-valued masks at small
     shapes with ragged tails; kernels H and I bit-equal to their plain
     versions on single-term probe masks (one nonzero of any value per row
     for H, per column for I; every width and C 80); the autograd pair
     against the CPU; time kernel (events and device time), plain version
     and the torch.bmm yardstick on the pre-widened bf16 mask, both at
     every width;
 11. the --mask_dtype int8 route through its entry points: Trainer with the
     coverage guard, 5 bf16 fit steps and evaluate at 32^3 b4, counting
     launches (H and I run; B-G do not); step time and peak memory; one
     int8 train step must launch lattice_knn once, H 12 times and I 12
     times; then 3 fit steps with int4, with the same checks;
 12. the same params and batch through the int8 route and the direct
     route in bf16: loss within rtol 3e-2, gradient cosine above 0.998;
 13. kernel J (the fused layer boundary) on its slice's path, the
     scripts/bench_fused.py workload at full size on the main path's graph
     (bf16 masks, core (4,8,8) at C = q = 32 and at every interior layer
     boundary of shiftinv, (C, q) = (32, 64), (64, 64), (64, 32), (32, 16),
     (16, 3), and core (8,8,8) at C = q = 32): one wrapper call each, which
     must launch J once each; each held against boundary_reference and
     identical across two launches, timed (events and device) beside its
     bound and the unfused chain of bf16 torch.matmul calls; then small
     blocks in f32 (the CUDA-core form) and bf16 (stages that end past ET,
     C 8, q 3, C = q = 64, f32 weights, a forced cluster of 2);
 14. the run around the step (Trainer.fit_scan: the first step eager on a
     side stream, then one CUDA graph of the train step replayed once a
     step): (a) 10 steps of eager fit and of fit_scan (T 5) from two fresh
     trainers and one minibatch generator, f32 (losses rtol 1e-5, params
     rtol 1e-5 / atol 1e-6) and bf16 (losses rtol 1e-3), printing whether
     they are bit-equal; (b) the launches the capture records equal the
     eager step's and STEP_LAUNCHES, a replay adds exactly its capture's
     launches (20 replays, 20 times; the capture itself counts none), and
     torch.profiler sees kernels A, B and C once a step in a replayed
     chunk; (c) ms a step by CUDA events, host ms a step and peak memory,
     eager and graph, over 20 steps after warm-up, with the device busy
     time a step (idle share) and the host time of one step on an idle
     card; (d) the index (64^3
     shiftinv_vel b1), block, int8 and int4 routes each captured: 3 steps
     (the eager first, 2 replayed) against 3 eager steps, loss rtol 1e-3;
     (e) the CLI in-process under a temporary NBODY_EXPERIMENTS_DIR:
     train --scan 10 -i 20 with device data and -n, eval -n (restores step
     20, the same median line, the (2, 4, 32768, 3) cube, the baseline
     line), -r -i 10 (chkpt-30.pt), and --trace of a 3-step run (the
     kernels' names in the chrome trace);
 15. the set and attn families (no kernel of the repo runs in them): the
     same f32 params and batch on the card and on the CPU (set, CHANNELS,
     16^3 b4; attn, ATTN_CHANNELS, 32^3 b10, train and eval mode): loss and
     forward (relative L2) within rtol 1e-4, and the card's largest
     deviation from the CPU's f64 forward within 1e-4 of the largest
     output or twice the CPU f32 forward's own, whichever is larger; 200 bf16 fit steps of set at 16^3, lr
     3e-3 (the verify recipe), the loss falling more than 2x; 3 steps of
     fit_scan's graph against 3 eager steps for each family (loss rtol
     1e-3, no wrapper launch); eager and graph ms a step, idle share and
     peak memory of both; cli.experiment -i 20 --cells 16 --synthetic
     in-process, its test median finite and its run written;
 16. the redshift-chain rollout at full width: cli.rollout in-process
     (shiftinv GRAPH_CHANNELS, 32^3 synthetic chain, K 14, bf16, --steps
     4, -i 20 a pair, -b 4, -t 8, window 3), its JSON line finite with
     lin_chain[0] == lin_reset[0], then the same at window 2 where every
     pair's exact guard lets it; one make_rollout call must launch
     exactly lattice_knn 1, the gather 7 and the segment sum 6 times a
     hop, and the epilogue's forward 6; the same stacked f32 params and
     x0 (32^3 b2) on the card and on the CPU, per-hop MSE within rtol 1e-4
     and equal per-hop coverage
     counts; ms a hop by CUDA events, idle share under torch.profiler and
     peak memory;
 17. the 15-op family (shiftinv15, GRAPH_CHANNELS, 32^3 b4, K 14, window
     2, bf16) and the graph options both graph families share: (a) the
     fused edge epilogue and the transpose's assembly
     (csrc/edge_epilogue.cu) at every layer's (C, q), f32 and layer 0's
     bf16, against their twins (the unfused chain) bit for bit forward,
     the backward's sums within 1e-5 of their |terms|, repeatable, timed
     beside their bounds and the unfused chain; kernel
     B at K' = 1 over the reverse-edge lookup's (4, 32768*14, C) table, C
     3-64 in f32 and bf16, bit-equal, and C over the lookup's plan
     bit-equal to the CPU and identical across two launches; D/E (core
     (8,8,8)), F/G and H/I (int8, core (8,8,8)) at widths 96 and 128, held
     as in phases 6 and 10; each timed beside its plain version, library
     call and bound; (b) the symmetrized graph built on the card equal to
     the CPU's, bit for bit; (c) Dataset -> Trainer with the coverage
     guard -> 5 bf16 fit steps -> evaluate on the direct route, one train
     step launching exactly S15_STEP_LAUNCHES, eager and graph step times
     with idle share and peak memory; the index, int8 and block routes 3
     steps each, eager against fit_scan's graph (loss rtol 1e-3), with
     their own launch constants; (d) card vs CPU f32 loss and forward
     (relative L2; 32^3 b1, rtol 1e-4), the index, int8 and block routes against the
     direct route in bf16 (loss rtol 3e-2, gradient cosine > 0.998), and
     fit_scan against fit over 3 steps (loss rtol 1e-3); (e) cli.train
     --model shiftinv15 --scan 5 -i 10 then cli.eval, cli.train --impl
     banded -i 3 and --remat -i 3 on the main path; (f) --remat on the main
     path (32^3 b4 f32): gradients equal the plain step's (rtol 1e-6),
     REMAT_STEP_LAUNCHES, peak memory and step time of both, and the remat
     step captured by fit_scan; (g) the exact and banded kNN at 32^3 b1
     equal the CPU's, and a non-cube forward (32^3 - 1 points, the exact
     search) against the CPU's: ids equal, loss and forward (relative L2)
     within rtol 1e-4;
 18. the program's tracing (nbody_tpu_torch/tracing.py) on the main path,
     32^3 b4 bf16: an eager step and a rollout hop with no profiler create
     no CUDA event; the capture makes one external timing event a mark of
     the step's timeline; a chunk of 10 replays moves graph.replays by 10,
     graph.captures by 0, every launch counter by 10 times the capture's
     (STEP_LAUNCHES) and loss.particles by 10 b N; the replayed timeline
     sums to within 5 % of a profiled replay's extent on the card; a
     profiled fit_scan takes one sample a chunk and shows the program's
     spans;
 19. the 4-op layer's epilogue (csrc/epilogue4.cu) against its twins (the
     unfused chain, on the card): at every layer's (C, q) of
     GRAPH_CHANNELS on the 32^3 b4 cube form in bf16 (h1 the strided
     slice of the joint product where q < C, relu but on the last layer)
     and three of them in f32, and at the velocity net's q 64 and last
     layer (16, 6) on the 64^3 b4 block-major form (core (4, 8, 8)): the
     forward bit-equal, the backward's masked gradient equal and its sums
     within 1e-5 of their |terms| (plus one bf16 unit), both repeatable,
     one launch counted each; each timed beside its logical bytes' bound
     and the unfused chain (forward; autograd's backward of it), its
     kernels' names in the benchmark's "other" bucket;
 20. the masked route's block layout (csrc/block_layout.cu):
     block_patches and patches_fold against their plain versions (run on
     the card and, for the fold, on the CPU) at every width the velocity
     step (64^3 b4, core (4, 8, 8)) and the 15-op index step (32^3 b4,
     core (8, 8, 8)) give them and at the counts' width 1, in f32 and
     bf16, and at 32^3 b4 core (4, 4, 8) (--impl block) at C 64: bit-equal,
     repeatable, one launch counted each; timed beside their bytes'
     bound and the plain versions; their names in the benchmark's "other"
     bucket.  The launches of one step on every block-layout route are
     pinned in phases 7, 8, 11, 14 and 17 (BLOCK_LAYOUT_STEP_LAUNCHES and
     its 15-op counts; none on a direct-route step).
The line before the last is {"kernels": [...]}, all nineteen kernels with
their bounds (H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s FP32, 989 TFLOP/s bf16
tensor cores); the last line is {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark_torch.yardstick import peaks
# the bounds' denominators: the H100 SXM's published peaks
from benchmark_torch.yardstick.peaks import H100_BF16_TC_OPS, H100_FP32_OPS

CELLS, BATCH, K, WINDOW = 32, 4, 14, 2
WIDTHS = (3, 16, 32, 64)          # the layer widths the gather/scatter see
SEG_WIDTHS = (1,) + WIDTHS        # and the segment sum's, counts included
# the 4-op layer's epilogue (ops/kernels/epilogue4.py) on every route of
# a 4-op train step: its forward and its backward once a layer
EPILOGUE4_STEP_LAUNCHES = {"epilogue4_forward": 6, "epilogue4_backward": 6}
# the masked and block routes' layout (ops/kernels/block_layout.py) on a
# 4-op train step: block_patches before each of the 12 gathers of D, F or
# H, patches_fold after each of the 12 scatters or counts of E, G or I
# (on the index and block routes the 12th fold is the in-degree counts')
BLOCK_LAYOUT_STEP_LAUNCHES = {"block_patches": 12, "patches_fold": 12}
# launches of one main-path train step: the graph build, the segment
# sum's 6 forward scatter-means + 5 gradients of the gathers, the epilogue;
# no block layout on the direct route
STEP_LAUNCHES = {"lattice_knn": 1, "topk_min": 0, "neighbor_segment_sum": 11,
                 "block_patches": 0, "patches_fold": 0,
                 **EPILOGUE4_STEP_LAUNCHES}
# every launch of one train step on the 64^3 index route and the 32^3
# block route: the features' gather, 6 forward and 5 backward gathers; the
# 6 forward scatter-means and 5 gradients of the gathers (the in-degree
# counts come off the block plan, with no launch); the epilogue; the layout
INDEX_STEP_LAUNCHES = {"lattice_knn": 1, "idx_dot_gather": 12, "idx_dot_scatter": 11,
                       **EPILOGUE4_STEP_LAUNCHES, **BLOCK_LAYOUT_STEP_LAUNCHES}
BLOCK_STEP_LAUNCHES = {"lattice_knn": 1, "block_gather": 12, "block_scatter": 11,
                       **EPILOGUE4_STEP_LAUNCHES, **BLOCK_LAYOUT_STEP_LAUNCHES}
# and on the int8 route: the features' gather, 6 forward and 5 backward
# gathers (H); the in-degree count, 6 forward scatter-means and 5
# gradients of the gathers (I); the epilogue; the layout
INT8_STEP_LAUNCHES = {"lattice_knn": 1, "mask_dot_gather": 12, "mask_dot_scatter": 12,
                      **EPILOGUE4_STEP_LAUNCHES, **BLOCK_LAYOUT_STEP_LAUNCHES}
CELLS64 = 64
# phase 15: set at BASELINE config 1 (16^3 b4), attn at the reference's b10
SET_CELLS, SET_BATCH, ATTN_BATCH = 16, 4, 10
# phase 16: the chain's hops, and every launch of one rollout hop on the
# main path's model (models/shiftinv.py): the graph build, the features'
# gather and one gather a layer (B), one scatter-mean a layer (C), the
# epilogue's forward once a layer
CHAIN_STEPS = 4
ROLLOUT_HOP_LAUNCHES = {"lattice_knn": 1, "neighbor_gather": 7,
                        "neighbor_segment_sum": 6, "epilogue4_forward": 6}
# phase 17: the 15-op family (models/shiftinv15.py).  Widths of the
# reverse-edge lookup (kernel B at K' = 1 over the (b, N*K, C) edge table,
# C = the layer's input or output width, whichever is smaller) and the
# block-major routes' fused widths 2C and 2q beyond 64
LOOKUP_WIDTHS = (3, 16, 32, 64)
WIDE_WIDTHS = (96, 128)
CORE_15 = (8, 8, 8)
# every launch of one 15-op train step on the direct route: forward A 1;
# the symmetrized graph's id gather B 1 and degree C 1; the features'
# gather B 1; a layer's fused pool scatter C 1, reverse-edge lookup B 1
# and col and row broadcast gathers B 2; the last layer's row pool C 1
# (B 20, C 8).  Backward: layer 0's input needs no gradient, so only its
# broadcasts' gradients C 2; layers 1-5 the pool scatter's B 1, the
# lookup's C 1 and the broadcasts' C 2; the row pool's B 1 (B 6, C 17)
# and the fused edge epilogue (ops/kernels/edge_epilogue.py): its forward
# and backward once a layer, the transpose's assembly once a widening
# layer (0-2) and its backward in layers 1-2 (layer 0's input needs none)
S15_EPILOGUE_LAUNCHES = {"edge_epilogue_forward": 6, "edge_epilogue_backward": 6,
                         "edge_transpose_forward": 3, "edge_transpose_backward": 2}
S15_STEP_LAUNCHES = {"lattice_knn": 1, "neighbor_gather": 26,
                     "neighbor_segment_sum": 25, **S15_EPILOGUE_LAUNCHES}
# the block-major routes (core (8,8,8)): B 7 (the id gather, one lookup a
# layer) and C 6 (the degree, five lookup gradients); the mask gather 13
# (the features' gather and one fused gather a layer, five fused-scatter
# gradients and the row pool's) and the mask scatter 13 (one fused
# scatter a layer and the row pool, six fused-gather gradients), and the
# layout around each of them
S15_INDEX_STEP_LAUNCHES = {"lattice_knn": 1, "neighbor_gather": 7,
                           "neighbor_segment_sum": 6, "idx_dot_gather": 13,
                           "idx_dot_scatter": 13, "block_patches": 13,
                           "patches_fold": 13}
S15_INT8_STEP_LAUNCHES = {"lattice_knn": 1, "neighbor_gather": 7,
                          "neighbor_segment_sum": 6, "mask_dot_gather": 13,
                          "mask_dot_scatter": 13, "block_patches": 13,
                          "patches_fold": 13}
# the block route (the cube form on F/G): B 7 and C 6 as above; F 19 (the
# features' gather, two broadcasts a layer, the gradients of layers 1-5's
# pool scatters and of the row pool) and G 19 (a pool scatter a layer, the
# row pool, the twelve broadcasts' gradients), and the layout around each
S15_BLOCK_STEP_LAUNCHES = {"lattice_knn": 1, "neighbor_gather": 7,
                           "neighbor_segment_sum": 6, "block_gather": 19,
                           "block_scatter": 19, "block_patches": 19,
                           "patches_fold": 19, **S15_EPILOGUE_LAUNCHES}
# --remat: every layer's forward runs again in the backward pass: the
# 4-op main step adds B 6, C 6 and the 4-op epilogue's forward 5 (the last
# layer's recompute stops before its epilogue, which saves nothing), the
# 15-op direct step B 18 and C 7, the epilogue's forward 6 and the
# transpose's 3
REMAT_STEP_LAUNCHES = {"lattice_knn": 1, "neighbor_gather": 18,
                       "neighbor_segment_sum": 17, "epilogue4_forward": 11,
                       "epilogue4_backward": 6}
S15_REMAT_STEP_LAUNCHES = {"lattice_knn": 1, "neighbor_gather": 44,
                           "neighbor_segment_sum": 32, "edge_epilogue_forward": 12,
                           "edge_epilogue_backward": 6, "edge_transpose_forward": 6,
                           "edge_transpose_backward": 2}
# widths the block-selection kernels see on shiftinv_vel: counts, the
# payload gather (disp + vel), and the channels 9-32-64-64-32-16-6
SELECT_WIDTHS = (1, 6, 9, 16, 32, 64)
# and the gathers' on the 32^3 block route too (channels 3-32-64-64-32-16-3)
GATHER_WIDTHS = (1, 3, 6, 9, 16, 32, 64)
INDEX_CORES = ((4, 8, 8), (8, 8, 8))
BLOCK_SRC = "nbody_tpu_torch/csrc/block_kernels.cu"
MASK_SRC = "nbody_tpu_torch/csrc/mask_kernels.cu"
EPILOGUE_SRC = "nbody_tpu_torch/csrc/edge_epilogue.cu"
EPILOGUE4_SRC = "nbody_tpu_torch/csrc/epilogue4.cu"
BLOCK_LAYOUT_SRC = "nbody_tpu_torch/csrc/block_layout.cu"
# widths the mask-dot kernels see on the int8 route: the counts, the
# displacement gather and the channels 3-32-64-64-32-16-3
MASK_WIDTHS = (1, 3, 16, 32, 64)
MASK_CORE = (4, 8, 8)
# kernel J's (C, q) at the interior layer boundaries of shiftinv (channels
# 3-32-64-64-32-16-3), the bench_fused shape C = q = 32 first
FUSED_BOUNDARIES = ((32, 32), (32, 64), (64, 64), (64, 32), (32, 16), (16, 3))
REPO_KERNELS = {
    "lattice_knn": ("nbody_tpu_torch/csrc/topk_kernels.cu",
                    "nbody_tpu/ops/pallas/topk_kernels.py:46"),
    "topk_min": ("nbody_tpu_torch/csrc/topk_kernels.cu",
                 "nbody_tpu/ops/pallas/topk_kernels.py:46"),
    "neighbor_gather": ("nbody_tpu_torch/csrc/banded_kernels.cu",
                        "nbody_tpu/ops/pallas/banded_kernels.py:113"),
    "neighbor_segment_sum": ("nbody_tpu_torch/csrc/banded_kernels.cu",
                             "nbody_tpu/ops/pallas/banded_kernels.py:170"),
    "idx_dot_gather": (BLOCK_SRC, "nbody_tpu/ops/pallas/idx_kernels.py:169"),
    "idx_dot_scatter": (BLOCK_SRC, "nbody_tpu/ops/pallas/idx_kernels.py:179"),
    "block_gather": (BLOCK_SRC, "nbody_tpu/ops/pallas/block_kernels.py:34"),
    "block_scatter": (BLOCK_SRC, "nbody_tpu/ops/pallas/block_kernels.py:67"),
    "mask_dot_gather": (MASK_SRC, "nbody_tpu/ops/pallas/mask_kernels.py:112"),
    "mask_dot_scatter": (MASK_SRC, "nbody_tpu/ops/pallas/mask_kernels.py:133"),
    "fused_boundary_dot": ("nbody_tpu_torch/csrc/fused_kernels.cu",
                           "nbody_tpu/ops/pallas/fused_kernels.py:66"),
    # the 15-op layer's edge epilogue and transpose replace no TPU kernel:
    # XLA fuses the chain they do
    **{n: (EPILOGUE_SRC, "none (the XLA-fused chain)")
       for n in ("edge_epilogue_forward", "edge_epilogue_backward",
                 "edge_transpose_forward", "edge_transpose_backward")},
    # and so does the 4-op layer's epilogue
    **{n: (EPILOGUE4_SRC, "none (the XLA-fused chain)")
       for n in ("epilogue4_forward", "epilogue4_backward")},
    # the block layout replaces XLA's pad, strided slices and slice-adds
    **{n: (BLOCK_LAYOUT_SRC, "none (the XLA pad, slices and slice-adds of "
                             "nbody_tpu/ops/blocked.py:122-201)")
       for n in ("block_patches", "patches_fold")},
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_profile(fn, iters):
    """[(kernel name, self device us, launches)] of the CUDA kernels that
    `iters` calls of fn launch, summed by torch.profiler after one warm-up
    call.  A profile that caught no kernel at all (seen on the card, in
    windows of launches that ran) is taken again, at most twice, and said
    so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for window in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(r[1] for r in rows) > 0:
            return rows
        print(f"cuda_profile: window {window} of {iters} calls caught no kernel")
    raise RuntimeError("chip_smoke: torch.profiler saw no device time in "
                       "three windows")


def device_ms(fn, iters=10):
    """Mean device time of one call of fn: the self time of every CUDA
    kernel it launches (the host's time between launches excluded, which
    cuda_ms includes)."""
    return sum(us for _, us, _ in cuda_profile(fn, iters)) / iters / 1e3


def device_top(fn, iters, per, top=8):
    """The `top` CUDA kernels of fn by self device time under
    torch.profiler: [(name, ms, launches), ...] per 1/`per` of a call."""
    rows = sorted(((n[:60], us / iters / per / 1e3, c / iters / per)
                   for n, us, c in cuda_profile(fn, iters)), key=lambda r: -r[1])
    return [(n, round(ms, 4), c) for n, ms, c in rows[:top]]


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (2^-8 at 0)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops=0.0, ops_rate=H100_FP32_OPS):
    """(bound_ms, bound_by): peaks.bound, the least time the card could
    take for the work, in milliseconds."""
    t, by = peaks.bound(n_bytes, ops, ops_rate)
    return t * 1e3, by


def set_bound(rec, n_bytes, ops=0.0, ops_rate=H100_FP32_OPS):
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, ops, ops_rate)


def check_knn_kernels(dev, pos_norm):
    """Kernel A's two entries against their plain versions on the card:
    lattice_knn bit-equal at 32^3 b4 windows 2 and 3 on the main path's
    positions and on the undisplaced (tie-heavy) grid, k = 32 too;
    topk_min bit-equal on lattice, random, tied and inf/NaN rows.  Times,
    bounds and library times.  Returns per-kernel records."""
    from nbody_tpu_torch.data.grid import grid_positions
    from nbody_tpu_torch.ops.kernels import topk_kernels as T

    g = torch.Generator(device=dev).manual_seed(0)
    rec = {name: {"max_abs_err": 0.0, "library_ms": None}
           for name in ("lattice_knn", "topk_min")}
    b, n, _ = pos_norm.shape
    grid = grid_positions(CELLS, box=1.0, device=dev).expand(b, n, 3).contiguous()
    for label, pos in (("main-path positions", pos_norm), ("undisplaced grid", grid)):
        for w, k in ((WINDOW, K), (3, K), (3, 32)):
            got, want = T.lattice_knn(pos, k, CELLS, w), T.lattice_knn_plain(pos, k, CELLS, w)
            bad = int((got != want).any(dim=-1).sum())
            rec["lattice_knn"]["max_abs_err"] = max(
                rec["lattice_knn"]["max_abs_err"], float((got - want).abs().max()))
            print(f"kernel A lattice_knn {label} ({b}, {n}) window {w} k={k}: "
                  f"{bad} rows differ")
            check(bad == 0, f"lattice_knn {label} w={w} k={k} differs from the "
                            "plain version")
    r = rec["lattice_knn"]
    r["ms"] = cuda_ms(lambda: T.lattice_knn(pos_norm, K, CELLS, WINDOW))
    r["plain_ms"] = cuda_ms(lambda: T.lattice_knn_plain(pos_norm, K, CELLS, WINDOW),
                            iters=5)
    m = (2 * WINDOW + 1) ** 3
    # positions in, ids out; ~20 FP32 operations per candidate (3 x (sub,
    # div, rint, mul, sub, mul) + 2 adds)
    set_bound(r, nbytes(pos_norm) + b * n * K * 4, 20.0 * b * n * m)

    d2 = T.lattice_sq_dist(pos_norm, CELLS, window=WINDOW).reshape(b * n, m)
    rows = d2.shape[0]
    d_rand = torch.rand((rows, m), generator=g, device=dev)
    d_bad = d_rand.clone()
    d_bad[torch.rand((rows, m), generator=g, device=dev) < 0.2] = float("inf")
    d_bad[torch.rand((rows, m), generator=g, device=dev) < 0.2] = float("nan")
    d_bad[:64] = float("inf")
    for label, d in (("lattice", d2), ("random", d_rand),
                     ("ties", torch.floor(d_rand * 8.0)), ("inf/nan", d_bad)):
        got, want = T.topk_min(d, K), T.topk_min_plain(d, K)
        bad = int((got != want).any(dim=1).sum())
        rec["topk_min"]["max_abs_err"] = max(
            rec["topk_min"]["max_abs_err"], float((got - want).abs().max()))
        print(f"kernel A topk_min {label} ({rows}, {m}) k={K}: "
              f"{bad} rows differ")
        check(bad == 0, f"topk_min {label} rows differ from the plain version")
    # the kernel's second instance (16 < k <= 32)
    check(torch.equal(T.topk_min(d_rand, 32), T.topk_min_plain(d_rand, 32)),
          "topk_min k=32 differs from the plain version")
    print("kernel A topk_min random k=32: bit-equal")
    r = rec["topk_min"]
    r["ms"] = cuda_ms(lambda: T.topk_min(d2, K))
    r["plain_ms"] = cuda_ms(lambda: T.topk_min_plain(d2, K))
    r["library_ms"] = cuda_ms(lambda: torch.topk(d2, K, largest=False, sorted=True))
    set_bound(r, nbytes(d2) + rows * K * 4, float(rows * m))
    for name, r in rec.items():
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; 32^3 b4 w{WINDOW} k{K})")
    return rec


def check_kernels(dev, idx):
    """Kernels B and C against their plain versions at the main path's
    shapes (32^3 b4 K14): the gather bit-equal, the segment sum over the
    card's graph plan bit-equal to the CPU plain version at every width in
    f32 and bf16 and identical across two launches; both autograd
    Functions against the CPU; times, bounds and library times.  Returns
    per-kernel records."""
    from nbody_tpu_torch.ops.kernels import banded_kernels as B
    from nbody_tpu_torch.ops.route import Route

    g = torch.Generator(device=dev).manual_seed(0)
    rec = {name: {"max_abs_err": 0.0}
           for name in ("neighbor_gather", "neighbor_segment_sum")}
    b, n, k = idx.shape
    idx_cpu = idx.cpu()
    plan = B.graph_plan(idx)
    plan_cpu = B.graph_plan(idx_cpu)
    check(all(torch.equal(a.cpu(), c) for a, c in zip(plan, plan_cpu)),
          "the card's graph plan differs from the CPU's")
    degree = plan_cpu.in_degree(b, n)
    print(f"graph plan: {plan.order.numel()} edges, in-degree min "
          f"{int(degree.min())} mean {float(degree.mean()):.2f} max "
          f"{int(degree.max())}; equal to the CPU's")
    for c in SEG_WIDTHS:
        for dt in (torch.float32, torch.bfloat16):
            e = torch.randn((b, n, k, c), generator=g, device=dev).to(dt)
            got = B.neighbor_segment_sum(e, plan)
            again = B.neighbor_segment_sum(e, plan)
            want = B.scatter_add_plain(e.cpu(), idx_cpu)
            err = float((got.cpu().float() - want.float()).abs().max())
            rec["neighbor_segment_sum"]["max_abs_err"] = max(
                rec["neighbor_segment_sum"]["max_abs_err"], err)
            equal = torch.equal(got.cpu(), want)
            print(f"kernel C segment sum C={c:>2} {str(dt):>14}: bit-equal to the "
                  f"CPU plain version {equal} (max|err| {err:.3e}); two launches "
                  f"identical {torch.equal(got, again)}")
            check(equal and got.dtype == dt, f"neighbor_segment_sum C={c} {dt} "
                                             "is not bit-equal to the CPU")
            check(torch.equal(got, again), f"neighbor_segment_sum C={c} {dt} "
                                           "differs between two launches")
            if c in WIDTHS:
                v = torch.randn((b, n, c), generator=g, device=dev).to(dt)
                got, want = B.neighbor_gather(v, idx), B.gather_plain(v, idx)
                rec["neighbor_gather"]["max_abs_err"] = max(
                    rec["neighbor_gather"]["max_abs_err"],
                    float((got.float() - want.float()).abs().max()))
                check(torch.equal(got, want),
                      f"neighbor_gather C={c} {dt} is not bit-equal")
    print(f"kernel B gather C in {WIDTHS}, f32 and bf16: bit-equal")

    # the autograd Functions: each gradient is the other kernel (the
    # gather's over the plan); the card's gradients against the CPU's
    c = 16
    v = torch.randn((b, n, c), generator=g, device=dev, requires_grad=True)
    ct = torch.randn((b, n, k, c), generator=g, device=dev)
    route, route_cpu = Route("direct", idx, plan), Route.direct(idx_cpu)
    (gv,) = torch.autograd.grad(route.gather(v), v, ct)
    vc = v.detach().cpu().requires_grad_()
    (gvc,) = torch.autograd.grad(route_cpu.gather(vc), vc, ct.cpu())
    e = torch.randn((b, n, k, c), generator=g, device=dev, requires_grad=True)
    ct2 = torch.randn((b, n, c), generator=g, device=dev)
    (ge,) = torch.autograd.grad(route.scatter_add(e), e, ct2)
    ec = e.detach().cpu().requires_grad_()
    (gec,) = torch.autograd.grad(route_cpu.scatter_add(ec), ec, ct2.cpu())
    print(f"autograd: gather grad (kernel C) bit-equal {torch.equal(gv.cpu(), gvc)}; "
          f"scatter grad (kernel B) bit-equal {torch.equal(ge.cpu(), gec)}")
    check(torch.equal(gv.cpu(), gvc) and torch.equal(ge.cpu(), gec),
          "gradients disagree")

    c = 64
    v = torch.randn((b, n, c), generator=g, device=dev).to(torch.bfloat16)
    e = torch.randn((b, n, k, c), generator=g, device=dev).to(torch.bfloat16)
    ids = B._flat_targets(idx, n)
    r = rec["neighbor_gather"]
    r["ms"] = cuda_ms(lambda: B.neighbor_gather(v, idx))
    r["plain_ms"] = cuda_ms(lambda: B.gather_plain(v, idx))
    vflat = v.reshape(b * n, c)
    r["library_ms"] = cuda_ms(lambda: vflat.index_select(0, ids))
    set_bound(r, nbytes(v, idx, e))          # out is e's size
    r = rec["neighbor_segment_sum"]
    out = B.neighbor_segment_sum(e, plan)
    r["ms"] = cuda_ms(lambda: B.neighbor_segment_sum(e, plan))
    r["plain_ms"] = cuda_ms(lambda: B.segment_sum_plain(e, plan))
    ef = e.float().reshape(-1, c)
    acc = torch.zeros((b * n, c), device=dev)
    r["library_ms"] = cuda_ms(lambda: acc.index_add_(0, ids, ef))
    set_bound(r, nbytes(e, plan.order, plan.offsets, out), float(e.numel()))
    plan_ms = cuda_ms(lambda: B.graph_plan(idx))
    for name, r in rec.items():
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; C={c} bf16)")
    print(f"time graph_plan (stable sort + search, plain torch): {plan_ms:.4f} ms")
    return rec


def scatter_worst(got, want, absum, bf16_out):
    """(max |err|, max(|err| - tol)) of a dense product: f32 sums within
    1e-5 of the summed |terms| (the order of the adds differs from the
    plain version's); a bf16 result one bf16 ulp more."""
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * absum + (bf16_ulp(want) if bf16_out else 0)
    return float(err.max()), float((err - tol).max())


def hold_segment_sum(name, kern, plain_cpu, note, label):
    """A segment-sum scatter (E or G) on the card: bit-equal to its plain
    version on the CPU, and identical across two launches."""
    got, again = kern(), kern()
    want = plain_cpu()
    err = float((got.cpu() - want).abs().max())
    note(name, err)
    equal, same = torch.equal(got.cpu(), want), torch.equal(got, again)
    check(equal, f"{name} {label} is not bit-equal to the CPU plain version "
                 f"(max|err| {err:.3e})")
    check(same, f"{name} {label} differs between two launches")


def scatter_library(plan, x, p_size):
    """One index_add_ of the f32 edge rows into per-block (P + 1)-row
    sums (a position outside the patch lands in a sink row): the call."""
    pos = plan.pos
    blocks = pos.shape[0] * pos.shape[1]
    blk = torch.arange(blocks, device=pos.device).reshape(pos.shape[:2] + (1,))
    valid = (pos >= 0) & (pos < p_size)
    ids = torch.where(valid, blk * (p_size + 1) + pos,
                      blk * (p_size + 1) + p_size).reshape(-1)
    vf = x.float().reshape(-1, x.shape[-1])
    acc = torch.zeros((blocks * (p_size + 1), x.shape[-1]), device=x.device)
    return lambda: acc.index_add_(0, ids, vf)


def scatter_bound(plan, x, out):
    """The segment sum's bound: the plan's order and offsets and the
    valid edge rows read once, the f32 output written once; one add per
    valid element."""
    n_valid = int(plan.offsets[-1])
    c = x.shape[-1]
    return bound(nbytes(plan.order, plan.offsets, out)
                 + n_valid * c * x.element_size(), float(n_valid * c))


def check_select_kernels(dev, idx64, idx32):
    """Kernels D-G against their plain versions at the 64^3 index route's
    and the 32^3 block route's shapes: the gathers bit-equal, the segment
    sums E and G over the card's block plan (equal to the CPU's) bit-equal
    to their CPU plain versions at every width, f32 and bf16 x fast, and
    identical across two launches; both autograd pairs against the CPU;
    kernel, plain version and library call timed at every width.  Returns
    per-kernel records."""
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import block_kernels as BK
    from nbody_tpu_torch.ops.kernels import idx_kernels as IK
    from nbody_tpu_torch.ops.route import Route

    g = torch.Generator(device=dev).manual_seed(1)
    rec = {n: {"max_abs_err": 0.0}
           for n in ("idx_dot_gather", "idx_dot_scatter", "block_gather",
                     "block_scatter")}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def plans(plan, p):
        cpu = BK.block_plan(plan.pos.cpu(), p)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(plan, cpu)),
              "the card's block plan differs from the CPU's")
        deg = cpu.site_degree()
        plan_ms = cuda_ms(lambda: BK.block_plan(plan.pos, p))
        print(f"block plan {tuple(plan.pos.shape)} P={p}: {int(cpu.offsets[-1])} "
              f"valid edges, site degree max {int(deg.max())}, empty sites "
              f"{float((deg == 0).float().mean()):.3f}; equal to the CPU's; "
              f"build {plan_ms:.4f} ms (stable sort + search, plain torch)")
        return cpu

    bf = torch.bfloat16
    plan_by_core = {}
    for core in INDEX_CORES:
        p = blocked.patch_size(CELLS64, WINDOW, core)
        plan = blocked.block_index_plan(idx64, CELLS64, WINDOW, core,
                                        drop_self_slot0=True)
        plan_cpu = plans(plan, p)
        plan_by_core[core] = (plan, p)
        pos = plan.pos
        _, nb, et = pos.shape
        for c in GATHER_WIDTHS:
            pat = randn((1, nb, p, c), bf)
            got, want = IK.dot_gather(pos, pat), IK.dot_gather_plain(pos, pat)
            note("idx_dot_gather", float((got.float() - want.float()).abs().max()))
            check(torch.equal(got, want), f"idx_dot_gather {core} C={c} not bit-equal")
            check(torch.equal(got, IK.dot_gather(pos, pat)),
                  f"idx_dot_gather {core} C={c} differs between two launches")
            for dt in (torch.float32, bf):
                ev = randn((1, nb, et, c), dt)
                hold_segment_sum(
                    "idx_dot_scatter", lambda: IK.dot_scatter(plan, ev, p),
                    lambda: IK.dot_scatter_plain(plan_cpu, ev.cpu(), p), note,
                    f"{core} C={c} {dt}")
            print(f"kernels D/E core {core} (1, {nb}, {et}) P={p} C={c:>2}: "
                  "gather bit-equal; segment sum bit-equal to the CPU (f32 and "
                  "bf16 input); both identical across launches")

    plan32 = blocked.block_index_plan(idx32, CELLS, WINDOW, blocked.CORE)
    pp32 = blocked.patch_size(CELLS, WINDOW, blocked.CORE)
    plan32_cpu = plans(plan32, pp32)
    p32 = plan32.pos
    b, nb, et = p32.shape
    for c in GATHER_WIDTHS:
        for dt in (torch.float32, bf):
            for fast in (True, False):
                pat = randn((b, nb, pp32, c), torch.float32).to(dt)
                got = BK.block_gather(p32, pat, fast)
                want = BK.block_gather_plain(p32, pat, fast)
                note("block_gather", float((got - want).abs().max()))
                check(torch.equal(got, want),
                      f"block_gather C={c} {dt} fast={fast} not bit-equal")
                check(torch.equal(got, BK.block_gather(p32, pat, fast)),
                      f"block_gather C={c} {dt} fast={fast} differs between "
                      "two launches")
                ev = randn((b, nb, et, c), torch.float32).to(dt)
                hold_segment_sum(
                    "block_scatter", lambda: BK.block_scatter(plan32, ev, pp32, fast),
                    lambda: BK.block_scatter_plain(plan32_cpu, ev.cpu(), pp32, fast),
                    note, f"C={c} {dt} fast={fast}")
        print(f"kernels F/G (4, {nb}, {et}) P={pp32} C={c:>2}: gathers "
              "bit-equal; segment sums bit-equal to the CPU; all identical "
              "across launches (f32/bf16 x fast on/off)")

    # ragged shapes off the gathers' 16-byte paths: P 61, ET 203 (ET * C not
    # whole vectors: one element an access), and C 64 patches 2 bytes past
    # a 16-byte boundary (16-byte output vectors, elements loaded one by one)
    rpos = torch.randint(-3, 64, (2, 3, 203), generator=g, device=dev,
                         dtype=torch.int32)
    for c in (3, 5):
        for dt, fast in ((bf, False), (torch.float32, True)):
            pat = randn((2, 3, 61, c), dt)
            got, want = BK.block_gather(rpos, pat, fast), BK.block_gather_plain(rpos, pat, fast)
            check(torch.equal(got, want) and torch.equal(got, BK.block_gather(rpos, pat, fast)),
                  f"block_gather ragged C={c} {dt} not bit-equal or not repeatable")
            note("block_gather", float((got.float() - want.float()).abs().max()))
        got = IK.dot_gather(rpos, pat)
        check(torch.equal(got, IK.dot_gather_plain(rpos, pat)),
              f"idx_dot_gather ragged C={c} not bit-equal")
    n64 = 3 * 61 * 64
    pat = randn((n64 + 1,), bf)[1:].view(1, 3, 61, 64)
    tl = BK.gather_tiling(203, 64, 2, pat.data_ptr() % 16 == 0, True)
    check(tl.path == BK.FLAT, f"misaligned patches take path {tl.path}")
    got = IK.dot_gather(rpos[:1], pat)
    check(torch.equal(got, IK.dot_gather_plain(rpos[:1], pat)),
          "idx_dot_gather on misaligned patches not bit-equal")
    print("gathers D/F on ragged shapes (P 61, ET 203, C 3 and 5, f32 fast and "
          "bf16; C 64 patches off a 16-byte boundary): bit-equal, repeatable")

    # autograd pairs, card against the CPU's plain versions: bit-equal
    plan, p = plan_by_core[INDEX_CORES[0]]
    plan_cpu = BK.BlockPlan(*(t.cpu() for t in plan))
    _, nb, et = plan.pos.shape
    pat = randn((1, nb, p, 16), bf).requires_grad_()
    ct = randn((1, nb, et, 16), bf)
    (gp,) = torch.autograd.grad(IK.idx_dot_gather(plan, pat), pat, ct)
    pc = pat.detach().cpu().requires_grad_()
    (gpc,) = torch.autograd.grad(IK.idx_dot_gather(plan_cpu, pc), pc, ct.cpu())
    ev = randn((1, nb, et, 16), bf).requires_grad_()
    ct2 = randn((1, nb, p, 16), torch.float32)
    (ge,) = torch.autograd.grad(IK.idx_dot_scatter(plan, ev, p), ev, ct2)
    ec = ev.detach().cpu().requires_grad_()
    (gec,) = torch.autograd.grad(IK.idx_dot_scatter(plan_cpu, ec, p), ec,
                                 ct2.cpu())
    print(f"autograd idx pair: gather grad (kernel E) bit-equal "
          f"{torch.equal(gp.cpu(), gpc)}; scatter grad (kernel D) bit-equal "
          f"{torch.equal(ge.cpu(), gec)}")
    check(torch.equal(gp.cpu(), gpc) and torch.equal(ge.cpu(), gec),
          "idx pair gradients disagree")
    block, block_cpu = (Route.block(i, CELLS, WINDOW) for i in (idx32, idx32.cpu()))
    v = randn((BATCH, CELLS ** 3, 16), bf).requires_grad_()
    ct = randn((BATCH, CELLS ** 3, K, 16), bf)
    (gv,) = torch.autograd.grad(block.gather(v), v, ct)
    vc = v.detach().cpu().requires_grad_()
    (gvc,) = torch.autograd.grad(block_cpu.gather(vc), vc, ct.cpu())
    e = randn((BATCH, CELLS ** 3, K, 16), bf).requires_grad_()
    ct2 = randn((BATCH, CELLS ** 3, 16), bf)
    (ge,) = torch.autograd.grad(block.scatter_add(e), e, ct2)
    ec = e.detach().cpu().requires_grad_()
    (gec,) = torch.autograd.grad(block_cpu.scatter_add(ec), ec, ct2.cpu())
    print(f"autograd block pair: gather grad (kernel G) bit-equal "
          f"{torch.equal(gv.cpu(), gvc)}; scatter grad (kernel F) bit-equal "
          f"{torch.equal(ge.cpu(), gec)}")
    check(torch.equal(gv.cpu(), gvc) and torch.equal(ge.cpu(), gec),
          "block pair gradients disagree")

    # times: the scatters at every width (E at both cores, bf16; G with the
    # block route's setting, bf16 and fast), beside their plain versions
    # and one index_add_, per call with CUDA events and, for kernel and
    # library, on the device alone (at narrow widths a call's host work
    # outlasts its device work); the record keeps C 64 at the default core.
    # Bounds from this run's plans and inputs.
    scatters = [("idx_dot_scatter", core, plan, p, 1,
                 lambda pl, x, q: IK.dot_scatter(pl, x, q),
                 lambda pl, x, q: IK.dot_scatter_plain(pl, x, q))
                for core, (plan, p) in plan_by_core.items()]
    scatters.append(("block_scatter", blocked.CORE, plan32, pp32, b,
                     lambda pl, x, q: BK.block_scatter(pl, x, q, True),
                     lambda pl, x, q: BK.block_scatter_plain(pl, x, q, True)))
    for name, core, plan, p, nbatch, kern, plain in scatters:
        _, nb, et = plan.pos.shape
        for c in SELECT_WIDTHS:
            x = randn((nbatch, nb, et, c), bf)
            out = kern(plan, x, p)
            library = scatter_library(plan, x, p)
            ms = cuda_ms(lambda: kern(plan, x, p))
            plain_ms = cuda_ms(lambda: plain(plan, x, p))
            lib_ms = cuda_ms(library)
            dev_ms = device_ms(lambda: kern(plan, x, p))
            dev_lib_ms = device_ms(library)
            b_ms, by = scatter_bound(plan, x, out)
            print(f"time {name} core {core} C={c:>2} bf16: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({by}); kernel faster than both "
                  f"{ms < min(plain_ms, lib_ms)}; device time: kernel "
                  f"{dev_ms:.4f} ms, library {dev_lib_ms:.4f} ms")
            if c == 64 and core in (INDEX_CORES[0], blocked.CORE):
                rec[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=by)
    # the gathers at every width (D at both cores, F on the block route's
    # bf16 patches), per call with CUDA events and on the device alone,
    # beside their plain versions and one index_select on precomputed int64
    # ids (a position outside the patch reads row 0); the record keeps C 64
    # at the default core.  Bounds from this run's inputs.
    gathers = [("idx_dot_gather", core, plan.pos, p, IK.dot_gather,
                IK.dot_gather_plain) for core, (plan, p) in plan_by_core.items()]
    gathers.append(("block_gather", blocked.CORE, p32, pp32,
                    lambda q, x: BK.block_gather(q, x, True),
                    lambda q, x: BK.block_gather_plain(q, x, True)))
    for name, core, sel, psize, kern, plain in gathers:
        blocks = sel.shape[0] * sel.shape[1]
        blk = torch.arange(blocks, device=dev).reshape(sel.shape[:2] + (1,))
        valid = (sel >= 0) & (sel < psize)
        ids = torch.where(valid, blk * psize + sel, 0).reshape(-1)
        for c in GATHER_WIDTHS:
            x = randn(tuple(sel.shape[:2]) + (psize, c), bf)
            out = kern(sel, x)
            flat = x.reshape(-1, c)
            ms = cuda_ms(lambda: kern(sel, x))
            plain_ms = cuda_ms(lambda: plain(sel, x))
            lib_ms = cuda_ms(lambda: flat.index_select(0, ids))
            dev_ms = device_ms(lambda: kern(sel, x))
            b_ms, by = bound(nbytes(sel, x, out))
            print(f"time {name} core {core} C={c:>2} bf16: kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}); device share of "
                  f"the bound {b_ms / dev_ms:.3f}")
            if c == 64 and core in (INDEX_CORES[0], blocked.CORE):
                rec[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=by)
    c = 64
    for name, r in rec.items():
        where = (f"64^3 core {INDEX_CORES[0]}" if name.startswith("idx")
                 else "32^3 b4 core (4, 4, 8)")
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {where}, C={c} bf16)")
    return rec


def check_mask_kernels(dev, idx):
    """Phase 10: kernels H/I against their plain versions at the int8
    route's 32^3 b4 core (4,8,8) shapes on the main path's graph, on
    general-valued masks with ragged tails and on single-term probes, each
    identical across two launches, the autograd pair against the CPU, and
    times at every width.  Returns per-kernel records."""
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import mask_kernels as MK

    g = torch.Generator(device=dev).manual_seed(2)
    rec = {n: {"max_abs_err": 0.0} for n in ("mask_dot_gather", "mask_dot_scatter")}
    bf = torch.bfloat16

    def randn(shape, dt=bf):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def hold(m, c, label, exact):
        """One (masks, width) pair: gather bit-equal when `exact` (one-hot
        masks), else both within 1e-5 of the summed |terms|."""
        b, nb, et = m.shape[:3]
        p = MK.patch_width(m)
        absm = MK.pack_int4(MK.unpack_int4(m).abs()) if m.dtype == torch.uint8 \
            else m.abs()
        pat, ev = randn((b, nb, p, c)), randn((b, nb, et, c))
        got, want = MK.dot_gather(m, pat), MK.mask_dot_gather_plain(m, pat)
        gsame = torch.equal(got, MK.dot_gather(m, pat))
        if exact:
            note("mask_dot_gather", float((got - want).abs().max()))
            check(torch.equal(got, want), f"mask_dot_gather {label} C={c} "
                                          "not bit-equal")
            gworst = 0.0
        else:
            gerr, gworst = scatter_worst(got, want, MK.mask_dot_gather_plain(
                absm, pat.abs()), False)
            note("mask_dot_gather", gerr)
        got, again = MK.dot_scatter(m, ev), MK.dot_scatter(m, ev)
        err, worst = scatter_worst(got, MK.mask_dot_scatter_plain(m, ev),
                                   MK.mask_dot_scatter_plain(absm, ev.abs()), False)
        note("mask_dot_scatter", err)
        same = torch.equal(got, again)
        print(f"kernels H/I {label} {tuple(m.shape)} P={p} C={c:>2}: gather "
              + ("bit-equal" if exact else f"worst err - tol {gworst:.3e}")
              + f", scatter max|err| {err:.3e} (worst err - tol {worst:.3e}), "
              f"same across two launches H {gsame} I {same}")
        check(gworst <= 0 and worst <= 0, f"mask_dot {label} C={c} out of tolerance")
        check(gsame, f"mask_dot_gather {label} C={c} differs between two launches")
        check(same, f"mask_dot_scatter {label} C={c} differs between two launches")

    def probe(shape, c, int4, gather):
        """Kernel H (gather) or I bit-equal to its plain version on masks
        with one nonzero of any value per row e (H) or column p (I): every
        sum has one term, so a k permutation that A and B disagree on, a
        wrong row map or a wrong widening shows as a difference that no
        tolerance hides."""
        b, nb, et, p = shape
        lo, hi = (-8, 8) if int4 else (-128, 128)
        one = (b, nb, et, 1) if gather else (b, nb, 1, p)
        at = torch.randint(0, p if gather else et, one, generator=g, device=dev)
        vals = torch.randint(lo, hi, one, generator=g, device=dev, dtype=torch.int8)
        m = torch.zeros(shape, dtype=torch.int8, device=dev).scatter_(
            3 if gather else 2, at, vals)
        m = MK.pack_int4(m) if int4 else m
        if gather:
            name, x = "mask_dot_gather", randn((b, nb, p, c))
            got, want = MK.dot_gather(m, x), MK.mask_dot_gather_plain(m, x)
        else:
            name, x = "mask_dot_scatter", randn((b, nb, et, c))
            got, want = MK.dot_scatter(m, x), MK.mask_dot_scatter_plain(m, x)
        err = float((got - want).abs().max())
        note(name, err)
        label = "int4" if int4 else "int8"
        print(f"kernel {'H' if gather else 'I'} single-term probe {label} {shape} "
              f"C={c:>2}: bit-equal {torch.equal(got, want)} (max|err| {err:.3e})")
        check(torch.equal(got, want), f"{name} probe {label} {shape} C={c} not "
                                      "bit-equal")

    masks = {mdt: blocked.block_masks(idx, CELLS, WINDOW, dt, MASK_CORE,
                                      drop_self_slot0=True)
             for mdt, dt in (("int8", torch.int8), ("int4", "int4"))}
    for c in MASK_WIDTHS:
        for mdt, m in masks.items():
            hold(m, c, mdt, True)
    # dense products: general values in [-3, 3], tails in ET, P and C (mask
    # rows of P 54 take the byte loads, P 216 the 4-byte copies, P 1152 the
    # 16-byte copies or H's TMA boxes)
    for shape in ((2, 8, 200, 54), (2, 8, 200, 216), (1, 3, 520, 1152)):
        m8 = torch.randint(-3, 4, shape, generator=g, device=dev,
                           dtype=torch.int8)
        for c in (3, 64, 80):
            hold(m8, c, "general int8", False)
            hold(MK.pack_int4(m8), c, "general int4", False)
    route_shape = tuple(masks["int8"].shape)
    for int4 in (False, True):
        for c in MASK_WIDTHS + (80,):
            probe(route_shape, c, int4, False)
        probe((2, 8, 200, 216), 3, int4, False)
        for shape in (route_shape, (2, 8, 200, 216), (2, 8, 200, 54)):
            for c in MASK_WIDTHS + (80,):
                probe(shape, c, int4, True)

    # the autograd pair on 16 blocks, card against the CPU's plain versions
    m = masks["int8"][:, :16].contiguous()
    b, nb, et, p = m.shape
    pat = randn((b, nb, p, 16)).requires_grad_()
    ct = randn((b, nb, et, 16), torch.float32)
    (gp,) = torch.autograd.grad(MK.mask_dot_gather(m, pat), pat, ct)
    pc = pat.detach().cpu().requires_grad_()
    (gpc,) = torch.autograd.grad(MK.mask_dot_gather(m.cpu(), pc), pc, ct.cpu())
    _, gworst = scatter_worst(gp.cpu(), gpc, MK.mask_dot_scatter_plain(
        m.cpu(), ct.abs().cpu()), True)
    ev = randn((b, nb, et, 16)).requires_grad_()
    ct2 = randn((b, nb, p, 16), torch.float32)
    (ge,) = torch.autograd.grad(MK.mask_dot_scatter(m, ev), ev, ct2)
    ec = ev.detach().cpu().requires_grad_()
    (gec,) = torch.autograd.grad(MK.mask_dot_scatter(m.cpu(), ec), ec, ct2.cpu())
    print(f"autograd mask pair: gather grad (kernel I) worst err - tol "
          f"{gworst:.3e}; scatter grad (kernel H) bit-equal "
          f"{torch.equal(ge.cpu(), gec)}")
    check(gworst <= 0 and torch.equal(ge.cpu(), gec), "mask pair gradients disagree")

    # the yardstick: one torch.bmm on the mask widened to bf16 before the
    # timed window (int8 and int4 route masks widen to the same tensor), so
    # it reads 2x (int8) or 4x (int4) the kernels' mask bytes
    b, nb, et, p = masks["int8"].shape
    wide = MK.widen(masks["int8"]).to(bf).reshape(b * nb, et, p)
    f32_out = "out_dtype" in (torch.bmm.__doc__ or "")
    out_kw = {"out_dtype": torch.float32} if f32_out else {}
    print(f"yardstick torch.bmm on the bf16-widened mask, "
          f"{'f32' if f32_out else 'bf16'} output")
    for name in ("mask_dot_scatter", "mask_dot_gather"):
        scatter = name == "mask_dot_scatter"
        for c in MASK_WIDTHS:
            x = randn((b, nb, et if scatter else p, c))
            a = wide.transpose(1, 2) if scatter else wide
            xl = x.reshape(b * nb, -1, c)
            lib_ms = cuda_ms(lambda: torch.bmm(a, xl, **out_kw), iters=10)
            for mdt, m in masks.items():
                fn = MK.dot_scatter if scatter else MK.dot_gather
                kern = lambda: fn(m, x)
                plain = (MK.mask_dot_scatter_plain if scatter
                         else MK.mask_dot_gather_plain)
                ms, plain_ms = cuda_ms(kern, iters=10), cuda_ms(lambda: plain(m, x),
                                                                iters=5)
                dev_ms = device_ms(kern)
                # the mask, the operand and the f32 output; a dense product
                # of every mask entry on the bf16 tensor cores
                ms_bound, by = bound(nbytes(m, x, kern()), 2.0 * b * nb * et * p * c,
                                     H100_BF16_TC_OPS)
                if mdt == "int8" and c == 64:
                    rec[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=ms_bound, bound_by=by)
                print(f"time {name} {mdt} C={c}: kernel {ms:.4f} ms (device "
                      f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, torch.bmm "
                      f"{lib_ms:.4f} ms, bound {ms_bound:.4f} ms ({by}; 32^3 b4 "
                      f"core {MASK_CORE}, {tuple(m.shape)} bf16)")
    return rec


def pos_norm(x_in, box):
    """The model's kNN input: grid + ZA positions on the unit torus."""
    return torch.remainder((x_in[..., :3] + box / 2.0 + x_in[..., 3:6]) / box, 1.0)


def reset_counts():
    """Zero the program's counters (nbody_tpu_torch/tracing.py)."""
    from nbody_tpu_torch import tracing
    tracing.reset()


def launches() -> collections.Counter:
    """{wrapper: launches} since the last reset_counts(), from the
    program's launch.<wrapper> counters (a replay of fit_scan's CUDA graph
    adds the launches its capture recorded); absent wrappers read 0."""
    from nbody_tpu_torch import tracing
    return collections.Counter({k[len("launch."):]: v
                                for k, v in tracing.counters().items()
                                if k.startswith("launch.") and v})


def one_step_launches(trainer, x, y, want, label):
    """Every kernel launch of one train step must be `want`, exactly;
    returns them."""
    reset_counts()
    trainer.train_step(x, y)
    torch.cuda.synchronize()
    step = launches()
    print(f"launches in one {label} train step: {step}")
    check(step == want, f"one {label} train step launched {step}, expected {want}")
    return step


def step_time(trainer, x, y, iters, label):
    """CUDA-event step time and peak device memory of trainer's step."""
    dev = x.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: trainer.train_step(x, y), iters=iters, warmup=2)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"train step ({label}, CUDA events, mean of {iters} after 2 "
          f"warm-up): {ms:.3f} ms; peak device memory {peak / 2**20:.1f} MiB")
    return ms, peak


def make_vel64(dev, C):
    """The 64^3 shiftinv_vel index path's Dataset and Trainer."""
    from nbody_tpu_torch.data.dataset import Dataset
    from nbody_tpu_torch.train.trainer import Trainer

    cfg = C.Config(
        data=C.DataConfig(
            data_dir=os.path.join(os.path.sep, "nonexistent-force-synthetic"),
            num_test=1, num_val=1, cells_per_side=CELLS64,
            synthetic_num_samples=6, include_velocity=True),
        model=C.ModelConfig(family="shiftinv_vel",
                            channels=tuple(C.GRAPH_VEL_CHANNELS), k_neighbors=K,
                            dtype="bfloat16", knn_window=WINDOW,
                            mask_dtype="index"),
        train=C.TrainConfig(num_iters=4, batch_size=1, learn_rate=1e-3,
                            checkpoint_every=1))
    t0 = time.perf_counter()
    ds = Dataset(cfg.data)
    print(f"64^3 velocity dataset: {ds.X_train.shape} train, {ds.X_test.shape} "
          f"test ({time.perf_counter() - t0:.1f} s)")
    return ds, Trainer(cfg, dev, dataset=ds)


def run_vel64(dev, ds, trainer):
    """Phase 7: the 64^3 shiftinv_vel index path through Trainer.fit and
    evaluate.  Returns the launch counts of the fit + evaluate."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.models import registry
    from nbody_tpu_torch.train.trainer import Trainer

    x0, _ = split_batch(torch.as_tensor(ds.X_train[:1], device=dev), 9)
    check(CELLS64 ** 3 > registry.EXACT_KNN_MAX_PARTICLES,
          "64^3 does not reach the host coverage search")
    t0 = time.perf_counter()
    cov = trainer.check_graph_coverage(x0)
    print(f"coverage guard, host k-d tree search: {cov} violations "
          f"({time.perf_counter() - t0:.1f} s)")
    check(cov == 0, "the lattice window does not cover the 64^3 data")
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(verbose=True)
    fit_s = time.perf_counter() - t0
    errors, preds = trainer.evaluate("test", verbose=True)
    torch.cuda.synchronize()
    counts = launches()
    print(f"launches during the 64^3 fit + evaluate: {counts}")
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    print(f"64^3 fit: 4 steps in {fit_s:.2f} s (host clock, coverage check "
          f"included); losses {losses}")
    check(len(losses) == 4 and np.isfinite(losses).all(), "non-finite 64^3 loss")
    rec = trainer.model.impl_record
    check(rec.get("impl") == "masked" and rec.get("mask_dtype") == "index"
          and rec.get("core") == [4, 8, 8], f"64^3 route is {rec}")
    check(counts["idx_dot_gather"] > 0 and counts["idx_dot_scatter"] > 0,
          "kernels D/E did not run on the 64^3 path")
    check(counts["neighbor_gather"] == 0 and counts["neighbor_segment_sum"] == 0,
          "kernels B/C ran on the 64^3 index path")
    n_test = ds.X_test.shape[0]
    check(preds.shape == (2, n_test, CELLS64 ** 3, 6) and np.isfinite(preds).all(),
          f"64^3 evaluate cube {preds.shape} not finite / wrong shape")
    check(np.array_equal(preds[0], ds.X_test[:, :, 9:]),
          "64^3 evaluate slot 0 is not the truth")
    check(np.isfinite(errors).all(), "non-finite 64^3 eval error")
    print(f"64^3 evaluate: cube {preds.shape}, errors {errors.tolist()}")

    x, y = split_batch(torch.as_tensor(ds.X_train[:1], device=dev), 9)
    one_step_launches(trainer, x, y, INDEX_STEP_LAUNCHES, "64^3 index")
    step_time(trainer, x, y, 5, "64^3 b1 K14 w2 bf16 shiftinv_vel, index core "
                                "(4, 8, 8)")
    cfg = trainer.cfg
    cfg8 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, masked_core=(8, 8, 8)))
    trainer8 = Trainer(cfg8, dev, dataset=ds)
    step_time(trainer8, x, y, 5, "64^3 b1 K14 w2 bf16 shiftinv_vel, index core "
                                 "(8, 8, 8)")
    check(trainer8.model.impl_record.get("core") == [8, 8, 8],
          f"--masked_core 8 8 8 route is {trainer8.model.impl_record}")
    return counts


def run_block32(dev, C, dataset):
    """Phase 8: the --impl block route at 32^3 b4 through Trainer.fit."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.train.trainer import Trainer

    cfg = C.Config(dataset.cfg, C.ModelConfig(
        family="shiftinv", channels=tuple(C.GRAPH_CHANNELS), k_neighbors=K,
        dtype="bfloat16", knn_window=WINDOW, neighbor_impl="block"),
        C.TrainConfig(num_iters=3, batch_size=BATCH, learn_rate=1e-3,
                      checkpoint_every=1))
    trainer = Trainer(cfg, dev, dataset=dataset)
    reset_counts()
    trainer.fit(verbose=True)
    torch.cuda.synchronize()
    counts = launches()
    print(f"launches during the --impl block fit: {counts}")
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    check(len(losses) == 3 and np.isfinite(losses).all(), "non-finite block loss")
    check(trainer.model.impl_record.get("impl") == "block",
          f"block route is {trainer.model.impl_record}")
    check(counts["block_gather"] > 0 and counts["block_scatter"] > 0,
          "kernels F/G did not run on the --impl block path")
    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    one_step_launches(trainer, x, y, BLOCK_STEP_LAUNCHES, "--impl block")
    step_time(trainer, x, y, 5, "32^3 b4 K14 w2 bf16 shiftinv, --impl block")
    return counts


def run_int_route(dev, C, dataset):
    """Phase 11: the --mask_dtype int8 route at 32^3 b4 through the coverage
    guard, Trainer.fit and evaluate, then int4 through fit.  Returns the
    launch counts of the int8 fit + evaluate."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.train.trainer import Trainer

    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    counts8 = None
    for mdt, iters in (("int8", 5), ("int4", 3)):
        cfg = C.Config(dataset.cfg, C.ModelConfig(
            family="shiftinv", channels=tuple(C.GRAPH_CHANNELS), k_neighbors=K,
            dtype="bfloat16", knn_window=WINDOW, mask_dtype=mdt),
            C.TrainConfig(num_iters=iters, batch_size=BATCH, learn_rate=1e-3,
                          checkpoint_every=1))
        trainer = Trainer(cfg, dev, dataset=dataset)
        if mdt == "int8":
            cov = trainer.check_graph_coverage(x)
            print(f"coverage guard (int8 route): {cov} violations")
            check(cov == 0, "the lattice window does not cover the data")
        reset_counts()
        trainer.fit(verbose=True)
        if mdt == "int8":
            errors, preds = trainer.evaluate("test", verbose=True)
            check(preds.shape == (2, 4, CELLS ** 3, 3) and np.isfinite(preds).all()
                  and np.isfinite(errors).all(),
                  f"int8 evaluate cube {preds.shape} not finite / wrong shape")
            print(f"int8 evaluate: cube {preds.shape}, errors {errors.tolist()}")
        torch.cuda.synchronize()
        counts = launches()
        print(f"launches during the --mask_dtype {mdt} fit"
              + (" + evaluate" if mdt == "int8" else "") + f": {counts}")
        losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
        check(len(losses) == iters and np.isfinite(losses).all(),
              f"non-finite {mdt} loss")
        rec = trainer.model.impl_record
        print(f"{mdt} route: {rec}; losses {losses}")
        check(rec.get("impl") == "masked" and rec.get("core") == list(MASK_CORE)
              and rec.get("mask_dtype") == mdt, f"{mdt} route is {rec}")
        check(counts["mask_dot_gather"] > 0 and counts["mask_dot_scatter"] > 0,
              f"kernels H/I did not run on the {mdt} route")
        check(all(counts[n] == 0 for n in
                  ("neighbor_gather", "neighbor_segment_sum", "idx_dot_gather",
                   "idx_dot_scatter", "block_gather", "block_scatter")),
              f"a kernel of B-G ran on the {mdt} route")
        step_time(trainer, x, y, 5, f"32^3 b4 K14 w2 bf16 shiftinv, --mask_dtype "
                                    f"{mdt} core {MASK_CORE}")
        if mdt == "int8":
            one_step_launches(trainer, x, y, INT8_STEP_LAUNCHES, "int8")
        counts8 = counts8 or counts
        del trainer
    return counts8


def run_cli(main, argv):
    """One in-process CLI run; returns its standard output (echoed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    print(out, end="")
    check(rc == 0, f"{main.__module__} {argv} returned {rc}")
    return out


def chunk_times(fn, steps):
    """(ms a step by CUDA events, host ms a step) of fn, which runs `steps`
    train steps without a host sync, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    host = (time.perf_counter() - t0) * 1e3 / steps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, host


def idle_host_ms(fn, reps=5):
    """Median host milliseconds of one call of fn launched on an idle card
    (synchronized before each call, not inside it)."""
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(host))


@contextlib.contextmanager
def experiments_dir():
    """A temporary NBODY_EXPERIMENTS_DIR under build/ for in-process CLI
    runs; yields its path and restores the variable."""
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    old_env = os.environ.get("NBODY_EXPERIMENTS_DIR")
    with tempfile.TemporaryDirectory(dir=build_dir) as exp:
        os.environ["NBODY_EXPERIMENTS_DIR"] = exp
        try:
            yield exp
        finally:
            if old_env is None:
                os.environ.pop("NBODY_EXPERIMENTS_DIR", None)
            else:
                os.environ["NBODY_EXPERIMENTS_DIR"] = old_env


def step_forms(dev, make_trainer, batches, ni, label):
    """fit_scan's graph and the eager step, each on a fresh trainer: ms a
    step by CUDA events and host ms a step over a chunk of len(batches)
    steps after a warm-up chunk, device busy a step (kernel self time
    under torch.profiler over 5 steps) and idle share, host ms of one step
    on an idle card, peak allocated and reserved memory."""
    from nbody_tpu_torch.data.dataset import split_batch
    steps = batches.shape[0]
    out = {}
    for form in ("graph", "eager"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = make_trainer()
        if form == "graph":
            def chunk():
                trainer.train_scan.run(batches, ni)

            def one():
                trainer.train_scan.run(batches[:1], ni)
        else:
            xy = [split_batch(batches[i], ni) for i in range(steps)]

            def chunk():
                for x, y in xy:
                    trainer.train_step(x, y)

            def one():
                trainer.train_step(*xy[0])
        ms, host = chunk_times(chunk, steps)
        pk, rs = torch.cuda.max_memory_allocated(dev), torch.cuda.memory_reserved(dev)
        busy, host1 = device_ms(one, 5), idle_host_ms(one)
        print(f"train step ({form}, {label}, {steps} steps after warm-up): "
              f"{ms:.3f} ms a step (CUDA events), host {host:.3f} ms a step; "
              f"device busy {busy:.3f} ms a step (idle share "
              f"{1 - busy / ms:.3f}); one step on an idle card: host "
              f"{host1:.3f} ms; peak allocated {pk / 2**20:.1f} MiB, reserved "
              f"{rs / 2**20:.1f} MiB")
        out[form] = {"ms": ms, "host_ms": host, "busy_ms": busy,
                     "idle_share": 1 - busy / ms, "idle_card_host_ms": host1,
                     "peak_mib": pk / 2**20, "reserved_mib": rs / 2**20}
        del trainer, chunk, one
    return out


def minibatches(ds, dev, n, batch):
    rng = ds.minibatch_rng()
    idxs = np.stack([ds.get_minibatch_indices(rng, batch) for _ in range(n)])
    return torch.as_tensor(ds.X_train[idxs], device=dev)


def eager_vs_graph(dev, dataset, cfg, want, label):
    """Phases 14 and 17: 3 eager steps against 3 steps of fit_scan's graph
    (the first eager on a side stream, the capture at the second) on the
    same batches: loss rtol 1e-3, and the launches of the three steps
    (the eager step's, and the capture's added at each of its two
    replays) three times `want`.  Returns the route's impl_record."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.train.trainer import Trainer

    torch.cuda.empty_cache()
    b = minibatches(dataset, dev, 3, cfg.train.batch_size)
    eager = Trainer(cfg, dev, dataset=dataset)
    ni = eager.num_inputs
    le = [float(eager.train_step(*split_batch(b[i], ni))) for i in range(3)]
    rec = dict(eager.model.impl_record)
    del eager
    graph = Trainer(cfg, dev, dataset=dataset)
    reset_counts()
    lg = graph.train_scan.run(b, ni).tolist()
    torch.cuda.synchronize()
    counts = launches()
    rel = max(abs(a - c) / abs(a) for a, c in zip(le, lg))
    print(f"{label} {rec}: eager {le} vs graph {lg} (steps 2-3 replayed), max "
          f"rel {rel:.2e}, bit-equal {le == lg}; launches (eager step + "
          f"2 replays) {dict(counts)}")
    check(all(np.isfinite(le)) and rel <= 1e-3, f"{label}: graph losses off eager's")
    check(counts == {n: 3 * v for n, v in want.items()},
          f"{label}: launched {counts}, expected three times {want}")
    del graph
    return rec


def run_scan(dev, C, dataset, ds64):
    """Phase 14: the run around the step -- Trainer.fit_scan, one CUDA
    graph of the train step replayed once a step, against eager fit; its
    launches, step times and memory; every other route's graph; the CLI's
    train (scan, device data, -n), eval, -r and --trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.cli import eval as cli_eval
    from nbody_tpu_torch.cli import train as cli_train
    from nbody_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    summary = {}

    def cfg_of(ds, dtype="bfloat16", batch=BATCH, family="shiftinv", **model):
        channels = C.GRAPH_VEL_CHANNELS if family == "shiftinv_vel" else C.GRAPH_CHANNELS
        return C.Config(ds.cfg, C.ModelConfig(
            family=family, channels=tuple(channels), k_neighbors=K, dtype=dtype,
            knn_window=WINDOW, **model),
            C.TrainConfig(num_iters=10, batch_size=batch, learn_rate=1e-3,
                          checkpoint_every=5))

    def flat(trainer):
        return torch.cat([p.detach().ravel() for p in trainer.model.parameters()])

    def synced_launches():
        torch.cuda.synchronize()
        return launches()

    # (a) graph against eager: 10 steps from two fresh trainers and one
    # minibatch generator, the losses at steps 5 and 10 and the params
    for dtype, rtol in (("float32", 1e-5), ("bfloat16", 1e-3)):
        cfg = cfg_of(dataset, dtype)
        eager = Trainer(cfg, dev, dataset=dataset)
        eager.fit(verbose=False)
        graph = Trainer(cfg, dev, dataset=dataset)
        graph.fit_scan(scan_chunk=5, verbose=False)
        le, lg = eager.train_error_history, graph.train_error_history
        pe, pg = flat(eager), flat(graph)
        bit = le == lg and bool(torch.equal(pe, pg))
        rel = max(abs(a - b) / abs(a) for a, b in zip(le, lg))
        print(f"fit (eager) vs fit_scan (graph, T 5), {dtype}, 10 steps: losses "
              f"{le} vs {lg}, max rel {rel:.2e}, params max abs diff "
              f"{float((pe - pg).abs().max()):.3e}; bit-equal: {bit}")
        check(len(lg) == 2 and rel <= rtol, f"{dtype} graph losses off eager's")
        check(eager.step == graph.step == 10, "the global step is not 10")
        if dtype == "float32":
            check(torch.allclose(pg, pe, rtol=1e-5, atol=1e-6),
                  "f32 graph params off eager's")
        summary[f"bit_equal_{dtype}"] = bit
        del eager, graph

    # (b) launches: a fresh trainer's first scanned step runs eagerly, the
    # capture follows at the next; the capture counts nothing itself and a
    # replay adds exactly its capture's launches
    cfg = cfg_of(dataset)
    batches = minibatches(dataset, dev, 20, BATCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    graph = Trainer(cfg, dev, dataset=dataset)
    reset_counts()
    graph.train_scan.run(batches[:1], 6)
    warm = synced_launches()
    reset_counts()
    graph.train_scan.run(batches[1:2], 6)
    captured = synced_launches()
    reset_counts()
    graph.train_scan.run(batches, 6)
    replayed = synced_launches()
    print(f"launches: eager first step {dict(warm)}; the next step, captured "
          f"and replayed, {dict(captured)}; 20 replayed steps {dict(replayed)}")
    check(all(captured.get(n, 0) == want for n, want in STEP_LAUNCHES.items())
          and captured == warm, f"the capture launched {captured}, expected "
                                f"{STEP_LAUNCHES} and the eager step's {warm}")
    check(replayed == {n: 20 * v for n, v in captured.items()},
          f"20 replays added {replayed}, not 20 times the capture's {captured}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.train_scan.run(batches[:5], 6)
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for n in ("lattice_knn_kernel", "gather_rows_kernel", "segment_sum_kernel"):
                if n in e.key:
                    kern[n] = kern.get(n, 0) + e.count
    print(f"kernels of one replayed chunk of 5 under torch.profiler: {kern}")
    check(kern == {"lattice_knn_kernel": 5, "gather_rows_kernel": 60,
                   "segment_sum_kernel": 55},
          "the replayed graph did not run kernels A, B and C once a step")

    # (c) step times over 20 steps after warm-up, host time, peak memory;
    # device busy a step (kernel self time under torch.profiler) and the host
    # time of one step launched on an idle card
    del graph
    summary.update(step_forms(dev, lambda: Trainer(cfg, dev, dataset=dataset),
                              batches, 6, "32^3 b4 K14 w2 bf16"))

    # (d) every other route: 3 steps of one chunk (the eager first step,
    # then 2 graph steps) against 3 eager steps on the same batches
    routes = (
        ("index64", ds64, cfg_of(ds64, batch=1, family="shiftinv_vel",
                                 mask_dtype="index"), INDEX_STEP_LAUNCHES),
        ("block32", dataset, cfg_of(dataset, neighbor_impl="block"),
         BLOCK_STEP_LAUNCHES),
        ("int8", dataset, cfg_of(dataset, mask_dtype="int8"), INT8_STEP_LAUNCHES),
        ("int4", dataset, cfg_of(dataset, mask_dtype="int4"), INT8_STEP_LAUNCHES))
    for name, ds, cfg, want in routes:
        eager_vs_graph(dev, ds, cfg, want, f"{name} route")
        summary[f"route_{name}"] = "captured"

    # (e) the CLI in-process: train with --scan and device data, eval, -r,
    # --trace, under a temporary experiments directory
    flags = ["--model", "shiftinv", "-k", str(K), "--cells", str(CELLS),
             "--knn_window", str(WINDOW), "--dtype", "bfloat16", "--synthetic",
             "--samples", "16", "-t", "4", "-b", str(BATCH)]
    with experiments_dir() as exp:
        out = run_cli(cli_train.main, flags + [
            "--scan", "10", "-i", "20", "--device_data", "on", "-n", "smoke"])
        root = os.path.join(exp, "ZA-FPM_0_smoke")
        med = [ln for ln in out.splitlines() if "median :" in ln][-1]
        check("MODEL NAMED: ZA-FPM_0_smoke" in out
              and sorted(os.listdir(os.path.join(root, "Session")))
              == ["chkpt-10.pt", "chkpt-20.pt"], "cli.train -n smoke artifacts")
        out = run_cli(cli_eval.main, flags + ["-n", "smoke"])
        cube = np.load(os.path.join(root, "Results", "X_0_prediction.npy"))
        check("Restored checkpoint at step 20" in out, "eval did not restore step 20")
        check([ln for ln in out.splitlines() if "median :" in ln][-1] == med,
              "eval does not reproduce the train run's median")
        check(cube.shape == (2, 4, CELLS ** 3, 3) and np.isfinite(cube).all(),
              f"eval cube {cube.shape}")
        check(any(ln.startswith("L2 median: model ") for ln in out.splitlines()),
              "eval printed no linear-velocity baseline line")
        out = run_cli(cli_train.main, flags + [
            "--scan", "10", "-i", "10", "-r", "-n", "smoke"])
        check("Restored checkpoint at step 20" in out and os.path.exists(
            os.path.join(root, "Session", "chkpt-30.pt")), "-r did not resume")
        trace = os.path.join(exp, "trace")
        run_cli(cli_train.main, flags + [
            "--scan", "3", "-i", "3", "-n", "smoke_trace", "--trace", trace])
        with open(os.path.join(trace, "trace.json")) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
        found = {n: sum(n in e for e in names) for n in (
            "lattice_knn_kernel", "gather_rows_kernel", "segment_sum_kernel")}
        print(f"--trace of a 3-step scan run, kernel events: {found}")
        # 3 steps (the eager first and 2 replays), and the coverage
        # guard's lattice search
        check(found == {"lattice_knn_kernel": 4, "gather_rows_kernel": 36,
                        "segment_sum_kernel": 33},
              "the --trace trace does not hold kernels A, B and C of "
              "every step")
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"run around the step (phase 14): {json.dumps(summary)}")


def run_set_attn(dev, C, dataset):
    """Phase 15: the set and attn families -- card against CPU in f32,
    200 bf16 fit steps of set, fit_scan's graph against the eager step,
    cli.experiment, and the step times of both families."""
    from nbody_tpu_torch.cli import experiment as cli_experiment
    from nbody_tpu_torch.data.dataset import Dataset, split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.physics.losses import loss_za
    from nbody_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    summary = {}
    ds16 = Dataset(C.DataConfig(
        data_dir=os.path.join(os.path.sep, "nonexistent-force-synthetic"),
        num_test=4, num_val=3, cells_per_side=SET_CELLS,
        synthetic_num_samples=32))
    # BASELINE config 1 (set, CHANNELS, 16^3 b4) and the reference's attn
    # run (ATTN_CHANNELS, 22 x 16, b10) on the main path's 32^3 cubes
    cases = {"set": (ds16, C.CHANNELS, SET_BATCH),
             "attn": (dataset, C.ATTN_CHANNELS, ATTN_BATCH)}

    def mcfg(family, dtype):
        return C.ModelConfig(family=family, channels=tuple(cases[family][1]),
                             dtype=dtype)

    # (a) the same params and batch, f32, on the card and on the CPU, and
    # the CPU in f64 as the reference both f32 forwards are held to
    for family, mode in (("set", "train"), ("attn", "train"), ("attn", "eval")):
        ds, _, batch = cases[family]
        x, y = split_batch(torch.as_tensor(ds.X_train[:batch]))
        res = {}
        state = None
        for key, d, dt in (("card", dev, None), ("cpu", torch.device("cpu"), None),
                           ("f64", torch.device("cpu"), torch.float64)):
            model = build_model(mcfg(family, "float32"), box=ds.box, device=d)
            if state is None:
                state = model.state_dict()
            else:
                model.load_state_dict(state)
            if dt is not None:
                model.dtype = dt        # the same forward computed in f64
            fwd = model if mode == "train" else model.eval_fn
            with torch.no_grad():
                pred = fwd(x.to(d))
                res[key] = (pred.cpu().double(), float(loss_za(pred, y.to(d))))
        (pd, ld), (pc, lc), (p64, _) = res["card"], res["cpu"], res["f64"]
        rel = abs(ld - lc) / abs(lc)
        norm = float((pd - pc).norm() / pc.norm())
        scale = float(p64.abs().max())
        err_card = float((pd - p64).abs().max()) / scale
        err_cpu = float((pc - p64).abs().max()) / scale
        print(f"card vs CPU f32, {family} {mode} mode ({ds.cells}^3 b{batch}): "
              f"loss {ld!r} vs {lc!r} (rel {rel:.2e}); forward rel L2 "
              f"{norm:.2e}; max abs diff / max |out| against the f64 "
              f"forward: card {err_card:.2e}, CPU f32 {err_cpu:.2e}")
        # attn's batch-coupled gram reaches ~1e8, so its softmax is a hard
        # argmax whose near-ties an f32 rounding flips: in train mode the
        # CPU's own f32 forward is ~5e-4 off the f64 one elementwise
        check(rel <= 1e-4 and norm <= 1e-4
              and err_card <= max(1e-4, 2.0 * err_cpu),
              f"{family} {mode}: card and CPU f32 forwards disagree")

    # (b) 200 bf16 fit steps of set at 16^3, lr 3e-3: the verify skill's
    # recipe (channels 6-64-32-3, seed 1, b4); the loss must fall > 2x
    cfg = C.Config(ds16.cfg, C.ModelConfig(
        family="set", channels=(6, 64, 32, 3), seed=1, dtype="bfloat16"),
        C.TrainConfig(num_iters=200, batch_size=SET_BATCH, learn_rate=3e-3,
                      checkpoint_every=1))
    trainer = Trainer(cfg, dev, dataset=ds16)
    reset_counts()
    trainer.fit(verbose=False)
    losses = trainer.train_error_history
    fall = losses[0] / float(np.mean(losses[-10:]))
    print(f"set 16^3 b4 bf16, 200 fit steps at lr 3e-3: loss {losses[0]:.5f} "
          f"-> {float(np.mean(losses[-10:])):.5f} (mean of the last 10), "
          f"fell {fall:.2f}x; launches through the wrappers "
          f"{dict(launches())}")
    check(len(losses) == 200 and np.isfinite(losses).all() and fall > 2.0,
          "set did not train: the loss fell by 2x or less")
    summary["set_fit_fall"] = fall
    del trainer

    # (c) fit_scan's graph against the eager step, 3 steps each, bf16;
    # (d) the step times of both forms
    for family, label in (("set", "16^3 b4 CHANNELS"),
                          ("attn", "32^3 b10 ATTN_CHANNELS 22 x 16")):
        ds, _, batch = cases[family]
        cfg = C.Config(ds.cfg, mcfg(family, "bfloat16"),
                       C.TrainConfig(num_iters=3, batch_size=batch,
                                     learn_rate=1e-3))
        # no wrapper launches: set and attn run no kernel of the repo
        eager_vs_graph(dev, ds, cfg, {}, f"{family} bf16 ({label})")
        summary[family] = step_forms(
            dev, lambda: Trainer(cfg, dev, dataset=ds),
            minibatches(ds, dev, 20, batch), 6, f"{family} {label} bf16")

    # (e) cli.experiment with the reference's defaults, 20 iterations
    with experiments_dir() as exp:
        out = run_cli(cli_experiment.main, ["-i", "20", "--cells", str(SET_CELLS),
                                            "--synthetic"])
        med = float([ln for ln in out.splitlines() if "median :" in ln][-1]
                    .split(":")[1])
        root = os.path.join(exp, "ZA-FPM_0_TEST")
        cube = np.load(os.path.join(root, "Results", "X_0_prediction.npy"))
        print(f"cli.experiment -i 20 --cells {SET_CELLS}: test median {med}, "
              f"cube {cube.shape}, session {sorted(os.listdir(os.path.join(root, 'Session')))}")
        check(np.isfinite(med) and np.isfinite(cube).all()
              and os.path.exists(os.path.join(root, "Session", "chkpt-20.pt")),
              "cli.experiment did not finish its run")
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"set and attn (phase 15): {json.dumps(summary)}")


def run_rollout(dev, C):
    """Phase 16: the redshift-chain rollout at full width -- cli.rollout
    end to end (window 3, and window 2 where every pair's guard passes),
    the launches of one make_rollout call, card against CPU in f32, and ms
    a hop, idle share and peak memory."""
    from nbody_tpu_torch.cli import rollout as cli_rollout
    from nbody_tpu_torch.data.dataset import Dataset
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.physics.losses import loss_za
    from nbody_tpu_torch.train.rollout import make_rollout, stack_params
    from nbody_tpu_torch.train.trainer import CoverageError

    t_phase = time.perf_counter()
    summary = {}
    flags = ["--model", "shiftinv", "-k", str(K), "--cells", str(CELLS),
             "-c", *map(str, C.GRAPH_CHANNELS), "--dtype", "bfloat16",
             "--synthetic", "--samples", "16", "--steps", str(CHAIN_STEPS),
             "-i", "20", "-b", str(BATCH), "-t", "8"]
    with experiments_dir():
        out = run_cli(cli_rollout.main, flags + ["-n", "chain"])
        rec = json.loads(out.strip().splitlines()[-1])
        lin, chain = (rec["rollout_linear_median_l2"],
                      rec["rollout_linear_chain_median_l2"])
        check(all(np.isfinite(v).all() for v in map(np.asarray, rec.values()))
              and len(rec["rollout_model_median_l2"]) == CHAIN_STEPS,
              "the chain's JSON line is not finite")
        check(lin[0] == chain[0], "lin_chain[0] != lin_reset[0]")
        try:
            run_cli(cli_rollout.main, flags + ["--knn_window", "2", "-n", "w2"])
            summary["window_2"] = "every pair's guard passed"
        except CoverageError as e:
            summary["window_2"] = f"refused: {e}"
        print(f"chain at knn_window 2: {summary['window_2']}")

    # the CLI's data, truth chain and monitor, and stacked params of
    # CHAIN_STEPS models (seeds s, s+1, ...)
    cfg = C.config_from_args(cli_rollout.build_chain_parser().parse_args(flags))
    datasets = [Dataset(cfg.data, raw=raw) for raw in cli_rollout.synthetic_chain_raw(
        cfg.data.synthetic_num_samples, CELLS, CHAIN_STEPS, cfg.data.seed)]
    x0, truth, _ = cli_rollout.truth_chain(datasets)
    monitor = cli_rollout.margin_monitor(cfg.model, datasets[0])
    stacked = stack_params([dict(build_model(dataclasses.replace(
        cfg.model, seed=cfg.model.seed + t), box=datasets[0].box,
        device=dev).named_parameters()) for t in range(CHAIN_STEPS)])

    # launches of one rollout call, and its times (bf16, the CLI's b8)
    model = build_model(cfg.model, box=datasets[0].box, device=dev)
    rollout = make_rollout(model, coverage_fn=monitor)
    x_dev = torch.as_tensor(x0, device=dev)

    def call():
        return rollout(stacked, x_dev)

    call()
    reset_counts()
    call()
    torch.cuda.synchronize()
    counts = launches()
    want = {n: v * CHAIN_STEPS for n, v in ROLLOUT_HOP_LAUNCHES.items()}
    print(f"launches of one {CHAIN_STEPS}-hop rollout call: {counts}")
    check(counts == want, f"the rollout launched {counts}, expected {want}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(call, iters=5, warmup=1) / CHAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    busy = device_ms(call, 3) / CHAIN_STEPS
    host1 = idle_host_ms(call) / CHAIN_STEPS
    print(f"rollout, where a hop's device time goes: {device_top(call, 3, CHAIN_STEPS)}")
    print(f"rollout (shiftinv {CELLS}^3 b{x0.shape[0]} K{K} w{cfg.model.knn_window} "
          f"bf16, {CHAIN_STEPS} hops, monitor on): {ms:.3f} ms a hop (CUDA "
          f"events, mean of 5 calls); device busy {busy:.3f} ms a hop (idle "
          f"share {1 - busy / ms:.3f}); host of one call on an idle card "
          f"{host1:.3f} ms a hop; peak allocated {peak / 2**20:.1f} MiB")
    summary.update(ms_a_hop=ms, busy_ms_a_hop=busy, idle_share=1 - busy / ms,
                   idle_card_host_ms_a_hop=host1, peak_mib=peak / 2**20)
    del model, rollout, x_dev

    # the same stacked params and x0 (b2), f32, on the card and on the CPU
    f32 = dataclasses.replace(cfg.model, dtype="float32")
    res = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(f32, box=datasets[0].box, device=d)
        st = {k: v.to(d) for k, v in stacked.items()}
        _, (traj, cov) = make_rollout(model, coverage_fn=monitor)(
            st, torch.as_tensor(x0[:2], device=d))
        res[key] = ([float(loss_za(traj[t], torch.as_tensor(truth[t, :2], device=d)))
                     for t in range(CHAIN_STEPS)], cov.cpu().tolist())
    (mse_d, cov_d), (mse_c, cov_c) = res["card"], res["cpu"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(mse_d, mse_c))
    print(f"rollout card vs CPU f32 ({CELLS}^3 b2, {CHAIN_STEPS} hops): per-hop MSE "
          f"{mse_d} vs {mse_c} (max rel {rel:.2e}); coverage counts {cov_d} vs "
          f"{cov_c}")
    check(rel <= 1e-4 and cov_d == cov_c, "the rollout on the card and on the "
                                          "CPU disagree")
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"rollout (phase 16): {json.dumps(summary)}")


# the repo's CUDA kernels by symbol: A, B, C / E / G (one segment-sum
# body), D / F, H, I
REPO_SYMBOLS = ("lattice_knn_kernel", "gather_rows_kernel", "segment_sum_kernel",
                "patch_gather_kernel", "mask_gather_kernel", "mask_scatter_kernel",
                "edge_epilogue_kernel", "edge_epilogue_bwd_kernel",
                "edge_sample_sums_kernel", "edge_transpose_kernel",
                "edge_transpose_bwd_kernel", "epilogue4_kernel",
                "epilogue4_rows_kernel", "epilogue4_bwd_kernel",
                "epilogue4_sums_kernel")
# the 15-op layers' (C, q) at GRAPH_CHANNELS
EPILOGUE_LAYERS = ((3, 32), (32, 64), (64, 64), (64, 32), (32, 16), (16, 3))


def device_breakdown(fn, iters, top=10):
    """(device busy ms a call, elementwise-kernel ms a call, the `top`
    kernels [(name, ms, launches) a call], {repo kernel symbol: [ms,
    launches] a call}) of fn under torch.profiler."""
    rows = sorted(((n[:60], us / iters / 1e3, c / iters)
                   for n, us, c in cuda_profile(fn, iters)), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    elementwise = sum(r[1] for r in rows if "elementwise" in r[0].lower())
    repo = {}
    for n, ms, c in rows:
        for sym in REPO_SYMBOLS:
            if sym in n:
                acc = repo.setdefault(sym, [0.0, 0.0])
                acc[0] += ms
                acc[1] += c
    return (busy, elementwise, [(n, round(ms, 4), c) for n, ms, c in rows[:top]],
            {k: [round(v[0], 4), v[1]] for k, v in repo.items()})


def time_row(label, kern, plain, library, bnd):
    """Print and return one kernel timing at a phase 17 shape: kernel
    (CUDA events and device time), plain version and library call, beside
    the bound `bnd` = (bound_ms, bound_by)."""
    ms, plain_ms = cuda_ms(kern, iters=10), cuda_ms(plain, iters=5)
    lib_ms = cuda_ms(library, iters=10) if library is not None else None
    dev_ms = device_ms(kern)
    b_ms, by = bnd
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
    print(f"time {label}: kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, library {lib}, bound {b_ms:.4f} ms ({by}); "
          f"share {b_ms / ms:.3f}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by}


def check_15op_kernels(dev, idx):
    """Phase 17 (a, b): the symmetrized graph and the reverse-edge lookup
    built on the card equal to the CPU's; kernel B at K' = 1 over the
    lookup's table and C over its plan, then D/E, F/G and H/I at widths 96
    and 128, each held against its plain version and timed.  Returns the
    card's graph."""
    from nbody_tpu_torch.models import shiftinv15 as S15
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import banded_kernels as B
    from nbody_tpu_torch.ops.kernels import block_kernels as BK
    from nbody_tpu_torch.ops.kernels import idx_kernels as IK
    from nbody_tpu_torch.ops.kernels import mask_kernels as MK
    from nbody_tpu_torch.ops.route import Route

    g = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16

    def randn(shape, dt=bf):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    # (b) the graph and the lookup, card against CPU
    graph = S15.build_block_sym_graph(idx)
    graph_cpu = S15.build_block_sym_graph(idx.cpu())
    same = [torch.equal(a.cpu(), c) for a, c in zip(graph, graph_cpu)]
    lookup = S15.reverse_lookup(graph, Route.direct(idx))
    lookup_cpu = S15.reverse_lookup(graph_cpu, Route.direct(idx.cpu()))
    same_lookup = torch.equal(lookup.idx.cpu(), lookup_cpu.idx) and all(
        torch.equal(a.cpu(), c) for a, c in zip(lookup.plan, lookup_cpu.plan))
    print(f"symmetrized graph on the card (idx, rev_pos, mask_b, deg) equal to "
          f"the CPU's: {same}; live reversed edges "
          f"{float(graph.mask_b.mean()):.4f} of block B, degree max "
          f"{float(graph.deg.max())}; lookup ids and plan equal: {same_lookup}")
    check(all(same) and same_lookup, "the card's symmetrized graph or lookup "
                                     "differs from the CPU's")
    ids, plan, plan_cpu = lookup.idx, lookup.plan, lookup_cpu.plan
    b, rows, _ = ids.shape

    # (a) kernel B at K' = 1 and kernel C over the lookup's plan
    flat = B._flat_targets(ids, rows)
    for c in LOOKUP_WIDTHS:
        for dt in (torch.float32, bf):
            table = randn((b, rows, c), dt)
            got = B.neighbor_gather(table, ids)
            check(torch.equal(got, B.gather_plain(table, ids))
                  and torch.equal(got, B.neighbor_gather(table, ids)),
                  f"kernel B lookup C={c} {dt} not bit-equal or not repeatable")
            e = randn((b, rows, 1, c), dt)
            hold_segment_sum("neighbor_segment_sum",
                             lambda: B.neighbor_segment_sum(e, plan),
                             lambda: B.segment_sum_plain(e.cpu(), plan_cpu),
                             lambda *_: None, f"lookup plan C={c} {dt}")
            if dt == bf or c == 64:
                out = got
                time_row(f"neighbor_gather lookup K'=1 C={c} {dt}",
                         lambda: B.neighbor_gather(table, ids),
                         lambda: B.gather_plain(table, ids),
                         lambda: table.reshape(-1, c).index_select(0, flat),
                         bound(nbytes(table, ids, out)))
                acc = torch.zeros((b * rows, c), device=dev)
                ef = e.float().reshape(-1, c)
                out = B.neighbor_segment_sum(e, plan)
                time_row(f"neighbor_segment_sum lookup plan C={c} {dt}",
                         lambda: B.neighbor_segment_sum(e, plan),
                         lambda: B.segment_sum_plain(e, plan),
                         lambda: acc.index_add_(0, flat, ef),
                         bound(nbytes(e, plan.order, plan.offsets, out),
                               float(e.numel())))
    print(f"kernel B at K'=1 over ({b}, {rows}, C) and C over the lookup's plan, "
          f"C in {LOOKUP_WIDTHS}, f32 and bf16: bit-equal, repeatable")

    # D/E at core (8,8,8) and F/G at the block route's core, widths 96, 128
    p8 = blocked.patch_size(CELLS, WINDOW, CORE_15)
    plan8 = blocked.block_index_plan(idx, CELLS, WINDOW, CORE_15, drop_self_slot0=True)
    plan8_cpu = BK.BlockPlan(*(t.cpu() for t in plan8))
    pb = blocked.patch_size(CELLS, WINDOW, blocked.CORE)
    planb = blocked.block_index_plan(idx, CELLS, WINDOW, blocked.CORE)
    planb_cpu = BK.BlockPlan(*(t.cpu() for t in planb))
    check(all(torch.equal(a, c) for a, c in zip(planb_cpu, BK.block_plan(
        planb.pos.cpu(), pb))), "the card's block plan differs from the CPU's")
    for name_g, name_s, pl, pl_cpu, p, gk, gp, sk, sp in (
            ("idx_dot_gather", "idx_dot_scatter", plan8, plan8_cpu, p8,
             IK.dot_gather, IK.dot_gather_plain,
             lambda q, x, n: IK.dot_scatter(q, x, n),
             lambda q, x, n: IK.dot_scatter_plain(q, x, n)),
            ("block_gather", "block_scatter", planb, planb_cpu, pb,
             lambda q, x: BK.block_gather(q, x, True),
             lambda q, x: BK.block_gather_plain(q, x, True),
             lambda q, x, n: BK.block_scatter(q, x, n, True),
             lambda q, x, n: BK.block_scatter_plain(q, x, n, True))):
        pos = pl.pos
        nbt, nb, et = pos.shape
        blk = torch.arange(nbt * nb, device=dev).reshape(nbt, nb, 1)
        valid = (pos >= 0) & (pos < p)
        gids = torch.where(valid, blk * p + pos, 0).reshape(-1)
        for c in WIDE_WIDTHS:
            pat, ev = randn((nbt, nb, p, c)), randn((nbt, nb, et, c))
            got = gk(pos, pat)
            check(torch.equal(got, gp(pos, pat)) and torch.equal(got, gk(pos, pat)),
                  f"{name_g} C={c} not bit-equal or not repeatable")
            hold_segment_sum(name_s, lambda: sk(pl, ev, p),
                             lambda: sp(pl_cpu, ev.cpu(), p), lambda *_: None,
                             f"C={c} bf16")
            core = CORE_15 if name_g.startswith("idx") else blocked.CORE
            flat_pat = pat.reshape(-1, c)
            time_row(f"{name_g} core {core} C={c} bf16", lambda: gk(pos, pat),
                     lambda: gp(pos, pat), lambda: flat_pat.index_select(0, gids),
                     bound(nbytes(pos, pat, got)))
            time_row(f"{name_s} core {core} C={c} bf16", lambda: sk(pl, ev, p),
                     lambda: sp(pl, ev, p), scatter_library(pl, ev, p),
                     scatter_bound(pl, ev, sk(pl, ev, p)))
        print(f"kernels {name_g}/{name_s} {tuple(pos.shape)} P={p} C in "
              f"{WIDE_WIDTHS}: gathers bit-equal, segment sums bit-equal to the "
              "CPU, all repeatable")

    # H/I on the 15-op's int8 masks (core (8,8,8)), widths 96 and 128
    masks = blocked.block_masks(idx, CELLS, WINDOW, torch.int8, CORE_15,
                                drop_self_slot0=True)
    mb, nb, et, p = masks.shape
    wide = MK.widen(masks).to(bf).reshape(mb * nb, et, p)
    out_kw = ({"out_dtype": torch.float32} if "out_dtype" in (torch.bmm.__doc__ or "")
              else {})
    for c in WIDE_WIDTHS:
        pat, ev = randn((mb, nb, p, c)), randn((mb, nb, et, c))
        got = MK.dot_gather(masks, pat)
        check(torch.equal(got, MK.mask_dot_gather_plain(masks, pat))
              and torch.equal(got, MK.dot_gather(masks, pat)),
              f"mask_dot_gather core {CORE_15} C={c} not bit-equal or not repeatable")
        got = MK.dot_scatter(masks, ev)
        _, worst = scatter_worst(got, MK.mask_dot_scatter_plain(masks, ev),
                                 MK.mask_dot_scatter_plain(masks, ev.abs()), False)
        check(worst <= 0 and torch.equal(got, MK.dot_scatter(masks, ev)),
              f"mask_dot_scatter core {CORE_15} C={c} out of tolerance or not "
              "repeatable")
        ops = 2.0 * mb * nb * et * p * c
        pl, el = pat.reshape(mb * nb, p, c), ev.reshape(mb * nb, et, c)
        time_row(f"mask_dot_gather int8 core {CORE_15} C={c}",
                 lambda: MK.dot_gather(masks, pat),
                 lambda: MK.mask_dot_gather_plain(masks, pat),
                 lambda: torch.bmm(wide, pl, **out_kw),
                 bound(nbytes(masks, pat) + mb * nb * et * c * 4, ops,
                       H100_BF16_TC_OPS))
        time_row(f"mask_dot_scatter int8 core {CORE_15} C={c}",
                 lambda: MK.dot_scatter(masks, ev),
                 lambda: MK.mask_dot_scatter_plain(masks, ev),
                 lambda: torch.bmm(wide.transpose(1, 2), el, **out_kw),
                 bound(nbytes(masks, ev) + mb * nb * p * c * 4, ops,
                       H100_BF16_TC_OPS))
    print(f"kernels H/I int8 {tuple(masks.shape)} C in {WIDE_WIDTHS}: gather "
          "bit-equal, scatter within 1e-5 of the summed |terms|, repeatable")
    del masks, wide
    return graph


def check_edge_epilogue(dev, graph):
    """Phase 17 (a): the fused edge epilogue and the transpose's assembly
    (csrc/edge_epilogue.cu) at every layer's (C, q) of GRAPH_CHANNELS on
    the card's 32^3 b4 graph, f32 operands with the bf16 biases the bf16
    model hands them, and layer 0's (C, q) in bf16: the forward against
    its twin (the unfused PyTorch chain, run on the card) equal as values
    and bit for bit where nonzero, and identical across two launches; the
    backward against its twin (the elementwise gradients equal, the sums
    within 1e-5 of the summed |terms|, plus one bf16 unit for bf16
    results) and identical across two launches; the transpose and its
    backward equal to theirs.  Each is timed beside its logical bytes'
    bound at 3.35 TB/s (each operand the kernel needs read once, dead
    rows of block B not read, each result written once) and the unfused
    chain (forward; autograd's backward of it), and its kernels' names
    land in the benchmark's "other" bucket.  Returns the timings and
    errors of every case, and the kernels line's record of each wrapper
    at the main path's widest layer (C = q = 64, f32)."""
    from benchmark_torch.yardstick.buckets import bucket_of
    from nbody_tpu_torch.ops.kernels import edge_epilogue as EE

    gen = torch.Generator(device=dev).manual_seed(16)
    f32, bf = torch.float32, torch.bfloat16
    mask_b = graph.mask_b
    b, n, k = mask_b.shape
    rows, live = b * n * k, float(mask_b.mean())

    def randn(*shape, dt=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def same(a, w):
        """Equal as values, and bit for bit where nonzero."""
        nz = w != 0
        return (a.dtype == w.dtype and torch.equal(a, w)
                and torch.equal(a[nz].float().view(torch.int32),
                                w[nz].float().view(torch.int32)))

    def unfused_backward(fn, inputs, grad):
        leaves = [x.detach().requires_grad_() if x is not None else None
                  for x in inputs]
        out = fn(*leaves)
        need = [x for x in leaves if x is not None and x.is_floating_point()]
        return lambda: torch.autograd.grad(out, need, grad, retain_graph=True)

    summary, names = {}, set()
    cases = [((c, q), f32, i < len(EPILOGUE_LAYERS) - 1)
             for i, (c, q) in enumerate(EPILOGUE_LAYERS)]
    cases.append((EPILOGUE_LAYERS[0], bf, True))
    for (c, q), dt, relu in cases:
        label = f"C={c} q={q} {str(dt)[6:]}{' relu' if relu else ''}"
        select = q < c
        es = torch.tensor([], dtype=dt).element_size()
        bias = randn(2, q, dt=bf)
        terms = [randn(b, 2, n, k, q, dt=dt), randn(b, 2, n, k, q, dt=dt),
                 randn(b, n, k, q, dt=dt) if select else None,
                 randn(b, n, k, q, dt=dt), randn(b, n, k, q, dt=dt),
                 *(randn(b, n, q, dt=dt) for _ in range(5)),
                 *(randn(b, q, dt=dt) for _ in range(4)), bias[0], bias[1]]

        def fwd():
            return EE.edge_epilogue_forward(relu, mask_b, *terms)

        def plain():
            return EE.epilogue_plain(relu, mask_b, *terms)

        got, want = fwd(), plain()
        fwd_err = float((got - want).abs().max())
        check(same(got, want) and torch.equal(got, fwd()),
              f"edge epilogue {label}: not the unfused chain's values or bits, "
              "or not repeatable")
        grad = randn(b, 2, n, k, q)
        y = want if relu else None

        def bwd():
            return EE.edge_epilogue_backward(grad, y, mask_b, select, dt, bf)

        g1, g2 = bwd(), bwd()
        gw = EE.epilogue_backward_plain(grad, y, mask_b, select, dt, bf)
        gabs = EE.epilogue_backward_plain(grad.abs(), y, mask_b, select, f32, f32)
        worst, bwd_err = 0.0, 0.0
        for i, (a_, a2, w_, s_) in enumerate(zip(g1, g2, gw, gabs)):
            if w_ is None:
                check(a_ is None, f"edge epilogue backward {label}: gradient {i}")
                continue
            check(a_.dtype == w_.dtype and a_.shape == w_.shape
                  and torch.equal(a_, a2),
                  f"edge epilogue backward {label}: gradient {i} of dtype "
                  f"{a_.dtype} shape {tuple(a_.shape)}, or not repeatable")
            bwd_err = max(bwd_err, float((a_.float() - w_.float()).abs().max()))
            if i in (0, 1, 2, 3, 4, 7, 8, 9):           # elementwise: exact
                check(torch.equal(a_, w_),
                      f"edge epilogue backward {label}: gradient {i} differs")
                continue
            tol = 1e-5 * s_.float() + (bf16_ulp(w_) if w_.dtype == bf else 0.0)
            worst = max(worst, float(((a_.float() - w_.float()).abs() - tol).max()))
        check(worst <= 0, f"edge epilogue backward {label}: a sum off its twin "
                          f"by {worst:.3e} beyond 1e-5 of its |terms|")
        hu, hu32, nq = rows * q * es, rows * q * 4, b * n * q * es
        small = rows * 4 + 4 * b * q * es + 2 * q * 2
        rec = {"fwd": time_row(
            f"edge_epilogue_forward {label}", fwd, plain, None,
            bound((3 + 3 * live) * hu + 2 * hu32 + 5 * nq + small))}
        rec["bwd"] = time_row(
            f"edge_epilogue_backward {label}", bwd,
            unfused_backward(lambda *xs: EE.epilogue_plain(relu, mask_b, *xs),
                             terms, grad), None,
            bound((1 + relu) * (1 + live) * hu32 + (7 if select else 4) * hu
                  + 3 * nq + small))
        rec["fwd"]["max_abs_err"], rec["bwd"]["max_abs_err"] = fwd_err, bwd_err
        for key in ("fwd", "bwd"):
            rec[key]["share"] = rec[key]["bound_ms"] / rec[key]["ms"]
        if not select:                                  # the transpose, q >= C
            h, rev = randn(b, 2, n, k, c, dt=dt), randn(b, n, k, c, dt=dt)
            t_got = EE.edge_transpose_forward(h, rev, mask_b)
            t_want = EE.transpose_plain(h, rev, mask_b)
            gt = randn(b, 2, n, k, c)
            tb = EE.edge_transpose_backward(gt, mask_b, dt)
            tbw = EE.transpose_backward_plain(gt, mask_b, dt)
            check(same(t_got, t_want)
                  and all(same(x, w_) for x, w_ in zip(tb, tbw)),
                  f"edge transpose C={c} {dt}: not its twin's values")
            hc, hc32 = rows * c * es, rows * c * 4
            rec["transpose_fwd"] = time_row(
                f"edge_transpose_forward C={c} {str(dt)[6:]}",
                lambda: EE.edge_transpose_forward(h, rev, mask_b),
                lambda: EE.transpose_plain(h, rev, mask_b), None,
                bound((1 + live) * hc + 2 * hc32 + rows * 4))
            rec["transpose_bwd"] = time_row(
                f"edge_transpose_backward C={c} {str(dt)[6:]}",
                lambda: EE.edge_transpose_backward(gt, mask_b, dt),
                unfused_backward(lambda a, r: EE.transpose_plain(a, r, mask_b),
                                 (h, rev), gt), None,
                bound((1 + live) * hc32 + 3 * hc + rows * 4))
            rec["transpose_fwd"]["max_abs_err"] = float((t_got - t_want).abs().max())
            rec["transpose_bwd"]["max_abs_err"] = max(
                float((x.float() - w_.float()).abs().max()) for x, w_ in zip(tb, tbw))
            for key in ("transpose_fwd", "transpose_bwd"):
                rec[key]["share"] = rec[key]["bound_ms"] / rec[key]["ms"]
            names.update(r[0] for r in cuda_profile(
                lambda: (EE.edge_transpose_forward(h, rev, mask_b),
                         EE.edge_transpose_backward(gt, mask_b, dt)), 5))
        names.update(r[0] for r in cuda_profile(lambda: (fwd(), bwd()), 5))
        summary[label] = rec
    ours = sorted(nm for nm in names if "edge_" in nm)
    bad = [nm for nm in ours if bucket_of(nm) != "other"]
    symbols = [sym for sym in REPO_SYMBOLS if sym.startswith("edge_")]
    print(f"edge epilogue and transpose at {len(cases)} (C, q) cases on the 32^3 "
          f"b4 graph (live block B {live:.4f}): forward equal to the unfused "
          f"chain bit for bit, backward within its sums' tolerance, all "
          f"repeatable; kernels {ours}")
    check(all(any(sym + "<" in nm or sym + "(" in nm for nm in ours)
              for sym in symbols) and not bad,
          f"edge epilogue kernels {ours}: {bad} land in a benchmark bucket "
          f"other than other, or one of {symbols} did not run")
    main = summary["C=64 q=64 float32 relu"]
    return summary, {"edge_epilogue_forward": main["fwd"],
                     "edge_epilogue_backward": main["bwd"],
                     "edge_transpose_forward": main["transpose_fwd"],
                     "edge_transpose_backward": main["transpose_bwd"]}


def route_cfg(C, ds, family="shiftinv15", dtype="bfloat16", iters=3, batch=BATCH,
              **model):
    """Phase 17's configurations: GRAPH_CHANNELS, K 14, window 2."""
    return C.Config(ds.cfg, C.ModelConfig(
        family=family, channels=tuple(C.GRAPH_CHANNELS), k_neighbors=K,
        dtype=dtype, knn_window=WINDOW, **model),
        C.TrainConfig(num_iters=iters, batch_size=batch, learn_rate=1e-3,
                      checkpoint_every=iters))


def profile_step(cfg, dev, dataset, x, y, label, out):
    """One route's eager 15-op train step under torch.profiler: device
    busy, the elementwise kernels' share, the top kernels and the repo's
    kernels a step, printed and added to `out`."""
    from nbody_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, dev, dataset=dataset)
    busy, elementwise, top, repo = device_breakdown(
        lambda: trainer.train_step(x, y), 3)
    print(f"15-op {label} step under torch.profiler: device busy {busy:.3f} ms, "
          f"elementwise kernels {elementwise:.3f} ms ({elementwise / busy:.3f}); "
          f"the repo's kernels [ms, launches] a step {repo}; top kernels (name, "
          f"ms, launches a step): {top}")
    out.update(busy_profile_ms=busy, elementwise_ms=elementwise, repo_kernels=repo)
    del trainer


def run_shiftinv15(dev, C, dataset, idx0):
    """Phase 17 (a-e): the 15-op family at full width on every route, its
    parity checks, and the CLI.  Returns the edge epilogue's kernels line
    records (check_edge_epilogue) and the direct route's launches a
    step."""
    from nbody_tpu_torch.cli import eval as cli_eval
    from nbody_tpu_torch.cli import train as cli_train
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.physics.losses import loss_za
    from nbody_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    summary = {}
    graph = check_15op_kernels(dev, idx0)
    summary["edge_epilogue"], epilogue_rec = check_edge_epilogue(dev, graph)
    del graph
    torch.cuda.empty_cache()

    # (c) the direct route through its entry points
    cfg = route_cfg(C, dataset, iters=5)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_every=1))
    trainer = Trainer(cfg, dev, dataset=dataset)
    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    cov = trainer.check_graph_coverage(x)
    print(f"15-op coverage guard: {cov} violations")
    check(cov == 0, "the lattice window does not cover the data")
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(verbose=True)
    fit_s = time.perf_counter() - t0
    errors, preds = trainer.evaluate("test", verbose=True)
    torch.cuda.synchronize()
    counts = launches()
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    print(f"15-op fit: 5 steps in {fit_s:.2f} s (host clock); losses {losses}; "
          f"launches during fit + evaluate {counts}")
    check(len(losses) == 5 and np.isfinite(losses).all(), "non-finite 15-op loss")
    check(set(counts) == {"lattice_knn", "neighbor_gather", "neighbor_segment_sum",
                          *S15_EPILOGUE_LAUNCHES},
          f"the 15-op direct route launched {counts}")
    check(preds.shape == (2, 4, CELLS ** 3, 3) and np.isfinite(preds).all()
          and np.isfinite(errors).all(), f"15-op evaluate cube {preds.shape}")
    check(trainer.model.impl_record.get("impl") == "direct",
          f"15-op route is {trainer.model.impl_record}")
    print(f"15-op evaluate: cube {preds.shape}, errors {errors.tolist()}")
    step = one_step_launches(trainer, x, y, S15_STEP_LAUNCHES, "15-op direct")
    del trainer
    torch.cuda.empty_cache()
    batches = minibatches(dataset, dev, 10, BATCH)
    summary["direct"] = step_forms(
        dev, lambda: Trainer(cfg, dev, dataset=dataset), batches, 6,
        "15-op 32^3 b4 K14 w2 bf16 direct")
    profile_step(cfg, dev, dataset, x, y, "direct", summary["direct"])

    # the other routes: eager against fit_scan's graph, 3 steps each
    for label, model, want, impl in (
            ("index", dict(mask_dtype="index"), S15_INDEX_STEP_LAUNCHES, "masked"),
            ("int8", dict(mask_dtype="int8"), S15_INT8_STEP_LAUNCHES, "masked"),
            ("block", dict(neighbor_impl="block"), S15_BLOCK_STEP_LAUNCHES, "block")):
        rcfg = route_cfg(C, dataset, **model)
        rec = eager_vs_graph(dev, dataset, rcfg, want,
                             f"15-op {label} route")
        check(rec.get("impl") == impl and (impl != "masked"
                                           or rec.get("core") == list(CORE_15)),
              f"15-op {label} route is {rec}")
        trainer = Trainer(rcfg, dev, dataset=dataset)
        ms, peak = step_time(trainer, x, y, 3, f"15-op 32^3 b4 K14 w2 bf16 "
                                               f"{label} route")
        summary[label] = {"ms": ms, "peak_mib": peak / 2**20}
        del trainer
        profile_step(rcfg, dev, dataset, x, y, label, summary[label])

    # (d) parity: card vs CPU in f32 (32^3 b1), the routes against direct
    # in bf16, and fit_scan against fit
    mcfg = route_cfg(C, dataset, dtype="float32").model
    xb, yb = split_batch(torch.as_tensor(dataset.X_test[:1]))
    res = {}
    state = None
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(mcfg, box=dataset.box, device=d)
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        with torch.no_grad():
            pred = model(xb.to(d))
            res[key] = (pred.cpu(), float(loss_za(pred, yb.to(d))))
    (pd, ld), (pc, lc) = res["card"], res["cpu"]
    rel = abs(ld - lc) / abs(lc)
    fwd = float((pd - pc).norm() / pc.norm())
    print(f"15-op card vs CPU f32 (32^3 b1): loss {ld!r} vs {lc!r} (rel "
          f"{rel:.2e}); forward rel L2 {fwd:.2e}, max |diff| / max |cpu| "
          f"{float((pd - pc).abs().max() / pc.abs().max()):.2e}")
    check(rel <= 1e-4 and fwd <= 1e-4, "15-op card and CPU f32 disagree")
    for model in (dict(mask_dtype="index"), dict(mask_dtype="int8"),
                  dict(neighbor_impl="block")):
        cross_route(dev, C, dataset, family="shiftinv15", **model)
    cfg3 = route_cfg(C, dataset)
    eager, graph = Trainer(cfg3, dev, dataset=dataset), Trainer(cfg3, dev, dataset=dataset)
    eager.fit(verbose=False)
    graph.fit_scan(scan_chunk=3, verbose=False)
    le, lg = eager.train_error_history, graph.train_error_history
    rel = abs(le[-1] - lg[-1]) / abs(le[-1])
    print(f"15-op fit vs fit_scan, 3 steps bf16: {le} vs {lg} (rel {rel:.2e})")
    check(len(le) == len(lg) == 1 and rel <= 1e-3, "15-op fit_scan off fit")
    del eager, graph
    torch.cuda.empty_cache()

    # (e) the CLI in-process
    flags = ["-k", str(K), "--cells", str(CELLS), "--knn_window", str(WINDOW),
             "--dtype", "bfloat16", "--synthetic", "--samples", "16", "-t", "4",
             "-b", str(BATCH)]
    with experiments_dir() as exp:
        out = run_cli(cli_train.main, ["--model", "shiftinv15"] + flags + [
            "--scan", "5", "-i", "10", "-n", "s15"])
        med = [ln for ln in out.splitlines() if "median :" in ln][-1]
        out = run_cli(cli_eval.main, ["--model", "shiftinv15"] + flags + ["-n", "s15"])
        check("Restored checkpoint at step 10" in out and
              [ln for ln in out.splitlines() if "median :" in ln][-1] == med,
              "cli.eval does not reproduce the 15-op train run")
        cube = np.load(os.path.join(exp, "ZA-FPM_0_s15", "Results",
                                    "X_0_prediction.npy"))
        check(cube.shape == (2, 4, CELLS ** 3, 3) and np.isfinite(cube).all(),
              f"15-op eval cube {cube.shape}")
        for extra, impl in ((["--impl", "banded"], "banded"), (["--remat"], "direct")):
            out = run_cli(cli_train.main, ["--model", "shiftinv"] + flags + extra
                          + ["-i", "3", "-n", "opt"])
            check(f"'impl': '{impl}'" in out and "Training finished!" in out,
                  f"cli.train {extra} did not run its route")
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"shiftinv15 (phase 17 a-e): {json.dumps(summary)}")
    return epilogue_rec, step


def run_graph_options(dev, C, dataset):
    """Phase 17 (f, g): --remat on the main path and the 15-op direct
    route, and the exact and banded kNN and a non-cube forward, card
    against CPU."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.ops.banded import default_band
    from nbody_tpu_torch.ops.knn import knn_periodic_batch
    from nbody_tpu_torch.physics.losses import loss_za
    from nbody_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    summary = {}
    # (f) remat on the main path, f32: gradients, launches, memory, time
    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    grads, state = {}, None
    for remat in (False, True):
        cfg = route_cfg(C, dataset, family="shiftinv", dtype="float32", remat=remat)
        trainer = Trainer(cfg, dev, dataset=dataset)
        if state is None:      # a copy: the steps below update the params
            state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        else:
            trainer.model.load_state_dict(state)
        trainer.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        loss = loss_za(trainer.model(x), y)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        grads[remat] = torch.cat([p.grad.ravel() for p in trainer.model.parameters()])
        print(f"main path f32 32^3 b4, remat={remat}: loss {float(loss.detach())!r}, "
              f"peak of one forward + backward {peak / 2**20:.1f} MiB")
        summary[f"remat_{remat}_peak_mib"] = peak / 2**20
        one_step_launches(trainer, x, y,
                          REMAT_STEP_LAUNCHES if remat else
                          {"lattice_knn": 1, "neighbor_gather": 12,
                           "neighbor_segment_sum": 11, **EPILOGUE4_STEP_LAUNCHES},
                          f"main path remat={remat}")
        summary[f"remat_{remat}"] = step_time(trainer, x, y, 5,
                                              f"main path f32, remat={remat}")
        del trainer
    g0, g1 = grads[False], grads[True]
    diff = float((g1 - g0).abs().max() / g0.abs().max())
    print(f"remat gradients against the plain step's: bit-equal "
          f"{torch.equal(g0, g1)}, max |diff| / max |grad| {diff:.2e}")
    check(torch.allclose(g1, g0, rtol=1e-6, atol=0), "remat gradients differ")
    eager_vs_graph(dev, dataset, route_cfg(C, dataset, family="shiftinv",
                                           remat=True),
                   REMAT_STEP_LAUNCHES, "main path bf16 --remat")
    eager_vs_graph(dev, dataset, route_cfg(C, dataset, remat=True),
                   S15_REMAT_STEP_LAUNCHES, "15-op direct bf16 --remat")

    # (g) the exact and banded kNN at 32^3 b1, card against CPU
    xb, yb = split_batch(torch.as_tensor(dataset.X_test[:1]))
    pn = pos_norm(xb, dataset.box)
    band = default_band(CELLS, WINDOW)
    for label, kw in (("exact", {}), (f"banded (band {band})", {"band": band})):
        t0 = time.perf_counter()
        got = knn_periodic_batch(pn.to(dev), K, **kw)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = knn_periodic_batch(pn, K, **kw)
        t_cpu = time.perf_counter() - t0
        rows = int((got.cpu() != want).any(-1).sum())
        print(f"{label} kNN 32^3 b1 K{K}: {rows} rows differ from the CPU's "
              f"(card {t_card:.2f} s, CPU {t_cpu:.2f} s, host clock)")
        check(rows == 0, f"the {label} kNN on the card differs from the CPU's")
    # a non-cube forward: 32^3 - 1 points, the lattice method's exact
    # fallback, f32, card against CPU
    xn, yn = xb[:, :-1].contiguous(), yb[:, :-1].contiguous()
    mcfg = route_cfg(C, dataset, family="shiftinv", dtype="float32").model
    res, state = {}, None
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(mcfg, box=dataset.box, device=d)
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        with torch.no_grad():
            idx = model.knn_fn(xn.to(d))
            pred = model.apply_with_idx(xn.to(d), idx)
            res[key] = (idx.cpu(), pred.cpu(), float(loss_za(pred, yn.to(d))),
                        dict(model.impl_record))
    (id_d, p_d, l_d, r_d), (id_c, p_c, l_c, _) = res["card"], res["cpu"]
    rel = abs(l_d - l_c) / abs(l_c)
    fwd = float((p_d - p_c).norm() / p_c.norm())
    print(f"non-cube forward ({CELLS ** 3 - 1} points, {r_d['impl']} route): ids "
          f"equal {torch.equal(id_d, id_c)}; loss {l_d!r} vs {l_c!r} (rel "
          f"{rel:.2e}); forward rel L2 {fwd:.2e}, max |diff| / max |cpu| "
          f"{float((p_d - p_c).abs().max() / p_c.abs().max()):.2e}")
    check(torch.equal(id_d, id_c) and rel <= 1e-4 and fwd <= 1e-4
          and r_d["impl"] == "direct", "the non-cube forward disagrees with the CPU")
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"graph options (phase 17 f-g): {json.dumps(summary)}")


def check_fused(dev, idx):
    """Phase 13: kernel J on its slice's path -- the scripts/bench_fused.py
    workload at full size on the main path's graph: core (4,8,8) with
    C = q = 32 and every interior boundary of shiftinv, and core (8,8,8)
    with C = q = 32, one call of the wrapper each with the launches
    counted -- held against boundary_reference and identical across two
    launches; then small blocks: f32 masks (the CUDA-core form), bf16 with
    row tiles that end past ET and q 3, and a forced cluster of 2; times
    at every path shape (events and device) beside the bound and the
    unfused bf16 chain.  Returns (record, launches on the path)."""
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import fused_kernels as FK

    g = torch.Generator(device=dev).manual_seed(3)
    rec = {"max_abs_err": 0.0, "library_ms": None}
    bf = torch.bfloat16
    bf_tol = ((2e-2, 2e-2), (2e-2, 2e-1), (2e-2, 2e-1))

    def inputs(masks, c, q, dt, scales):
        b, nb, et, p = masks.shape
        return tuple((torch.randn(shape, generator=g, device=dev) * sc).to(dt)
                     for shape, sc in (((b, nb, p, c), scales[0]),
                                       ((b, nb, et, c), scales[1]),
                                       ((c, q), scales[2]), ((c, q), scales[2])))

    def hold(masks, args, got, tol, label):
        want = FK.boundary_reference(masks, *args)
        for name, gv, wv, (rtol, atol) in zip(("act", "h1", "s"), got, want, tol):
            err = (gv.float() - wv.float()).abs()
            worst = float((err - (atol + rtol * wv.float().abs())).max())
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
            print(f"kernel J {label} {name}: max|err| {float(err.max()):.3e} "
                  f"(rtol {rtol}, atol {atol}; worst {worst:.3e})")
            check(worst <= 0 and gv.dtype == wv.dtype and gv.shape == wv.shape,
                  f"fused_boundary_dot {label} {name} out of tolerance")

    def same(call, first, label):
        again = call()
        torch.cuda.synchronize()
        ok = all(torch.equal(x, y) for x, y in zip(first, again))
        print(f"kernel J {label}: identical across two launches {ok}")
        check(ok, f"fused_boundary_dot {label} differs between two launches")

    def chain_ms(masks, args):
        """The unfused chain of bf16 torch.matmul calls (reads the mask
        twice): the yardstick a fused kernel must beat."""
        b, nb, et, p = masks.shape
        pat, a, w1, w2 = args
        m2 = masks.reshape(b * nb, et, p)
        mt, p2 = m2.transpose(1, 2), pat.reshape(b * nb, p, -1)
        a2 = a.reshape(b * nb, et, -1)

        def run():
            act = torch.relu(torch.matmul(m2, p2) + a2)
            torch.matmul(act, w1)
            torch.matmul(mt, torch.matmul(act, w2))
        return cuda_ms(run, iters=5, warmup=1)

    # the slice's path: at each shape one wrapper call with the count set
    # to 0 just before and read just after; then its checks and times
    path = [(MASK_CORE, c, q) for c, q in FUSED_BOUNDARIES] + [((8, 8, 8), 32, 32)]
    path_launches = 0
    masks = None
    for core, c, q in path:
        if masks is None or core != MASK_CORE:
            masks = None
            torch.cuda.empty_cache()
            masks = blocked.block_masks(idx, CELLS, WINDOW, bf, core,
                                        drop_self_slot0=True)
        args = inputs(masks, c, q, bf, (1.0, 0.01, 0.1))
        reset_counts()
        got = FK.fused_boundary_dot(masks, *args)
        torch.cuda.synchronize()
        n = launches()["fused_boundary_dot"]
        check(n == 1, f"kernel J launched {n} times on one path call")
        path_launches += n
        b, nb, et, p = masks.shape
        tl = FK.fused_tiling(p, c, q, FK.max_smem(dev))
        label = (f"core {core} {tuple(masks.shape)} C={c} q={q} (cluster "
                 f"{tl.cluster}, {tl.warps}+1 warps, {tl.rows}-row stages x "
                 f"{tl.stages})")
        hold(masks, args, got, bf_tol, label)
        call = lambda: FK.fused_boundary_dot(masks, *args)
        same(call, got, label)
        ms, dev_ms = cuda_ms(call, iters=5, warmup=1), device_ms(call, iters=5)
        yard = chain_ms(masks, args)
        # masks, patches, a_edge, W1, W2 in; act, h1, s out; the two mask
        # products and the two weight products on the bf16 tensor cores
        ms_bound, by = bound(nbytes(masks, *args, *got),
                             2.0 * b * nb * (et * p * c + 2 * et * c * q + et * p * q),
                             H100_BF16_TC_OPS)
        print(f"time fused_boundary_dot core {core} C={c} q={q}: kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f}), bound {ms_bound:.4f} ms ({by}), share "
              f"{ms_bound / dev_ms:.3f} of the device time; unfused bf16 "
              f"torch.matmul chain {yard:.4f} ms")
        if core == MASK_CORE and (c, q) == (32, 32):
            rec.update(ms=ms, bound_ms=ms_bound, bound_by=by, plain_ms=cuda_ms(
                lambda: FK.boundary_reference(masks, *args), iters=3, warmup=1))
            print(f"time fused_boundary_dot bench shape: plain {rec['plain_ms']:.4f} ms")
        del got, args
    print(f"kernel J path: {len(path)} shapes, {path_launches} launches")
    del masks
    torch.cuda.empty_cache()

    # small blocks: f32 masks at core (2,2,2) (P 216, ET 104; exact f32 on
    # the CUDA cores); bf16 at core (2,2,4) (P 288, ET 208) and (2,2,2), with
    # 32- and 16-row stages that end past ET, C 16 / 8 and q 3; f32 weights;
    # a cluster of 2 forced at core (2,2,4)
    for dt, core, c, q, tol in ((torch.float32, (2, 2, 2), 16, 16, ((1e-5, 1e-5),) * 3),
                                (bf, (2, 2, 4), 16, 16, bf_tol), (bf, (2, 2, 4), 8, 8, bf_tol),
                                (bf, (2, 2, 2), 16, 3, bf_tol), (bf, (2, 2, 2), 64, 64, bf_tol)):
        small = blocked.block_masks(idx[:1], CELLS, WINDOW, dt, core,
                                    drop_self_slot0=True)[:, :64].contiguous()
        args = inputs(small, c, q, dt, (1.0, 1.0, 1.0))
        label = f"{str(dt).split('.')[-1]} core {core} {tuple(small.shape)} C={c} q={q}"
        got = FK.fused_boundary_dot(small, *args)
        hold(small, args, got, tol, label)
        same(lambda: FK.fused_boundary_dot(small, *args), got, label)
    small = blocked.block_masks(idx[:1], CELLS, WINDOW, bf, (2, 2, 4),
                                drop_self_slot0=True)[:, :64].contiguous()
    # bf16 masks with f32 a_edge and weights (the weight products in f32 on
    # the CUDA cores)
    pat, a, w1, w2 = inputs(small, 16, 16, torch.float32, (1.0, 1.0, 1.0))
    args = (pat.to(bf), a, w1, w2)
    label = "bf16 masks, f32 a_edge and weights, core (2,2,4) C=q=16"
    got = FK.fused_boundary_dot(small, *args)
    hold(small, args, got, bf_tol, label)
    same(lambda: FK.fused_boundary_dot(small, *args), got, label)
    args = inputs(small, 32, 32, bf, (1.0, 1.0, 1.0))
    b, nb, et, p = small.shape
    tl = FK.fused_tiling(p, 32, 32, FK.max_smem(dev), cluster=2)

    def forced():
        outs = (torch.empty((b, nb, et, 32), dtype=bf, device=dev),
                torch.empty((b, nb, et, 32), device=dev),
                torch.empty((b, nb, p, 32), device=dev))
        FK.launch(FK.library(), tl, small, *args, outs)
        return outs
    got = forced()
    label = f"bf16 core (2,2,4) C=q=32, cluster of {tl.cluster}"
    hold(small, args, got, bf_tol, label)
    same(forced, got, label)
    return rec, path_launches


def cross_route(dev, C, dataset, mask_dtype="index", family="shiftinv", **route):
    """Phases 9, 12 and 17: one batch, one set of params, the index (D/E),
    int8 (H/I) or, with neighbor_impl="block", block (F/G) route against
    the direct route (B/C) of `family`, bf16 loss and gradients."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.physics.losses import loss_za

    route = route or {"mask_dtype": mask_dtype}
    label = route.get("mask_dtype", route.get("neighbor_impl"))
    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    out = {}
    params = None
    for name, kw in (("direct", {}), ("route", route)):
        model = build_model(C.ModelConfig(
            family=family, channels=tuple(C.GRAPH_CHANNELS), k_neighbors=K,
            dtype="bfloat16", knn_window=WINDOW, **kw),
            box=4.0 * CELLS, device=dev)
        if params is None:
            params = model.params
        else:
            model.params.load_state_dict(params.state_dict())
        loss = loss_za(model(x), y)
        loss.backward()
        grads = torch.cat([p.grad.double().ravel() for p in model.parameters()])
        out[name] = (float(loss.detach()), grads, dict(model.impl_record))
        del model
    (ld, gd, rd), (li, gi, ri) = out["direct"], out["route"]
    rel = abs(li - ld) / abs(ld)
    cos = float(gd @ gi / (gd.norm() * gi.norm()))
    print(f"cross-route bf16 {family} (32^3 b4): direct {rd['impl']} loss {ld!r}, "
          f"{label} {ri['impl']} {ri['core']} loss {li!r}: rel {rel:.2e}, "
          f"gradient cosine {cos:.6f}")
    check(rd["impl"] == "direct" and ri["impl"] == (
        "block" if label == "block" else "masked") and ri["mask_dtype"] == (
        None if label == "block" else label), "routes not taken")
    check(rel <= 3e-2 and cos > 0.998, f"{family}: {label} and direct routes "
                                       "disagree")


def replay_kernels(scan, batch, tries=3):
    """(timeline segments ms, [(start us, end us)] of the device
    activities) of one profiled fit_scan step on `batch` (1, b, N, C)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            scan.run(batch, 6)
            torch.cuda.synchronize()
        kern = [(e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        if kern:
            return scan.timeline.segments_ms(), kern
    raise RuntimeError("chip_smoke: torch.profiler saw no device activity in "
                       f"{tries} windows of one replay")


def union_us(intervals):
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def step_phases(segments):
    """{forward, backward, adam} ms of a step's timeline, as the
    benchmark's readers split it (benchmark_torch/yardstick/samples.py)."""
    from benchmark_torch.yardstick import samples
    return {p: samples.phase_ms(segments, p) for p in samples.PHASES}

def run_tracing(dev, C, dataset):
    """Phase 18: the program's tracing (nbody_tpu_torch/tracing.py) on the
    main path at 32^3 b4 bf16.  With no profiler an eager train step and a
    rollout hop create no CUDA event and mark nothing; fit_scan's capture
    records the step's timeline into the graph (external timing events)
    and counts nothing itself; a chunk of T replays then moves
    graph.replays by T, graph.captures by 0, every launch counter by T
    times the capture's (STEP_LAUNCHES), loss.particles by T*b*N and
    timeline.marks by T times the timeline's marks; the replayed
    timeline's segments, all non-negative, sum to within 5 % of one
    profiled replay's extent on the card (first kernel's start to last
    kernel's end; its busy time printed beside); a profiled fit_scan of a fresh
    trainer takes one sample a chunk, with its own graph counts, and the
    program's spans appear among the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch import tracing
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.train.rollout import make_rollout, stack_params
    from nbody_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    summary = {}
    cfg = C.Config(dataset.cfg, C.ModelConfig(
        family="shiftinv", channels=tuple(C.GRAPH_CHANNELS), k_neighbors=K,
        dtype="bfloat16", knn_window=WINDOW),
        C.TrainConfig(num_iters=20, batch_size=BATCH, learn_rate=1e-3,
                      checkpoint_every=10))
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, dev, dataset=dataset)
    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    batches = minibatches(dataset, dev, 12, BATCH)
    made = []
    real_event = torch.cuda.Event

    def counted_event(*args, **kwargs):
        made.append(bool(kwargs.get("external", False)))
        return real_event(*args, **kwargs)

    torch.cuda.Event = counted_event
    try:
        reset_counts()
        trainer.train_step(x, y)
        model = trainer.model
        make_rollout(model)(stack_params([dict(model.named_parameters())]), x)
        torch.cuda.synchronize()
        quiet = tracing.counters()
        print(f"no profiler: an eager step and a rollout hop created {len(made)} "
              f"CUDA events; counters {quiet}")
        check(not made and "timeline.marks" not in quiet
              and trainer.train_step.timeline is None,
              "an eager step or a rollout hop with no profiler created CUDA "
              "events or marked its timeline")
        scan = trainer.train_scan
        scan.run(batches[:1], 6)                # the eager first step
        check(not made, "fit_scan's eager first step created CUDA events")
        reset_counts()
        scan.run(batches[1:2], 6)               # captured, then replayed
        torch.cuda.synchronize()
    finally:
        torch.cuda.Event = real_event
    tl = scan.timeline
    first = tracing.counters()
    names = tl.names
    print(f"the capture made {len(made)} CUDA events (external: "
          f"{sum(made)}); the step's marks {names}; counters after the "
          f"captured step's replay {first}")
    check(len(made) == len(names) and all(made),
          "the capture did not make one external event a mark")
    check(names[:4] == ["start", "knn", "plan", "features"]
          and names[-3:] == ["layer0.backward", "backward", "adam"]
          and "loss" in names, f"the step's marks are {names}")
    check(first.get("graph.captures") == 1 and first.get("graph.replays") == 1,
          f"the captured step counted {first}")
    once = {k: v for k, v in first.items() if k.startswith("launch.")}
    check(all(once.get("launch." + n, 0) == v for n, v in STEP_LAUNCHES.items()),
          f"the capture's launches {once}, expected {STEP_LAUNCHES}")

    steps = 10
    before = tracing.counters()
    scan.run(batches[2:2 + steps], 6)
    torch.cuda.synchronize()
    moved = tracing.delta(before)
    print(f"a chunk of {steps} replays moved {moved}")
    check(moved.get("graph.replays") == steps and "graph.captures" not in moved,
          f"{steps} replays moved the graph counters {moved}")
    check({k: v for k, v in moved.items() if k.startswith("launch.")}
          == {k: steps * v for k, v in once.items()},
          f"{steps} replays did not add {steps} times the capture's launches")
    check(moved.get("loss.particles") == steps * BATCH * CELLS ** 3,
          f"loss.particles moved {moved.get('loss.particles')}")
    check(moved.get("timeline.marks") == steps * len(names),
          "the replays did not record the timeline's marks")
    seg, kern = replay_kernels(scan, batches[:1])
    total = sum(seg.values())
    busy = union_us(kern) / 1e3
    extent = (max(e for _, e in kern) - min(s for s, _ in kern)) / 1e3
    phases = step_phases(seg)
    print(f"one profiled replay: timeline {total:.4f} ms ({phases}), device "
          f"busy {busy:.4f} ms, first kernel start to last end {extent:.4f} "
          f"ms; segments {seg}")
    check(all(np.isfinite(v) and v >= 0.0 for v in seg.values()) and total > 0,
          f"the replayed timeline's segments are {seg}")
    # the events time the step's span on the card, the gaps between its
    # kernels included: held to the replay's first-to-last kernel extent
    check(abs(total - extent) <= 0.05 * extent,
          f"the timeline's {total:.4f} ms is more than 5 % off the replay's "
          f"{extent:.4f} ms from its first kernel's start to its last's end")
    summary.update(timeline_ms=total, busy_ms=busy, extent_ms=extent,
                   phases_ms=phases, marks=len(names))
    del trainer, scan

    # a fresh trainer's fit_scan under a profiler: the warm step and the
    # capture in the first chunk, one sample a chunk, the program's spans
    tracing.reset()
    trainer = Trainer(cfg, dev, dataset=dataset)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit_scan(verbose=False, scan_chunk=10)
        torch.cuda.synchronize()
    got = tracing.samples()
    spans = {e.name for e in prof.events()} & {
        "fit_scan.stage", "fit_scan.steps", "fit_scan.read_losses",
        "coverage.exact", "coverage.monitor", "train_scan.warm_step",
        "train_scan.capture"}
    counts = [s["counts"] for s in got]
    print(f"profiled fit_scan of 20 steps in chunks of 10: {len(got)} samples, "
          f"graph counts {[(c.get('graph.captures', 0), c.get('graph.replays', 0)) for c in counts]}, "
          f"forward/backward/adam ms {[step_phases(s['device_ms']) for s in got]}; "
          f"spans seen {sorted(spans)}")
    check(len(got) == 2 and [s["steps"] for s in got] == [10, 10],
          f"the profiled fit_scan took {len(got)} samples")
    check([(c.get("graph.captures", 0), c.get("graph.replays", 0)) for c in counts]
          == [(1, 9), (0, 10)], f"the samples' graph counts are {counts}")
    check(all(s["device_ms"] for s in got)
          and all(r.get("device_ms") for r in trainer.metrics_log if "step" in r),
          "a chunk's record or sample has no device_ms")
    check(len(spans) == 7, f"the profiler saw the program's spans {sorted(spans)}")
    del trainer
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"tracing (phase 18): {json.dumps(summary)}")


# phase 19: the 4-op epilogue's cases: (form, the row axes of one sample,
# (C, q), dtype, relu) -- every layer of GRAPH_CHANNELS on the 32^3 cube
# form in bf16, three in f32 (the last on the narrow rows' kernels, as
# q 16, 6 and 3 in bf16), and the velocity net's q 64 and last layer on
# the 64^3 block-major form (core (4, 8, 8): NB 1,024 blocks of R 256)
EPILOGUE4_CASES = (
    *(("cube32", (CELLS ** 3,), cq, "bfloat16", i < len(EPILOGUE_LAYERS) - 1)
      for i, cq in enumerate(EPILOGUE_LAYERS)),
    ("cube32", (CELLS ** 3,), (64, 64), "float32", True),
    ("cube32", (CELLS ** 3,), (64, 32), "float32", True),
    ("cube32", (CELLS ** 3,), (16, 3), "float32", False),
    ("block64", (CELLS64 ** 3 // 256, 256), (64, 64), "bfloat16", True),
    ("block64", (CELLS64 ** 3 // 256, 256), (16, 6), "bfloat16", False),
)


def check_epilogue4(dev):
    """Phase 19: the 4-op layer's epilogue (csrc/epilogue4.cu) at
    EPILOGUE4_CASES, b4 K 14: the forward against its twin (the unfused
    chain, run on the card) equal as values and bit for bit where nonzero,
    identical across two launches, one launch counted; the backward's
    masked gradient equal to its twin's, its K, sample and batch sums
    within 1e-5 of the summed |terms| plus one bf16 unit for bf16 results,
    identical across two launches, one launch counted.  Each is timed
    beside its logical bytes' bound at 3.35 TB/s (forward: h1's q of each
    row, h2 and the output once each, h3, h4 and the bias once; backward:
    the gradient, under relu the output and the masked gradient, once
    each, and h3's gradient) and the unfused chain (forward; autograd's
    backward of it), and its kernels' names land in the benchmark's
    "other" bucket.  Returns the timings and errors of every case, and the
    kernels line's record of each wrapper at the main path's widest layer
    (C = q = 64, bf16, relu)."""
    from benchmark_torch.yardstick.buckets import bucket_of
    from nbody_tpu_torch.ops.kernels import epilogue4 as E4

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(19)
    summary, names = {}, set()

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def same(a, w):
        """Equal as values, and bit for bit where nonzero."""
        nz = w != 0
        return (a.dtype == w.dtype and torch.equal(a, w)
                and torch.equal(a[nz].float().view(torch.int32),
                                w[nz].float().view(torch.int32)))

    def counted(fn, name):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        check(launches() == {name: 1}, f"{name}: launches {dict(launches())}")
        return out

    for form, lead, (c, q), dtype, relu in EPILOGUE4_CASES:
        dt = getattr(torch, dtype)
        strided = q < c
        label = (f"{form} C={c} q={q} {dtype}{' relu' if relu else ''}"
                 f"{' strided h1' if strided else ''}")
        shape = (BATCH, *lead, K, q)
        h1 = (randn(*shape[:-1], 2 * q, dt=dt)[..., :q] if strided
              else randn(*shape, dt=dt))
        terms = (h1, randn(*shape, dt=dt), randn(BATCH, *lead, q, dt=dt),
                 randn(BATCH, q, dt=dt), randn(q, dt=dt))

        def fwd():
            return E4.epilogue4_forward(*terms, relu)

        def plain():
            return E4.epilogue4_plain(*terms, relu)

        got, want = counted(fwd, "epilogue4_forward"), plain()
        fwd_err = float((got.float() - want.float()).abs().max())
        check(same(got, want) and torch.equal(got, fwd()),
              f"epilogue4 {label}: not the unfused chain's values or bits, "
              "or not repeatable")
        del got
        grad = randn(*shape, dt=dt)
        y = want if relu else None
        dtypes = (dt,) * 5

        def bwd():
            return E4.epilogue4_backward(grad, y, dtypes)

        g1 = counted(bwd, "epilogue4_backward")
        g2 = bwd()
        gw = E4.epilogue4_backward_plain(grad, y, dtypes)
        check(all(a.dtype == w.dtype and a.shape == w.shape and torch.equal(a, a2)
                  for a, a2, w in zip(g1, g2, gw))
              and torch.equal(g1[0], gw[0]) and g1[1] is g1[0],
              f"epilogue4 backward {label}: the masked gradient differs from "
              "its twin's, or a result's dtype, shape or bits across launches")
        del g2
        gabs = E4.epilogue4_backward_plain(grad.abs().float(), y, (torch.float32,) * 5)
        worst, bwd_err = 0.0, 0.0
        for i in (2, 3, 4):
            a, w = g1[i].float(), gw[i].float()
            tol = 1e-5 * gabs[i] + (bf16_ulp(w) if dt == torch.bfloat16 else 0.0)
            bwd_err = max(bwd_err, float((a - w).abs().max()))
            worst = max(worst, float(((a - w).abs() - tol).max()))
        check(worst <= 0, f"epilogue4 backward {label}: a sum off its twin by "
                          f"{worst:.3e} beyond 1e-5 of its |terms|")
        del g1, gw, gabs
        es = torch.tensor([], dtype=dt).element_size()
        edge, node = h1.numel() * es, terms[2].numel() * es
        small = (BATCH * q + q) * es
        leaves = [x.detach().requires_grad_() for x in terms]
        out = E4.epilogue4_plain(*leaves, relu)

        def unfused_backward():
            return torch.autograd.grad(out, leaves, grad, retain_graph=True)

        rec = {"fwd": time_row(f"epilogue4_forward {label}", fwd, plain, None,
                               bound(3 * edge + node + small)),
               "bwd": time_row(f"epilogue4_backward {label}", bwd,
                               unfused_backward, None,
                               bound((3 if relu else 1) * edge + node + small))}
        rec["fwd"]["max_abs_err"], rec["bwd"]["max_abs_err"] = fwd_err, bwd_err
        for key in ("fwd", "bwd"):
            rec[key]["share"] = rec[key]["bound_ms"] / rec[key]["ms"]
        names.update(r[0] for r in cuda_profile(lambda: (fwd(), bwd()), 2))
        summary[label] = rec
        del h1, terms, grad, y, want, leaves, out
        torch.cuda.empty_cache()
    ours = sorted(nm for nm in names if "epilogue4" in nm)
    bad = [nm for nm in ours if bucket_of(nm) != "other"]
    symbols = ("epilogue4_kernel", "epilogue4_rows_kernel", "epilogue4_bwd_kernel",
               "epilogue4_sums_kernel")
    print(f"epilogue4 at {len(EPILOGUE4_CASES)} cases: forward equal to the "
          f"unfused chain bit for bit, backward within its sums' tolerance, "
          f"all repeatable; kernels {ours}")
    check(all(any(sym + "<" in nm for nm in ours) for sym in symbols) and not bad,
          f"epilogue4 kernels {ours}: {bad} land in a benchmark bucket other "
          f"than other, or one of {symbols} did not run")
    print(f"epilogue4 (phase 19, {time.perf_counter() - t_phase:.1f} s): "
          f"{json.dumps(summary)}")
    widest = summary["cube32 C=64 q=64 bfloat16 relu"]
    return {"epilogue4_forward": widest["fwd"], "epilogue4_backward": widest["bwd"]}


# phase 20: the block layout's shapes: (cube side, core, widths) of the
# velocity step (64^3 b4, core (4, 8, 8): counts 1, payload 6, channels
# 9-32-64-64-32-16-6) and the 15-op index step (32^3 b4, core (8, 8, 8):
# counts 1, 3, payload 6, fused widths 32-128), and the --impl block core
BLOCK_LAYOUT_CASES = (
    (CELLS64, (4, 8, 8), (1, 6, 9, 16, 32, 64)),
    (CELLS, (8, 8, 8), (1, 3, 6, 32, 64, 128)),
    (CELLS, (4, 4, 8), (64,)),
)


def check_block_layout(dev):
    """Phase 20: block_patches and patches_fold (csrc/block_layout.cu) at
    BLOCK_LAYOUT_CASES, b4 window 2, in f32 and bf16: each bit-equal to
    its plain version on the card (the fold also to the plain version on
    the CPU), identical across two launches, one launch counted; timed
    beside its bytes' bound at 3.35 TB/s (the input and the output once
    each) and its plain version, its kernels' names in the benchmark's
    "other" bucket.  Returns the kernels line's records (the velocity
    step's widest layer: block_patches in bf16, patches_fold in f32, C 64)."""
    from benchmark_torch.yardstick.buckets import bucket_of
    from nbody_tpu_torch.ops.kernels import block_layout as BL

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(20)
    summary, names = {}, set()

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def counted(fn, name):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        check(launches() == {name: 1}, f"{name}: launches {dict(launches())}")
        return out

    def timed(label, kern, plain, n_bytes):
        """CUDA-event ms of the kernel and its plain version, beside the
        bound of n_bytes (events only: torch.profiler drops the records
        of windows of short kernels)."""
        ms, plain_ms = cuda_ms(kern, iters=20), cuda_ms(plain, iters=5)
        b_ms, by = bound(n_bytes)
        print(f"time {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({by}); share {b_ms / ms:.3f}")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": b_ms, "bound_by": by, "share": b_ms / ms,
                "max_abs_err": 0.0}

    for cells, core, widths in BLOCK_LAYOUT_CASES:
        for c in widths:
            for dt in (torch.float32, torch.bfloat16):
                label = f"{cells}^3 b{BATCH} core {core} C={c} {str(dt)[6:]}"
                values = torch.randn(BATCH, cells ** 3, c, generator=gen,
                                     device=dev).to(dt)
                patches = counted(lambda: BL.block_patches(values, cells, WINDOW, core),
                                  "block_patches")
                want = BL.block_patches_plain(values, cells, WINDOW, core)
                check(torch.equal(bits(patches), bits(want)) and torch.equal(
                    bits(patches), bits(BL.block_patches(values, cells, WINDOW, core))),
                      f"block_patches {label}: not the plain version's bits, or "
                      "not repeatable")
                acc = torch.randn(want.shape, generator=gen, device=dev).to(dt)
                fold = counted(lambda: BL.patches_fold(acc, cells, WINDOW, core),
                               "patches_fold")
                fw = BL.patches_fold_plain(acc, cells, WINDOW, core)
                fc = BL.patches_fold_plain(acc.cpu(), cells, WINDOW, core)
                check(torch.equal(bits(fold), bits(fw))
                      and torch.equal(bits(fold.cpu()), bits(fc))
                      and torch.equal(bits(fold),
                                      bits(BL.patches_fold(acc, cells, WINDOW, core))),
                      f"patches_fold {label}: not the plain version's bits (card "
                      "or CPU), or not repeatable")
                rec = {"build": timed(
                           f"block_patches {label}",
                           lambda: BL.block_patches(values, cells, WINDOW, core),
                           lambda: BL.block_patches_plain(values, cells, WINDOW, core),
                           nbytes(values, patches)),
                       "fold": timed(
                           f"patches_fold {label}",
                           lambda: BL.patches_fold(acc, cells, WINDOW, core),
                           lambda: BL.patches_fold_plain(acc, cells, WINDOW, core),
                           nbytes(acc, fold))}
                if c == 64 and cells == CELLS64:
                    # a window of 10 calls: the profiler has dropped every
                    # record of a window of 2 (about 2 ms of kernels)
                    names.update(r[0] for r in cuda_profile(
                        lambda: (BL.block_patches(values, cells, WINDOW, core),
                                 BL.patches_fold(acc, cells, WINDOW, core)), 10))
                summary[label] = rec
                del values, patches, want, acc, fold, fw, fc
        torch.cuda.empty_cache()
    ours = sorted(nm for nm in names if "patch_build" in nm or "patch_fold" in nm)
    bad = [nm for nm in ours if bucket_of(nm) != "other"]
    print(f"block layout at {len(summary)} cases: both kernels bit-equal to their "
          f"plain versions, repeatable; kernels {ours}")
    check(any("patch_build_kernel" in nm for nm in ours)
          and any("patch_fold_kernel" in nm for nm in ours) and not bad,
          f"block layout kernels {ours}: {bad} land in a benchmark bucket other "
          "than other, or one did not run")
    print(f"block layout (phase 20, {time.perf_counter() - t_phase:.1f} s): "
          f"{json.dumps(summary)}")
    key = f"{CELLS64}^3 b{BATCH} core (4, 8, 8) C=64"
    return {"block_patches": summary[f"{key} bfloat16"]["build"],
            "patches_fold": summary[f"{key} float32"]["fold"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.data.dataset import Dataset, split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.ops.kernels import (banded_kernels, block_kernels,
                                             block_layout, build, edge_epilogue,
                                             epilogue4, fused_kernels,
                                             mask_kernels, topk_kernels)
    from nbody_tpu_torch.physics.losses import loss_za
    from nbody_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi name, power.limit: {smi}")

    # 2. build
    t0 = time.perf_counter()
    libraries = (topk_kernels.library, banded_kernels.library,
                 block_kernels.library, mask_kernels.library,
                 fused_kernels.library, edge_epilogue.library,
                 epilogue4.library, block_layout.library)
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda load: load(), libraries))
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          "(one nvcc per source, in parallel)")
    for lib, info in build.BUILD_INFO.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        print(f"  {lib}: nvcc {info['seconds']:.1f} s -> {info['path']}")
        for ln in ptxas:
            print(f"    {ln}")

    # the main path's data and a first batch, for realistic kernel inputs
    cfg = C.Config(
        data=C.DataConfig(
            data_dir=os.path.join(os.path.sep, "nonexistent-force-synthetic"),
            num_test=4, num_val=2, cells_per_side=CELLS,
            synthetic_num_samples=16),
        model=C.ModelConfig(family="shiftinv", channels=tuple(C.GRAPH_CHANNELS),
                            k_neighbors=K, dtype="bfloat16", knn_window=WINDOW),
        train=C.TrainConfig(num_iters=5, batch_size=BATCH, learn_rate=1e-3,
                            checkpoint_every=1))
    t0 = time.perf_counter()
    dataset = Dataset(cfg.data)
    print(f"dataset: {dataset.X_train.shape} train, {dataset.X_test.shape} test "
          f"({time.perf_counter() - t0:.1f} s)")
    trainer = Trainer(cfg, dev, dataset=dataset)
    x0, _ = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    idx0 = trainer.model.knn_fn(x0)
    torch.cuda.synchronize()

    # 3. kernels vs plain versions
    rec = check_knn_kernels(dev, pos_norm(x0, trainer.box))
    rec.update(check_kernels(dev, idx0))

    # 4. the main path: coverage guard, fit, evaluate
    cov = trainer.check_graph_coverage(x0)
    print(f"coverage guard: {cov} violations")
    check(cov == 0, "the lattice window does not cover the data")
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(verbose=True)
    fit_s = time.perf_counter() - t0
    errors, preds = trainer.evaluate("test", verbose=True)
    torch.cuda.synchronize()
    counters = launches()
    print(f"launches during fit + evaluate: {counters}")
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    print(f"fit: 5 steps in {fit_s:.2f} s (host clock, coverage check "
          f"included); losses {losses}")
    check(len(losses) == 5 and np.isfinite(losses).all(), "non-finite loss")
    check(all(counters[n] > 0 for n in
              ("lattice_knn", "neighbor_gather", "neighbor_segment_sum")),
          "a kernel was not launched")
    check(counters["topk_min"] == 0, "topk_min ran on the main path")
    check(preds.shape == (2, 4, CELLS ** 3, 3) and np.isfinite(preds).all(),
          f"evaluate cube {preds.shape} not finite / wrong shape")
    check(np.array_equal(preds[0], dataset.X_test[:4, :, 6:]),
          "evaluate slot 0 is not the truth")
    check(np.isfinite(errors).all(), "non-finite eval error")
    print(f"evaluate: cube {preds.shape}, errors {errors.tolist()}")

    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    reset_counts()
    trainer.train_step(x, y)
    torch.cuda.synchronize()
    step = launches()
    print(f"launches in one train step: {step}")
    check(all(step.get(n, 0) == want for n, want in STEP_LAUNCHES.items()),
          f"one train step launched {step}, expected {STEP_LAUNCHES}")
    step_time(trainer, x, y, 10, "32^3 b4 K14 w2 bf16")
    del trainer

    # 5. card vs CPU, f32, one cube
    mcfg = C.ModelConfig(family="shiftinv", channels=tuple(C.GRAPH_CHANNELS),
                         k_neighbors=K, dtype="float32", knn_window=WINDOW)
    xb, yb = split_batch(torch.as_tensor(dataset.X_test[:1]))
    losses_dev = {}
    idx_dev = {}
    for d in (dev, torch.device("cpu")):
        model = build_model(mcfg, box=4.0 * CELLS, device=d)
        with torch.no_grad():
            idx_dev[d.type] = model.knn_fn(xb.to(d)).cpu()
            losses_dev[d.type] = float(loss_za(model(xb.to(d)), yb.to(d)))
    rel = abs(losses_dev["cuda"] - losses_dev["cpu"]) / abs(losses_dev["cpu"])
    idx_rows = int((idx_dev["cuda"] != idx_dev["cpu"]).any(-1).sum())
    print(f"card vs CPU f32 loss: {losses_dev['cuda']!r} vs {losses_dev['cpu']!r} "
          f"(rel {rel:.2e}); kNN rows differing: {idx_rows}")
    check(rel <= 1e-4, "card and CPU f32 losses disagree")

    # 6. kernels D-G vs plain versions, at the shapes of the 64^3 graph
    ds64, trainer64 = make_vel64(dev, C)
    x64, _ = split_batch(torch.as_tensor(ds64.X_train[:1], device=dev), 9)
    idx64 = trainer64.model.knn_fn(x64)
    want64 = topk_kernels.lattice_knn_plain(pos_norm(x64, trainer64.box), K,
                                            CELLS64, WINDOW)
    bad = int((idx64 != want64).any(dim=-1).sum())
    print(f"kernel A lattice_knn 64^3 b1 window {WINDOW}: {bad} rows differ "
          "from the plain version")
    check(bad == 0, "lattice_knn differs from its plain version at 64^3")
    rec.update(check_select_kernels(dev, idx64, idx0))
    del x64, idx64, want64
    # 7. the 64^3 shiftinv_vel index path
    counts64 = run_vel64(dev, ds64, trainer64)
    del trainer64
    for n in ("idx_dot_gather", "idx_dot_scatter"):
        counters[n] = counts64[n]
    # 8. the --impl block route
    counts_block = run_block32(dev, C, dataset)
    for n in ("block_gather", "block_scatter"):
        counters[n] = counts_block[n]
    # 9. index route against the direct route
    cross_route(dev, C, dataset, "index")
    # 10. kernels H/I vs plain versions, on the main path's graph
    rec.update(check_mask_kernels(dev, idx0))
    # 11. the int8 and int4 mask routes
    counts_int = run_int_route(dev, C, dataset)
    for n in ("mask_dot_gather", "mask_dot_scatter"):
        counters[n] = counts_int[n]
    # 12. int8 route against the direct route
    cross_route(dev, C, dataset, "int8")
    # 13. kernel J vs boundary_reference
    rec["fused_boundary_dot"], counters["fused_boundary_dot"] = check_fused(dev, idx0)
    # 14. the run around the step: fit_scan's CUDA graph, the CLI
    run_scan(dev, C, dataset, ds64)
    # 15. the set and attn families, cli.experiment
    run_set_attn(dev, C, dataset)
    # 16. the redshift-chain rollout at full width, cli.rollout
    run_rollout(dev, C)
    # 17. the 15-op family on every route, --remat, the kNN methods
    epilogue_rec, s15_step = run_shiftinv15(dev, C, dataset, idx0)
    rec.update(epilogue_rec)
    for n in epilogue_rec:
        counters[n] = s15_step[n]
    run_graph_options(dev, C, dataset)
    # 18. the program's tracing: timeline, counters, samples, spans
    run_tracing(dev, C, dataset)
    # 19. the 4-op layer's epilogue on the cube and block-major forms
    rec.update(check_epilogue4(dev))
    for n in EPILOGUE4_STEP_LAUNCHES:
        counters[n] = step[n]
    # 20. the masked route's block layout
    rec.update(check_block_layout(dev))
    for n in BLOCK_LAYOUT_STEP_LAUNCHES:
        counters[n] = counts64[n]

    kernels = [{"name": n, "route": "cuda", "source": REPO_KERNELS[n][0],
                "replaces": REPO_KERNELS[n][1], "launches": counters[n],
                **{key: rec[n][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}} for n in REPO_KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
