#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cuahn_vio_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:

1. build the kernels with nvcc for sm_90a, one nvcc per source, started
   together (``cuahn_vio_torch/ops/cuda/warp.cu``: the warp B1/B2, the
   row-band warp B3 and the flat sampler B4; ``remap.cu``: the
   undistortion remap C1; ``prng.cu``: the threefry kernel T1; ``conv.cu``:
   V1, the towers' low-channel convolutions; ``conv_gemm.cu``: V2, the
   towers' other layers of blocks 2-4, with its split path V2K; a copy of
   it with V2K's shapes on their whole-K tilings, phase 3's yardstick
   ``V2_WHOLE_K``; ``heads.cu``: H1, the two MC-dropout heads), and print
   each kernel's registers, shared memory and spill bytes (``-Xptxas
   -v``);
2. hold each kernel to its plain PyTorch version on the card, uint8 and
   float32, bit for bit (max abs error 0.0, NaN exactly where the plain
   version has NaN): the warp at 224x320 with B in {1, 4, 8, 65} (and, in
   float32, at the trainer's B = 16 and its probe's B = 32), at the
   ragged 224x317, 7x5 and 6x3 (B = 8) and on 50,000 6x3 images (widths
   that are not a multiple of a thread's pixels, narrower than one
   thread's 8 pixels) with near-identity, off-image, z <= 0, NaN, z = 0
   (+-inf and NaN coordinates) and rolled homographies, and in uint8 at
   close-loops' B = 64; the row-band warp on the same cases and on rolls whose
   tiles' bands lie just under and just over its shared band (8.8 deg for
   uint8, 1.8 deg for float32), against the warp kernel and the plain
   version; the flat sampler (``sample_parity_inputs``) at its five
   shapes (a rendered frame's 71,680 coordinates on a 512x512 texture, a
   blurred frame's 3 x 71,680 at ``--exposure-ms 8``, 16 bank textures at
   a blurred frame's coordinates each, the JAX trainer's batch, and 32 of
   them, its probe's, the FIL window batch, 4 textures at 7 blurred
   frames' coordinates each, and the FIL pair step's 8 textures at the
   trainer batch's coordinates), at ragged N, at 4-byte-misaligned
   coordinates, on a texture whose rows are not whole 4-byte words, and at in-range, edge,
   off-image, +-inf and NaN ones; the remap C1 at 640x480 -> 224x320 on
   the default config's fisheye map, on a radtan map and on a map of
   off-image, edge, exactly integer and NaN coordinates, at N = 1, 7 and
   165 frames, each map's tiles counted by path by the kernel itself
   (shared ring or global taps) and held to ``ops/remap.tile_boxes``: every
   fisheye and radtan tile on the shared ring, at least one edge-map tile
   on global taps; the towers' fused convolutions at each shape of
   ``ops/cuda/conv.SHAPES`` (``CONV_LAYERS``, the v10 weights of each
   shape's first layer: V1's three, V2's eight, two of them V2K's) at B =
   64, 16, 8, 1 and 13 and at ragged sizes, each output within
   ``ops/cuda/conv.rounding_bound`` of the shape's plain version (V1's: the
   same float32 sums in the same order, one rounding a term against two;
   V2's: the same GEMM in the library's order, V2K's in its runs of c_in),
   and a pair's row of the B = 64 launch bit for bit its B = 1 launch; H1 with the v10 heads at B = 64, 19, 16 and 1
   (``HEADS_BATCHES``, T1's masks), its members, corner prediction and
   variance within ``ops/cuda/heads.rounding_bounds`` of its plain
   version, and pairs 0 and 63 of the B = 64 call bit for bit those pairs
   called alone;
3. time each kernel, its plain version and ``torch.nn.functional.
   grid_sample`` on the same points (the library yardstick; the port never
   calls it) beside its byte bound: device time from CUDA-graph replays
   (the median of three, taken in turns; the numbers kept), the kernel's
   ratio to grid_sample, and eager call-to-call time. The warp at B = 1, 4 and 64 (uint8 and float32)
   and at B = 8 and 16 float32 (the FIL pair step's and the trainer's
   warp), the
   row-band warp at B = 4, 8 and 64 (uint8), the flat sampler at its
   five shapes on uint8 textures, beside the launch floor (a one-element
   ``add_`` in the same CUDA graph); the remap C1 at N = 1 and N = 165
   raw 640x480 frames on the fisheye map, beside ``grid_sample`` on the
   same frames (as float) and coordinates and its byte bound, and with a
   cold L2 (each call after a read of L2_FLUSH_BYTES, in one graph, less
   the reads alone); V1 at each of its shapes at B = 64 and V2 at B = 64,
   16 and 1, beside their FLOP bound, the plain version, and cuDNN's best
   algorithm for the convolution with its bias (``library_ms``: benchmark
   mode over every engine, NCHW and NHWC) and the LeakyReLU pass that
   follows it; V2K also beside V2's whole-K tiling of its shape
   (``V2_WHOLE_K``); H1 at B = 64, 16 and 1 (``HEADS_TIMED_BATCHES``) beside the
   heads' FLOP bound, its plain version and the UAHN's eager heads stage
   it replaced (``McHead`` twice and the statistics), and the eager
   call-to-call time of H1 and of that stage;
3b. the JAX random stream: the port's host keys (``PRNGKey``, ``split``,
   ``fold_in``) against JAX's in ``PRNG_REF``; the threefry kernel T1 on
   the card against JAX's bits, uniform, bernoulli and randint (over
   PRNG_SPANS) bit for bit and its normals and truncated normals within
   PRNG_NORMAL_JAX_TOL, and the four MC-dropout masks of phase 4's first
   network call bit for bit; ``init_uahn(PRNGKey(0))`` built on the card
   (one truncated-normal launch) against the same build on the CPU, every
   leaf within PRNG_INIT_ULPS ulp, and its build time; T1 against its
   plain version (``utils/prng.draw_plain``) on the card at the masks'
   shapes (K = 4 and 4 x 64), the effects' (2 x 224 x 320) and the
   layouts a thread's run of values makes risky (short rows, 4,096 rows of
   1,001) in every mode, and at the UAHN's kernels (PRNG_INIT_CASE) in the
   truncated-normal mode: bits, uniform and bernoulli bit for bit, the
   normals within PRNG_NORMAL_ULPS ulp; then T1's time (CUDA graph
   replays), its plain version's and its bound at those shapes (its bytes,
   or its draw's integer-pipe bound from its SASS, ``sass_bound.py``).
   From here on every phase that runs the network at p = 0.05 must launch
   T1 once a network call (phases 4, 6-11 and 13-17: its four masks in one
   launch), ``make-synthetic --effects`` once a frame (phases 12 and 13:
   its two noise images) and the trainers once a field of a batch's draws
   (phases 11, 14 and 17a); the kernels line carries T1's launches by
   phase and by mode;
4. the single-stream slice: a synthetic 2.5 s still + 6 s flight from the
   port's ``make_sequence``, run through ``run_offline`` with the shipped
   v10 weights and 16-member MC dropout (p = 0.05, the JAX package's masks
   at seed 0: one T1 launch a network call); the warp launch count must
   be 3 x steps x IEKF iterations, T1's steps x IEKF iterations, V1's 3 x
   steps x IEKF iterations (block 3's conv0, block 4's conv0 and conv1),
   V2's 14 x steps x IEKF iterations (the other layers of blocks 2-4),
   V2K's 12 x steps x IEKF iterations (V2's split path: its GEMM and the
   sum of its splits for each of the six layers at 7x10 and 4x5 out),
   H1's 2 x steps x IEKF iterations (fc0 of both heads, then the tail),
   every pose finite and the ATE under the bar below;
5. textured data: three photo-texture sequences (``TEX_SEQS``) rendered
   with ``make_sequence`` on the card, and one motion-blurred one
   (``BLUR_SEQ``, ``exposure_s = EXPOSURE_S``: each frame the mean of 3
   renders); the flat sampler must launch once per rendered frame, and
   each blurred frame must equal, bit for bit, the uint8 of the mean of
   its three taps rendered one by one on the card (and differ from its
   sharp render);
6. the batched path: ``run_offline_batch`` over the slice's sequence and
   the three textured ones (B = 4, lockstep, padded to the longest) with
   ``BATCH_SAMPLER = "full"``; the warp kernel must launch 3 x F x IEKF
   times (once per warp site and lockstep frame, not per sequence), every
   pose finite and each sequence's ATE under its bar (``BATCH_ATE_BARS_M``);
7. the first ``ROWSKIP_FRAMES`` lockstep frames again with
   ``BATCH_SAMPLER = "rowskip"`` and the same MC-dropout keys: the row-band
   kernel must launch 3 x frames x IEKF times, the warp kernel never, and
   the poses must agree with the "full" run's within ``ROWSKIP_POS_TOL_M``;
8. the stepwise runner: phase 4's sequence cut to its first
   STEPWISE_FRAMES frame pairs, model and seed through
   ``run_stepwise``, staged (each stage closed by a device synchronize)
   and fused; each run must make 3 x (steps + 1) x IEKF warp launches (the
   warm-up step on frame 0 launches too) and no other sampler launch,
   recover from no divergence, give finite poses, ``stage_ms`` of shape
   (F, 5), and poses within ``STEPWISE_POS_TOL_M`` of phase 4's (the same
   operations and MC-dropout keys); prints each staged column's median
   and the fused total;
9. bfloat16 conv towers: phase 4's sequence through ``run_offline`` with
   a bf16 UAHN; 3 x steps x IEKF warp launches, finite poses, the ATE
   under ``BF16_ATE_BAR_M``; ms/frame beside phase 4's float32;
10. the CLI, as subprocesses of ``python -m cuahn_vio_torch.cli`` (each
   prints its kernels' launch counts after the verb) in a temporary
   directory: ``make-synthetic`` over photo-texture ground (all four
   files, ``_config.yaml`` included; one flat-sampler launch a frame),
   ``run-vio --config --weights --timing-out --odom-out --state-out
   --cov-calib`` (3 x (poses + 1) x IEKF warp launches), then
   ``error-singlerun se3``, ``timing-percentages`` and
   ``error-simulation`` on what ``run-vio`` wrote, side by side; the same
   ``run-vio`` without the stepwise flags runs beside phase 12 (its
   covariance inflated by the factors must be the first run's npz
   covariance). Every exit code must be
   0 and the timing csv must have one row of 5 stages a pose. Prints
   whether PyYAML is installed: the port needs none;
11. the trainer: first the pair draws of its first step and of its probe
   on the card against the JAX ``sample_pair`` draws at those keys
   (TRAIN_DRAWS: uniform, Bernoulli and randint draws equal, the rest
   within DRAW_TOL), counting a batch's T1 launches; then ``train-uahn
   --resume`` v10 for TRAIN_STEPS steps at
   224x320, batch TRAIN_BATCH, photo textures and effects on (the CLI's
   default), twice at one seed, the first with cuDNN's deterministic
   algorithms (phase 17a's reference; the second as ``train`` runs by
   default), each run a subprocess that also records
   the shape of every warp and flat-sampler launch and the host time at
   the end of every step (a synchronize only after the first and the
   last step). Each run must log a finite loss and ``skipped=`` on every logged
   step; launch the flat sampler (B4) twice a step at shape 3 (16
   textures x 3 x 224 x 320 points) and twice for the probe's 32
   textures; launch the warp (B2) in float32 three times a step at B = 16
   and six times for the probe at B = 32, and no other warp; launch T1
   for a batch's draws and once for the masks each step, for the probe's
   batch once and once a probe call; write the
   checkpoint and ``.best``, both read back by the port with every leaf
   finite, of v10's shapes and not v10's values. Prints each run's ms per
   step (the window from the end of the first step to the end of the
   last, over its steps, the checkpoint write inside it; beside it the
   median host gap between step ends) and samples/s beside the card's
   name and power limit, how far apart the two runs' weights are, and the
   ATE of ``run_offline`` with the first run's weights on phase 4's
   sequence beside v10's (reports, not gates);
12. the raw-camera chain, as subprocesses of ``python -m
   cuahn_vio_torch.cli`` in phase 10's directory: ``make-synthetic
   --traj-file`` phase 10's GT pose file (``--spline-dt 0.1``, held-out
   photo texture, ``--exposure-ms 8 --effects``, RAW_DURATION_S),
   ``distort-to-euroc`` (640x480 Kannala-Brandt PNGs), ``convert-euroc``,
   ``run-vio`` with the v10 weights, ``error-singlerun se3``, and
   ``format-converter`` of phase 10's GT file, txt -> csv -> txt. Every
   exit code must be 0; the flat sampler must launch once a rendered
   frame, the remap once for the converted batch, the warp 3 x poses x
   IEKF times; the interior [40:180, 60:260] of the converted frames
   within RAW_RMSE_BAR levels RMSE of the rendered ones; every pose finite,
   the ATE under RAW_ATE_BAR_M; the second txt equal to the first. Prints
   the PNG decode and encode ms per frame, the decode ms per frame of the
   same frames written with PIL's row filters (``encode_png_like_pil``;
   their pixels must come back equal), the remap's device ms, and the ATE
   beside that of ``run_offline`` on the rendered (virtual) frames.
   Phase 10's plain ``run-vio`` and phase 13's ``make-synthetic`` and
   ``run-vio`` run beside this phase (started with it, each chain in a
   thread of its own);
13. the loop-closure workflow of ``benchmarks/loop_closure_demo.sh``, as
   subprocesses of ``python -m cuahn_vio_torch.cli`` in a temporary
   directory: the demo's double-loop pose file (``write_loop_trajectory``)
   flown by ``make-synthetic --traj-file`` with the demo's flags
   (LOOP_SYNTH_ARGS: 20 s, a held-out procedural texture named by its
   pick, ``--exposure-ms 8 --effects``), ``run-vio`` v10 ``--state-out``,
   ``close-loops`` (LOOP_CLOSE_ARGS; a subprocess that also records the
   batch of every warp launch), ``smooth-trajectory --loops-file`` twice,
   once with ``--huber`` and once with ``--mesh`` (read by 16b), side by
   side and beside phase 16c's ``distributed-selftest``, and
   ``error-singlerun se3`` of the online and the smoothed runs, side by
   side. Subprocesses run side by side only where their own times are no
   metric; every in-process timing runs with no child alive. Every exit code must be 0; the flat sampler must
   launch once a rendered frame, the warp 3 x poses x IEKF times in
   ``run-vio`` and, in ``close-loops``, 3 times per network batch of at
   most ``LOOP_BATCH`` pairs, uint8, the batches covering each pair inside
   the geometric gate once per warp site; at least one factor written;
   every smoothed pose finite, the two plain smoothings byte-identical and
   no kernel launched by them; the smoothed ATE under LOOP_ATE_BAR_M and
   below the online ATE. The warp is then held to its plain version and
   timed at each batch size close-loops launched it at. Prints the
   candidates, the pairs inside the geometric gate, the factors kept, the
   ATEs beside the JAX package's, each verb's seconds, and the
   Gauss-Newton iteration's ms at the run's size with the normal equations
   repeated GN_REPEATS times (``gn_iteration_ms``: the module's repeats
   must be bit-identical);
14. filter-in-the-loop training in this process: first the window draws
   of its first FIL step on the card against the JAX ``window_loss`` draws
   at that key (TRAIN_DRAWS, the bounds of phase 11), counting a FIL
   step's and a pair step's draw launches; then ``train.fil.fil_finetune``
   from v10 for FIL_STEPS steps (FIL steps and pair steps in turn) on a
   bank of FIL_BANK windows of FIL_WINDOW frames cut from the GT files of
   phases 10 and 13, FIL_BATCH windows a FIL step, 224x320, 3 blur taps.
   Every loss and every step's gradients must be finite; a FIL step must
   launch the flat sampler once (FIL_BATCH textures x (W + 1) x 3 x 224 x
   320 points) and the warp 3 x W x IEKF times at B = FIL_BATCH in uint8,
   a pair step the sampler twice at FIL_PAIR_BATCH textures and the warp
   3 times at B = FIL_PAIR_BATCH in float32, and nothing else, and T1 for
   a step's draws and once a network call; the weights
   must move from v10, and the checkpoint be written and read back finite.
   Prints the set-up's ms and each step's (host clock, a synchronize at
   the set-up's end and at each step's), the peak device memory and, as a
   report, the ATE of ``run_offline`` with
   the tuned weights on phase 4's sequence beside v10's.
15. the diagnostics, on phase 10's files. 15a, in this process: each
   function of the sparse-vision front end and the error map on the card
   against the port's own on the CPU, on identical inputs:
   ``grid_detect`` on DIAG_FRAMES of the sequence's frames (scores within
   SCORE_TOL of the largest, a differing pick only at a near-tie),
   ``track_pyramidal`` on their consecutive pairs from the CPU's grid
   points (``valid`` equal except within THRESH_TOL of a threshold,
   tracks within TRACK_TOL_PX), ``triangulate_nview`` on TRI_FEATURES
   ground points seen from TRI_VIEWS of the sequence's GT camera poses
   (``ok`` equal, positions within TRI_TOL_M), ``preintegrate`` over
   PREINT_INTERVALS of its frame intervals (within PREINT_TOL, Jacobians
   within PREINT_JAC_RTOL relative), and the UAHN's error map of one pair
   at dropout 0 (within ERR_MAP_LEVELS on ERR_MAP_SHARE of the pixels;
   its maximum printed); and the pairs/s of ``eval_flow`` in process
   (``eval_flow_rate``). 15b, the verbs as subprocesses of ``python -m
   cuahn_vio_torch.cli`` with their warp launches recorded, side by side
   but for ``track-features``, which runs alone: ``eval-flow
   --prior gt`` over every pair (3 float32 warps, one T1 draw, 3 V1, 14
   V2, 12 V2K and 2 H1 launches a batch of at most 16, nothing else; the
   corner-error RMSE under FLOW_RMSE_BARS_PX) and ``--prior none --limit
   DIAG_NONE_LIMIT`` (block 1 runs, 3 warps a batch; V2 15 times and V2K
   14, block 1's conv2 having block 2's conv2's shape); ``inspect-frame``
   (the full cascade: exactly 4 float32 warps at B = 1, one T1 draw, 3
   V1, 15 V2, 14 V2K and 2 H1 launches; the PNG
   224 x 960, the mean error finite); ``track-features`` (no kernel
   launch, 80 slots a frame, ids non-decreasing; ms/frame and survivors
   beside the JAX package's); ``calibrate-covariance`` and
   ``calibrate-state-covariance`` on phase 10's plain log (finite fits),
   and the latter refusing phase 10's ``--cov-calib`` log (exit non-zero,
   naming its factors). The warp is then held to its plain version and
   timed at each batch size eval-flow launched it at.
16. the sweep and the parallel layer. 16a, in this process: ``tune-filter``
   (``cli.main``) over the smoke's sequence (the card's ``make_sequence``,
   whose IMU stream and ground truth are the host's, the CPU's bit for
   bit), with a trace of the IMU's float32 ops on the card against the CPU
   (``trace_imu_ops``), and the JAX package's ``run-vio --state-out`` log
   of it (TUNE_LOG) at TUNE_GRID, 256 points, under the port's ``ResourceMonitor`` of this process: no
   kernel launch, 256 rows, each row's ``ate_pos`` within TUNE_ATE_TOL_M
   of the JAX verb's row of its grid_index (TUNE_ROWS), the same inf
   pattern and ``n_gated``, the top TUNE_TOP rows in the JAX order up to
   near-ties; prints the sweep's seconds, frames, filter replays per
   second, peak device memory and the monitor's summary. 16b:
   ``optimize_sharded`` with SCHUR_BLOCKS blocks on the card at phase 13's
   loop-closure graph against the dense ``optimize`` (positions within
   SCHUR_POS_TOL_M, the final cost at most SCHUR_COST_DROP of the first,
   GN_REPEATS repeats bit-identical), ms per GN iteration of both (CUDA
   events), and phase 13's ``smooth-trajectory --mesh`` within
   SCHUR_POS_TOL_M of its dense smoothing. 16c: ``distributed-selftest``
   as one process on the card (run in phase 13), its checksums within
   SELFTEST_RTOL of JAX_SELFTEST, then the ``--bench`` workload in this
   process at SELFTEST_BENCH's size (the JAX recipe's 400 frames cut to
   10) and its rate. 16d: ``run-vio-batch --mesh`` (``cli.main``) on
   phase 6's sequences cut to MESH_BATCH_FRAMES frame pairs, its pose
   files byte for byte those frames of phase 6's, 3 x MESH_BATCH_FRAMES x
   IEKF warp launches; ``error-dataset``, ``error-comparison`` (the
   ATE of ``error-singlerun`` on the same file), ``align-trajectory``,
   ``timing-comparison`` and ``pid-monitor`` of a child process as
   subprocesses side by side.
17. data parallelism and the plots. 17a: phase 11's ``train-uahn`` run
   (its seed, steps, batch and flags; the same spied subprocess,
   ``train_child``, with cuDNN's deterministic algorithms as phase 11's
   first run: cuDNN's default backward sums in a varying order, and two
   default runs on an H100 have written weights up to 7.6e-6 apart) as
   a one-rank NCCL job of ``python3 -m
   torch.distributed.run --standalone --nproc-per-node 1`` (``--no-python``:
   the launcher takes no ``-c``), so the trainer's data-parallel path runs
   on the card: the rank binding, the global loss denominators and the
   flat gradient's ``all_reduce``. It must log "data-parallel over 1 ranks
   (seq mesh)", pass phase 11's checks (the same B4 and B2 launches a
   step, finite losses, both checkpoints) and write weights within
   DP_WEIGHTS_TOL of phase 11's first run's; prints that distance beside
   phase 11's two-run one and its ms per step beside phase 11's. 17b: the
   five plot surfaces side by side as subprocesses on files the smoke
   made: ``plot-trajectories`` on phase 13's online, smoothed and GT pose
   files, ``plot-trackhist`` on phase 10's sequence and ``--state-out``
   log, ``timing-flamegraph`` on phase 10's timing csv, ``error-simulation
   --plot`` on phase 10's log and sim GT, and ``watch-run --gt`` on phase
   10's finished estimate for WATCH_TICKS polls WATCH_INTERVAL_S apart.
   Each must exit 0, launch no kernel and write an RGB PNG that the port's
   reader decodes at its figure's figsize x dpi, in which the colour of
   each series drawn opaque or on white appears (``plots.series_colours``
   of the figure built in this process from the same files);
   ``watch-run`` must print exactly the JAX verb's one line.

Then one JSON line of kernels, the card's name and power limit, and the
result line. Exits non-zero (and prints no result) without a CUDA device,
without the port's sources beside it, or when any phase fails. Uses only
the port: no JAX and nothing of ``cuahn_vio``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "weights", "uahn_fil_v10.msgpack")
WALL_LIMIT_S = 1000  # hard stop well inside the 1200 s budget

H, W = 224, 320
# parity shapes beside 224x320, (B, H, W): a ragged width, tiny images,
# and a batch large enough for 8 pixels a thread on images 3 pixels wide
RAGGED_SHAPES = ((8, 224, 317), (8, 7, 5), (8, 6, 3), (50000, 6, 3))
# rolls (deg) whose row-band tiles straddle the shared band's size
BAND_EDGE_ROLL_DEG = {1: 8.8, 4: 1.8}  # by image element bytes; any pixels per thread
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
WARP_FLOPS_PER_PIXEL = 38  # 15 coords, 2 div, 4 clip, 17 bilinear
SAMPLE_FLOPS_PER_POINT = 21  # 4 clip, 17 bilinear

# The slice's sequence: 2.5 s still, 6 s of motion, the noise of the
# verify recipe's make-synthetic drive, fixed seeds.
SEQ = dict(duration=6.0, t_still=2.5, seed=7, texture_seed=7,
           sigma_w=0.002, sigma_a=0.02, bias_g=0.003, bias_a=0.02)
# ATE bar. Reference: ``python3 smoke_reference.py OUT_DIR`` runs the same
# sequence (SEQ through the port's make_sequence on the CPU: the JAX
# package's frames, its ground drawn from PRNGKey(texture_seed)) through the
# JAX package's ``run-vio`` with the v10 weights and scores it with its
# ``error-singlerun se3``, on the CPU: ATE pos rmse 0.03642 m at seed 0
# (seeds 1 and 2: 0.03639, 0.03613 m; the port on the CPU draws the same
# masks and gives 0.03642, 0.03639, 0.03613 m). The margin, ~20x that
# seed-to-seed spread, covers frames rendered on the card and the card's
# float32 sums.
REF_ATE_M = 0.03642
ATE_MARGIN_M = 0.005
ATE_BAR_M = REF_ATE_M + ATE_MARGIN_M

# The batched phase's photo-texture sequences: entries of the texture
# bank's procedural part (``data/textures._procedural_extras(512)``, the
# whole bank where no image package is installed) at uint8 levels, one
# texture period per TEX_SCALE_M metres, SEQ's noise and still phase.
# Durations differ so that the batch pads.
TEX_SEQS = (
    dict(texture=0, duration=6.0, seed=11),  # fractal noise
    dict(texture=5, duration=5.0, seed=12),  # fractal noise
    dict(texture=11, duration=4.0, seed=13),  # paving stones
)
TEX_SIZE = 512
TEX_SCALE_M = 4.0
# make-synthetic --exposure-ms 8: the blurred render's exposure, which
# gives the flat sampler its 3-tap shape (phases 2, 3 and 5)
EXPOSURE_S = 0.008
BLUR_SEQ = dict(texture=0, duration=1.0, seed=14)
# the JAX trainer's batch (trainer.py batch_size): textures per launch of
# the flat sampler at shape 3
BATCH_TEXTURES = 16
# ATE bars of the batched phase, one per sequence (SEQ, then TEX_SEQS).
# Reference: ``python3 smoke_reference.py OUT_DIR --part batch`` makes the
# same four sequences with the port's make_sequence on the CPU and runs them
# through the JAX package's ``run-vio-batch`` with the v10 weights, scored
# with its ``error-singlerun se3``, on the CPU (JAX_REF_BATCH_ATE_M, the
# mean over MC-dropout seeds 0-2). Each bar is that ATE + 0.005 m, or + 5x
# the JAX package's seed-to-seed spread where that spread is above
# 0.001 m. Measured: JAX seeds 0/1/2 0.03616/0.03611/0.03615,
# 0.04416/0.04464/0.04416, 0.01795/0.01805/0.01791, 0.00654/0.00601/0.00595 m
# (spreads 0.00005, 0.00048, 0.00014, 0.00059 m: the 0.005 m margin holds).
# The port's run-vio-batch on the CPU draws the same masks: every ATE the
# same to 5 decimals but seed 1's second (0.04465).
JAX_REF_BATCH_ATE_M = (0.03614, 0.04432, 0.01797, 0.00617)
BATCH_ATE_BARS_M = tuple(round(a + ATE_MARGIN_M, 5) for a in JAX_REF_BATCH_ATE_M)
ROWSKIP_FRAMES = 40
ROWSKIP_POS_TOL_M = 1e-5  # rowskip vs full run, world positions
# run_stepwise (staged and fused) against phase 4's run_offline, world
# positions: the same operations on the same MC-dropout keys, so 0.0 is
# expected; the bound allows only float32 rounding of another cuDNN choice
STEPWISE_POS_TOL_M = 1e-5
STEPWISE_FRAMES = 60  # phase 8: the frame pairs of phase 4's sequence that each mode runs
# ATE bar of the bf16 phase. Reference: ``python3 smoke_reference.py
# OUT_DIR --part bf16`` runs SEQ through the JAX package's ``run-vio
# --bf16`` with the v10 weights on the CPU, scored with its
# ``error-singlerun se3``: seeds 0/1/2 0.03604/0.03607/0.03578 m, mean
# 0.03596 m (the port's ``run-vio --bf16`` on the CPU: 0.03624/0.03623/
# 0.03596 m: the same masks, bf16 rounded at other places); the bar is
# that mean + ATE_MARGIN_M.
REF_BF16_ATE_M = 0.03596
BF16_ATE_BAR_M = REF_BF16_ATE_M + ATE_MARGIN_M
# phase 10's make-synthetic: seconds of motion after the still phase
CLI_DURATION_S = 3.0
CLI_NOISE = ("--sigma-w", "0.002", "--sigma-a", "0.02", "--bias-g", "0.003", "--bias-a", "0.02")
CLI_COV_CALIB = "pos:2,ori:2"
CLI_RUN = ("run-vio", "seq.npz", "--config", "seq_config.yaml", "--weights", WEIGHTS)
# phase 11's train-uahn runs: steps, batch (the JAX trainer's) and
# checkpoint interval (the probe's batch is train.trainer.PROBE_SIZE)
TRAIN_STEPS = 12
TRAIN_BATCH = 16
TRAIN_SAVE_EVERY = 6
TRAIN_RUNS = 2  # at one seed: the step time's spread in one call, and the weights compared
# the remap C1: raw frames a batch in phases 2 and 3 (a converted sequence
# of ~5 s at 30 Hz), and the float32 work a frame's output pixel and a map
# entry need (4 fmas, the rounding and clamp; floor, weights)
REMAP_FRAMES = 165
REMAP_FLOPS_PER_PIXEL = 11
REMAP_FLOPS_PER_MAP_ENTRY = 10
REMAP_PARITY_FRAMES = (1, 7, REMAP_FRAMES)  # phase 2: a ring's tail and a chunk's
L2_FLUSH_BYTES = 256 << 20  # read between cold calls: five times the 50 MB L2
# phase 12's make-synthetic --traj-file: seconds after the still phase (the
# replayed GT file hovers for its own first 2.5 s, then flies), and the
# interior RMSE bar of tests/test_euroc_e2e.py
RAW_DURATION_S = 5.0
RAW_RMSE_BAR = 6.0
RAW_INTERIOR = (slice(40, 180), slice(60, 260))
# ATE bar of phase 12. Reference: ``python3 smoke_reference.py OUT_DIR
# --part raw`` makes phase 10's GT file and phase 12's sequence with the
# port's make-synthetic on the CPU (the card machine's texture bank, the
# 12 procedural textures), then runs the JAX package's distort-to-euroc,
# convert-euroc, run-vio (v10, MC-dropout seeds 0-2) and error-singlerun
# se3 on the CPU. The bar is the JAX mean + 0.005 m, or + 5x its
# seed-to-seed spread where that spread is above 0.001 m; it covers the
# frames rendered on the card.
# Measured: JAX chain seeds 0/1/2 0.01272/0.01239/0.01246 m (mean 0.01252,
# spread 0.00033: the 0.005 m margin holds); the port's chain on the CPU
# 0.01272/0.01239/0.01245 m; the JAX run-vio on the rendered frames, no
# round trip, 0.01333/0.01284/0.01335 m.
REF_RAW_ATE_M = 0.01252
RAW_ATE_BAR_M = REF_RAW_ATE_M + ATE_MARGIN_M
# phase 13: the workflow of benchmarks/loop_closure_demo.sh, with its
# flags: a double-loop pose file (``write_loop_trajectory``) flown by
# make-synthetic over a held-out texture named explicitly (pick 2 of the
# held-out split; on the card machine's bank of 12 procedural textures the
# split is bank[3] alone, a fractal noise), then run-vio, close-loops and
# smooth-trajectory
LOOP_SYNTH_ARGS = ("--duration", "20", "--spline-dt", "0.1", "--traj-z-offset", "1.7",
                   "--sigma-w", "0.002", "--sigma-a", "0.02", "--bias-g", "0.003",
                   "--bias-a", "0.02", "--texture", "heldout", "--texture-pick", "2",
                   "--tex-scale", "4.0", "--exposure-ms", "8", "--effects")
LOOP_CLOSE_ARGS = ("--min-dt", "5.0", "--max-dist", "1.0", "--stride", "3", "--max-pairs",
                   "200", "--max-sigma-px", "25")
LOOP_HUBER = 3.0  # the robust smoothing's --huber
# ATE bar of phase 13. Reference: ``python3 smoke_reference.py OUT_DIR
# --part loop`` makes phase 13's sequence with the port's make-synthetic on
# the CPU (the card machine's texture bank), then runs the JAX chain
# run-vio (v10, MC-dropout seeds 0-2) --state-out, close-loops
# (LOOP_CLOSE_ARGS) and smooth-trajectory --loops-file, scored with its
# error-singlerun se3, on the CPU. The bar is the JAX mean smoothed ATE +
# ATE_MARGIN_M. Measured: JAX seeds 0/1/2 online 0.15613/0.15524/0.15601 m,
# 93/97/96 factors, smoothed 0.10110/0.10146/0.10183 m (mean 0.10146, spread
# 0.00073); the port's chain on the CPU draws the same masks: online
# 0.15614/0.15525/0.15602 m, the same factors, smoothed 0.10110/0.10146/
# 0.10184 m.
REF_LOOP_ATE_M = 0.10146
LOOP_ATE_BAR_M = REF_LOOP_ATE_M + ATE_MARGIN_M
# phase 14, filter-in-the-loop: FIL_STEPS steps of train/fil.fil_finetune
# from v10 (every second one a pair step), windows of FIL_WINDOW frames,
# FIL_BATCH windows a FIL step, 224x320, 3 blur taps, from a bank of
# FIL_BANK windows cut from the GT files of phases 10 and 13
FIL_STEPS = 4
FIL_WINDOW = 6
FIL_BATCH = 4
FIL_BANK = 32
FIL_PAIR_BATCH = 8  # train/fil's pair steps: TrainConfig(batch_size=8)
GN_REPEATS = 20  # phase 13: repeats of the smoother's normal equations
# phase 15, the diagnostics, in phase 10's directory: eval-flow --prior
# none runs on the first DIAG_NONE_LIMIT pairs; the bars of the corner-error
# RMSE (px) by prior. Reference: ``python3 smoke_reference.py OUT_DIR --part
# diag`` makes phase 10's sequence with the port's make-synthetic on the CPU
# over the card machine's texture bank and runs the JAX package's eval-flow
# on it for MC-dropout seeds 0-2: mean RMSE 0.4110 px (gt, 83 pairs; spread
# 0.0020) and 0.4573 px (none, 32 pairs; spread 0.0050); the port's on the
# CPU 0.408-0.410 and 0.454-0.458. The margin is ten times the larger spread.
# The JAX track-features on it keeps 26 of 80 tracks from frame 0 (the
# port's on the CPU 26).
DIAG_NONE_LIMIT = 32
INSPECT_FRAME = 10  # inspect-frame --frame
DIAG_FRAMES = 5  # phase 15a: grid_detect frames (and their consecutive pairs' tracks)
TRI_FEATURES, TRI_VIEWS = 64, 5
PREINT_INTERVALS = 16
SCORE_TOL = 1e-5  # of the CPU's largest Shi-Tomasi score
THRESH_TOL = 1e-5  # KLT: a valid flag may differ this close to its threshold
TRACK_TOL_PX = 1e-3
TRI_TOL_M = 1e-4
PREINT_TOL = 1e-5
PREINT_JAC_RTOL = 1e-4
ERR_MAP_LEVELS, ERR_MAP_SHARE = 0.05, 0.999
REF_FLOW_RMSE_PX = {"gt": 0.4110, "none": 0.4573}
FLOW_RMSE_MARGIN_PX = 0.05
REF_TRACK_SURVIVORS = 26  # the JAX track-features on that sequence: survivors from frame 0
FLOW_RMSE_BARS_PX = {k: round(v + FLOW_RMSE_MARGIN_PX, 4) for k, v in REF_FLOW_RMSE_PX.items()}
FIL_IEKF = 1  # train/fil's VioConfig(update_gate_frames=-1): one IEKF iteration


# phase 16a, the filter-parameter sweep: ``tune-filter`` of the smoke's
# sequence (SEQ) and the JAX package's ``run-vio --state-out`` log of it
# (v10, seed 0; its three keys in TUNE_LOG) over TUNE_GRID, 4 x 4 x 2 x 2 x
# 2 x 2 = 256 points at the default gate and tau, each row held to the JAX
# verb's row of its grid_index in TUNE_ROWS. Reference: ``python3
# smoke_reference.py OUT_DIR --part tune`` writes the two files (on the
# CPU) and prints the port's largest ate_pos difference from the JAX rows
# on the CPU, which sets TUNE_ATE_TOL_M.
TUNE_LOG = "tests/data/smoke_tune_log.npz"
TUNE_ROWS = "tests/data/smoke_tune_rows_jax.jsonl"
TUNE_GRID = ("--k-net-cov", "4,7.9,12,20", "--q-scale", "0.5,1,2,4", "--q-pos-extra",
             "1e-5,1e-4", "--bias-sigma-px", "0,0.5", "--chi2-soft", "0,20", "--echo-beta",
             "0,0.3")
TUNE_POINTS = 256
TUNE_ATE_TOL_M = 1e-4  # the port on the CPU: 3.172e-06 m at most, no inf row
TUNE_TOP = 10  # rows whose order is held to the JAX verb's (up to near-ties)
# phase 16b, the Schur smoother: blocks on one card at phase 13's graph,
# and its bars against the dense solve (tests/test_pose_graph_sharded.py:71)
SCHUR_BLOCKS = 4
SCHUR_POS_TOL_M = 2e-3
SCHUR_COST_DROP = 1e-3
# phase 16c: the JAX package's single-process ``run_selftest(8)`` on 8 fake
# CPU devices (``smoke_reference.py --part tune``); the port's checksums
# within SELFTEST_RTOL of them (float32 sums in another order)
JAX_SELFTEST = {"filter_pos_checksum": 72.00117492675781,
                "filter_cov_checksum": 0.01577342301607132,
                "pose_checksum": 53.35031318664551}
SELFTEST_RTOL = 1e-5
MESH_BATCH_FRAMES = 40  # phase 16d: the lockstep frames of run-vio-batch with and without --mesh
SELFTEST_BENCH = dict(frames=10, steps=16, reps=3)  # the JAX recipe's 400 frames, cut
# phase 17a: the one-rank NCCL job's weights against phase 11's first run,
# both with cuDNN's deterministic algorithms (one process's weights, so
# equal to rounding)
DP_WEIGHTS_TOL = 1e-5
# The random-stream phase (3b): JAX's draws, written by ``python3
# smoke_reference.py OUT --part prng`` (a few keys, split, fold_in, bits,
# uniform, bernoulli and normal of PRNG_COUNT values, and the four masks
# of phase 4's first network call), and T1's cases on the card: the four
# masks of one network call (K = 4) and of a close-loops batch of 64 pairs
# (K = 4 x 64), and one frame's two sensor-effects noise images.
PRNG_REF = "tests/data/prng_jax.npz"
PRNG_SEEDS = (0, 7, 2**33 + 5)
PRNG_FOLDS = (0, 1, 10_000, 2**32 - 1)
PRNG_COUNT = 1001
PRNG_SPANS = ((0, 10), (-7, 100_000))  # randint's [lo, hi): a texture pick's, a wide one
PRNG_NORMAL_JAX_TOL = 1e-6  # XLA's CPU log1p is its own polynomial (tests/test_torch_prng.py)
PRNG_NORMAL_ULPS = 2  # the kernel's log1pf against torch.log1p on the card
PRNG_CASES = {
    "masks K=4": [16 * 5120, 16 * 256] * 2,
    # the batched path's masks at B = 2 and 4 sequences (phases 6 and 7):
    # under the long runs' switch (``ops/cuda/prng.values_per_thread``)
    "masks K=8": [16 * 5120, 16 * 256] * 4,
    "masks K=16": [16 * 5120, 16 * 256] * 8,
    "masks K=256": [16 * 5120, 16 * 256] * 128,
    "effects K=2": [H * W] * 2,
    # the layouts a thread's run of values makes risky: rows of 0, 1, R - 1,
    # R + 1 and 3R values for runs of 4, 8 and 16 (a run over three rows,
    # a total that is no multiple of a run), and 4,096 rows of 1,001
    "short rows K=16": [c for r in (4, 8, 16) for c in (0, 1, r - 1, r + 1, 3 * r)] + [2],
    "rows K=4096": [1001] * 4096,
}
# the random UAHN's kernels (init_uahn, one truncated-normal launch): drawn
# in that mode only; the card's build against the CPU's, every kernel value
# within PRNG_INIT_UNIT_TOL times its leaf's scale plus one rounding of the
# scaled value (the bound the CPU's build is held to against JAX's,
# tests/test_torch_init.py: the card's log1pf and the CPU's torch.log1p
# round apart at a few values)
PRNG_INIT_CASE = "init K=27"
PRNG_INIT_UNIT_TOL = 2.4e-7
# T1's modes (utils/prng.MODE_NAMES) and the (a, b) each case draws with;
# the bytes a value writes
T1_MODE_ARGS = {"bits": (0.0, 1.0), "uniform": (0.3, 1.7), "bernoulli": (0.95, 1.0),
                "normal": (0.0, 1.0), "truncated_normal": (-2.0, 2.0)}
PRNG_OUT_BYTES = {"bits": 4, "uniform": 4, "bernoulli": 1, "normal": 4, "truncated_normal": 4}
# The trainers' draws (phases 11 and 14): the JAX draws of phase 11's first
# step, of its probe and of phase 14's first FIL step at their keys, written
# by ``python3 smoke_reference.py OUT --part train`` on the card machine's
# texture bank (CARD_TEXTURES procedural textures); the first
# DRAW_NOISE_VALUES values of every noise image. The port's draws on the
# card: uniform, Bernoulli and randint ones (heights, texture picks,
# exposures, the effects' uniforms and clean coins) equal, everything made
# of a normal (or of exp, cos, sin) within DRAW_TOL.
TRAIN_DRAWS = "tests/data/train_draws_jax.npz"
CARD_TEXTURES = 12
DRAW_NOISE_VALUES = 8
DRAW_TOL = 2e-6
TORCHRUN = ("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
            "--no-python")
WATCH_TICKS, WATCH_INTERVAL_S = 3, 0.2  # phase 17b's watch-run


def write_loop_trajectory(path: str) -> None:
    """The pose file of ``benchmarks/loop_closure_demo.sh``: two 10 s laps
    of a gentle double loop at fixed heading, after a rest-to-motion ramp
    (22 s at 50 Hz, '# t x y z qx qy qz qw')."""
    import numpy as np

    t = np.arange(0, 22.0, 1.0 / 50.0)
    w = 2 * np.pi / 10.0  # a 10 s lap: revisits at dt = 10 s
    env = np.clip(t / 1.5, 0, 1) ** 2  # rest -> motion ramp (trips the init jerk gate)
    x = 1.0 * (1 - np.cos(w * t)) * env
    y = 0.8 * np.sin(w * t) * env
    z = 0.15 * np.sin(2 * w * t) * env
    roll = 0.03 * np.sin(1.3 * t)
    pitch = 0.03 * np.cos(1.1 * t)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    q = np.stack([sr * cp, cr * sp, -sr * sp, cr * cp], -1)  # xyzw, yaw fixed
    np.savetxt(path, np.column_stack([t, x, y, z, q]),
               header="timestamp tx ty tz qx qy qz qw", comments="# ")


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {extra}".rstrip(), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rolled(deg: float, hgt: int = H, wid: int = W):
    """Pixel homography of a camera roll by ``deg`` about the image centre."""
    import math

    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    cx, cy = (wid - 1) / 2.0, (hgt - 1) / 2.0
    return [[c, -s, cx - c * cx + s * cy], [s, c, cy - s * cx - c * cy], [0.0, 0.0, 1.0]]


def parity_cases(torch, rng, b: int, dtype, hgt: int = H, wid: int = W):
    """(imgs, homographies) at B = b: random near-identity homographies,
    then (when b >= 4) off-image, z <= 0 and NaN ones, (when b >= 6) an
    extreme (90 deg) and a 20 deg roll, and (when b >= 7) z = 0 everywhere
    (+-inf coordinates, NaN at u = v = 0)."""
    import numpy as np

    if dtype == torch.uint8:
        imgs = rng.integers(0, 256, (b, hgt, wid)).astype(np.uint8)
    else:
        imgs = rng.random((b, hgt, wid)).astype(np.float32)
    hs = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    hs[:, :2, :2] += rng.normal(0, 0.03, (b, 2, 2)).astype(np.float32)
    hs[:, :2, 2] += rng.normal(0, 8.0, (b, 2)).astype(np.float32)
    hs[:, 2, :2] += rng.normal(0, 2e-4, (b, 2)).astype(np.float32)
    if b >= 4:
        hs[1] = [[1, 0, 5000], [0, 1, 5000], [0, 0, 1]]  # everything off-image
        hs[2] = [[1, 0, 0], [0, 1, 0], [0.01, 0, -1.6]]  # z <= 0 left of u=160
        hs[3, 0, 0] = np.nan  # NaN everywhere
    if b >= 6:
        hs[4] = rolled(90.0, hgt, wid)  # every output row sweeps a full image column
        hs[5] = rolled(20.0, hgt, wid)
    if b >= 7:
        hs[6] = [[1, 0, 0], [0, 1, 0], [0, 0, 0]]  # x/0, y/0: +-inf, and 0/0
    return imgs, hs


def tile_bands(torch, hs, hgt: int, wid: int, itemsize: int):
    """(B, tiles) bytes of the row band that each tile of the row-band
    kernel copies for homographies ``hs`` (0: no in-image tap): the rows of
    the in-image taps of its pixels, the tiles being runs of as many
    threads' pixels as a block has (``warp.cu``; the card's build says how
    many)."""
    from cuahn_vio_torch.ops.cuda.warp import pixels_per_thread, threads_per_block
    from cuahn_vio_torch.ops.warp import COORD_CLIP, _row_dot

    b, dev = hs.shape[0], hs.device
    u = torch.arange(wid, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(hgt, dtype=torch.float32, device=dev)[None, :, None]
    h = hs[:, :, :, None, None]
    x, y, z = (_row_dot(h[:, i], u, v) for i in range(3))
    su, sv = x / z, y / z
    nan = torch.isnan(su) | torch.isnan(sv)
    xi = torch.floor(su.clamp(-COORD_CLIP, COORD_CLIP)).nan_to_num(0.0).long()
    yi = torch.floor(sv.clamp(-COORD_CLIP, COORD_CLIP)).nan_to_num(0.0).long()
    lo, hi = yi.clamp(min=0), (yi + 1).clamp(max=hgt - 1)
    ok = ~nan & (xi + 1 >= 0) & (xi < wid) & (lo <= hi)
    ppt, threads = pixels_per_thread(b, hgt, wid), threads_per_block()
    groups = (wid + ppt - 1) // ppt
    r = torch.arange(hgt, device=dev)[:, None]
    c = torch.arange(wid, device=dev)[None, :]
    tile = ((r * groups + c // ppt) // threads).expand(b, hgt, wid)
    n_tiles = int(tile.max()) + 1
    idx = (torch.arange(b, device=dev)[:, None, None] * n_tiles + tile).reshape(-1)
    rmin = torch.full((b * n_tiles,), hgt, device=dev).scatter_reduce(
        0, idx, torch.where(ok, lo, hgt).reshape(-1), "amin")
    rmax = torch.full((b * n_tiles,), -1, device=dev).scatter_reduce(
        0, idx, torch.where(ok, hi, -1).reshape(-1), "amax")
    rows = torch.where(rmax >= rmin, rmax - rmin + 1, 0)
    return (rows * wid * itemsize).reshape(b, n_tiles)


def nan_checked_err(torch, out, ref, what: str) -> float:
    """Max abs error over ref's non-NaN entries; NaN must be exactly where
    ref has NaN."""
    nan_ref = torch.isnan(ref)
    if not torch.equal(torch.isnan(out), nan_ref):
        raise AssertionError(f"NaN pattern differs: {what}")
    diff = (out - ref).abs()[~nan_ref]
    return diff.max().item() if diff.numel() else 0.0


def warp_parity_inputs(torch, rng, dtype, dev):
    """(B, label, imgs, hs) of the warps' parity phase: 224x320 at B = 1,
    4, 8 and 65 (1, 2, 4 and 8 pixels a thread on the H100), in float32
    also at the trainer's B = 16 and its probe's B = PROBE_SIZE, and the
    RAGGED_SHAPES (parity_cases; B is None for these)."""
    from cuahn_vio_torch.train.trainer import PROBE_SIZE

    from cuahn_vio_torch.pipeline.loop_closure import LOOP_BATCH

    full = (1, 4, 8, 65) + ((TRAIN_BATCH, PROBE_SIZE) if dtype == torch.float32
                            else (LOOP_BATCH,))
    for b, hgt, wid in [(b, H, W) for b in full] + list(RAGGED_SHAPES):
        imgs, hs = parity_cases(torch, rng, b, dtype, hgt, wid)
        yield ((b if (hgt, wid) == (H, W) else None), f"{str(dtype):13s} B={b} {hgt}x{wid}",
               torch.as_tensor(imgs, device=dev), torch.as_tensor(hs, device=dev))


def check_warp(torch, label, imgs, hs) -> float:
    """The warp kernel against its plain version on ``imgs``, ``hs`` (from
    ``parity_cases``), bit for bit. Returns the max abs error (0.0)."""
    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda, pixels_per_thread
    from cuahn_vio_torch.ops.warp import homography_warp_plain

    out = homography_warp_cuda(imgs, hs)
    ref = homography_warp_plain(imgs, hs)
    torch.cuda.synchronize()
    err = nan_checked_err(torch, out, ref, f"warp {label}")
    nan_ref = torch.isnan(ref)
    if imgs.shape[0] >= 7 and not (
        nan_ref[3].all() and (ref[1] == 0).all() and (out[1] == 0).all()
        and nan_ref[6].any() and not nan_ref[6].all()
    ):
        raise AssertionError("special homographies lost their meaning")
    print(f"  warp parity {label} ({pixels_per_thread(*imgs.shape)} pixels a "
          f"thread): max abs err {err:.3e}, NaN pixels {int(nan_ref.sum())}", flush=True)
    if err != 0.0:
        raise AssertionError(f"warp kernel vs plain {err:.3e}: not bit-identical")
    return err


def check_kernel(torch, dev):
    """Phase 2, B1/B2: the warp kernel against its plain version, bit for
    bit. Returns the max abs error at 224x320 by (dtype name, B), each
    0.0."""
    import numpy as np

    rng = np.random.default_rng(0)
    errs = {}
    for dtype in (torch.uint8, torch.float32):
        for b, label, imgs, hs in warp_parity_inputs(torch, rng, dtype, dev):
            err = check_warp(torch, label, imgs, hs)
            if b is not None:
                errs[(str(dtype).split(".")[-1], b)] = err
    return errs


def check_rowskip(torch, dev):
    """Phase 2, B3: the row-band warp against the warp kernel and the plain
    version, which it must equal bit for bit, on the warp's cases and on
    rolls whose tiles' bands lie just under and just over the shared band
    (one image row either side). Returns the max abs error (0.0)."""
    import numpy as np

    from cuahn_vio_torch.ops.cuda.warp import (
        band_bytes,
        homography_warp_cuda,
        homography_warp_rowskip_cuda,
    )
    from cuahn_vio_torch.ops.warp import homography_warp_plain

    rng = np.random.default_rng(2)
    limit = band_bytes()
    for dtype in (torch.uint8, torch.float32):
        cases = [case[1:] for case in warp_parity_inputs(torch, rng, dtype, dev)]
        item = torch.tensor([], dtype=dtype).element_size()
        deg = BAND_EDGE_ROLL_DEG[item]
        imgs, hs = parity_cases(torch, rng, 2, dtype)
        hs[:] = rolled(deg)
        hs[1] = rolled(-deg)
        hs = torch.as_tensor(hs, device=dev)
        bands = tile_bands(torch, hs, H, W, item)
        under = int(((bands <= limit) & (bands > limit - W * item)).sum())
        over = int(((bands > limit) & (bands <= limit + W * item)).sum())
        if not (under and over):
            raise AssertionError(f"{deg} deg roll: no tile band just under ({under}) and "
                                 f"just over ({over}) {limit} B")
        cases.append((f"{str(dtype):13s} B=2 {H}x{W} +-{deg} deg roll, tile bands "
                      f"{under} just under / {over} just over {limit} B",
                      torch.as_tensor(imgs, device=dev), hs))
        for label, imgs, hs in cases:
            out = homography_warp_rowskip_cuda(imgs, hs)
            full = homography_warp_cuda(imgs, hs)
            ref = homography_warp_plain(imgs, hs)
            torch.cuda.synchronize()
            err_full = nan_checked_err(torch, out, full, f"rowskip vs warp {label}")
            err_plain = nan_checked_err(torch, out, ref, f"rowskip vs plain {label}")
            print(f"  rowskip parity {label}: max abs err vs warp kernel "
                  f"{err_full:.3e}, vs plain {err_plain:.3e}", flush=True)
            if not (err_full == 0.0 and err_plain == 0.0):
                raise AssertionError("the row-band warp is not bit-identical")
    return 0.0


def sample_cases(torch, rng, dtype, dev):
    """A 512x512 texture and flat coordinates: in-range, edges, off-image,
    +-inf and NaN."""
    import numpy as np

    t = TEX_SIZE
    if dtype == torch.uint8:
        tex = rng.integers(0, 256, (t, t)).astype(np.uint8)
    else:
        tex = rng.random((t, t)).astype(np.float32)
    inside = rng.uniform(0.0, t - 1.0, (2, 4096))
    edge = np.array([0.0, t - 1.0, t - 1.5, -0.5, t - 0.5, -1.0, float(t), -0.999, t - 0.001])
    special = np.array([-600.0, 600.0, 1e5, -1e5, np.inf, -np.inf, np.nan, 3.0])
    su = np.concatenate([inside[0], np.repeat(edge, len(edge)), np.repeat(special, len(special))])
    sv = np.concatenate([inside[1], np.tile(edge, len(edge)), np.tile(special, len(special))])
    return (torch.as_tensor(tex, device=dev),
            torch.as_tensor(su.astype(np.float32), device=dev),
            torch.as_tensor(sv.astype(np.float32), device=dev))


def camera(torch, dev):
    """(c_rot_i, i_t_i2c) of the smoke's sequences (the UZH-FPV indoor 45
    extrinsics) on ``dev``."""
    import numpy as np

    from cuahn_vio_torch.utils.config import VioOptions

    t_imu_to_cam = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64)
    return (torch.tensor(t_imu_to_cam[:3, :3], dtype=torch.float32, device=dev),
            torch.tensor(-t_imu_to_cam[:3, :3].T @ t_imu_to_cam[:3, 3], dtype=torch.float32,
                         device=dev))


def frame_sample_coords(torch, dev, exposure_s: float = 0.0):
    """The (P,) coordinates at which ``sample_plane`` has the flat sampler
    read the texture for one rendered frame: the first TEX_SEQS flight 2 s
    into its motion, mirror-tiled onto a 512x512 texture at TEX_SCALE_M.
    Sharp (``exposure_s`` 0): P = 224 x 320, shape 1; blurred over
    ``exposure_s`` (``render_frame_blurred``, its 3 taps in one call): P =
    3 x 224 x 320, shape 2."""
    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, exposure_taps, ground_points
    from cuahn_vio_torch.data.textures import default_tex_params, plane_coords

    p, q = exposure_taps(AnalyticTrajectory(), [2.0], exposure_s, dev)
    if exposure_s == 0.0:
        p, q = p[:, 0], q[:, 0]  # render_frame's single pose
    ground, _ = ground_points(p[0], q[0], *camera(torch, dev), H, W)
    su, sv = plane_coords(TEX_SIZE, ground, default_tex_params(TEX_SCALE_M).to(dev))
    return su.reshape(-1).contiguous(), sv.reshape(-1).contiguous()


def batch_sample_inputs(torch, dev, dtype):
    """Shape 3, the JAX trainer's batch (``trainer.make_batch``, ``vmap`` of
    ``sample_pair`` over 16 samples): BATCH_TEXTURES bank textures
    (``_procedural_extras(512)`` in turn, at uint8 levels; float32 k/255
    for ``dtype`` float32), each at the coordinates of one blurred frame
    (EXPOSURE_S, 3 taps) at a random time of the analytic flight, under
    random tex params across the trainer's range (scale 1.5-10 m
    log-uniform, rotation 0-2 pi, offset 0-2), from a numpy seed. Returns
    (textures (B, 512, 512), su, sv (B, 3 x 224 x 320))."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, exposure_taps, ground_points
    from cuahn_vio_torch.data.textures import (
        _procedural_extras,
        plane_coords,
        quantize_u8,
        texture_u8,
    )

    b = BATCH_TEXTURES
    rng = np.random.default_rng(6)
    extras = _procedural_extras(TEX_SIZE)
    bank = [quantize_u8(extras[i % len(extras)]) for i in range(b)]
    tex = np.stack([texture_u8(t) for t in bank] if dtype == torch.uint8 else bank)
    p, q = exposure_taps(AnalyticTrajectory(), rng.uniform(0.5, 6.0, b), EXPOSURE_S, dev)
    th = rng.uniform(0.0, 2 * np.pi, b)
    params = np.stack([np.exp(rng.uniform(np.log(1.5), np.log(10.0), b)), np.cos(th),
                       np.sin(th), *rng.uniform(0.0, 2.0, (2, b))], axis=1)
    ground, _ = ground_points(p, q, *camera(torch, dev), H, W)  # (B, 3, H, W, 2)
    su, sv = plane_coords(TEX_SIZE, ground,
                          torch.tensor(params, dtype=torch.float32, device=dev))
    return (torch.as_tensor(tex, device=dev), su.reshape(b, -1).contiguous(),
            sv.reshape(b, -1).contiguous())


def fil_sample_inputs(torch, dev, dtype):
    """Shape 4, the FIL window batch (``train.fil.render_windows``): FIL_BATCH
    bank textures (``_procedural_extras(512)`` in turn, at uint8 levels;
    float32 k/255 for ``dtype`` float32), each at the coordinates of
    FIL_WINDOW + 1 consecutive blurred frames (EXPOSURE_S, 3 taps, 30 Hz)
    from a random time of the analytic flight, under random tex params
    across the trainer's range, from a numpy seed. Returns (textures (B,
    512, 512), su, sv (B, (W + 1) x 3 x 224 x 320))."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, exposure_taps, ground_points
    from cuahn_vio_torch.data.textures import (
        _procedural_extras,
        plane_coords,
        quantize_u8,
        texture_u8,
    )

    b, f = FIL_BATCH, FIL_WINDOW + 1
    rng = np.random.default_rng(8)
    extras = _procedural_extras(TEX_SIZE)
    bank = [quantize_u8(extras[(3 * i) % len(extras)]) for i in range(b)]
    tex = np.stack([texture_u8(t) for t in bank] if dtype == torch.uint8 else bank)
    times = (rng.uniform(0.5, 5.5, b)[:, None] + np.arange(f)[None, :] / 30.0).reshape(-1)
    p, q = exposure_taps(AnalyticTrajectory(), times, EXPOSURE_S, dev)
    th = rng.uniform(0.0, 2 * np.pi, b)
    params = np.stack([np.exp(rng.uniform(np.log(1.5), np.log(10.0), b)), np.cos(th),
                       np.sin(th), *rng.uniform(0.0, 2.0, (2, b))], axis=1)
    ground, _ = ground_points(p, q, *camera(torch, dev), H, W)  # (B F, 3, H, W, 2)
    su, sv = plane_coords(TEX_SIZE, ground.reshape(b, f, *ground.shape[1:]),
                          torch.tensor(params, dtype=torch.float32, device=dev))
    return (torch.as_tensor(tex, device=dev), su.reshape(b, -1).contiguous(),
            sv.reshape(b, -1).contiguous())


def misaligned(torch, x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary (as ``su[1:]`` of a fresh tensor does)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def sample_parity_inputs(torch, rng, dtype, dev):
    """(label, images, su, sv) of the flat sampler's parity phase: shapes 1,
    2 and 3 (a frame's, a blurred frame's and the trainer batch's
    coordinates), shape 4 (the FIL windows), shape 5 (shape 3's first
    FIL_PAIR_BATCH textures: a FIL pair step's batch), shape 3 at the
    probe's 32 textures (the batch twice, its
    second half's coordinates rolled by one texture), the batch's first 2
    and 4 textures, ragged N (N mod 8 !=
    0), 4-byte-misaligned coordinates, all of shape 3's points on one
    texture (8 points a thread in one row), and the special coordinates
    (in-range, edges, off-image, +-inf, NaN) on one texture, on a texture
    509 wide (rows not whole 4-byte words: one load a uint8 tap) and on
    3."""
    tex, su, sv = sample_cases(torch, rng, dtype, dev)
    frame = frame_sample_coords(torch, dev)
    blurred = frame_sample_coords(torch, dev, EXPOSURE_S)
    texs, bsu, bsv = batch_sample_inputs(torch, dev, dtype)
    cut = bsu.shape[1] - 5
    yield "shape 1 (frame)", tex, *frame
    yield "shape 2 (blurred frame)", tex, *blurred
    yield "shape 3 (trainer batch)", texs, bsu, bsv
    yield "shape 4 (FIL windows)", *fil_sample_inputs(torch, dev, dtype)
    yield ("shape 5 (FIL pair step)", texs[:FIL_PAIR_BATCH], bsu[:FIL_PAIR_BATCH],
           bsv[:FIL_PAIR_BATCH])
    yield ("shape 3 (probe, 2 x the batch's textures)", torch.cat([texs, texs]),
           torch.cat([bsu, bsu.roll(1, 0)]), torch.cat([bsv, bsv.roll(1, 0)]))
    for b in (2, 4):
        yield f"batch of {b}", texs[:b], bsu[:b], bsv[:b]
    yield "shape 1 ragged", tex, frame[0][:-3], frame[1][:-3]
    yield "shape 3 ragged", texs, bsu[:, :cut].contiguous(), bsv[:, :cut].contiguous()
    yield "shape 3 on one texture, ragged", texs[0], bsu.reshape(-1)[:-5], bsv.reshape(-1)[:-5]
    yield "shape 2 at su[1:], sv[1:]", tex, blurred[0][1:], blurred[1][1:]
    yield "shape 3 misaligned", texs, misaligned(torch, bsu), misaligned(torch, bsv)
    yield "special", tex, su, sv
    yield "special on a 509-wide texture", tex[:509, :509].contiguous(), su, sv
    yield "special on 3 textures", texs[:3], *(torch.stack([x, x.flip(0), x.roll(7)]) for x in (su, sv))


def check_sample(torch, dev):
    """Phase 2, B4: the flat sampler against its plain version, bit for bit,
    on ``sample_parity_inputs``, uint8 and float32. Returns the max abs
    error at shapes 1-2 ("frame"), at shape 3 and the probe's 32 textures
    ("batch"), at shape 4 ("fil"), at shape 5 ("pair") and over all
    ("all")."""
    import numpy as np

    from cuahn_vio_torch.ops.cuda.warp import bilinear_sample_cuda, pixels_per_thread
    from cuahn_vio_torch.ops.warp import bilinear_sample_flat

    rng = np.random.default_rng(3)
    worst = {"frame": 0.0, "batch": 0.0, "fil": 0.0, "pair": 0.0, "other": 0.0}
    for dtype in (torch.uint8, torch.float32):
        for label, tex, csu, csv in sample_parity_inputs(torch, rng, dtype, dev):
            out = bilinear_sample_cuda(tex, csu, csv)
            ref = bilinear_sample_flat(tex, csu, csv)
            torch.cuda.synchronize()
            err = nan_checked_err(torch, out, ref, f"flat sampler {dtype} {label}")
            b = tex.shape[0] if tex.dim() == 3 else 1
            print(f"  sampler parity {str(dtype):13s} {label} B={b} N={csu.shape[-1]} "
                  f"({pixels_per_thread(b, 1, csu.shape[-1])} points a thread, su at "
                  f"{csu.data_ptr() % 16} mod 16 B): max abs err {err:.3e}, NaN points "
                  f"{int(torch.isnan(ref).sum())}", flush=True)
            if err != 0.0:
                raise AssertionError(f"sampler vs plain {err:.3e}: not bit-identical")
            key = {"shape 1": "frame", "shape 2": "frame", "shape 3": "batch",
                   "shape 4": "fil", "shape 5": "pair"}.get(label.split(" (")[0], "other")
            worst[key] = max(worst[key], err)
    return dict(worst, all=max(worst.values()))


def time_ms(torch, fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` eager calls back to back (CUDA
    events): at small sizes this is the host's launch rate."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(torch, fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in a
    CUDA graph and replayed, so no host launch cost is between kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def warp_bound_ms(b: int, pixel_bytes: int) -> float:
    """Least time for one warp of B images: each input byte read once
    (images + homographies), each output float written once, against the
    float32 work of the coordinates and the bilinear blend."""
    bytes_moved = b * (H * W * pixel_bytes + 9 * 4) + b * H * W * 4
    flops = b * H * W * WARP_FLOPS_PER_PIXEL
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def timed(torch, fns: dict, bound_ms: float, iters: int, rounds: int = 3):
    """(device times from CUDA-graph replays + bound_ms, eager times) of
    ``fns`` {key: fn}; each device time is the median of ``rounds``
    measurements, taken in turns over ``fns``."""
    import statistics

    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            runs[k].append(time_graph_ms(torch, fn))
    row = {k: statistics.median(v) for k, v in runs.items()}
    row["bound_ms"] = bound_ms
    eager = {k: time_ms(torch, fn, iters) for k, fn in fns.items()}
    return row, eager


def library_grid(torch, hs):
    """grid_sample's (B, H, W, 2) normalized (align_corners=True) grid of
    the points at which the warp samples under ``hs`` (the library
    yardstick's input)."""
    dev = hs.device
    u = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    v = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    h = hs[:, :, :, None, None]
    z = h[:, 2, 0] * u + h[:, 2, 1] * v + h[:, 2, 2]
    su = (h[:, 0, 0] * u + h[:, 0, 1] * v + h[:, 0, 2]) / z
    sv = (h[:, 1, 0] * u + h[:, 1, 1] * v + h[:, 1, 2]) / z
    return torch.stack([2 * su / (W - 1) - 1, 2 * sv / (H - 1) - 1], dim=-1)


def time_warp(torch, dev, rng, kernel: str, dtype, b: int, iters: int) -> dict:
    """Warp kernel (``kernel`` "warp") or row-band kernel ("rowskip") /
    plain / grid_sample times of B 224x320 images of ``dtype``, each under
    the same finite near-identity homography. Returns {ms, plain_ms,
    library_ms, bound_ms}."""
    import torch.nn.functional as F

    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda, homography_warp_rowskip_cuda
    from cuahn_vio_torch.ops.warp import homography_warp_plain

    name = "uint8" if dtype == torch.uint8 else "float32"
    imgs, hs = parity_cases(torch, rng, b, dtype)
    hs[:] = hs[0]  # finite, near identity for every image
    imgs = torch.as_tensor(imgs, device=dev)
    hs = torch.as_tensor(hs, device=dev)
    # grid_sample's input: the same images as float, and the same sample
    # points as a normalized grid
    img_f = (imgs.float() / 255.0 if name == "uint8" else imgs)[:, None]
    grid = library_grid(torch, hs)

    def library():
        return F.grid_sample(img_f, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    lib_err = (library()[:, 0] - homography_warp_plain(imgs, hs)).abs().max().item()
    launch = homography_warp_cuda if kernel == "warp" else homography_warp_rowskip_cuda
    row, eager = timed(torch, dict(
        ms=lambda: launch(imgs, hs),
        plain_ms=lambda: homography_warp_plain(imgs, hs),
        library_ms=library,
    ), warp_bound_ms(b, imgs.element_size()), iters)
    print(f"  {kernel} {name} B={b} device time (CUDA graph): kernel {row['ms']:.5f} ms"
          f" | plain {row['plain_ms']:.5f} ms | grid_sample "
          f"{row['library_ms']:.5f} ms (|diff| {lib_err:.2e}) | kernel / grid_sample "
          f"{row['ms'] / row['library_ms']:.3f} | byte bound {row['bound_ms']:.5f} ms",
          flush=True)
    print(f"  {kernel} {name} B={b} eager call to call: kernel {eager['ms']:.5f} ms | "
          f"plain {eager['plain_ms']:.5f} ms | grid_sample "
          f"{eager['library_ms']:.5f} ms", flush=True)
    return row


def time_kernel(torch, dev):
    """Phase 3, warps: ``time_warp`` for uint8 frames (the main path's
    input) and float32 images. Returns {(kernel, dtype name, B): {ms,
    plain_ms, library_ms, bound_ms}}."""
    import numpy as np

    rng = np.random.default_rng(1)
    cases = (("warp", torch.uint8, 1, 500), ("warp", torch.uint8, 4, 200),
             ("warp", torch.uint8, 64, 50), ("warp", torch.float32, 1, 500),
             ("warp", torch.float32, 4, 200), ("warp", torch.float32, FIL_PAIR_BATCH, 200),
             ("warp", torch.float32, 16, 200),
             ("warp", torch.float32, 64, 50),
             ("rowskip", torch.uint8, 4, 200), ("rowskip", torch.uint8, 8, 200),
             ("rowskip", torch.uint8, 64, 50))
    return {(kernel, "uint8" if dtype == torch.uint8 else "float32", b):
            time_warp(torch, dev, rng, kernel, dtype, b, iters)
            for kernel, dtype, b, iters in cases}


# the towers' input (H, W) at 224x320 frames
TOWER_INPUT = {"block2": (H // 4, W // 4), "block3": (H // 2, W // 2), "block4": (H, W)}
# each shape of ``ops/cuda/conv.SHAPES`` as its first layer in the towers:
# (tower, layer); V1's three, then V2's eight
CONV_LAYERS = (("block4", 0), ("block4", 1), ("block3", 0), ("block2", 0), ("block2", 1),
               ("block3", 1), ("block4", 2), ("block3", 2), ("block3", 3), ("block2", 2),
               ("block2", 3))
CONV_BATCHES = (64, 16, 8, 1, 13)  # close-loops, eval-flow, run-vio-batch, run-vio, a ragged B
# the batches phase 3 times, by kernel: V1 at close-loops' B = 64 alone,
# which keeps the phase inside its time (its plain version is a slow
# reference), V2 at B = 64, 16 and 1
CONV_TIMED_BATCHES = {"V1": (64,), "V2": (64, 16, 1)}
# V2's split path's launches a no-grad float32 call on the card: two for
# each of the six layers of blocks 2-4 at 7x10 and 4x5 out, and for block
# 1's conv2 where the full cascade runs it
SPLIT_LAUNCHES_PRIOR, SPLIT_LAUNCHES_FULL = 2 * 6, 2 * 7
# phase 3's yardstick for V2K: the tilings its shapes had while V2 took
# their K whole in a block, in a copy of conv_gemm.cu
V2_WHOLE_K = {
    (128, 256, 3, 2): "kBM = 64, kBN = 64, kTM = 8, kTN = 8, kKS = 2, kBK = 12, kStages = 3",
    (256, 256, 3, 2): "kBM = 32, kBN = 32, kTM = 8, kTN = 4, kKS = 4, kBK = 6, kStages = 3",
}
# ragged parity inputs (B, H, W): no multiple of a tile, smaller than one,
# odd under the stride
CONV_RAGGED = ((3, 37, 53), (2, 5, 3), (2, 9, 11))


def conv_layers(torch, dev) -> list:
    """(label, kernel, conv layer with the v10 weights, its input H, its
    input W) of each shape in ``conv.SHAPES``, the sizes from the layers
    before it."""
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.ops.cuda import conv
    from cuahn_vio_torch.utils.checkpoint import load_params

    model = build_uahn(load_params(WEIGHTS), device=dev)
    out, shapes = [], []
    for tower, i in CONV_LAYERS:
        layers = list(getattr(model, tower).children())
        h, w = TOWER_INPUT[tower]
        for layer in layers[:i]:
            k, st = layer.kernel_size[0], layer.stride[0]
            h, w = conv.out_size(h, k, st), conv.out_size(w, k, st)
        c = layers[i]
        shapes.append((c.in_channels, c.out_channels, c.kernel_size[0], c.stride[0]))
        out.append((f"{tower}.conv{i}", conv.SHAPES[shapes[-1]], c, h, w))
    if sorted(shapes) != sorted(conv.SHAPES):
        raise AssertionError(f"CONV_LAYERS' shapes {shapes} are not conv.SHAPES, each once")
    return out


def conv_label(kernel) -> str:
    """A conv kernel's name in the smoke's lines: V1, V2, or V2K (V2's
    split path)."""
    return f"{kernel.label}K" if kernel.splits else kernel.label


def whole_k_source() -> str:
    """A copy of ``conv_gemm.cu`` (under ``_build/``) with V2K's shapes on
    their whole-K tilings (``V2_WHOLE_K``) in its ``conv_gemm_f32``, and no
    split path; returns its path."""
    import re

    from cuahn_vio_torch.ops.cuda import build
    from cuahn_vio_torch.ops.cuda import conv as conv_cuda

    with open(conv_cuda.V2.source) as f:
        src = f.read()
    for shape, tiling in V2_WHOLE_K.items():
        name = ", ".join(map(str, shape))
        src, n = re.subn(r"struct Tiling<" + re.escape(name) + r"> \{.*?\n\};",
                         f"struct Tiling<{name}> : Whole {{\n  static constexpr int {tiling};\n}};",
                         src, flags=re.S)
        assert n == 1, f"conv_gemm.cu has no Tiling<{name}>"
    src, n = re.subn(r"#define V2_SPLIT_SHAPES\(X\)[^\n]*\n(?:[^\n]*\\\n)*[^\n]*\n",
                     "#define V2_SPLIT_SHAPES(X)\n", src)
    src = src.replace("#define V2_SHAPES(X)", "#define V2_SHAPES(X) " + " ".join(
        f"X({', '.join(map(str, shape))})" for shape in V2_WHOLE_K) + " \\\n ", 1)
    assert n == 1 and all(f"X({', '.join(map(str, s))}) " in src for s in V2_WHOLE_K)
    path = os.path.join(build.BUILD_DIR, "whole_k", "conv_gemm_whole_k.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path) or open(path).read() != src:
        with open(path, "w") as f:
            f.write(src)
    return path


def whole_k_launcher():
    """``conv_gemm_f32`` of ``whole_k_source``'s library, its shared memory
    allowed."""
    import ctypes

    from cuahn_vio_torch.ops.cuda import build

    path = whole_k_source()
    if build.entry(path, "conv_gemm_init", ())() != 0:
        raise AssertionError("the whole-K copy of conv_gemm.cu: conv_gemm_init failed")
    return build.entry(path, "conv_gemm_f32", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9
                       + (ctypes.c_void_p,))


def check_conv(torch, dev) -> dict:
    """Phase 2, V1 and V2: each kernel against its plain version on the card
    at each of its shapes' tower size at B = 64, 16, 8, 1 and 13 and on
    CONV_RAGGED's sizes; each output within ``conv.rounding_bound``; rows 0
    and 63 of the B = 64 launch the same bits as those pairs launched
    alone. Returns {label: (kernel, max abs error, largest share of the
    bound)}."""
    from cuahn_vio_torch.ops.cuda.conv import conv_leaky_cuda, rounding_bound

    gen = torch.Generator(device=dev).manual_seed(25)
    found = {}
    for label, kernel, conv, h, w in conv_layers(torch, dev):
        worst_err, worst_share = 0.0, 0.0
        wt, bias, s = conv.weight.detach(), conv.bias.detach(), conv.stride[0]
        for b, hh, ww in [(b, h, w) for b in CONV_BATCHES] + list(CONV_RAGGED):
            x = torch.rand((b, conv.in_channels, hh, ww), generator=gen, device=dev) * 2 - 0.5
            got = conv_leaky_cuda(x, wt, bias, s)
            want = kernel.plain(x, wt, bias, s)
            bound = rounding_bound(x, wt, bias, s)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{conv_label(kernel)} {label} at {(b, hh, ww)}: shape "
                                     f"{tuple(got.shape)} against {tuple(want.shape)}, or not "
                                     f"finite")
            err = (got - want).abs()
            share = float(torch.where(err == 0, 0.0, err / bound).max())
            if share > 1.0:
                raise AssertionError(f"{conv_label(kernel)} {label} at {(b, hh, ww)}: "
                                     f"{float(err.max()):.3e} apart from its plain version, "
                                     f"{share:.2f}x its bound")
            if b == 64:
                for i in (0, 63):
                    if not conv_leaky_cuda(x[i:i + 1].contiguous(), wt, bias, s).equal(got[i:i + 1]):
                        raise AssertionError(f"{conv_label(kernel)} {label}: pair {i} of 64 not the "
                                             f"bits of B = 1")
            worst_err, worst_share = max(worst_err, float(err.max())), max(worst_share, share)
        found[label] = (kernel, worst_err, worst_share)
    return found


def conv_ptxas_entry(report: dict, kernel, shape: tuple) -> dict:
    """ptxas's entry (``conv.ptxas_report``) of ``kernel`` at layer
    ``shape`` as close-loops' B = 64 runs it: V1's one instantiation, V2's
    wide tiling (``<..., 0>``)."""
    name = "{}<{}".format(kernel.symbol, ",".join(map(str, shape)))
    return report.get(f"{name}>") or report[f"{name},0>"]


def time_conv(torch, dev) -> dict:
    """Phase 3, V1 and V2: device times (CUDA-graph replays, in turns) at
    each shape's tower size at its kernel's ``CONV_TIMED_BATCHES``: the
    shape's kernel, its plain version, cuDNN's best algorithm for the
    convolution with its bias (``library_ms``: benchmark mode trying every
    engine, the faster of NCHW and NHWC; the port never calls it), its
    LeakyReLU pass, and the FLOP bound; for V2K also V2's whole-K tiling of
    the shape (``whole_ms``, ``V2_WHOLE_K``; None elsewhere). Returns
    {(label, B): {kernel, shape, ms, plain_ms, library_ms, library_layout,
    leaky_ms, whole_ms, bound_ms, gflop}}."""
    import torch.nn.functional as F

    from cuahn_vio_torch.ops.cuda.conv import conv_leaky_cuda, out_size

    gen = torch.Generator(device=dev).manual_seed(26)
    whole = whole_k_launcher()
    rows = {}
    benchmark, limit = torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit
    torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit = True, 0
    try:
        for label, kernel, conv, h, w in conv_layers(torch, dev):
            for b in CONV_TIMED_BATCHES[kernel.label]:
                x = torch.rand((b, conv.in_channels, h, w), generator=gen, device=dev)
                wt, bias, s, pad = conv.weight.detach(), conv.bias.detach(), conv.stride, conv.padding
                x_nhwc = x.contiguous(memory_format=torch.channels_last)
                w_nhwc = wt.contiguous(memory_format=torch.channels_last)
                y = F.conv2d(x, wt, bias, s, pad)
                flops = 2 * y.numel() * conv.in_channels * conv.kernel_size[0] ** 2
                bytes_moved = 4 * (x.numel() + y.numel() + wt.numel() + bias.numel())
                fns = {
                    "ms": lambda: conv_leaky_cuda(x, wt, bias, s[0]),
                    "plain_ms": lambda: kernel.plain(x, wt, bias, s[0]),
                    "nchw": lambda: F.conv2d(x, wt, bias, s, pad),
                    "nhwc": lambda: F.conv2d(x_nhwc, w_nhwc, bias, s, pad),
                    "leaky_ms": lambda: F.leaky_relu(y, 0.1),
                }
                if kernel.splits:  # V2's whole-K tiling of the shape, into its own output
                    out_w = torch.empty_like(y)
                    k = conv.kernel_size[0]
                    sizes = (b, conv.in_channels, conv.out_channels, k, s[0], h, w,
                             out_size(h, k, s[0]), out_size(w, k, s[0]))

                    def whole_k():
                        err = whole(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                                    out_w.data_ptr(), *sizes,
                                    torch.cuda.current_stream().cuda_stream)
                        if err != 0:
                            raise AssertionError(f"V2's whole-K {label}: cudaError {err}")

                    fns["whole_ms"] = whole_k
                row, _ = timed(torch, fns, max(flops / F32_FLOPS_PER_S,
                                               bytes_moved / HBM_BYTES_PER_S) * 1e3, iters=5)
                layout = min(("nchw", "nhwc"), key=lambda k: row[k])
                rows[(label, b)] = dict(kernel=kernel, shape=(conv.in_channels, conv.out_channels,
                                                              conv.kernel_size[0], s[0]),
                                        ms=row["ms"], plain_ms=row["plain_ms"],
                                        library_ms=row[layout], library_layout=layout,
                                        leaky_ms=row["leaky_ms"], whole_ms=row.get("whole_ms"),
                                        bound_ms=row["bound_ms"], gflop=flops / 1e9)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit = benchmark, limit
    return rows


HEADS_BATCHES = (64, 19, 16, 1)  # close-loops, its ragged last call, eval-flow, run-vio
HEADS_TIMED_BATCHES = (64, 16, 1)


def heads_inputs(torch, dev, b: int, seed: int):
    """(model with the v10 weights, features, masks) of one heads call at
    B = ``b``: block 4's features as a LeakyReLU output of a tower's scale,
    the masks drawn by T1 as a network call draws them."""
    import numpy as np

    from cuahn_vio_torch.models.uahn import build_uahn, draw_masks
    from cuahn_vio_torch.ops.cuda.heads import IN
    from cuahn_vio_torch.utils.checkpoint import load_params

    model = build_uahn(load_params(WEIGHTS), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.nn.functional.leaky_relu(
        torch.randn((b, IN), generator=gen, device=dev) + 0.2, 0.1)
    keys = np.stack([np.array([seed, i], np.uint32) for i in range(b)])
    return model, feat, draw_masks(keys, model.dropout_rate, IN, dev, b)


def check_heads(torch, dev) -> dict:
    """Phase 2, H1: the kernel pair against its plain version at
    HEADS_BATCHES with the v10 heads, each output within
    ``heads.rounding_bounds``; rows 0 and 63 of the B = 64 call the same
    bits as those pairs called alone. Returns {output: (max abs error,
    largest share of the bound)}."""
    from cuahn_vio_torch.ops.cuda import heads

    found = {}
    for b in HEADS_BATCHES:
        model, feat, masks = heads_inputs(torch, dev, b, 26 + b)
        pair = (model.head_mean, model.head_logvar)
        with torch.no_grad():
            got = heads.mc_heads_cuda(feat, masks, model.dropout_rate, pair, model.corners)
            want = heads.heads_plain(feat, masks, model.dropout_rate, pair, model.corners)
            bounds = heads.rounding_bounds(feat, masks, model.dropout_rate, pair, model.corners,
                                           want[0])
            torch.cuda.synchronize()
            for name, g, w, lim in zip(("members", "pred", "var"), got, want, bounds):
                if g.shape != w.shape or not torch.isfinite(g).all():
                    raise AssertionError(f"H1 {name} at B = {b}: shape {tuple(g.shape)} against "
                                         f"{tuple(w.shape)}, or not finite")
                err = (g - w).abs()
                share = float(torch.where(err == 0, 0.0, err / lim).max())
                if share > 1.0:
                    raise AssertionError(f"H1 {name} at B = {b}: {float(err.max()):.3e} apart "
                                         f"from its plain version, {share:.2f}x its bound")
                e0, s0 = found.get(name, (0.0, 0.0))
                found[name] = (max(e0, float(err.max())), max(s0, share))
            if b == 64:
                for i in (0, 63):
                    one = heads.mc_heads_cuda(feat[i:i + 1].contiguous(),
                                              tuple((m0[i:i + 1], m1[i:i + 1]) for m0, m1 in masks),
                                              model.dropout_rate, pair, model.corners)
                    if not all(o.equal(g[i:i + 1]) for o, g in zip(one, got)):
                        raise AssertionError(f"H1: pair {i} of 64 not the bits of B = 1")
    return found


def time_heads(torch, dev) -> dict:
    """Phase 3, H1: device times (CUDA-graph replays, in turns) at
    HEADS_TIMED_BATCHES with the v10 heads: the kernel pair, the UAHN's
    eager heads stage (``McHead`` twice and ``ensemble_statistics``, the
    path before H1, which its no-grad call on the card took), the plain
    version, and the FLOP bound (``perfbench/lib/counts.head_flops``' work:
    fc0 and fc1 of both heads); and each one's eager call-to-call time.
    Returns {B: {ms, eager_ms, plain_ms, bound_ms, gflop, ms_host,
    eager_ms_host}}."""
    from cuahn_vio_torch.ops.cuda import heads

    rows = {}
    for b in HEADS_TIMED_BATCHES:
        model, feat, masks = heads_inputs(torch, dev, b, 27 + b)
        pair, rate = (model.head_mean, model.head_logvar), model.dropout_rate

        def eager():
            means, logvars = model._members(feat, masks)
            return heads.ensemble_statistics(means, logvars, model.corners)

        flops = 2 * b * 2 * heads.MEMBERS * (heads.IN * heads.HIDDEN + heads.HIDDEN * heads.OUT)
        fns = {"ms": lambda: heads.mc_heads_cuda(feat, masks, rate, pair, model.corners),
               "eager_ms": eager,
               "plain_ms": lambda: heads.heads_plain(feat, masks, rate, pair, model.corners)}
        with torch.no_grad():
            row, host = timed(torch, fns, flops / F32_FLOPS_PER_S * 1e3, iters=20)
        rows[b] = dict(row, gflop=flops / 1e9, ms_host=host["ms"], eager_ms_host=host["eager_ms"])
    return rows


def sample_bound_ms(torch, tex, su, sv) -> tuple[float, int]:
    """(least ms, distinct texels read) of one flat-sampler call: 8 B of
    coordinates and 4 B of output a point, and each texel that an in-image
    tap of this call reads, once, against the float32 work."""
    t = tex.shape[-1]
    b = tex.shape[0] if tex.dim() == 3 else 1
    x0, y0 = torch.floor(su).long(), torch.floor(sv).long()
    base = (torch.arange(b, device=su.device) * (t * t)).reshape(b, *[1] * (su.dim() - 1))
    taps = torch.cat([(base + (y0 + dy) * t + (x0 + dx)).reshape(-1)
                      for dy in (0, 1) for dx in (0, 1)])
    inside = torch.cat([((y0 + dy >= 0) & (y0 + dy < t) & (x0 + dx >= 0) & (x0 + dx < t))
                        .reshape(-1) for dy in (0, 1) for dx in (0, 1)])
    texels = int(torch.unique(taps[inside]).numel())
    n = su.numel()
    bytes_moved = 3 * n * 4 + texels * tex.element_size()
    return max(bytes_moved / HBM_BYTES_PER_S,
               n * SAMPLE_FLOPS_PER_POINT / F32_FLOPS_PER_S) * 1e3, texels


def time_sample(torch, dev):
    """Phase 3, B4: the flat sampler on uint8 textures at its four shapes:
    1, one rendered frame's 71,680 coordinates on a 512x512 texture; 2, a
    blurred frame's 3 x 71,680 (EXPOSURE_S); 3, the trainer batch's
    BATCH_TEXTURES textures at 3 x 71,680 each; 4, the FIL window batch's
    FIL_BATCH textures at (FIL_WINDOW + 1) x 3 x 71,680 each; 5, shape 3's
    first FIL_PAIR_BATCH textures (a FIL pair step). Beside it, in the same
    turns: its plain version, batched grid_sample on the same points, and
    the launch floor (a one-element ``add_`` in the same CUDA graph).
    Returns {shape: {ms, plain_ms, library_ms, floor_ms, bound_ms, points,
    texels}}."""
    import numpy as np
    import torch.nn.functional as F

    from cuahn_vio_torch.ops.cuda.warp import bilinear_sample_cuda, pixels_per_thread
    from cuahn_vio_torch.ops.warp import bilinear_sample_flat

    t = TEX_SIZE
    rng = np.random.default_rng(4)
    tex = torch.as_tensor(rng.integers(0, 256, (t, t)).astype(np.uint8), device=dev)
    texs, bsu, bsv = batch_sample_inputs(torch, dev, torch.uint8)
    shapes = {1: (tex, *frame_sample_coords(torch, dev)),
              2: (tex, *frame_sample_coords(torch, dev, EXPOSURE_S)),
              3: (texs, bsu, bsv),
              4: fil_sample_inputs(torch, dev, torch.uint8),
              5: (texs[:FIL_PAIR_BATCH], bsu[:FIL_PAIR_BATCH], bsv[:FIL_PAIR_BATCH])}
    one = torch.zeros(1, device=dev)
    rows = {}
    for shape, (img, su, sv) in shapes.items():
        imgs, su2, sv2 = (img if img.dim() == 3 else img[None],
                          su.reshape(-1, su.shape[-1]), sv.reshape(-1, sv.shape[-1]))
        b, n = su2.shape
        bound, texels = sample_bound_ms(torch, img, su, sv)
        tex_f = (imgs.float() / 255.0)[:, None]
        grid = torch.stack([2 * su2 / (t - 1) - 1, 2 * sv2 / (t - 1) - 1], dim=-1)[:, None]

        def library():
            return F.grid_sample(tex_f, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        lib_err = (library().reshape(b, n) - bilinear_sample_flat(imgs, su2, sv2)).abs().max()
        row, eager = timed(torch, dict(
            ms=lambda: bilinear_sample_cuda(img, su, sv),
            plain_ms=lambda: bilinear_sample_flat(img, su, sv),
            library_ms=library,
            floor_ms=lambda: one.add_(1.0),
        ), bound, 500 if shape < 3 else 50)
        row.update(points=b * n, texels=texels)
        rows[shape] = row
        print(f"  sampler shape {shape} uint8 B={b} N={n} ({pixels_per_thread(b, 1, n)} points "
              f"a thread, {texels} texels) device time (CUDA graph): kernel {row['ms']:.5f} ms"
              f" | plain {row['plain_ms']:.5f} ms | grid_sample {row['library_ms']:.5f} ms "
              f"(|diff| {lib_err.item():.2e}) | kernel / grid_sample "
              f"{row['ms'] / row['library_ms']:.3f} | byte bound {row['bound_ms']:.5f} ms | "
              f"kernel / bound {row['ms'] / row['bound_ms']:.2f} | launch floor "
              f"{row['floor_ms']:.5f} ms", flush=True)
        print(f"  sampler shape {shape} eager call to call: kernel {eager['ms']:.5f} ms | "
              f"plain {eager['plain_ms']:.5f} ms | grid_sample {eager['library_ms']:.5f} ms",
              flush=True)
    return rows


def slice_setup(torch, dev):
    """The slice's sequence, options (the config make-synthetic writes for
    it) and v10 model on ``dev``, warmed up outside any count."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params
    from cuahn_vio_torch.utils.config import VioOptions

    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    seq = make_sequence(AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam),
                        device=dev, **SEQ)
    opts.calib_camimu_dt = 0.0
    opts.init_height = float(seq.gt_pose_w[0, 2])
    opts.init_imu_thresh = 0.2
    model = build_uahn(load_params(WEIGHTS), device=dev,
                       dropout_rate=opts.mc_dropout, blocks_to_run=opts.blocks_to_run)
    # warm-up: first cuDNN/cuBLAS calls and the masks' first draw
    warm = torch.as_tensor(seq.frames[:1], device=dev)
    model(warm, warm, torch.zeros((1, 4, 2), device=dev), use_prior=True,
          dropout_keys=np.zeros((1, 2), np.uint32))
    return seq, opts, model


def textured_sequences(dev):
    """The batched phase's three photo-texture sequences (TEX_SEQS) from
    the port's make_sequence on ``dev``."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.data.textures import (
        _procedural_extras,
        default_tex_params,
        quantize_u8,
    )
    from cuahn_vio_torch.utils.config import VioOptions

    extras = _procedural_extras(TEX_SIZE)
    t_imu_to_cam = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam)
    noise = {k: SEQ[k] for k in ("t_still", "sigma_w", "sigma_a", "bias_g", "bias_a")}
    return [
        make_sequence(AnalyticTrajectory(), t_imu_to_cam, duration=spec["duration"],
                      seed=spec["seed"], texture=quantize_u8(extras[spec["texture"]]),
                      tex_params=default_tex_params(TEX_SCALE_M), device=dev, **noise)
        for spec in TEX_SEQS
    ]


def run_slice(torch, dev):
    """Phase 4: the single-stream main path. Returns (launches, steps,
    iekf, ms/frame, ATE pos m, ATE ori deg, (seq, opts, model, result))."""
    import numpy as np

    from cuahn_vio_torch.eval.align import ate_rmse
    from cuahn_vio_torch.ops.cuda import (
        launch_counts,
        reset_launch_counts,
        threefry_launches_by_mode,
    )
    from cuahn_vio_torch.pipeline.runner import run_offline

    seq, opts, model = slice_setup(torch, dev)
    cfg = opts.vio_config()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames,
                      model, opts.filter_params(dev), cfg, opts.runner_options(),
                      seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts, threefry_by_mode={
        k: v for k, v in threefry_launches_by_mode.items() if v})
    steps = len(res.times)
    if not np.isfinite(res.pose_w).all():
        raise AssertionError("non-finite pose in the slice")
    ori, pos = ate_rmse(res.times, res.pose_w, seq.gt_times, seq.gt_pose_w)
    return (launches, steps, cfg.max_iekf_iterations, seconds * 1e3 / steps, pos, ori,
            (seq, opts, model, res))


def make_textured(torch, dev):
    """Phase 5: the three photo-texture sequences on the card. Returns
    (sequences, sampler launches, frames rendered)."""
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    seqs = textured_sequences(dev)
    torch.cuda.synchronize()
    return seqs, dict(launch_counts), sum(len(s.cam_t) for s in seqs)


def make_blurred(torch, dev):
    """Phase 5, blurred: one short photo-texture sequence (BLUR_SEQ) made
    with ``exposure_s = EXPOSURE_S`` on the card; then each of its frames
    against the uint8 of the mean of its three taps rendered one by one
    (``render_frame`` at the same poses) on the card. Returns (frames,
    sampler launches in make_sequence, frames that differ from that mean,
    frames that differ from the sharp render at the last tap)."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import (
        AnalyticTrajectory,
        exposure_taps,
        make_sequence,
        render_frame,
    )
    from cuahn_vio_torch.data.textures import (
        _procedural_extras,
        default_tex_params,
        quantize_u8,
        texture_u8,
    )
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.utils.config import VioOptions

    texture = quantize_u8(_procedural_extras(TEX_SIZE)[BLUR_SEQ["texture"]])
    traj, t_still = AnalyticTrajectory(), SEQ["t_still"]
    reset_launch_counts()
    torch.cuda.synchronize()
    seq = make_sequence(traj, np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam),
                        duration=BLUR_SEQ["duration"], seed=BLUR_SEQ["seed"], t_still=t_still,
                        texture=texture, tex_params=default_tex_params(TEX_SCALE_M),
                        exposure_s=EXPOSURE_S, device=dev)
    torch.cuda.synchronize()
    launches = launch_counts["bilinear_sample"]
    tex = torch.as_tensor(texture_u8(texture), device=dev)
    params = default_tex_params(TEX_SCALE_M).to(dev)
    p, q = exposure_taps(traj, seq.cam_t - t_still, EXPOSURE_S, dev)
    unequal = unblurred = 0
    for i, frame in enumerate(seq.frames):
        taps = [render_frame(p[i, k], q[i, k], *camera(torch, dev), texture=tex,
                             tex_params=params) for k in range(p.shape[1])]
        mean = torch.stack(taps).sum(dim=0) / len(taps)
        want = (mean * 255.0).clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
        sharp = (taps[-1] * 255.0).clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
        unequal += not np.array_equal(frame, want)
        unblurred += np.array_equal(frame, sharp)
    return len(seq.frames), launches, unequal, unblurred


def run_batched(torch, dev, seqs, opts, model):
    """Phase 6: run_offline_batch over ``seqs`` in lockstep with the "full"
    batched sampler. Returns (results, launches, seconds)."""
    import numpy as np

    from cuahn_vio_torch.ops import warp
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.pipeline.runner import run_offline_batch

    warp.BATCH_SAMPLER = "full"
    sequences = [(s.imu_t, s.imu_w, s.imu_a, s.cam_t, s.frames) for s in seqs]
    fparams = opts.filter_params(dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_offline_batch(sequences, model, fparams, opts.vio_config(),
                                opts.runner_options(), seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    for res in results:
        if not np.isfinite(res.pose_w).all():
            raise AssertionError("non-finite pose in the batched run")
    return results, launches, seconds


def run_rowskip(torch, dev, seqs, opts, model, frames: int):
    """Phase 7: the first ``frames`` lockstep frames of the batched run with
    the row-band sampler and the masks of run_offline_batch at seed 0.
    Returns (results, launches)."""
    from cuahn_vio_torch.ops import warp
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.parallel.sharded_eval import batched_run_sequences
    from cuahn_vio_torch.pipeline.runner import batch_frame_keys, batch_results, prepare_batch
    from cuahn_vio_torch.pipeline.vio import sequence_mask_keys
    from cuahn_vio_torch.utils import prng

    sequences = [(s.imu_t, s.imu_w, s.imu_a, s.cam_t, s.frames) for s in seqs]
    fparams = opts.filter_params(dev)
    batch = prepare_batch(sequences, opts.runner_options(), fparams, dev)
    cut = batch._replace(
        imgs_u8=batch.imgs_u8[:, :frames + 1], w_win=batch.w_win[:, :frames],
        a_win=batch.a_win[:, :frames], dt_win=batch.dt_win[:, :frames],
        n_used=batch.n_used[:, :frames],
        n_frames=[min(nf, frames) for nf in batch.n_frames],
        times=[t[:frames] for t in batch.times],
    )
    # run_offline_batch's keys at seed 0, its first ``frames`` frame pairs
    frame_keys = batch_frame_keys(0, len(seqs), frames)
    mask_keys = prng.keys_tensor(
        sequence_mask_keys(frame_keys, opts.vio_config().max_iekf_iterations), dev)
    warp.BATCH_SAMPLER = "rowskip"
    try:
        reset_launch_counts()
        _, outs = batched_run_sequences(
            cut.states0, model, fparams, opts.vio_config(), cut.imgs_u8, cut.w_win,
            cut.a_win, cut.dt_win, cut.n_used, mask_keys,
        )
        torch.cuda.synchronize()
        launches = dict(launch_counts)
    finally:
        warp.BATCH_SAMPLER = "full"
    return batch_results(outs, cut), launches


def cut_sequence(seq, res, pairs: int):
    """``seq`` (a SyntheticSequence) with its last frames dropped so that a
    run of it, whose frames used end at the last one (``res``, a run of
    the whole), keeps its first ``pairs`` frame pairs; the IMU stays
    whole."""
    keep = len(seq.cam_t) - (len(res.times) - pairs)
    return seq._replace(cam_t=seq.cam_t[:keep], frames=seq.frames[:keep])


def run_stepwise_phase(torch, dev, seq, opts, model, staged: bool):
    """Phase 8: phase 4's sequence (cut to STEPWISE_FRAMES frame pairs),
    model and seed through run_stepwise. Returns (result, launches,
    seconds)."""
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.pipeline.runner import run_stepwise

    fparams = opts.filter_params(dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_stepwise(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames, model,
                       fparams, opts.vio_config(), opts.runner_options(), seed=0,
                       device=dev, staged_timing=staged)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, dict(launch_counts), seconds


def run_bf16(torch, dev, seq, opts):
    """Phase 9: phase 4's sequence through run_offline with bfloat16 conv
    towers. Returns (result, launches, ms/frame)."""
    import numpy as np

    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.pipeline.runner import run_offline
    from cuahn_vio_torch.utils.checkpoint import load_params

    model = build_uahn(load_params(WEIGHTS), device=dev, dropout_rate=opts.mc_dropout,
                       blocks_to_run=opts.blocks_to_run, compute_dtype=torch.bfloat16)
    warm = torch.as_tensor(seq.frames[:1], device=dev)  # first bf16 cuDNN calls
    model(warm, warm, torch.zeros((1, 4, 2), device=dev), use_prior=True,
          dropout_keys=np.zeros((1, 2), np.uint32))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames, model,
                      opts.filter_params(dev), opts.vio_config(), opts.runner_options(),
                      seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, dict(launch_counts), seconds * 1e3 / len(res.times)


# runs ``python -m cuahn_vio_torch.cli ARGS`` (runpy, as -m does), then
# prints the kernels' launch counts of that process as its last line: {}
# when the verb did not load the kernels' module (the numpy-only verbs
# import no torch, and the runner imports nothing of the port before them)
CLI_RUNNER = (
    "import json, runpy, sys\n"
    "runpy.run_module('cuahn_vio_torch.cli', run_name='__main__', alter_sys=True)\n"
    "cuda = sys.modules.get('cuahn_vio_torch.ops.cuda')\n"
    "print('launch_counts ' + json.dumps(cuda.launch_counts if cuda else {}))\n"
)


CHILDREN = set()  # the subprocesses running now; ``main`` kills what is left


def run_child(argv, cwd: str) -> subprocess.CompletedProcess:
    """``argv`` in ``cwd`` with the port on its path, its output captured,
    killed after 600 s; as ``subprocess.run``, but killed too when the
    smoke stops before it ends."""
    proc = subprocess.Popen(argv, cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    CHILDREN.add(proc)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        CHILDREN.discard(proc)
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def started(fn, *args) -> concurrent.futures.Future:
    """``fn(*args)`` in a thread of its own from now on (a chain of
    subprocesses: each waits on its child, so the threads run side by
    side); ``.result()`` waits for it and raises what it raised."""
    fut = concurrent.futures.Future()

    def target():
        try:
            fut.set_result(fn(*args))
        except BaseException as exc:  # noqa: BLE001 - handed to .result()
            fut.set_exception(exc)

    threading.Thread(target=target, daemon=True).start()
    return fut


def side_by_side(*calls) -> list:
    """Each ``(fn, *args)`` of ``calls`` at once (``started``); their
    results in order, once all have ended. For verbs whose own times are no
    metric: those run alone."""
    futs = [started(*call) for call in calls]
    concurrent.futures.wait(futs)
    return [f.result() for f in futs]


def cli(args, cwd: str) -> tuple[str, dict]:
    """One verb of the port's CLI in a subprocess on the card. Returns (its
    output, its launch counts); raises when it exits non-zero."""
    proc = run_child([sys.executable, "-c", CLI_RUNNER, *args], cwd)
    if proc.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    out, _, last = proc.stdout.rstrip("\n").rpartition("\n")
    return out, json.loads(last.split(" ", 1)[1])


def run_cli(tmp: str) -> dict:
    """Phase 10: the verbs through ``python -m cuahn_vio_torch.cli`` in
    ``tmp``. Returns what the checks found."""
    import importlib.util

    import numpy as np

    from cuahn_vio_torch.eval.traj_io import load_pose_file, load_timing_file
    from cuahn_vio_torch.ops.cuda.warp import KERNEL, SAMPLE_KERNEL

    out = {"pyyaml_installed": importlib.util.find_spec("yaml") is not None}
    _, counts = cli(["make-synthetic", "--out", "seq.npz", "--duration", str(CLI_DURATION_S),
                     "--texture", "heldout", "--seed", "7", *CLI_NOISE], tmp)
    written = sorted(os.listdir(tmp))
    if written != ["seq.npz", "seq_config.yaml", "seq_gt.txt", "seq_state_gt.txt"]:
        raise AssertionError(f"make-synthetic wrote {written}")
    frames = len(np.load(os.path.join(tmp, "seq.npz"))["frames"])
    out.update(frames=frames, sampler_launches=counts[SAMPLE_KERNEL])
    if counts[SAMPLE_KERNEL] != frames:
        raise AssertionError(f"make-synthetic: {counts[SAMPLE_KERNEL]} sampler launches for "
                             f"{frames} frames")
    said, counts = cli([*CLI_RUN, "--out", "est.txt", "--timing-out", "t.csv", "--odom-out",
                        "odom.txt", "--state-out", "state.npz", "--cov-calib",
                        CLI_COV_CALIB], tmp)
    poses = load_pose_file(os.path.join(tmp, "est.txt"))
    times, stages = load_timing_file(os.path.join(tmp, "t.csv"))
    out.update(poses=len(poses.times), warp_launches=counts[KERNEL],
               threefry_launches=counts["threefry"],
               other_launches=counts[SAMPLE_KERNEL] + counts["homography_warp_rowskip"])
    # the pose file prints times to 5 decimals, the timing csv to 15
    if stages.shape != (len(poses.times), 5) or not np.allclose(times, poses.times, atol=1e-5):
        raise AssertionError(f"timing csv {stages.shape} for {len(poses.times)} poses")
    if not np.isfinite(poses.poses).all() or "divergence guard" in said:
        raise AssertionError("run-vio --timing-out: non-finite poses or a rollback")
    odom = np.loadtxt(os.path.join(tmp, "odom.txt"))
    if odom.shape != (len(poses.times), 10):
        raise AssertionError(f"odometry file {odom.shape}")
    (sr, _), (tp, _), (sim, _) = side_by_side(
        (cli, ["error-singlerun", "se3", "seq_gt.txt", "est.txt"], tmp),
        (cli, ["timing-percentages", "t.csv"], tmp),
        (cli, ["error-simulation", "state.npz", "seq_state_gt.txt"], tmp))
    out["ate_pos_m"] = float(sr.split("pos: rmse ")[1].split()[0])
    out["fps"] = float(tp.split("=> ")[1].split()[0])
    out["sim_pos_rmse_m"] = float(sim.split("pos_rmse")[1].split()[0])
    return out


def plain_run(tmp: str) -> dict:
    """Phase 10's second ``run-vio``, without the stepwise flags, in
    ``tmp`` (started with phase 12: its time is no metric): its
    covariance inflated by CLI_COV_CALIB's factors must be the first
    run's npz covariance. Returns what the check found; raises on a failed
    one."""
    import numpy as np

    from cuahn_vio_torch.eval.calibration import apply_cov_inflation

    cli([*CLI_RUN, "--out", "plain.txt", "--state-out", "plain.npz"], tmp)
    state, plain = (np.load(os.path.join(tmp, f)) for f in ("state.npz", "plain.npz"))
    factors = {k: float(v) for k, v in (kv.split(":") for kv in CLI_COV_CALIB.split(","))}
    want = apply_cov_inflation(plain["cov_core"], factors)
    out = dict(cov_rel_diff=float(np.abs(state["cov_core"] - want).max() / np.abs(want).max()),
               pos_diff_m=float(np.abs(state["pose"][:, :3] - plain["pose"][:, :3]).max()),
               cov_calib_factors=state["cov_calib_factors"].tolist())
    if not out["cov_rel_diff"] <= 1e-6:
        raise AssertionError(f"--cov-calib: npz covariance {out['cov_rel_diff']:.3e} from the "
                             "inflated plain run's")
    return out


def train_child(argv, deterministic: bool = False) -> None:
    """Phase 11's subprocess: ``python -m cuahn_vio_torch.cli`` ARGV, with
    the warp and flat-sampler wrappers spied on (the shape of each launch;
    the launch itself and its count are the wrapper's) and the host time
    at the end of each training step recorded, with a synchronize after
    the first and the last step only (the loop runs as ``train`` runs it
    in between); prints them as the last line. ``deterministic``: cuDNN's
    deterministic algorithms (``torch.backends.cudnn.deterministic``), so
    two such runs at one seed write the same weights bit for bit."""
    import torch

    torch.backends.cudnn.deterministic = deterministic

    from cuahn_vio_torch import cli
    from cuahn_vio_torch.ops.cuda import launch_counts, threefry_launches_by_mode
    from cuahn_vio_torch.ops.cuda import warp as cuda_warp
    from cuahn_vio_torch.train import trainer

    steps = int(argv[argv.index("--steps") + 1])
    seen = {"warps": [], "samples": [], "step_ends": []}
    warp, sample, make_step = (cuda_warp.homography_warp_cuda, cuda_warp.bilinear_sample_cuda,
                               trainer.make_train_step)

    def spy_warp(imgs, h_uv):
        seen["warps"].append([imgs.shape[0], str(imgs.dtype).split(".")[-1]])
        return warp(imgs, h_uv)

    def spy_sample(img, su, sv):
        seen["samples"].append([img.shape[0] if img.dim() == 3 else 1, su.shape[-1]])
        return sample(img, su, sv)

    def timed_step_maker(*args):
        step = make_step(*args)

        def timed(*a):
            out = step(*a)
            if len(seen["step_ends"]) in (0, steps - 1):
                torch.cuda.synchronize()
            seen["step_ends"].append(time.perf_counter())
            return out

        return timed

    cuda_warp.homography_warp_cuda, cuda_warp.bilinear_sample_cuda = spy_warp, spy_sample
    trainer.make_train_step = timed_step_maker
    cli.main(argv)
    print("train_child " + json.dumps(dict(seen, launch_counts=launch_counts,
                                           threefry_by_mode=threefry_launches_by_mode)),
          flush=True)


def train_once(torch, tmp: str, probe_size: int, batch_t1: int, launcher: tuple = (),
               deterministic: bool = False) -> dict:
    """One ``train-uahn`` run from v10 in a subprocess (``train_child``,
    ``deterministic`` as there) writing ``tmp``/w.msgpack, with its checks:
    finite logged losses, the launches of B4 and B2 at the trainer's shapes
    and of T1 (``batch_t1`` a batch's draws, and a network call's masks),
    the checkpoint and ``.best`` read back; ``launcher``: the arguments of a
    ``python3`` that starts the subprocess (``TORCHRUN``: as a one-rank
    job). Returns what it found; raises on a failed check."""
    import numpy as np

    from cuahn_vio_torch.utils.checkpoint import load_params

    out_path = os.path.join(tmp, "w.msgpack")
    args = ["train-uahn", "--resume", WEIGHTS, "--steps", str(TRAIN_STEPS), "--batch-size",
            str(TRAIN_BATCH), "--save-every", str(TRAIN_SAVE_EVERY), "--out", out_path]
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            f"chip_smoke.train_child(sys.argv[1:], {deterministic})")
    prefix = [sys.executable, *launcher] if launcher else []
    proc = run_child([*prefix, sys.executable, "-c", code, *args], tmp)
    if proc.returncode != 0:
        raise AssertionError(f"train-uahn exited {proc.returncode}: {proc.stderr[-3000:]}")
    said, _, last = proc.stdout.rstrip("\n").rpartition("\n")
    seen = json.loads(last.split(" ", 1)[1])
    for line in said.splitlines():
        print(f"  train-uahn: {line}", flush=True)
    logged = [line for line in said.splitlines() if line.startswith("step") and " loss " in line]
    losses = [float(line.split(" loss ")[1].split()[0]) for line in logged]
    if len(logged) < 2 or not all(np.isfinite(losses)) or not all(
            "skipped=" in line for line in logged):
        raise AssertionError(f"train-uahn logged {logged}")
    probe = [line for line in said.splitlines() if "PROBE" in line]
    n_points = 3 * H * W  # blur_taps x one frame's pixels
    want_samples = sorted([[TRAIN_BATCH, n_points]] * (2 * TRAIN_STEPS)
                          + [[probe_size, n_points]] * 2)
    want_warps = sorted([[TRAIN_BATCH, "float32"]] * (3 * TRAIN_STEPS)
                        + [[probe_size, "float32"]] * 6)
    counts = seen["launch_counts"]
    if sorted(seen["samples"]) != want_samples or counts["bilinear_sample"] != len(want_samples):
        raise AssertionError(f"train-uahn flat-sampler launches {seen['samples']} "
                             f"({counts['bilinear_sample']} counted)")
    if (sorted(seen["warps"]) != want_warps or counts["homography_warp"] != len(want_warps)
            or counts["homography_warp_rowskip"]):
        raise AssertionError(f"train-uahn warp launches {seen['warps']} ({counts} counted)")
    # a batch's draws and the MC-dropout masks a step; the probe's batch
    # once, its masks once a probe call (two modes)
    expect_t1("train-uahn", counts["threefry"], TRAIN_STEPS * (batch_t1 + 1) + batch_t1 + 2)
    v10 = load_params(WEIGHTS)
    written = {}
    for path in (out_path, out_path + ".best"):
        got = written[path] = load_params(path)
        if got.keys() != v10.keys() or any(got[k].shape != v10[k].shape for k in v10):
            raise AssertionError(f"{path}: not v10's tree")
        if not all(torch.isfinite(got[k]).all() for k in got):
            raise AssertionError(f"{path}: non-finite weights")
        if all(torch.equal(got[k], v10[k]) for k in v10):
            raise AssertionError(f"{path}: v10's weights unchanged")
    ends = np.asarray(seen["step_ends"])
    if len(ends) != TRAIN_STEPS or not probe:
        raise AssertionError(f"train-uahn: {len(ends)} steps timed, probe lines {probe}")
    # steps 1 .. TRAIN_STEPS - 1 as train() runs them, between two synchronizes
    ms_step = float((ends[-1] - ends[0]) / (TRAIN_STEPS - 1) * 1e3)
    return dict(logged_losses=losses, ms_per_step=ms_step,
                median_gap_ms=float(np.median(np.diff(ends)) * 1e3),
                samples_per_s=TRAIN_BATCH / ms_step * 1e3, warp_launches=len(seen["warps"]),
                threefry_launches=counts["threefry"],
                threefry_launches_by_mode={k: v for k, v in seen["threefry_by_mode"].items() if v},
                sampler_launches=len(seen["samples"]), probe=probe[-1].split(": ", 1)[1],
                data_parallel="data-parallel over 1 ranks (seq mesh)" in said.splitlines(),
                weights=written[out_path])


def compare_draws(found: dict, ref, prefix: str, exact: tuple) -> float:
    """The port's draws ``found`` {name: tensor or array} against the JAX
    draws ``ref[prefix_name]``: the names in ``exact`` equal, the others
    within DRAW_TOL. Returns the largest difference; raises on a failed
    check."""
    import numpy as np

    worst = 0.0
    for name, got in found.items():
        want = ref[f"{prefix}_{name}"]
        got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
        if got.shape != want.shape:
            raise AssertionError(f"{prefix} {name}: shape {got.shape}, JAX's {want.shape}")
        diff = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
        if (name in exact and diff != 0.0) or not diff <= DRAW_TOL:
            raise AssertionError(f"{prefix} {name}: {diff:.3e} from JAX's draws")
        worst = max(worst, diff)
    return worst


def noise_head(noise, n: int):
    """The first ``n`` values of each (H, W) image of a noise tensor."""
    return noise.reshape(*noise.shape[:-2], -1)[..., :n]


def check_pair_draws(torch, dev) -> dict:
    """Phase 11: the pair draws of ``train-uahn``'s first step (its
    defaults at batch TRAIN_BATCH, seed 0: the sample keys ``split(kb,
    TRAIN_BATCH)``) and of its probe (``split(PRNGKey(PROBE_SEED),
    PROBE_SIZE)`` on the held-out textures), drawn on the card
    (``draw_pairs`` and the frames' noise) against the JAX ``sample_pair``
    draws in TRAIN_DRAWS; counts their T1 launches by mode (a training
    step's batch). Returns what it found; raises on a failed check."""
    import numpy as np

    from cuahn_vio_torch import cli
    from cuahn_vio_torch.data.sensor_effects import draw_noise, noise_keys
    from cuahn_vio_torch.data.textures import heldout_indices, train_indices
    from cuahn_vio_torch.ops.cuda import reset_launch_counts, threefry_launches_by_mode
    from cuahn_vio_torch.train import trainer
    from cuahn_vio_torch.utils import prng

    cfg = cli.train_config(cli.build_parser().parse_args(
        ["train-uahn", "--batch-size", str(TRAIN_BATCH)]))
    _, kb, _ = prng.split(prng.prng_key(0), 3)
    out = {}
    with np.load(os.path.join(REPO, TRAIN_DRAWS)) as ref:
        for prefix, key, b, split in (
                ("step0", kb, TRAIN_BATCH, train_indices),
                ("probe", prng.prng_key(trainer.PROBE_SEED), trainer.PROBE_SIZE, heldout_indices)):
            keys = prng.split(key, b)
            idx = torch.as_tensor(split(CARD_TEXTURES), dtype=torch.long, device=dev)
            reset_launch_counts()
            draws = trainer.draw_pairs(cfg, keys, dev, idx)
            noise = draw_noise(noise_keys(trainer.sample_keys(keys)[:, 9]), (H, W), dev)
            by_mode = {k: v for k, v in threefry_launches_by_mode.items() if v}
            found = {k: getattr(draws, k) for k in (
                "p1", "q1", "p2", "q2", "dp", "rv_d", "tex_idx", "tex_params", "exposure_frac",
                "prior_sigma", "prior_noise")}
            found.update(params1=draws.effects.params1, params2=draws.effects.params2,
                         sigma=draws.effects.sigma,
                         noise=noise_head(noise, DRAW_NOISE_VALUES).transpose(0, 1))
            out[prefix] = dict(max_abs_diff_from_jax=compare_draws(
                found, ref, prefix, ("p1", "tex_idx", "exposure_frac", "sigma")),
                launches_by_mode=by_mode)
    out["batch_launches"] = sum(out["step0"]["launches_by_mode"].values())
    return out


def check_window_draws(torch, dev, cfg) -> dict:
    """Phase 14: the window draws of ``fil_finetune``'s first step (a FIL
    step at seed 0: the window keys ``split(ks, FIL_BATCH)``, ks =
    ``split(PRNGKey(0), 3)[2]``) drawn on the card (``draw_windows``)
    against the JAX ``window_loss`` draws in TRAIN_DRAWS, and the T1
    launches by mode of a FIL step's draws and of a pair step's batch
    (``draw_pairs`` and the noise at FIL_PAIR_BATCH). Returns what it found;
    raises on a failed check."""
    import numpy as np

    from cuahn_vio_torch.data.sensor_effects import draw_noise, noise_keys
    from cuahn_vio_torch.data.textures import train_indices
    from cuahn_vio_torch.ops.cuda import reset_launch_counts, threefry_launches_by_mode
    from cuahn_vio_torch.train import fil, trainer
    from cuahn_vio_torch.utils import prng

    _, kb, ks = prng.split(prng.prng_key(0), 3)
    idx = torch.as_tensor(train_indices(CARD_TEXTURES), dtype=torch.long, device=dev)
    reset_launch_counts()
    draws = fil.draw_windows(cfg, prng.split(ks, cfg.batch_size), idx, dev)
    out = dict(fil_launches_by_mode={k: v for k, v in threefry_launches_by_mode.items() if v})
    found = draws._asdict()
    found["frame_noise"] = noise_head(found["frame_noise"], DRAW_NOISE_VALUES)
    with np.load(os.path.join(REPO, TRAIN_DRAWS)) as ref:
        out["max_abs_diff_from_jax"] = compare_draws(found, ref, "fil", ("tex_idx",))
    keys = prng.split(kb, FIL_PAIR_BATCH)
    reset_launch_counts()
    trainer.draw_pairs(trainer.TrainConfig(batch_size=FIL_PAIR_BATCH), keys, dev, idx)
    draw_noise(noise_keys(trainer.sample_keys(keys)[:, 9]), (H, W), dev)
    out["pair_launches_by_mode"] = {k: v for k, v in threefry_launches_by_mode.items() if v}
    return out


def run_train(torch, dev, seq, opts) -> dict:
    """Phase 11: the first step's and the probe's pair draws on the card
    against JAX's (``check_pair_draws``), TRAIN_RUNS ``train-uahn`` runs
    from v10 at one seed (``train_once``), how far apart their written
    weights are, and ``run_offline`` with the first run's weights on phase
    4's sequence. Returns what the checks found; raises on a failed one."""
    import numpy as np

    from cuahn_vio_torch.eval.align import ate_rmse
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.pipeline.runner import run_offline
    from cuahn_vio_torch.train.trainer import PROBE_SIZE

    from cuahn_vio_torch.data.textures import get_texture_bank

    if len(get_texture_bank()) != CARD_TEXTURES:  # the draws' references were made on it
        raise AssertionError(f"the texture bank holds {len(get_texture_bank())} textures, the "
                             f"references' {CARD_TEXTURES}")
    draws = check_pair_draws(torch, dev)
    runs = []
    for i in range(TRAIN_RUNS):  # the first with cuDNN's deterministic algorithms (17a's reference)
        with tempfile.TemporaryDirectory() as tmp:
            runs.append(train_once(torch, tmp, PROBE_SIZE, draws["batch_launches"],
                                   deterministic=i == 0))
    first = runs[0]["weights"]
    weights_diff = max(float((r["weights"][k] - first[k]).abs().max())
                       for r in runs[1:] for k in first)
    model = build_uahn(first, device=dev, dropout_rate=opts.mc_dropout,
                       blocks_to_run=opts.blocks_to_run)
    res = run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames, model,
                      opts.filter_params(dev), opts.vio_config(), opts.runner_options(),
                      seed=0, device=dev)
    if not np.isfinite(res.pose_w).all():
        raise AssertionError("run_offline with the trained weights: non-finite poses")
    _, ate = ate_rmse(res.times, res.pose_w, seq.gt_times, seq.gt_pose_w)
    for r in runs:
        del r["weights"]
    return dict(runs=runs, weights_max_abs_diff=weights_diff, trained_ate_pos_m=ate,
                probe_size=PROBE_SIZE, first_weights=first, draws=draws)


def run_dp_train(torch, probe_size: int, batch_t1: int, phase11: dict) -> dict:
    """Phase 17a: phase 11's run as a one-rank NCCL job (``TORCHRUN``),
    against phase 11's first run's weights (``phase11``). Returns what the
    checks found; raises on a failed one."""
    with tempfile.TemporaryDirectory() as tmp:
        run = train_once(torch, tmp, probe_size, batch_t1, TORCHRUN, deterministic=True)
    weights = run.pop("weights")
    run["weights_max_abs_diff_from_phase11"] = max(
        float((weights[k] - phase11[k]).abs().max()) for k in phase11)
    if not run["data_parallel"]:
        raise AssertionError("train-uahn under torch.distributed.run: no data-parallel line")
    if not run["weights_max_abs_diff_from_phase11"] <= DP_WEIGHTS_TOL:
        raise AssertionError(f"data-parallel weights {run['weights_max_abs_diff_from_phase11']:.3e}"
                             f" from phase 11's, above {DP_WEIGHTS_TOL:.0e}")
    return run


def run_plots(cli_dir: str, loop_dir: str, out_dir: str) -> dict:
    """Phase 17b: the five plot surfaces side by side in ``out_dir`` on
    phase 10's files (``cli_dir``) and phase 13's (``loop_dir``), each PNG
    held to its figure (size, series colours). Returns what the checks
    found; raises on a failed one."""
    import numpy as np

    from cuahn_vio_torch.eval import plots
    from cuahn_vio_torch.eval.simulation import ResultSimulation, load_state_gt
    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.utils.png import read_png

    c = lambda name: os.path.join(cli_dir, name)  # noqa: E731
    poses = [os.path.join(loop_dir, n) for n in ("est.txt", "smoothed.txt", "replay_gt.txt")]
    d = np.load(c("state.npz"))
    sim = ResultSimulation(d["times"], d["pose"], load_state_gt(c("seq_state_gt.txt")),
                           est_v_body=d.get("v_body"), est_ba=d.get("ba"), est_bg=d.get("bg"),
                           est_cov_diag=d.get("cov_diag"), est_cov_core=d.get("cov_core"))
    surfaces = {  # name: (argv, the PNG, its figure)
        "plot-trajectories": (["plot-trajectories", *poses, "--out", "traj.png"], "traj.png",
                              plots.trajectories(poses)),
        "plot-trackhist": (["plot-trackhist", c("seq.npz"), c("state.npz"), "--out",
                            "trackhist.png"], "trackhist.png",
                           plots.trackhist(np.load(c("seq.npz"))["frames"], d)),
        "timing-flamegraph": (["timing-flamegraph", c("t.csv"), "--out", "flame.png"],
                              "flame.png", plots.flamegraph(c("t.csv"))),
        "error-simulation --plot": (["error-simulation", c("state.npz"), c("seq_state_gt.txt"),
                                     "--plot", "sim.png"], "sim.png",
                                    plots.simulation_errors(sim)),
        "watch-run": (["watch-run", c("est.txt"), "--gt", c("seq_gt.txt"), "--max-ticks",
                       str(WATCH_TICKS), "--interval", str(WATCH_INTERVAL_S), "--out",
                       "watch.png"], "watch.png",
                      plots.watch(load_pose_file(c("est.txt")), load_pose_file(c("seq_gt.txt")))),
    }
    out = {"verb_s": {}}
    done = side_by_side(*[(timed_verb, out, name, cli, argv, out_dir)
                          for name, (argv, _, _) in surfaces.items()])
    n_est = len(load_pose_file(c("est.txt")).times)
    for (name, (_, png, fig)), (said, counts) in zip(surfaces.items(), done):
        want = ([f"[watch-run] {n_est} poses -> {png}"] if name == "watch-run"
                else [f"wrote {png}"])
        if said.splitlines()[-len(want):] != want or any(counts.values()):
            raise AssertionError(f"{name}: printed {said[-300:]!r}, launches {counts}")
        if name == "watch-run" and said.splitlines() != want:
            raise AssertionError(f"watch-run printed {said!r}, not the JAX verb's {want}")
        rgb = read_png(os.path.join(out_dir, png), rgb=True)
        with open(os.path.join(out_dir, png), "rb") as f:
            colour_type = f.read(26)[25]
        if colour_type != 2 or rgb.shape != (fig.pixels[1], fig.pixels[0], 3):
            raise AssertionError(f"{name}: colour type {colour_type}, {rgb.shape} for a "
                                 f"{fig.pixels} figure")
        have = {tuple(p) for p in np.unique(rgb.reshape(-1, 3), axis=0)}
        missing = [what for what, colour in plots.series_colours(fig) if colour not in have]
        if missing:
            raise AssertionError(f"{name}: no pixel of the colour of {missing}")
        out[name] = f"{rgb.shape[1]}x{rgb.shape[0]}, {len(plots.series_colours(fig))} series"
    return out


def build_kernels() -> dict:
    """Phase 1: build every kernel source at once (one nvcc each, in
    threads: each waits on its own subprocess). Returns {source: nvcc
    seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    from cuahn_vio_torch.ops.cuda import build
    from cuahn_vio_torch.ops.cuda import conv as conv_cuda
    from cuahn_vio_torch.ops.cuda import heads as heads_cuda
    from cuahn_vio_torch.ops.cuda import prng as prng_cuda
    from cuahn_vio_torch.ops.cuda import remap as remap_cuda
    from cuahn_vio_torch.ops.cuda import warp as warp_cuda

    jobs = [(m.SOURCE, m.build_kernel) for m in (warp_cuda, remap_cuda, prng_cuda, heads_cuda)]
    # the two sources of ``conv.build_kernel`` and phase 3's whole-K copy,
    # each in its own thread
    jobs += [(source, lambda source=source: build.build(source)[1])
             for source in (*conv_cuda.SOURCES, whole_k_source())]
    with ThreadPoolExecutor(len(jobs)) as pool:
        seconds = list(pool.map(lambda job: job[1](), jobs))
    return {os.path.relpath(source, REPO): s for (source, _), s in zip(jobs, seconds)}


def remap_maps(torch, dev) -> dict:
    """The remap's parity maps (224x320, raw 640x480): the default config's
    Kannala-Brandt camera, a radtan (EuRoC MH cam0) camera, and a map of
    off-image, edge, exactly integer and NaN coordinates."""
    from cuahn_vio_torch.runtime.undistort import build_undist_map
    from cuahn_vio_torch.utils.config import VioOptions

    opts = VioOptions.uzhfpv_indoor45()
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    mx, my = u * 2.0 - 1.0, v * 2.25 - 20.0  # integer columns, quarter rows, off the top
    mx[0, :8] = torch.tensor([-1.0, -0.5, -1e-6, 639.0, 639.5, 640.0, 1e9, float("nan")])
    my[1, :6] = torch.tensor([479.0, 479.25, 480.0, -1.0, -0.0, 1e30])
    return {
        "fisheye": build_undist_map(opts.cam_intrinsics, opts.cam_distortion, True, device=dev),
        "radtan": build_undist_map([458.654, 457.296, 367.215, 248.375],
                                   [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                                   False, device=dev),
        "edges": (mx.contiguous(), my.contiguous()),
    }


def remap_layout_checked(remap_cuda) -> dict:
    """C1's constants from the built library, which must be those that
    ``ops/remap.tile_boxes`` assumes (TILE, STAGE_BYTES, CHUNK)."""
    from cuahn_vio_torch.ops import remap

    got = remap_cuda.layout()
    want = dict(tile_rows=remap.TILE[0], tile_cols=remap.TILE[1],
                stage_bytes=remap.STAGE_BYTES, chunk=remap.CHUNK)
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"remap.cu's layout {got} is not ops/remap.py's {want}")
    return got


def check_remap(torch, dev) -> tuple[int, dict]:
    """Phase 2, C1: the remap kernel against ``remap_u8_plain`` on the card,
    bit for bit, on ``remap_maps`` at REMAP_PARITY_FRAMES raw 640x480
    frames; each launch's tiles by path as the kernel counts them, held to
    ``tile_boxes``, with every fisheye and radtan tile on the shared ring
    and an edge-map tile on global taps. Returns (max abs error (0),
    {map: {"shared": tiles, "global": tiles}})."""
    import numpy as np

    from cuahn_vio_torch.ops.cuda.remap import remap_u8_cuda
    from cuahn_vio_torch.ops.remap import remap_u8_plain, tile_boxes

    rng = np.random.default_rng(8)
    frames = {n: torch.as_tensor(rng.integers(0, 256, (n, 480, 640)).astype(np.uint8),
                                 device=dev) for n in REMAP_PARITY_FRAMES}
    worst, paths = 0, {}
    for name, (mx, my) in remap_maps(torch, dev).items():
        shared = tile_boxes(mx, my, 480, 640)["shared"]
        want = [int(shared.sum()), int((~shared).sum())]
        paths[name] = dict(zip(("shared", "global"), want))
        for n, raw in frames.items():
            counted = torch.zeros(2, dtype=torch.int32, device=dev)
            out = remap_u8_cuda(raw, mx, my, counted)
            ref = remap_u8_plain(raw, mx, my)
            torch.cuda.synchronize()
            err = int((out.int() - ref.int()).abs().max())
            print(f"  remap parity {name} N={n} 640x480 -> {H}x{W}: max abs err {err} levels; "
                  f"tiles on the shared ring {counted[0]}, on global taps {counted[1]}",
                  flush=True)
            if err != 0:
                raise AssertionError(f"remap kernel vs plain {err}: not bit-identical")
            if counted.tolist() != want:
                raise AssertionError(f"remap {name}: the kernel's tiles by path {counted.tolist()}"
                                     f", tile_boxes's {want}")
            worst = max(worst, err)
    if paths["fisheye"]["global"] or paths["radtan"]["global"] or not paths["edges"]["global"]:
        raise AssertionError(f"remap tiles by path {paths}: the camera maps must stream every "
                             "tile through shared memory, the edge map must take global taps")
    return worst, paths


def remap_bound_ms(torch, n: int, mx, my, src_h: int, src_w: int) -> tuple[float, int]:
    """(least ms, raw bytes read a frame) of one remap of n frames: the
    output bytes written, each raw pixel that an in-image tap of the map
    reads, once a frame, and the map, against the float32 work."""
    x0, y0 = torch.floor(mx).long(), torch.floor(my).long()
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < src_w) & (yi >= 0) & (yi < src_h) & ~torch.isnan(mx)
            taps.append((yi * src_w + xi)[inside])
    footprint = int(torch.unique(torch.cat(taps)).numel())
    bytes_moved = n * (mx.numel() + footprint) + 2 * mx.numel() * 4
    flops = n * mx.numel() * REMAP_FLOPS_PER_PIXEL + mx.numel() * REMAP_FLOPS_PER_MAP_ENTRY
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3, footprint


def time_cold_ms(torch, fn, flush, per_graph: int = 10, replays: int = 5) -> float:
    """Device time of one ``fn`` call with a cold L2: ``flush`` (a read of
    more than the L2 holds) then ``fn``, ``per_graph`` times in one CUDA
    graph, less the same graph of ``flush`` alone."""
    def both():
        flush()
        fn()

    return (time_graph_ms(torch, both, per_graph, replays)
            - time_graph_ms(torch, flush, per_graph, replays))


def time_remap(torch, dev) -> dict:
    """Phase 3, C1: the remap kernel, its plain version and ``grid_sample``
    (float32 frames, the same coordinates as a normalized grid; the
    yardstick, which the port never calls) on the fisheye map at N = 1 and
    REMAP_FRAMES, beside the byte bound and the launch floor, and the
    kernel with a cold L2 (``time_cold_ms``). The bound ratio uses the
    CUDA-graph (hot) time, as the earlier rows of this kernel did. Returns {N:
    {ms, cold_ms, plain_ms, library_ms, floor_ms, bound_ms, footprint}}."""
    import numpy as np
    import torch.nn.functional as F

    from cuahn_vio_torch.ops.cuda.remap import remap_u8_cuda
    from cuahn_vio_torch.ops.remap import remap_u8_plain

    mx, my = remap_maps(torch, dev)["fisheye"]
    grid = torch.stack([2 * mx / 639.0 - 1, 2 * my / 479.0 - 1], dim=-1)
    rng = np.random.default_rng(9)
    one = torch.zeros(1, device=dev)
    spill = torch.ones(L2_FLUSH_BYTES // 4, device=dev)
    spill_sum = torch.zeros((), device=dev)
    rows = {}
    for n in (1, REMAP_FRAMES):
        frames = torch.as_tensor(rng.integers(0, 256, (n, 480, 640)).astype(np.uint8),
                                 device=dev)
        frames_f = frames.float()[:, None]
        grid_n = grid[None].expand(n, H, W, 2)
        bound, footprint = remap_bound_ms(torch, n, mx, my, 480, 640)

        def library():
            return F.grid_sample(frames_f, grid_n, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        lib_err = (library()[:, 0] - remap_u8_plain(frames, mx, my).float()).abs().max().item()
        row, eager = timed(torch, dict(
            ms=lambda: remap_u8_cuda(frames, mx, my),
            plain_ms=lambda: remap_u8_plain(frames, mx, my),
            library_ms=library,
            floor_ms=lambda: one.add_(1.0),
        ), bound, 200 if n == 1 else 20)
        row["footprint"] = footprint
        row["cold_ms"] = time_cold_ms(torch, lambda: remap_u8_cuda(frames, mx, my),
                                      lambda: torch.sum(spill, dim=0, out=spill_sum))
        rows[n] = row
        print(f"  remap N={n} 640x480 -> {H}x{W} device time (CUDA graph): kernel "
              f"{row['ms']:.5f} ms (cold L2 {row['cold_ms']:.5f}) | plain {row['plain_ms']:.5f} ms"
              f" | grid_sample "
              f"{row['library_ms']:.5f} ms (float, |diff| {lib_err:.2f}) | kernel / "
              f"grid_sample {row['ms'] / row['library_ms']:.3f} | byte bound "
              f"{row['bound_ms']:.5f} ms ({footprint} raw bytes read a frame) | kernel / bound "
              f"{row['ms'] / row['bound_ms']:.2f} | launch floor {row['floor_ms']:.5f} ms",
              flush=True)
        print(f"  remap N={n} eager call to call: kernel {eager['ms']:.5f} ms | plain "
              f"{eager['plain_ms']:.5f} ms | grid_sample {eager['library_ms']:.5f} ms", flush=True)
    return rows


def encode_png_like_pil(img) -> bytes:
    """An 8-bit greyscale PNG of (H, W) uint8 ``img`` with the row filters
    that PIL's encoder picks (``libImaging/ZipEncode.c``): per row, of
    None, Up, Sub and Paeth in that order, the first with the least sum of
    absolute signed filtered bytes (Average only under ``optimize``). Real
    camera files carry such rows; the port's writer uses None only."""
    import struct
    import zlib

    import numpy as np

    from cuahn_vio_torch.utils.png import SIGNATURE, ZLIB_LEVEL, _chunk

    x = np.asarray(img).astype(np.int16)
    hgt, wid = x.shape
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filtered = np.stack([x, x - b, x - a, x - paeth]).astype(np.uint8)
    pick = np.abs(filtered.view(np.int8).astype(np.int32)).sum(axis=2).argmin(axis=0)
    raw = np.empty((hgt, wid + 1), np.uint8)
    raw[:, 0] = np.array([0, 2, 1, 4], np.uint8)[pick]
    raw[:, 1:] = filtered[pick, np.arange(hgt)]
    header = struct.pack(">IIBBBBB", wid, hgt, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), ZLIB_LEVEL)) + _chunk(b"IEND", b""))


def png_ms_per_frame(euroc_dir: str) -> dict:
    """Per frame of the port's PNG codec on the raw frames that
    ``distort-to-euroc`` wrote (host clock): decode and encode ms, then the
    decode ms of the same frames written with PIL's row filters (the
    reader's Average/Paeth path), whose pixels must come back equal, and
    how many rows of those files took each filter."""
    import numpy as np

    from cuahn_vio_torch.utils.png import _parse, encode_png, read_pngs

    data = os.path.join(euroc_dir, "mav0", "cam0", "data")
    paths = sorted(os.path.join(data, name) for name in os.listdir(data))
    t0 = time.perf_counter()
    frames = read_pngs(paths)
    t1 = time.perf_counter()
    for frame in frames:
        encode_png(frame)
    t2 = time.perf_counter()
    filtered_dir = os.path.join(euroc_dir, "pil_filtered")
    os.makedirs(filtered_dir)
    filtered_paths = [os.path.join(filtered_dir, os.path.basename(p)) for p in paths]
    rows = np.zeros(5, np.int64)
    for path, frame in zip(filtered_paths, frames):
        blob = encode_png_like_pil(frame)
        rows += np.bincount(_parse(blob, path)[3][:, 0], minlength=5)
        with open(path, "wb") as f:
            f.write(blob)
    t3 = time.perf_counter()
    back = read_pngs(filtered_paths)
    t4 = time.perf_counter()
    if not all(np.array_equal(x, y) for x, y in zip(back, frames)):
        raise AssertionError("the PNG reader gave other pixels back from PIL-filtered files")
    n = len(paths)
    return {"frames": n, "png_decode_ms_per_frame": (t1 - t0) * 1e3 / n,
            "png_encode_ms_per_frame": (t2 - t1) * 1e3 / n,
            "png_pil_filtered_decode_ms_per_frame": (t4 - t3) * 1e3 / n,
            "png_pil_filtered_rows_by_filter": rows.tolist()}


def run_raw_chain(torch, dev, tmp: str, model, iekf: int) -> dict:
    """Phase 12: the raw-camera chain through the CLI in phase 10's
    directory ``tmp``, and ``run_offline`` on the rendered frames (the
    virtual camera, no round trip) with ``model`` for comparison. Returns
    what the checks found; raises on a failed one."""
    import numpy as np

    from cuahn_vio_torch.eval.align import ate_rmse
    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.ops.cuda.remap import KERNEL as REMAP_KERNEL
    from cuahn_vio_torch.ops.cuda.warp import KERNEL, SAMPLE_KERNEL
    from cuahn_vio_torch.pipeline.runner import run_offline
    from cuahn_vio_torch.utils.config import VioOptions

    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    out = {"verb_s": {}}

    def verb(args):  # ``cli`` in ``tmp``, each verb's seconds (its process start included)
        t0 = time.perf_counter()
        said = cli(args, tmp)
        key = args[0] if args[0] not in out["verb_s"] else f"{args[0]} 2"
        out["verb_s"][key] = round(time.perf_counter() - t0, 3)
        return said

    noise = ["--sigma-w", "0.002", "--sigma-a", "0.02", "--bias-g", "0.003", "--bias-a", "0.02"]
    _, counts = verb(["make-synthetic", "--traj-file", "seq_gt.txt", "--spline-dt", "0.1",
                     "--out", "raw_seq.npz", "--duration", str(RAW_DURATION_S), "--texture",
                     "heldout", "--exposure-ms", "8", "--effects", "--seed", "7", *noise])
    seq = np.load(path("raw_seq.npz"))
    frames = len(seq["frames"])
    out.update(frames=frames, sampler_launches=counts[SAMPLE_KERNEL],
               threefry_launches_effects=counts["threefry"])
    if counts[SAMPLE_KERNEL] != frames:
        raise AssertionError(f"make-synthetic --traj-file: {counts[SAMPLE_KERNEL]} sampler "
                             f"launches for {frames} frames")
    expect_t1("make-synthetic --effects (each frame's noise)", counts["threefry"], frames)
    verb(["distort-to-euroc", "raw_seq.npz", "--config", "raw_seq_config.yaml", "--out",
         "euroc"])
    codec = png_ms_per_frame(path("euroc"))
    raw_frames = codec.pop("frames")
    out.update(codec)
    if raw_frames != frames:
        raise AssertionError(f"distort-to-euroc wrote {raw_frames} PNGs for {frames} frames")
    _, counts = verb(["convert-euroc", "euroc", "--config", "raw_seq_config.yaml", "--out",
                     "conv.npz"])
    conv = np.load(path("conv.npz"))
    out["remap_launches"] = counts[REMAP_KERNEL]
    if counts[REMAP_KERNEL] != 1 or conv["frames"].shape != seq["frames"].shape:
        raise AssertionError(f"convert-euroc: {counts[REMAP_KERNEL]} remap launches, frames "
                             f"{conv['frames'].shape}")
    a = conv["frames"][(slice(None), *RAW_INTERIOR)].astype(np.float64)
    b = seq["frames"][(slice(None), *RAW_INTERIOR)].astype(np.float64)
    out["interior_rmse"] = float(np.sqrt(np.mean((a - b) ** 2)))
    if not out["interior_rmse"] <= RAW_RMSE_BAR:
        raise AssertionError(f"converted frames {out['interior_rmse']:.3f} levels RMSE from the "
                             f"rendered ones (bar {RAW_RMSE_BAR})")
    _, counts = verb(["run-vio", "conv.npz", "--config", "raw_seq_config.yaml", "--weights",
                     WEIGHTS, "--out", "est_raw.txt", "--state-out", "state_raw.npz"])
    poses = load_pose_file(path("est_raw.txt"))
    out.update(poses=len(poses.times), warp_launches=counts[KERNEL],
               threefry_launches_run_vio=counts["threefry"])
    expect_t1("run-vio on the converted frames", counts["threefry"], len(poses.times) * iekf)
    if counts[KERNEL] != 3 * len(poses.times) * iekf or not np.isfinite(poses.poses).all():
        raise AssertionError(f"run-vio on the converted frames: {counts[KERNEL]} warp launches "
                             f"for {len(poses.times)} poses, or non-finite poses")
    said, _ = verb(["error-singlerun", "se3", "raw_seq_gt.txt", "est_raw.txt"])
    out["ate_pos_m"] = float(said.split("pos: rmse ")[1].split()[0])
    verb(["format-converter", "seq_gt.txt", "gt.csv"])
    verb(["format-converter", "gt.csv", "gt_back.txt"])
    with open(path("seq_gt.txt")) as f1, open(path("gt_back.txt")) as f2:
        out["gt_txt_round_trip_equal"] = f1.read() == f2.read()
    if not out["gt_txt_round_trip_equal"]:
        raise AssertionError("format-converter txt -> csv -> txt changed the GT file")
    # the same sequence's rendered frames, without the round trip
    opts = VioOptions.from_yaml(path("raw_seq_config.yaml"))
    t0 = time.perf_counter()
    res = run_offline(seq["imu_t"], seq["imu_w"], seq["imu_a"], seq["cam_t"], seq["frames"],
                      model, opts.filter_params(dev), opts.vio_config(), opts.runner_options(),
                      seed=0, device=dev)
    gt = load_pose_file(path("raw_seq_gt.txt"))
    out["virtual_ate_pos_m"] = ate_rmse(res.times, res.pose_w, gt.times, gt.poses)[1]
    out["virtual_poses"] = len(res.times)
    out["virtual_run_s"] = round(time.perf_counter() - t0, 3)
    return out


def warp_child(argv) -> None:
    """Phases 13 and 15's subprocess: ``python -m cuahn_vio_torch.cli``
    ARGV with the warp wrapper spied on (the batch and dtype of each
    launch; the launch itself and its count are the wrapper's); prints them
    and the launch counts as the last line. A network call replayed from
    CUDA graphs (``models/uahn_graphs``) launches the warps its capture
    recorded, as the launch counts count them; the stages' eager pass
    before a capture launches what the replay that follows it does, and
    is not counted."""
    import torch

    from cuahn_vio_torch import cli
    from cuahn_vio_torch.models import uahn_graphs
    from cuahn_vio_torch.ops.cuda import launch_counts
    from cuahn_vio_torch.ops.cuda import warp as cuda_warp

    seen, captured = [], []
    warp = cuda_warp.homography_warp_cuda
    build, replay = uahn_graphs.StageGraphs.__init__, uahn_graphs.StageGraphs.replay

    def spy_warp(imgs, h_uv):
        into = captured if torch.cuda.is_current_stream_capturing() else seen
        into.append([imgs.shape[0], str(imgs.dtype).split(".")[-1]])
        return warp(imgs, h_uv)

    def spy_build(graphs, stages, inputs):
        n = len(seen)
        build(graphs, stages, inputs)
        del seen[n:]
        graphs.spied_warps = captured[:]
        captured.clear()

    def spy_replay(graphs, inputs):
        seen.extend(graphs.spied_warps)
        return replay(graphs, inputs)

    cuda_warp.homography_warp_cuda = spy_warp
    uahn_graphs.StageGraphs.__init__, uahn_graphs.StageGraphs.replay = spy_build, spy_replay
    cli.main(argv)
    print("warp_child " + json.dumps(dict(warps=seen, launch_counts=launch_counts)), flush=True)


def spied_cli(args, cwd: str) -> tuple[str, dict]:
    """``warp_child`` of ``args`` in ``cwd``: (the verb's output, {warps:
    [[B, dtype] of each warp launch], launch_counts}); raises when it exits
    non-zero."""
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            "chip_smoke.warp_child(sys.argv[1:])")
    proc = run_child([sys.executable, "-c", code, *args], cwd)
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    said, _, last = proc.stdout.rstrip("\n").rpartition("\n")
    return said, json.loads(last.split(" ", 1)[1])


def gn_call_ms(torch, fn) -> dict:
    """{1: ms, 11: ms}: fn(1) and fn(11) (a smoother with that many
    Gauss-Newton iterations), each bracketed by CUDA events and closed by
    a synchronize; (ms[11] - ms[1]) / 10 is one iteration."""
    ms = {}
    for iters in (1, 11):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(iters)
        end.record()
        torch.cuda.synchronize()
        ms[iters] = start.elapsed_time(end)
    return ms


def gn_iteration_ms(torch, dev, est: str, loops: str) -> dict:
    """The smoother's Gauss-Newton iteration on the card at the run's size,
    on the graph that ``smooth-trajectory --loops-file`` builds
    (``cli.smoothing_graph`` of the verb's own arguments): ``optimize``
    with 1 and with 11 iterations, each bracketed by CUDA events and closed
    by a synchronize; the difference over 10 is one iteration (the factors'
    Jacobians, assembly, the dense solve). Then the normal equations at the
    graph's first iterate, GN_REPEATS times each, by the module's
    ``index_put_(accumulate=True)``, by ``index_add_`` (float32 atomics)
    and by one dense matmul JᵀJ, each repeat compared bit for bit with the
    first, each one's mean device ms (``time_ms``) and its H's largest
    difference from the module's, over H's largest entry. Raises unless the
    module's repeats are bit-identical; the others are reported. Last, the
    device ms of the step's dense solve, ``optimize``'s LU against a
    Cholesky, and how far apart their solutions are."""
    from cuahn_vio_torch import cli
    from cuahn_vio_torch.parallel import pose_graph as pg

    args = cli.build_parser().parse_args(
        ["smooth-trajectory", est, "--loops-file", loops, "--out", os.devnull])
    _, graph = cli.smoothing_graph(args, dev)
    pg.optimize(graph, iters=1, huber_delta=args.huber)  # warm: cuSOLVER's workspace
    ms = gn_call_ms(torch, lambda n: pg.optimize(graph, iters=n, huber_delta=args.huber))
    out = dict(unknowns=6 * len(graph.p), graph_factors=int(graph.idx_i.numel()),
               gn_ms_per_iteration=(ms[11] - ms[1]) / 10, gn_1_iteration_call_ms=ms[1])

    g = graph
    r, j_i, j_j = pg._factor_jacobians(g.p[g.idx_i], g.q[g.idx_i], g.p[g.idx_j], g.q[g.idx_j],
                                       g.dp_meas, g.dq_meas)
    rw = (g.sqrt_info @ r[..., None])[..., 0]
    jiw, jjw = g.sqrt_info @ j_i, g.sqrt_info @ j_j
    m, dim = rw.shape[0], 6 * len(g.p)
    off = torch.arange(6, device=dev)
    at_i, at_j = g.idx_i[:, None] * 6 + off, g.idx_j[:, None] * 6 + off

    def by_index_add():
        place = (torch.cat([at_i, at_i, at_j, at_j])[:, :, None] * dim
                 + torch.cat([at_i, at_j, at_i, at_j])[:, None, :])
        blocks = torch.cat([jiw.mT @ jiw, jiw.mT @ jjw, jjw.mT @ jiw, jjw.mT @ jjw])
        h = rw.new_zeros(dim * dim).index_add_(0, place.reshape(-1), blocks.reshape(-1))
        rows = torch.cat([jiw.mT @ rw[..., None], jjw.mT @ rw[..., None]])
        rhs = rw.new_zeros(dim).index_add_(0, torch.cat([at_i, at_j]).reshape(-1),
                                           rows.reshape(-1))
        return h.view(dim, dim), rhs

    def by_matmul():
        jac = rw.new_zeros((m, 6, len(g.p), 6))
        k = torch.arange(m, device=dev)
        jac[k, :, g.idx_i, :] = jiw
        jac[k, :, g.idx_j, :] = jjw
        jac = jac.reshape(6 * m, dim)
        return jac.T @ jac, jac.T @ rw.reshape(-1)

    ways = {"index_put_accumulate": lambda: pg._normal_equations(g.idx_i, g.idx_j, jiw, jjw,
                                                                 rw, dim),
            "index_add": by_index_add, "dense_matmul": by_matmul}
    ref = ways["index_put_accumulate"]()
    for name, fn in ways.items():
        first = fn()
        same = all(torch.equal(x, y) for _ in range(GN_REPEATS - 1) for x, y in zip(fn(), first))
        out[f"normal_equations_{name}_bit_identical_x{GN_REPEATS}"] = same
        out[f"normal_equations_{name}_ms"] = time_ms(torch, fn, GN_REPEATS)
        out[f"normal_equations_{name}_h_rel_diff"] = float(
            (first[0] - ref[0]).abs().max() / ref[0].abs().max())
    if not out[f"normal_equations_index_put_accumulate_bit_identical_x{GN_REPEATS}"]:
        raise AssertionError("the smoother's normal equations differ from repeat to repeat")
    # the step's solve: optimize's LU against a Cholesky of the same
    # symmetric positive definite system
    h, rhs = ref
    h[:6, :6] += torch.eye(6, device=dev) * pg.GAUGE_WEIGHT
    h.diagonal().add_(1e-6)  # optimize's default damping
    solves = {"lu": lambda: torch.linalg.solve(h, -rhs),
              "cholesky": lambda: torch.cholesky_solve(-rhs[:, None], torch.linalg.cholesky(h))}
    for name, fn in solves.items():
        out[f"solve_{name}_ms"] = time_ms(torch, fn, GN_REPEATS)
    out["solve_cholesky_vs_lu_max_abs_diff"] = float(
        (solves["cholesky"]()[:, 0] - solves["lu"]()).abs().max())
    return out


def timed_verb(out: dict, key: str, fn, args, cwd: str):
    """``fn(args, cwd)`` (``cli`` or ``spied_cli``), its seconds (its
    process start included) in ``out["verb_s"][key]``."""
    t0 = time.perf_counter()
    said = fn(args, cwd)
    out["verb_s"][key] = round(time.perf_counter() - t0, 3)
    return said


def loop_run(tmp: str, iekf: int) -> dict:
    """Phase 13's first verbs in ``tmp``: the demo's pose file flown by
    ``make-synthetic``, then ``run-vio``, with their checks. Started
    before phase 12 (``started``) and read by ``run_loop``; the verbs'
    own times are no metric. Returns what the checks found; raises on a
    failed one."""
    import numpy as np

    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.ops.cuda.warp import KERNEL, SAMPLE_KERNEL

    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    out = {"verb_s": {}}
    write_loop_trajectory(path("loopy_traj.txt"))
    said, counts = timed_verb(out, "make-synthetic", cli,
                              ["make-synthetic", "--out", "replay.npz", "--traj-file",
                               "loopy_traj.txt", *LOOP_SYNTH_ARGS], tmp)
    out["texture"] = said.split("ground texture: ")[1].split(",")[0]
    frames = len(np.load(path("replay.npz"))["frames"])
    out.update(frames=frames, sampler_launches=counts[SAMPLE_KERNEL],
               threefry_launches_effects=counts["threefry"])
    if counts[SAMPLE_KERNEL] != frames:
        raise AssertionError(f"make-synthetic: {counts[SAMPLE_KERNEL]} sampler launches for "
                             f"{frames} frames")
    expect_t1("make-synthetic --effects (each frame's noise)", counts["threefry"], frames)
    _, counts = timed_verb(out, "run-vio", cli,
                           ["run-vio", "replay.npz", "--config", "replay_config.yaml",
                            "--weights", WEIGHTS, "--out", "est.txt", "--state-out",
                            "state.npz"], tmp)
    poses = len(load_pose_file(path("est.txt")).times)
    out.update(poses=poses, run_vio_warp_launches=counts[KERNEL],
               threefry_launches_run_vio=counts["threefry"])
    expect_t1("run-vio", counts["threefry"], poses * iekf)
    if counts[KERNEL] != 3 * poses * iekf:
        raise AssertionError(f"run-vio: {counts[KERNEL]} warp launches for {poses} poses")
    return out


def run_loop(torch, dev, tmp: str, first: dict, beside: dict) -> dict:
    """Phase 13: ``benchmarks/loop_closure_demo.sh`` through the CLI in
    ``tmp``, after ``loop_run`` (``first``, what it found): close-loops,
    then the smoothings, ``smooth-trajectory --mesh`` (read by phase 16b)
    and the zero-argument calls of ``beside`` side by side, then the
    ATEs. Returns what the checks found, with ``beside``'s results under
    its keys; raises on a failed check."""
    import re

    import numpy as np

    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.ops.cuda.warp import KERNEL, SAMPLE_KERNEL
    from cuahn_vio_torch.pipeline.loop_closure import LOOP_BATCH

    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    out = dict(first, verb_s=dict(first["verb_s"]))
    poses = first["poses"]
    cfg = ["--config", "replay_config.yaml"]
    args = ["close-loops", "replay.npz", "state.npz", "--weights", WEIGHTS, *cfg, "--out",
            "loops.txt", *LOOP_CLOSE_ARGS]
    said, seen = timed_verb(out, "close-loops", spied_cli, args, tmp)
    for line in said.splitlines():
        print(f"  close-loops: {line}", flush=True)
    candidates = int(said.split(" loop candidates")[0].split()[-1])
    inferred = int(re.search(r"(\d+) of \d+ candidates inside", said).group(1))
    factors = len(np.loadtxt(path("loops.txt"), comments="#", ndmin=2))
    batches = -(-inferred // LOOP_BATCH)
    warps = seen["warps"]
    out.update(candidates=candidates, geometric_gate_passed=inferred, factors=factors,
               network_batches=batches, close_loops_warp_launches=len(warps),
               close_loops_warp_batches=sorted({b for b, _ in warps}))
    counts = seen["launch_counts"]
    if (len(warps) != 3 * batches or counts[KERNEL] != len(warps)
            or sum(b for b, _ in warps) != 3 * inferred
            or any(b > LOOP_BATCH or t != "uint8" for b, t in warps)
            or counts[SAMPLE_KERNEL] or counts["homography_warp_rowskip"]):
        raise AssertionError(f"close-loops: warp launches {warps} ({counts}) for {inferred} "
                             f"pairs inside the geometric gate")
    out["threefry_launches_close_loops"] = counts["threefry"]
    expect_t1("close-loops (a batch's masks in one)", counts["threefry"], batches)
    if factors < 1:
        raise AssertionError("close-loops wrote no factor")
    # the warp at each batch size that close-loops launched it at: held to
    # its plain version bit for bit, then timed (these launches are this
    # process's, not the verb's)
    rng = np.random.default_rng(9)
    out["close_loops_by_batch"] = {}
    for b in sorted({b for b, _ in warps}):
        imgs, hs = parity_cases(torch, rng, b, torch.uint8)
        err = check_warp(torch, f"close-loops torch.uint8 B={b} {H}x{W}",
                         torch.as_tensor(imgs, device=dev), torch.as_tensor(hs, device=dev))
        row = time_warp(torch, dev, rng, "warp", torch.uint8, b, 200 if b < 16 else 50)
        out["close_loops_by_batch"][b] = dict(row, launches=[w for w, _ in warps].count(b),
                                              max_abs_err=err)

    runs = (("smoothed.txt", []), ("smoothed_again.txt", []),
            ("smoothed_huber.txt", ["--huber", str(LOOP_HUBER)]),
            ("smoothed_mesh.txt", ["--mesh"]))
    smooth = ["smooth-trajectory", "est.txt", "--loops-file", "loops.txt"]
    done = side_by_side(*[(timed_verb, out, f"smooth-trajectory {name}", cli,
                           [*smooth, *extra, "--out", name], tmp) for name, extra in runs],
                        *[(fn,) for fn in beside.values()])
    for (name, extra), (said, counts) in zip(runs, done):
        poses_s = load_pose_file(path(name))
        if any(counts.values()) or len(poses_s.times) != poses:
            raise AssertionError(f"smooth-trajectory {extra}: {counts} launches, "
                                 f"{len(poses_s.times)} poses")
        if not np.isfinite(poses_s.poses).all():
            raise AssertionError(f"smooth-trajectory {extra}: non-finite poses")
        out[f"cost {name}"] = said.splitlines()[-2]
    out["smooth_mesh_said"] = done[len(runs) - 1][0]
    out.update(zip(beside, done[len(runs):]))
    with open(path("smoothed.txt"), "rb") as f1, open(path("smoothed_again.txt"), "rb") as f2:
        out["repeat_smoothing_identical"] = f1.read() == f2.read()
    if not out["repeat_smoothing_identical"]:
        raise AssertionError("two smoothings of one run differ")
    keys = (("online", "est.txt"), ("smoothed", "smoothed.txt"),
            ("smoothed_huber", "smoothed_huber.txt"))
    ates = side_by_side(*[(cli, ["error-singlerun", "se3", "replay_gt.txt", name], tmp)
                          for _, name in keys])
    for (key, _), (said, _) in zip(keys, ates):
        out[f"ate_pos_m_{key}"] = float(said.split("pos: rmse ")[1].split()[0])
    out.update(gn_iteration_ms(torch, dev, path("est.txt"), path("loops.txt")))
    return out


def run_fil(torch, dev, gt_files: dict, seq, opts) -> dict:
    """Phase 14: the first FIL step's window draws on the card against
    JAX's (``check_window_draws``), then ``train.fil.fil_finetune`` in
    this process from v10 on the GT files ``gt_files`` {name: path}
    (copied as ``name_with_gt.txt`` into a temporary GT directory), with
    the warp and flat-sampler wrappers
    spied on (the shape of each launch), every step's gradients checked
    before the optimizer takes them, and the host time (a synchronize
    there) when the set-up is done (the texture bank on the card, the loss
    and optimizer made: the first draw of ``step_kinds``) and at each
    step's log line; then ``run_offline`` with the tuned weights
    on phase 4's sequence. Returns what the checks found; raises on a
    failed one."""
    import shutil

    import numpy as np

    from cuahn_vio_torch.eval.align import ate_rmse
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.ops.cuda import (
        launch_counts,
        reset_launch_counts,
        threefry_launches_by_mode,
    )
    from cuahn_vio_torch.ops.cuda import warp as cuda_warp
    from cuahn_vio_torch.pipeline.runner import run_offline
    from cuahn_vio_torch.train import fil
    from cuahn_vio_torch.utils.checkpoint import load_params

    seen = {"warps": [], "samples": [], "grads_finite": [], "ends": []}
    warp, sample, adamw, step_kinds = (cuda_warp.homography_warp_cuda,
                                       cuda_warp.bilinear_sample_cuda, fil.OptaxAdamW,
                                       fil.step_kinds)

    def spy_warp(imgs, h_uv):
        seen["warps"].append((imgs.shape[0], str(imgs.dtype).split(".")[-1]))
        return warp(imgs, h_uv)

    def spy_sample(img, su, sv):
        seen["samples"].append((img.shape[0] if img.dim() == 3 else 1, su.shape[-1]))
        return sample(img, su, sv)

    class CheckedAdamW(adamw):
        def step(self):
            seen["grads_finite"].append(all(bool(torch.isfinite(p.grad).all())
                                            for p in self.params if p.grad is not None))
            super().step()

    def mark():
        torch.cuda.synchronize()
        return time.perf_counter(), len(seen["warps"]), len(seen["samples"])

    def spy_step_kinds(*args):  # its body runs at the loop's first step
        seen["set_up"] = mark()
        yield from step_kinds(*args)

    logged = []

    def log(msg, **_):
        seen["ends"].append(mark())
        logged.append(msg)

    cfg = fil.FilConfig(window=FIL_WINDOW, batch_size=FIL_BATCH)
    c_rot_i, i_t_i2c = camera(torch, dev)
    v10 = load_params(WEIGHTS)
    draws = check_window_draws(torch, dev, cfg)
    out = {"draws_max_abs_diff_from_jax": draws["max_abs_diff_from_jax"]}
    with tempfile.TemporaryDirectory() as tmp:
        gt_dir = os.path.join(tmp, "gt")
        os.makedirs(gt_dir)
        for name, src in gt_files.items():
            shutil.copy(src, os.path.join(gt_dir, f"{name}_with_gt.txt"))
        t0 = time.perf_counter()
        bank = fil.build_window_bank(FIL_BANK, cfg, seed=0, gt_dir=gt_dir)
        out["bank_build_s"] = round(time.perf_counter() - t0, 3)
        model = build_uahn(v10, device=dev)  # train-fil's UAHN: dropout 0.05
        weights = os.path.join(tmp, "w.msgpack")
        cuda_warp.homography_warp_cuda, cuda_warp.bilinear_sample_cuda = spy_warp, spy_sample
        fil.OptaxAdamW, fil.step_kinds = CheckedAdamW, spy_step_kinds
        try:
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            start = time.perf_counter()
            fil.fil_finetune(model, opts.filter_params(dev), c_rot_i, i_t_i2c, cfg,
                             steps=FIL_STEPS, seed=0, bank=bank, log_every=1, log_fn=log,
                             checkpoint_path=weights, save_every=FIL_STEPS - 1,
                             pair_step_every=2)
            counts, by_mode = dict(launch_counts), dict(threefry_launches_by_mode)
        finally:
            cuda_warp.homography_warp_cuda, cuda_warp.bilinear_sample_cuda = warp, sample
            fil.OptaxAdamW, fil.step_kinds = adamw, step_kinds
        out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        written = load_params(weights)
    for line in logged:
        print(f"  train-fil: {line}", flush=True)
    steps = [line for line in logged if line.startswith("step")]
    losses = [float(line.split(" loss ")[1]) for line in steps]
    kinds = [line.split("[")[1].split("]")[0] for line in steps]
    out.update(kinds=kinds, losses=losses, grads_finite=seen["grads_finite"],
               bank_windows=int(bank.tap_p.shape[0]))
    if (kinds != ["fil", "pair"] * (FIL_STEPS // 2) or not np.isfinite(losses).all()
            or len(seen["grads_finite"]) != FIL_STEPS or not all(seen["grads_finite"])):
        raise AssertionError(f"fil_finetune: steps {kinds}, losses {losses}, finite "
                             f"gradients {seen['grads_finite']}")
    # the launches of each step, by shape; the set-up launches nothing
    n_points = (FIL_WINDOW + 1) * cfg.blur_taps * H * W
    marks = [seen["set_up"]] + seen["ends"][-FIL_STEPS:]
    out["set_up_ms"] = round((seen["set_up"][0] - start) * 1e3, 3)
    out["step_ms"] = []
    launched = {f"{what}_launches_{kind}": 0 for what in ("warp", "sampler")
                for kind in ("fil", "pair")}
    for k, kind in enumerate(kinds):
        (t_a, w_a, s_a), (t_b, w_b, s_b) = marks[k], marks[k + 1]
        warps, samples = seen["warps"][w_a:w_b], seen["samples"][s_a:s_b]
        if kind == "fil":
            want_w = [(FIL_BATCH, "uint8")] * (3 * FIL_WINDOW * FIL_IEKF)
            want_s = [(FIL_BATCH, n_points)]
        else:
            want_w = [(FIL_PAIR_BATCH, "float32")] * 3
            want_s = [(FIL_PAIR_BATCH, cfg.blur_taps * H * W)] * 2
        if warps != want_w or samples != want_s:
            raise AssertionError(f"step {k} ({kind}): warps {warps}, samples {samples}")
        launched[f"warp_launches_{kind}"] += len(warps)
        launched[f"sampler_launches_{kind}"] += len(samples)
        out["step_ms"].append(round((t_b - t_a) * 1e3, 3))
    out.update(launched)
    if seen["set_up"][1:] != (0, 0) or sum(launched.values()) != (len(seen["warps"])
                                                                  + len(seen["samples"])):
        raise AssertionError(f"fil_finetune launches outside its steps: {seen['set_up']}, "
                             f"{launched}")
    if (counts[cuda_warp.KERNEL] != len(seen["warps"])
            or counts[cuda_warp.SAMPLE_KERNEL] != len(seen["samples"])
            or counts[cuda_warp.ROWSKIP_KERNEL] or counts.get("remap")):
        raise AssertionError(f"fil_finetune launch counts {counts}")
    # a step's draws, and the masks: one launch a network call, W x IEKF a
    # FIL step, one a pair step
    fil_draws = sum(draws["fil_launches_by_mode"].values())
    pair_draws = sum(draws["pair_launches_by_mode"].values())
    out["threefry_launches"] = counts["threefry"]
    out["threefry_launches_by_mode"] = {k: v for k, v in by_mode.items() if v}
    out["threefry_draw_launches"] = {"fil": draws["fil_launches_by_mode"],
                                     "pair": draws["pair_launches_by_mode"]}
    expect_t1("fil_finetune", counts["threefry"],
              sum(fil_draws + FIL_WINDOW * FIL_IEKF if kind == "fil" else pair_draws + 1
                  for kind in kinds))
    if written.keys() != v10.keys() or not all(torch.isfinite(written[k]).all() for k in v10):
        raise AssertionError("the FIL checkpoint is not v10's tree of finite weights")
    tuned = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    moved = sorted({k.split(".")[0] for k in v10 if not torch.equal(tuned[k], v10[k])})
    out["blocks_moved"] = moved
    if not moved:
        raise AssertionError("fil_finetune left v10's weights unchanged")
    tuned_model = build_uahn(tuned, device=dev, dropout_rate=opts.mc_dropout,
                             blocks_to_run=opts.blocks_to_run)
    res = run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames, tuned_model,
                      opts.filter_params(dev), opts.vio_config(), opts.runner_options(),
                      seed=0, device=dev)
    out["tuned_ate_pos_m"] = ate_rmse(res.times, res.pose_w, seq.gt_times, seq.gt_pose_w)[1]
    return out


def check_grid_detect(torch, dev, imgs) -> dict:
    """Phase 15a: ``grid_detect`` on the card against the CPU on (K, H, W)
    uint8 ``imgs``: the dense scores within SCORE_TOL of the CPU's largest
    score, each cell's best score too, and a cell whose pick differs only
    at a near-tie (the card's pick scores, on the CPU, within that
    tolerance of the CPU's maximum); ``valid`` equal where the picks agree.
    Returns the differences; raises on a failed check."""
    from cuahn_vio_torch.vision.detect import grid_detect, shi_tomasi_score

    x_cpu = torch.as_tensor(imgs).to(torch.float32) / 255.0
    x_dev = torch.as_tensor(imgs, device=dev).to(torch.float32) / 255.0
    s_cpu = shi_tomasi_score(x_cpu)
    tol = SCORE_TOL * float(s_cpu.max())
    score_diff = float((shi_tomasi_score(x_dev).cpu() - s_cpu).abs().max())
    pts, valid, best = grid_detect(x_cpu)
    pts_d, valid_d, best_d = (t.cpu() for t in grid_detect(x_dev))
    best_diff = float((best_d - best).abs().max())
    differ = (pts_d != pts).any(dim=-1)
    k, g = torch.nonzero(differ, as_tuple=True)
    u, v = pts_d[k, g, 0].long(), pts_d[k, g, 1].long()
    near_tie = bool((s_cpu[k, v, u] >= best[k, g] - tol).all())
    out = dict(frames=len(imgs), score_max_diff=score_diff, best_max_diff=best_diff,
               tol=tol, picks_differing=int(differ.sum()))
    if not (score_diff <= tol and best_diff <= tol and near_tie
            and torch.equal(valid_d[~differ], valid[~differ])):
        raise AssertionError(f"grid_detect on the card vs the CPU: {out}")
    return out


def check_tracks(torch, dev, imgs) -> dict:
    """Phase 15a: ``track_pyramidal`` on the card against the CPU on the K - 1
    consecutive pairs of (K, H, W) uint8 ``imgs``, from the CPU's grid
    points of each pair's first frame: ``valid`` equal except where the
    CPU's residual or a determinant lies within THRESH_TOL of its threshold,
    the tracks within TRACK_TOL_PX where both are valid. Returns the
    differences; raises on a failed check."""
    from cuahn_vio_torch.vision.detect import grid_detect
    from cuahn_vio_torch.vision.klt import DET_MIN, MAX_RESIDUAL, track_pyramidal

    x_cpu = torch.as_tensor(imgs).to(torch.float32) / 255.0
    x_dev = torch.as_tensor(imgs, device=dev).to(torch.float32) / 255.0
    pts_diff, flips, near_flips, valid_n = 0.0, 0, 0, 0
    for k in range(len(imgs) - 1):
        pts = grid_detect(x_cpu[k])[0]
        p_c, v_c, st = track_pyramidal(x_cpu[k], x_cpu[k + 1], pts, with_stats=True)
        p_d, v_d = (t.cpu() for t in track_pyramidal(x_dev[k], x_dev[k + 1], pts.to(dev)))
        near = (((st["residual"] - MAX_RESIDUAL).abs() < THRESH_TOL)
                | ((st["det"] - DET_MIN).abs() < THRESH_TOL).any(dim=0))
        flip = v_c != v_d
        flips += int((flip & ~near).sum())
        near_flips += int((flip & near).sum())
        both = v_c & v_d
        valid_n += int(v_c.sum())
        if both.any():
            pts_diff = max(pts_diff, float((p_d - p_c).abs()[both].max()))
    out = dict(pairs=len(imgs) - 1, cpu_valid_tracks=valid_n, pts_max_diff_px=pts_diff,
               valid_flips_near_threshold=near_flips, valid_flips_elsewhere=flips)
    if flips or not pts_diff <= TRACK_TOL_PX:
        raise AssertionError(f"track_pyramidal on the card vs the CPU: {out}")
    return out


def triangulation_inputs(torch, gt_pose, rng):
    """(bearings, rot_c2a, p_cia, valid) of TRI_FEATURES ground points (0 to
    0.3 m above the plane) in view of the first of TRI_VIEWS camera poses of
    ``gt_pose`` (N, 7) [xyz qx qy qz qw] IMU poses spread over its second
    half, under the default extrinsics; the anchor is the first view, and a
    view observes a point in front of it (bearing z > 0.2); numpy
    float32."""
    import numpy as np

    from cuahn_vio_torch.data.oracle import camera_pose
    from cuahn_vio_torch.utils.config import VioOptions

    t = torch.as_tensor(np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64))
    rows = np.linspace(len(gt_pose) // 2, len(gt_pose) - 1, TRI_VIEWS).astype(int)
    pose = torch.as_tensor(gt_pose[rows], dtype=torch.float64)
    rots, centres = (x.numpy() for x in camera_pose(  # camera -> world, centres
        pose[:, :3], pose[:, [6, 3, 4, 5]], t[:3, :3], -t[:3, :3].T @ t[:3, 3]))
    # points: rays of the anchor's image, met with planes 0-0.3 m above the ground
    ray = rots[0] @ np.stack([rng.uniform(-0.6, 0.6, TRI_FEATURES),
                              rng.uniform(-0.4, 0.4, TRI_FEATURES), np.ones(TRI_FEATURES)])
    lam = (rng.uniform(0.0, 0.3, TRI_FEATURES) - centres[0, 2]) / ray[2]
    pts = (centres[0][:, None] + lam * ray).T  # (F, 3)
    pf_c = np.einsum("mji,fmj->fmi", rots, pts[:, None, :] - centres[None])
    bear = pf_c / np.linalg.norm(pf_c, axis=-1, keepdims=True)
    rot_c2a = np.einsum("ji,mjk->mik", rots[0], rots)  # R_a^T R_i
    p_cia = (centres - centres[0]) @ rots[0]  # R_a^T (c_i - c_a)
    f = TRI_FEATURES
    return (bear.astype(np.float32), np.tile(rot_c2a, (f, 1, 1, 1)).astype(np.float32),
            np.tile(p_cia, (f, 1, 1)).astype(np.float32), bear[..., 2] > 0.2)  # seen in front


def check_triangulation(torch, dev, gt_pose) -> dict:
    """Phase 15a: ``triangulate_nview`` on the card against the CPU on
    ``triangulation_inputs``: ``ok`` equal, positions within TRI_TOL_M where
    ok. Returns the differences; raises on a failed check."""
    import numpy as np

    from cuahn_vio_torch.vision.triangulate import triangulate_nview

    args = triangulation_inputs(torch, gt_pose, np.random.default_rng(15))
    p_c, ok_c = triangulate_nview(*(torch.as_tensor(a) for a in args))
    p_d, ok_d = (t.cpu() for t in triangulate_nview(*(torch.as_tensor(a, device=dev)
                                                      for a in args)))
    diff = float((p_d - p_c).abs()[ok_c].max()) if ok_c.any() else 0.0
    out = dict(features=TRI_FEATURES, views=TRI_VIEWS, ok=int(ok_c.sum()),
               pos_max_diff_m=diff)
    if not (torch.equal(ok_c, ok_d) and ok_c.any() and diff <= TRI_TOL_M):
        raise AssertionError(f"triangulate_nview on the card vs the CPU: {out}")
    return out


def preint_inputs(imu_t, imu_w, imu_a, cam_t, bg, ba):
    """(w_mid, a_mid, dt, bg, ba) of PREINT_INTERVALS consecutive camera
    intervals of a sequence: each interval's IMU samples, midpoint-averaged,
    padded with dt = 0 rows to the longest; numpy float32."""
    import numpy as np

    k0 = len(cam_t) // 2
    wins = []
    for a, b in zip(cam_t[k0:k0 + PREINT_INTERVALS], cam_t[k0 + 1:k0 + PREINT_INTERVALS + 1]):
        j = np.flatnonzero((imu_t >= a) & (imu_t < b))
        j = np.append(j, j[-1] + 1)
        wins.append((0.5 * (imu_w[j[:-1]] + imu_w[j[1:]]), 0.5 * (imu_a[j[:-1]] + imu_a[j[1:]]),
                     np.diff(imu_t[j])))
    t_max = max(len(d) for _, _, d in wins)
    pad = lambda x: np.concatenate([x, np.zeros((t_max - len(x),) + x.shape[1:])])  # noqa: E731
    n = len(wins)
    return tuple(np.asarray(x, np.float32) for x in (
        [pad(w) for w, _, _ in wins], [pad(a) for _, a, _ in wins],
        [pad(d) for _, _, d in wins], np.tile(bg, (n, 1)), np.tile(ba, (n, 1))))


def check_preintegration(torch, dev, inputs) -> dict:
    """Phase 15a: ``preintegrate`` on the card against the CPU on
    ``preint_inputs``: dq, dv and dp within PREINT_TOL, each Jacobian within
    PREINT_JAC_RTOL of its largest entry. Returns the differences; raises
    on a failed check."""
    from cuahn_vio_torch.vision.preint import preintegrate

    f_c = preintegrate(*(torch.as_tensor(a) for a in inputs))
    f_d = preintegrate(*(torch.as_tensor(a, device=dev) for a in inputs))
    out = dict(intervals=inputs[2].shape[0], samples_per_interval=inputs[2].shape[1])
    state = max(float((getattr(f_d, k).cpu() - getattr(f_c, k)).abs().max())
                for k in ("dq", "dv", "dp", "dt"))
    jac = max(float((getattr(f_d, k).cpu() - getattr(f_c, k)).abs().max()
                    / getattr(f_c, k).abs().max())
              for k in ("j_q_bg", "j_v_bg", "j_v_ba", "j_p_bg", "j_p_ba"))
    out.update(state_max_diff=state, jacobian_max_rel_diff=jac)
    if not (state <= PREINT_TOL and jac <= PREINT_JAC_RTOL):
        raise AssertionError(f"preintegrate on the card vs the CPU: {out}")
    return out


def check_error_map(torch, dev, frames) -> dict:
    """Phase 15a: the UAHN's error map of one pair (v10, dropout 0, blocks
    1-4, float frames) on the card against the CPU: within ERR_MAP_LEVELS
    on at least ERR_MAP_SHARE of the pixels. Returns the share and the
    largest difference; raises on a failed check."""
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params

    weights = load_params(WEIGHTS)
    maps = []
    for d in ("cpu", dev):
        model = build_uahn(weights, device=d, dropout_rate=0.0)
        pair = torch.as_tensor(frames, device=d).to(torch.float32) / 255.0
        maps.append(model(pair[:1], pair[1:], None, use_prior=False,
                          return_error_map=True)[2].cpu())
    diff = (maps[1] - maps[0]).abs()
    out = dict(share_within=float((diff <= ERR_MAP_LEVELS).float().mean()),
               max_diff_levels=float(diff.max()), mean_cpu=float(maps[0].mean()),
               mean_card=float(maps[1].mean()))
    if not out["share_within"] >= ERR_MAP_SHARE:
        raise AssertionError(f"error map on the card vs the CPU: {out}")
    return out


def eval_flow_rate(torch, dev, tmp: str) -> dict:
    """Phase 15a: ``eval.flow.eval_flow`` in this process on phase 10's
    sequence, prior gt, batch 16 (the verb's defaults, v10, MC dropout on),
    after one warm-up call; host clock with a synchronize at each end.
    Returns the pairs, seconds and pairs/s."""
    import numpy as np

    from cuahn_vio_torch.eval.flow import eval_flow
    from cuahn_vio_torch.eval.simulation import load_state_gt
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params
    from cuahn_vio_torch.utils.config import VioOptions

    d = np.load(os.path.join(tmp, "seq.npz"))
    gt = load_state_gt(os.path.join(tmp, "seq_state_gt.txt"))
    fp = VioOptions.uzhfpv_indoor45().filter_params(dev)
    model = build_uahn(load_params(WEIGHTS), device=dev)
    run = lambda: eval_flow(d["frames"], d["cam_t"], gt.times, gt.pose, fp.c_rot_i,  # noqa: E731
                            fp.i_t_i2c, model)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs = len(run().pred)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(pairs=pairs, seconds=seconds, pairs_per_s=pairs / seconds)


def run_vision_checks(torch, dev, tmp: str) -> dict:
    """Phase 15a in this process on phase 10's files in ``tmp``: each new
    function on the card against the port's own on the CPU, on identical
    inputs, and ``eval_flow_rate``."""
    import numpy as np

    from cuahn_vio_torch.eval.simulation import load_state_gt

    d = np.load(os.path.join(tmp, "seq.npz"))
    gt = load_state_gt(os.path.join(tmp, "seq_state_gt.txt"))
    frames = d["frames"]
    k = len(frames) // 2
    imgs = frames[k:k + DIAG_FRAMES + 1]
    return dict(
        grid_detect=check_grid_detect(torch, dev, imgs[:DIAG_FRAMES]),
        track_pyramidal=check_tracks(torch, dev, imgs),
        triangulate_nview=check_triangulation(torch, dev, gt.pose),
        preintegrate=check_preintegration(torch, dev, preint_inputs(
            d["imu_t"], d["imu_w"], d["imu_a"], d["cam_t"], gt.bg[0], gt.ba[0])),
        error_map=check_error_map(torch, dev, frames[INSPECT_FRAME:INSPECT_FRAME + 2]),
        eval_flow_in_process=eval_flow_rate(torch, dev, tmp),
    )


def run_diagnostics(torch, dev, tmp: str) -> dict:
    """Phase 15b: the diagnostics verbs through ``python -m
    cuahn_vio_torch.cli`` in phase 10's directory ``tmp``, each with its
    warp launches recorded (``spied_cli``). Returns what the checks found;
    raises on a failed one."""
    import re

    import numpy as np

    from cuahn_vio_torch.ops.cuda import heads as heads_cuda
    from cuahn_vio_torch.ops.cuda.warp import KERNEL
    from cuahn_vio_torch.utils.png import read_pngs

    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    out = {"verb_s": {}}
    n_pairs = len(np.load(path("seq.npz"))["frames"]) - 1
    flow_batch = 16  # eval-flow's default --batch

    def only_warps(seen, want, key, calls, gemm, split):
        """Exactly ``want`` warps, and ``calls`` network calls: a T1 draw,
        three V1 launches, ``gemm`` V2 launches (one a layer), ``split``
        launches of V2's split path and H1's two each."""
        counts = seen["launch_counts"]
        heads = heads_cuda.LAUNCHES
        if (sorted(seen["warps"]) != sorted(want) or counts[KERNEL] != len(want)
                or counts["threefry"] != calls or counts["lowc_conv"] != 3 * calls
                or counts["conv_gemm"] != gemm * calls or counts["mc_heads"] != heads * calls
                or counts["conv_gemm_split"] != split * calls
                or sum(counts.values()) != len(want) + (4 + gemm + split + heads) * calls):
            raise AssertionError(f"{key}: warp launches {seen['warps']} ({counts}), "
                                 f"expected {want}, {calls} threefry, {3 * calls} lowc_conv, "
                                 f"{gemm * calls} conv_gemm, {split * calls} conv_gemm_split "
                                 f"and {heads * calls} mc_heads launches")
        out["threefry_launches"] = out.get("threefry_launches", 0) + calls

    def refused():  # calibrate-state-covariance on the --cov-calib log: its stderr
        return run_child([sys.executable, "-m", "cuahn_vio_torch.cli",
                          "calibrate-state-covariance", "state.npz", "seq_state_gt.txt"], tmp)

    eval_flow = ["eval-flow", "seq.npz", "seq_state_gt.txt", "--weights", WEIGHTS]
    flows = (("gt", n_pairs, ["--out", "flow.npz"]),
             ("none", min(n_pairs, DIAG_NONE_LIMIT), ["--limit", str(DIAG_NONE_LIMIT)]))
    # every verb but track-features (whose ms/frame is a metric) side by side
    verbs = {**{f"eval-flow --prior {prior}": (spied_cli, [*eval_flow, "--prior", prior, *extra])
                for prior, _, extra in flows},
             "inspect-frame": (spied_cli, ["inspect-frame", "seq.npz", "--frame",
                                           str(INSPECT_FRAME), "--weights", WEIGHTS, "--out",
                                           "inspect.png"]),
             "calibrate-covariance": (cli, ["calibrate-covariance", "plain.npz"]),
             "calibrate-state-covariance": (cli, ["calibrate-state-covariance", "plain.npz",
                                                  "seq_state_gt.txt"])}
    done = side_by_side(*[(timed_verb, out, key, fn, args, tmp)
                          for key, (fn, args) in verbs.items()], (refused,))
    said_by = {}
    for key, (said, seen) in zip(verbs, done):
        for line in said.splitlines():
            print(f"  {key}: {line}", flush=True)
        said_by[key] = (said, seen)

    out["eval_flow_warps"] = []
    for prior, pairs, _ in flows:
        key = f"eval-flow --prior {prior}"
        said, seen = said_by[key]
        sizes = [flow_batch] * (pairs // flow_batch)
        if pairs % flow_batch:
            sizes.append(pairs % flow_batch)
        # V2 takes blocks 2-4's 14 layers, and block 1's conv2 (block 2's
        # conv2's shape, so the split path's too) where block 1 runs
        full = prior != "gt"
        only_warps(seen, [[b, "float32"] for b in sizes for _ in range(3)], key, len(sizes),
                   15 if full else 14, SPLIT_LAUNCHES_FULL if full else SPLIT_LAUNCHES_PRIOR)
        rmse = float(re.search(r"corner error  px: rmse ([0-9.]+)", said).group(1))
        out[f"flow_rmse_px_{prior}"] = rmse
        out[f"flow_pairs_{prior}"] = pairs
        out["eval_flow_warps"] += seen["warps"]
        if not rmse <= FLOW_RMSE_BARS_PX[prior]:
            raise AssertionError(f"{key}: corner-error RMSE {rmse} px above the bar "
                                 f"{FLOW_RMSE_BARS_PX[prior]} px")
    dump = np.load(path("flow.npz"))
    if dump["pred"].shape != (n_pairs, 8) or not np.isfinite(dump["pred"]).all():
        raise AssertionError(f"eval-flow --out: pred {dump['pred'].shape}")

    said, seen = said_by["inspect-frame"]
    only_warps(seen, [[1, "float32"]] * 4, "inspect-frame", 1, 15,  # the full cascade
               SPLIT_LAUNCHES_FULL)
    out["inspect_warp_launches"] = len(seen["warps"])
    out["inspect_png_shape"] = list(read_pngs([path("inspect.png")])[0].shape)
    out["inspect_mean_err"] = float(said.rsplit("mean photometric err ", 1)[1].rstrip(")"))
    if out["inspect_png_shape"] != [H, 3 * W] or not np.isfinite(out["inspect_mean_err"]):
        raise AssertionError(f"inspect-frame: {out}")

    said, counts = timed_verb(out, "track-features", cli,
                              ["track-features", "seq.npz", "--out", "tracks.npz"], tmp)
    for line in said.splitlines():
        print(f"  track-features: {line}", flush=True)
    tracks = np.load(path("tracks.npz"))
    out["track_ms_per_frame"] = float(re.search(r"([0-9.]+) ms/frame", said).group(1))
    out["track_survivors"] = int(re.search(r"(\d+) survivors", said).group(1))
    out["track_survivors_jax"] = REF_TRACK_SURVIVORS
    ids = tracks["ids"]
    if (any(counts.values()) or ids.shape != (n_pairs + 1, 80)
            or tracks["pts"].shape != (n_pairs + 1, 80, 2) or (np.diff(ids, axis=0) < 0).any()):
        raise AssertionError(f"track-features: {counts} launches, ids {ids.shape}")

    said, _ = said_by["calibrate-covariance"]
    out["k_net_cov_fit"] = float(re.search(r"fitted k_net_cov: +([0-9.e+-]+)", said).group(1))
    said, _ = said_by["calibrate-state-covariance"]
    fit = re.search(r"--cov-calib (.*)", said).group(1)
    out["cov_calib_fit"] = fit
    values = [out["k_net_cov_fit"]] + [float(kv.split(":")[1]) for kv in fit.split(",")]
    if not np.isfinite(values).all():
        raise AssertionError(f"calibration fits not finite: {values}")
    proc = done[-1]
    out["inflated_log_refused"] = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
    if proc.returncode == 0 or "already inflated" not in proc.stderr or "'pos': 2.0" not in (
            proc.stderr):
        raise AssertionError(f"calibrate-state-covariance on the inflated log: exit "
                             f"{proc.returncode}, {proc.stderr[-500:]}")
    # the warp at each batch size eval-flow launched it at: held to its
    # plain version bit for bit, then timed (these launches are this
    # process's, not the verbs')
    rng = np.random.default_rng(12)
    out["eval_flow_by_batch"] = {}
    for b in sorted({b for b, _ in out["eval_flow_warps"]}):
        imgs, hs = parity_cases(torch, rng, b, torch.float32)
        err = check_warp(torch, f"eval-flow torch.float32 B={b} {H}x{W}",
                         torch.as_tensor(imgs, device=dev), torch.as_tensor(hs, device=dev))
        row = time_warp(torch, dev, rng, "warp", torch.float32, b, 200)
        out["eval_flow_by_batch"][b] = dict(
            row, launches=[w for w, _ in out["eval_flow_warps"]].count(b), max_abs_err=err)
    del out["eval_flow_warps"]
    return out


def tune_sequence(seq, opts, tmp: str) -> None:
    """Phase 16a's inputs in ``tmp``: ``seq.npz`` (IMU arrays and cam_t),
    ``seq_gt.txt`` and ``seq_config.yaml`` of the smoke's sequence from the
    card's ``make_sequence`` (``seq``)."""
    import numpy as np

    from cuahn_vio_torch.eval.traj_io import save_pose_file

    np.savez(os.path.join(tmp, "seq.npz"), imu_t=seq.imu_t, imu_w=seq.imu_w, imu_a=seq.imu_a,
             cam_t=seq.cam_t)
    save_pose_file(os.path.join(tmp, "seq_gt.txt"), seq.gt_times, seq.gt_pose_w)
    dataclasses.replace(opts, init_height=float(seq.gt_pose_w[0, 2])).to_yaml(
        os.path.join(tmp, "seq_config.yaml"))


def rows_against_jax(rows: list, jax_rows: list, tol_m: float) -> dict:
    """Phase 16a's check: each port row against the JAX row of its
    grid_index (ate_pos within ``tol_m``, the same inf, the same n_gated)
    and the first TUNE_TOP rows in the JAX order up to near-ties (two rows
    whose ate_pos are within ``tol_m`` may trade places). Raises on a
    failed check."""
    import math

    by_index = {r["grid_index"]: r for r in rows}
    if len(rows) != len(jax_rows) or set(by_index) != {r["grid_index"] for r in jax_rows}:
        raise AssertionError(f"{len(rows)} rows against the JAX verb's {len(jax_rows)}")
    worst, n_inf = 0.0, 0
    for jr in jax_rows:
        tr = by_index[jr["grid_index"]]
        a, b = tr["ate_pos"], jr["ate_pos"]
        if math.isinf(a) != math.isinf(b):
            raise AssertionError(f"grid point {jr['grid_index']}: ate_pos {a} against {b}")
        n_inf += math.isinf(b)
        if not math.isinf(b):
            worst = max(worst, abs(a - b))
        if tr.get("n_gated") != jr.get("n_gated"):
            raise AssertionError(f"grid point {jr['grid_index']}: n_gated {tr.get('n_gated')} "
                                 f"against {jr.get('n_gated')}")
    if not worst <= tol_m:
        raise AssertionError(f"ate_pos {worst:.3e} m from the JAX rows (tolerance {tol_m:.0e})")
    ate = {r["grid_index"]: r["ate_pos"] for r in jax_rows}
    for k, (tr, jr) in enumerate(zip(rows[:TUNE_TOP], jax_rows[:TUNE_TOP])):
        if tr["grid_index"] != jr["grid_index"] and \
                not abs(ate[tr["grid_index"]] - ate[jr["grid_index"]]) <= tol_m:
            raise AssertionError(f"top row {k}: grid point {tr['grid_index']}, JAX "
                                 f"{jr['grid_index']}")
    return dict(rows=len(rows), inf_rows=n_inf, max_ate_pos_diff_m=worst,
                top=[r["grid_index"] for r in rows[:TUNE_TOP]],
                jax_top=[r["grid_index"] for r in jax_rows[:TUNE_TOP]])


def trace_imu_ops(torch, dev) -> dict:
    """Phase 16a: where a float32 evaluation of the smoke trajectory's IMU
    on the card leaves the CPU's (fault C-2 of the card's ``make_sequence``
    before it took the IMU stream from the host): each op of
    ``AnalyticTrajectory.imu_true`` at the smoke sequence's IMU times, on
    the card and on the CPU, as the largest absolute difference: ``sin`` /
    ``cos`` of the five closed forms' arguments, ``pos_w``, ``quat_i2w``,
    ``jacfwd``'s q-dot and p-double-dot, the outputs w_body and f_body;
    and the two last products (the body rate 2 vec(q* q-dot), the specific
    force R^T (p-double-dot - g)) on each device from the CPU's inputs, so
    that a product's own share shows."""
    import numpy as np
    from torch.func import jacfwd, vmap

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory
    from cuahn_vio_torch.ops.quat import quat_mul, quat_to_rot

    traj = AnalyticTrajectory()
    imu_t = np.arange(0.0, SEQ["t_still"] + SEQ["duration"], 1.0 / 500.0)
    shifted = np.maximum(imu_t - SEQ["t_still"], 0.0)
    conj = torch.tensor([1.0, -1.0, -1.0, -1.0])
    gravity = torch.tensor([0.0, 0.0, -9.81])

    def body_rate(q, qdot):
        return 2.0 * quat_mul(q * conj.to(q.device), qdot)[1:4]

    def specific_force(q, acc):
        return quat_to_rot(q).T @ (acc - gravity.to(q.device))

    def evaluate(device, inputs=None):
        t = torch.tensor(shifted, dtype=torch.float32, device=device)
        rates = (traj.wx, traj.wy, traj.wz, traj.w_rock, traj.w_rock * 0.83)
        args = torch.stack([w * t for w in rates])
        out = dict(sin=torch.sin(args), cos=torch.cos(args), pos_w=vmap(traj.pos_w)(t),
                   quat_i2w=vmap(traj.quat_i2w)(t),
                   qdot=vmap(jacfwd(traj.quat_i2w))(t).to(t.dtype),
                   acc_w=vmap(jacfwd(jacfwd(traj.pos_w)))(t).to(t.dtype))
        out["w_body"], out["f_body"] = vmap(traj.imu_true)(t)
        if inputs is not None:
            q, qdot, acc = (inputs[k].to(device) for k in ("quat_i2w", "qdot", "acc_w"))
            out["w_body from the CPU's q, q-dot"] = vmap(body_rate)(q, qdot)
            out["f_body from the CPU's q, p-double-dot"] = vmap(specific_force)(q, acc)
        return {k: v.cpu() for k, v in out.items()}

    cpu = evaluate("cpu")
    cpu = evaluate("cpu", cpu)
    card = evaluate(dev, cpu)
    return {k: float((card[k].double() - cpu[k].double()).abs().max()) for k in cpu}


def run_sweep(torch, dev, seq, opts, tmp: str) -> dict:
    """Phase 16a: ``tune-filter`` in this process on the card over the
    smoke's sequence and TUNE_LOG at TUNE_GRID, under the port's
    ``ResourceMonitor`` of this process; every row held to the JAX verb's
    (``rows_against_jax``). Returns what the checks found; raises on a
    failed one."""
    import contextlib
    import io

    import numpy as np

    from cuahn_vio_torch import cli as tcli
    from cuahn_vio_torch.eval.recorder import ResourceMonitor
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts

    tune_sequence(seq, opts, tmp)
    out = {"imu_ops_card_vs_cpu_max_abs_diff": trace_imu_ops(torch, dev)}
    frames = len(np.load(os.path.join(REPO, TUNE_LOG))["times"])
    argv = ["tune-filter", os.path.join(tmp, "seq.npz"), os.path.join(REPO, TUNE_LOG),
            os.path.join(tmp, "seq_gt.txt"), "--config", os.path.join(tmp, "seq_config.yaml"),
            *TUNE_GRID, "--out", os.path.join(tmp, "rows.jsonl")]
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    said = io.StringIO()
    with ResourceMonitor(interval=0.5) as mon, contextlib.redirect_stdout(said):
        t0 = time.perf_counter()
        tcli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if any(launch_counts.values()):
        raise AssertionError(f"the sweep launched kernels: {dict(launch_counts)}")
    with open(os.path.join(tmp, "rows.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(REPO, TUNE_ROWS)) as f:
        jax_rows = [json.loads(line) for line in f]
    if len(rows) != TUNE_POINTS or f"sweeping {TUNE_POINTS} grid points" not in said.getvalue():
        raise AssertionError(f"the sweep wrote {len(rows)} rows, not {TUNE_POINTS}")
    out.update(rows_against_jax(rows, jax_rows, TUNE_ATE_TOL_M))
    out.update(grid_points=TUNE_POINTS, frames=frames, sweep_s=seconds,
               filter_replays_per_s=TUNE_POINTS * frames / seconds,
               peak_device_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               process_monitor=mon.summary, best_ate_pos_m=rows[0]["ate_pos"])
    return out


def run_schur(torch, dev, loop_dir: str, mesh_said: str) -> dict:
    """Phase 16b: ``optimize_sharded`` with SCHUR_BLOCKS blocks on the card
    at phase 13's loop-closure graph (``cli.smoothing_graph`` of its
    ``smooth-trajectory`` arguments), against the dense ``optimize`` there:
    positions within SCHUR_POS_TOL_M, the final cost at most
    SCHUR_COST_DROP of the first, GN_REPEATS repeats bit-identical; ms per
    GN iteration of both; then phase 13's ``smooth-trajectory --mesh``
    (its output ``mesh_said``; no kernel launched, as phase 13 checked),
    its poses within SCHUR_POS_TOL_M of phase 13's dense smoothing.
    Returns what the checks found; raises on a failed one."""
    import numpy as np

    from cuahn_vio_torch import cli as tcli
    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.parallel import pose_graph as pg
    from cuahn_vio_torch.parallel import pose_graph_sharded as pgs
    from cuahn_vio_torch.parallel.mesh import make_mesh

    est, loops = os.path.join(loop_dir, "est.txt"), os.path.join(loop_dir, "loops.txt")
    args = tcli.build_parser().parse_args(
        ["smooth-trajectory", est, "--loops-file", loops, "--out", os.devnull])
    _, graph = tcli.smoothing_graph(args, dev)
    mesh = make_mesh(dev)
    sg = pgs.partition_graph(graph, SCHUR_BLOCKS)
    reset_launch_counts()
    p_dense, _, _ = pg.optimize(graph, iters=args.iters)
    first = pgs.optimize_sharded(sg, mesh, iters=args.iters)
    same = all(all(torch.equal(x, y) for x, y in zip(pgs.optimize_sharded(sg, mesh,
                                                                          iters=args.iters),
                                                     first))
               for _ in range(GN_REPEATS - 1))
    p, _ = pgs.reassemble(sg, *first[:4], mesh)
    costs = first[4].cpu().numpy()
    diff = float(np.abs(p - p_dense.cpu().numpy()).max())
    out = dict(unknowns=6 * len(graph.p), blocks=SCHUR_BLOCKS, separators=len(sg.sep_idx),
               interiors_per_block=int(sg.int_idx.shape[1]),
               factors_per_block=int(sg.pos_i.shape[1]), max_pos_diff_from_dense_m=diff,
               cost_first=float(costs[0]), cost_last=float(costs[-1]),
               **{f"bit_identical_x{GN_REPEATS}": same})
    if any(launch_counts.values()):
        raise AssertionError(f"the smoothers launched kernels: {dict(launch_counts)}")
    if not same:
        raise AssertionError("the Schur smoother's repeats differ")
    if not (diff <= SCHUR_POS_TOL_M and costs[-1] <= SCHUR_COST_DROP * costs[0]):
        raise AssertionError(f"Schur smoother: {diff:.3e} m from the dense solve, cost "
                             f"{costs[0]:.4g} -> {costs[-1]:.4g}")
    for name, fn in (("schur", lambda n: pgs.optimize_sharded(sg, mesh, iters=n)),
                     ("dense", lambda n: pg.optimize(graph, iters=n))):
        ms = gn_call_ms(torch, fn)
        out[f"{name}_ms_per_iteration"] = (ms[11] - ms[1]) / 10
    meshed = load_pose_file(os.path.join(loop_dir, "smoothed_mesh.txt")).poses
    dense = load_pose_file(os.path.join(loop_dir, "smoothed.txt")).poses
    out["cli_mesh_max_pos_diff_from_dense_m"] = float(np.abs(meshed[:, :3] - dense[:, :3]).max())
    if "sharded GN over 1 devices" not in mesh_said or not (
            out["cli_mesh_max_pos_diff_from_dense_m"] <= SCHUR_POS_TOL_M):
        raise AssertionError(f"smooth-trajectory --mesh: {mesh_said!r}, "
                             f"{out['cli_mesh_max_pos_diff_from_dense_m']:.3e} m from dense")
    return out


def selftest_verb(tmp: str) -> tuple[str, dict]:
    """Phase 16c's verb: ``distributed-selftest`` through the CLI as one
    process on the card, writing ``tmp``/selftest.json (run beside phase
    13's smoothings)."""
    return cli(["distributed-selftest", "--out", "selftest.json"], tmp)


def run_selftest_phase(torch, dev, tmp: str, counts: dict) -> dict:
    """Phase 16c: the checksums of ``selftest_verb`` (its launch counts
    ``counts``) within SELFTEST_RTOL of JAX_SELFTEST; then the ``--bench``
    workload in this process at SELFTEST_BENCH's size (its rate). Returns
    what the checks found; raises on a failed one."""
    import numpy as np

    from cuahn_vio_torch.parallel.selftest import run_selftest_bench

    with open(os.path.join(tmp, "selftest.json")) as f:
        res = json.load(f)
    out = {k: res[k] for k in ("n_processes", "n_devices", "device", "filter_pos_checksum",
                               "filter_cov_checksum", "pose_checksum", "pose_final_cost")}
    for key, want in JAX_SELFTEST.items():
        if not np.isclose(res[key], want, rtol=SELFTEST_RTOL, atol=0):
            raise AssertionError(f"selftest {key} {res[key]!r} against JAX {want!r}")
    if res["n_processes"] != 1 or not res["device"].startswith("cuda") or any(counts.values()):
        raise AssertionError(f"selftest ran as {res}, launches {counts}")
    bench = run_selftest_bench(device=dev, **SELFTEST_BENCH)
    out.update(bench_frames=bench["bench_frames"], bench_seconds=bench["bench_seconds"],
               bench_frames_per_s=bench["bench_frames_per_s"], **SELFTEST_BENCH)
    return out


def run_batch_mesh_and_verbs(torch, dev, seqs, results, opts, tmp: str, cli_dir: str) -> dict:
    """Phase 16d in ``tmp``: ``run-vio-batch --mesh`` (in this process, the
    CLI's ``main``) on phase 6's sequences cut to their first
    MESH_BATCH_FRAMES frame pairs, each pose file equal byte for byte to
    those frames of phase 6's result (``results``, the run without
    ``--mesh``) written as the verb writes them; then ``error-dataset``,
    ``error-comparison`` (their ATE that of ``error-singlerun`` on the same
    file, to the 4 decimals they print), ``align-trajectory``,
    ``timing-comparison`` (on phase 10's timing csv) and ``pid-monitor`` of
    a child process (one JSON line, the JAX verb's keys), as subprocesses
    side by side. Returns what the checks found."""
    import contextlib
    import io

    import numpy as np

    from cuahn_vio_torch import cli as tcli
    from cuahn_vio_torch.eval.traj_io import save_pose_file
    from cuahn_vio_torch.ops import warp
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.ops.cuda.warp import KERNEL

    path = lambda *parts: os.path.join(tmp, *parts)  # noqa: E731
    for sub in ("nomesh", "gt", os.path.join("algos", "port")):
        os.makedirs(path(sub), exist_ok=True)
    names = [f"seq{i}" for i in range(len(seqs))]
    k = MESH_BATCH_FRAMES
    for name, s, res in zip(names, seqs, results):
        cut = cut_sequence(s, res, k)
        np.savez(path(f"{name}.npz"), imu_t=cut.imu_t, imu_w=cut.imu_w, imu_a=cut.imu_a,
                 cam_t=cut.cam_t, frames=cut.frames)
        save_pose_file(path("gt", f"{name}.txt"), s.gt_times, s.gt_pose_w)
        save_pose_file(path("nomesh", f"{name}.txt"), res.times[:k], res.pose_w[:k],
                       res.cov_ori[:k], res.cov_pos[:k])
    opts.to_yaml(path("batch_config.yaml"))
    warp.BATCH_SAMPLER = "full"
    reset_launch_counts()
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        tcli.main(["run-vio-batch", *[path(f"{n}.npz") for n in names], "--config",
                   path("batch_config.yaml"), "--weights", WEIGHTS, "--out-dir",
                   path("algos", "port"), "--mesh"])
    out = dict(batch_frames=k, batch_mesh_s=round(time.perf_counter() - t0, 3),
               batch_mesh_warp_launches=launch_counts[KERNEL],
               batch_mesh_threefry_launches=launch_counts["threefry"])
    if f"sharding {len(names)} sequences over 1 devices" not in said.getvalue():
        raise AssertionError(f"run-vio-batch --mesh said {said.getvalue()!r}")
    unequal = [n for n in names if open(path("algos", "port", f"{n}.txt"), "rb").read()
               != open(path("nomesh", f"{n}.txt"), "rb").read()]
    out["batch_mesh_files_equal"] = not unequal
    if unequal:
        raise AssertionError(f"run-vio-batch --mesh: {unequal} differ from phase 6's run")

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        (sr, _), (ds, _), (cmp, _), (al, _), (tc, _), (pm, _) = side_by_side(
            (cli, ["error-singlerun", "se3", path("gt", "seq0.txt"),
                   path("algos", "port", "seq0.txt")], tmp),
            (cli, ["error-dataset", "se3", path("gt", "seq0.txt"), path("nomesh")], tmp),
            (cli, ["error-comparison", "se3", path("gt"), path("algos")], tmp),
            (cli, ["align-trajectory", path("gt", "seq0.txt"),
                   path("algos", "port", "seq0.txt"), "--method", "se3", "--out",
                   path("aligned_gt.txt")], tmp),
            (cli, ["timing-comparison", os.path.join(cli_dir, "t.csv")], tmp),
            (cli, ["pid-monitor", str(child.pid), "--duration", "1.0"], tmp))
    finally:
        child.kill()
        child.wait()
    singlerun = float(sr.split("pos: rmse ")[1].split()[0])
    dataset = float(ds.splitlines()[1].split()[1])  # the seq0 row
    row = cmp.splitlines()[-1].split()  # port, then one column a sequence
    comparison = float(row[1])
    out.update(ate_error_singlerun_m=singlerun, ate_error_dataset_m=dataset,
               ate_error_comparison_m=comparison, error_comparison_row=" ".join(row))
    if not (abs(dataset - singlerun) <= 5e-5 and abs(comparison - singlerun) <= 5e-5):
        raise AssertionError(f"ATE: error-dataset {dataset}, error-comparison {comparison}, "
                             f"error-singlerun {singlerun}")
    out["align_trajectory"] = al.strip()
    out["timing_comparison_rows"] = len(tc.splitlines())
    summary = json.loads(pm.splitlines()[-1])
    out["pid_monitor"] = summary
    if set(summary) != {"samples", "cpu_mean_pct", "cpu_max_pct", "rss_mean_mb", "rss_max_mb"}:
        raise AssertionError(f"pid-monitor printed {summary}")
    return out


def kernel_entry(name, source_line, launches, err, row, ptxas, bound_by="bytes"):
    """One entry of the kernels line; ``ptxas`` is the kernel's
    ``build.ptxas_report`` entry (registers and spill bytes)."""
    return dict(
        name=name, route="cuda", source="cuahn_vio_torch/ops/cuda/warp.cu",
        replaces=f"cuahn_vio/ops/pallas/warp_kernel.py:{source_line}",
        launches=launches, max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=bound_by, library_ms=row["library_ms"],
        registers=ptxas["registers"], spill_stores=ptxas["spill_stores"],
        spill_loads=ptxas["spill_loads"],
    )


def sample_entry(sharp_launches, blur_launches, err, rows, ptxas, points_per_thread):
    """B4's entry of the kernels line: its launches at shapes 1 (sharp
    frames) and 2 (blurred frames) in phase 5, the times of shape 1 in the
    common fields, and each shape's times and bound under ``shapes``."""
    def compiled(shape):  # the instantiation a launch at ``shape`` runs (whole-word rows)
        b = {3: BATCH_TEXTURES, 4: FIL_BATCH, 5: FIL_PAIR_BATCH}.get(shape, 1)
        p = points_per_thread(b, 1, rows[shape]["points"] // b)
        return ptxas[f"flat_kernel<h,{p},1>"]

    entry = kernel_entry("bilinear_sample (make-synthetic texture, sharp and --exposure-ms)",
                         174, sharp_launches + blur_launches, err, rows[1], compiled(1))
    entry["launches_by_shape"] = {"1": sharp_launches, "2": blur_launches}
    entry["shapes"] = {
        str(shape): dict(points=row["points"], texels=row["texels"], ms=row["ms"],
                         plain_ms=row["plain_ms"], library_ms=row["library_ms"],
                         bound_ms=row["bound_ms"], launch_floor_ms=row["floor_ms"],
                         registers=compiled(shape)["registers"])
        for shape, row in rows.items()
    }
    return entry


def remap_entry(launches, err, rows, ptxas, paths, layout) -> dict:
    """C1's entry of the kernels line: not a TPU kernel (it replaces the JAX
    package's host C++ remap); its launches in phase 12, the times of a
    REMAP_FRAMES-frame batch in the common fields (hot L2; ``cold_ms`` with
    a cold one), each batch's times and bound under ``shapes``, the tiles
    of each parity map by path, and its compiled resources."""
    row = rows[REMAP_FRAMES]
    return dict(
        name=f"remap (convert-euroc, 640x480 -> {H}x{W}, N={REMAP_FRAMES})", route="cuda",
        source="cuahn_vio_torch/ops/cuda/remap.cu",
        replaces="cuahn_vio/runtime/undistort.cpp:92", tpu_kernel=False,
        launches=launches, max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by="bytes", library_ms=row["library_ms"],
        cold_ms=row["cold_ms"], registers=ptxas["registers"], smem_bytes=ptxas["smem_bytes"],
        spill_stores=ptxas["spill_stores"], spill_loads=ptxas["spill_loads"],
        tiles_by_path=paths, layout=layout,
        shapes={str(n): dict(ms=r["ms"], cold_ms=r["cold_ms"], plain_ms=r["plain_ms"],
                             library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                             launch_floor_ms=r["floor_ms"],
                             raw_bytes_read_per_frame=r["footprint"])
                for n, r in rows.items()},
    )


def prng_reference_checks(torch, dev, ref) -> dict:
    """Phase 3b, against JAX (``PRNG_REF``): the host keys exactly, T1's
    bits, uniform, bernoulli and randint (over PRNG_SPANS) bit for bit, its
    normals and truncated normals within PRNG_NORMAL_JAX_TOL, and the masks
    of phase 4's first network call. Returns what it found; raises on a
    failed check."""
    import numpy as np

    from cuahn_vio_torch.models.uahn import draw_masks
    from cuahn_vio_torch.pipeline.vio import sequence_mask_keys
    from cuahn_vio_torch.utils import prng

    base = prng.prng_key(42)
    host = dict(
        seed_keys=np.stack([prng.prng_key(s) for s in ref["seeds"].tolist()]),
        split6=prng.split(base, 6),
        fold_keys=prng.fold_in(base, ref["folds"]),
        draw_keys=prng.fold_in(base, np.arange(3)),
    )
    for name, got in host.items():
        if not np.array_equal(got, ref[name]):
            raise AssertionError(f"prng: host {name} {got.tolist()} != JAX's {ref[name].tolist()}")
    keys = prng.keys_tensor(host["draw_keys"], dev)
    n = ref["bits"].shape[1]
    drawn = dict(bits=prng.random_bits(keys, (n,)).cpu().numpy().view(np.uint32),
                 uniform=prng.uniform(keys, (n,), 0.3, 1.7).cpu().numpy(),
                 bernoulli=prng.bernoulli(keys, (n,), 0.95).cpu().numpy().astype(bool))
    for name, got in drawn.items():
        want = ref[name]
        if not np.array_equal(got.view(want.dtype) if got.dtype != want.dtype and
                              got.itemsize == want.itemsize else got, want):
            raise AssertionError(f"prng: T1 {name} differs from JAX's")
    for (lo, hi), want in zip(ref["spans"].tolist(), ref["randint"]):
        got = prng.randint(host["draw_keys"], (n,), lo, hi, dev).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"prng: T1 randint on [{lo}, {hi}) differs from JAX's")
    out = {}
    for name, draw in (("normal", lambda: prng.normal(keys, (n,))),
                       ("truncated_normal", lambda: prng.truncated_normal(keys, (n,), -2.0, 2.0))):
        got = draw().cpu().numpy()
        diff = out[f"{name}_max_abs_diff_from_jax"] = float(np.abs(got - ref[name]).max())
        if not (diff <= PRNG_NORMAL_JAX_TOL and np.array_equal(np.sign(got), np.sign(ref[name]))):
            raise AssertionError(f"prng: T1 {name} {diff:.3e} from JAX's (tol "
                                 f"{PRNG_NORMAL_JAX_TOL})")
    out["randint_equal_jax"] = True
    # phase 4's first network call: frame pair 0 of split(PRNGKey(0), F), IEKF
    # iteration 0 (split's first key is F's for every F)
    table = sequence_mask_keys(prng.split(prng.prng_key(0), 1), 1)
    call = prng.fold_in(prng.split(prng.prng_key(0), 1)[0], 0)
    if not np.array_equal(call, ref["mask_call_key"]):
        raise AssertionError(f"prng: phase 4's first call key {call} != JAX's")
    masks = draw_masks(prng.keys_tensor(table[0], dev), 0.05, 5120, dev)
    flat = [m for head in masks for m in head]
    for name, mask in zip(("mean0", "mean1", "logvar0", "logvar1"), flat):
        shape = tuple(ref[f"mask_{name}_shape"].tolist())
        want = np.unpackbits(ref[f"mask_{name}"])[:int(np.prod(shape))].reshape(shape)
        got = mask[0].cpu().numpy().astype(np.uint8)
        if got.shape != shape or not np.array_equal(got, want):
            raise AssertionError(f"prng: phase 4's first {name} mask differs from JAX's")
    out["masks_equal_jax"] = True
    return out


def check_init_uahn(torch, dev) -> dict:
    """Phase 3b: ``init_uahn(PRNGKey(0))`` built on the card (its kernels in
    one truncated-normal T1 launch) against the same build on the CPU
    (the plain version), every kernel value within PRNG_INIT_UNIT_TOL of
    its leaf's scale plus one rounding, biases 0; the card's build time
    (host clock, synchronized; the second of two builds). Returns what it
    found (with the largest difference in ulp); raises on a failed
    check."""
    import numpy as np

    from cuahn_vio_torch.models.uahn import TRUNC_NORMAL_STD, init_uahn
    from cuahn_vio_torch.ops.cuda import reset_launch_counts, threefry_launches_by_mode
    from cuahn_vio_torch.utils import prng

    init_uahn(prng.prng_key(0), device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = init_uahn(prng.prng_key(0), device=dev).state_dict()
    torch.cuda.synchronize()
    out = dict(card_build_ms=(time.perf_counter() - t0) * 1e3,
               launches_by_mode={k: v for k, v in threefry_launches_by_mode.items() if v})
    if out["launches_by_mode"] != {"truncated_normal": 1}:
        raise AssertionError(f"init_uahn on the card: T1 launches {out['launches_by_mode']}")
    t0 = time.perf_counter()
    cpu = init_uahn(prng.prng_key(0), device="cpu").state_dict()
    out["cpu_build_ms"] = (time.perf_counter() - t0) * 1e3
    ulps, unequal = 0, 0
    for name, want in cpu.items():
        got = card[name].cpu()
        if name.endswith(".bias"):
            if got.any() or want.any():
                raise AssertionError(f"init_uahn {name}: a bias is not 0")
            continue
        ulps = max(ulps, int((got.view(torch.int32).long() - want.view(torch.int32).long()
                              ).abs().max()))
        unequal += int((got != want).sum())
        a, b = got.numpy(), want.numpy()
        std = np.sqrt(np.float32(1.0 / got[0].numel())) / np.float32(TRUNC_NORMAL_STD)
        if not (np.abs(a - b) <= PRNG_INIT_UNIT_TOL * std + np.spacing(np.abs(b))).all():
            raise AssertionError(f"init_uahn {name}: the card's {np.abs(a - b).max():.3e} from "
                                 f"the CPU's")
    values = sum(v.numel() for v in cpu.values())
    out.update(leaves=len(cpu), values=values, max_ulps_from_cpu=ulps,
               unequal_share=unequal / values)
    return out


def t1_cases() -> dict:
    """{case: row counts} of T1's card cases: PRNG_CASES and the UAHN's
    kernels (PRNG_INIT_CASE)."""
    from cuahn_vio_torch.models.uahn import UAHN
    from cuahn_vio_torch.utils.checkpoint import flax_kernel_shape

    kernels = [math.prod(flax_kernel_shape(p.shape)) for n, p in UAHN().named_parameters()
               if n.endswith(".weight")]
    return dict(PRNG_CASES, **{PRNG_INIT_CASE: kernels})


def t1_modes(case: str) -> tuple:
    """The modes T1 draws ``case`` in: every mode, the UAHN's kernels in
    the truncated-normal mode only."""
    return ("truncated_normal",) if case == PRNG_INIT_CASE else tuple(T1_MODE_ARGS)


def check_prng(torch, dev) -> dict:
    """Phase 3b: T1 against JAX (``prng_reference_checks``), the card's
    ``init_uahn`` against the CPU's (``check_init_uahn``), and T1 against
    its plain version on the card at ``t1_cases`` in ``t1_modes``, then
    timed there, its bound the larger of its bytes at the HBM rate and its
    function's operations on the integer and float pipes
    (``sass_bound.t1_function_bound``, at the card's maximum SM clock; the
    bounds of the SASS that the kernel issues, without and with its row
    search, ``sass_bound.t1_bound``, beside it). Returns {"reference": ..., "init": ..., "cases":
    {case: {mode: row}}}; raises on a failed check."""
    import numpy as np

    import sass_bound
    from cuahn_vio_torch.ops.cuda import build
    from cuahn_vio_torch.ops.cuda import prng as prng_cuda
    from cuahn_vio_torch.utils import prng

    with np.load(os.path.join(REPO, PRNG_REF)) as ref:
        found = {"reference": prng_reference_checks(torch, dev, dict(ref))}
    found["init"] = check_init_uahn(torch, dev)
    sass = sass_bound.sass_pipes(sass_bound.disassemble(build.library_path(prng_cuda.SOURCE)))
    sms, _, max_mhz = sass_bound.card_clock(torch)
    found["cases"] = {}
    for case, counts in t1_cases().items():
        keys = prng.keys_tensor(prng.split(prng.prng_key(len(counts)), len(counts)), dev)
        rows = found["cases"][case] = {}
        for name in t1_modes(case):
            mode = prng.MODE_NAMES.index(name)
            a, b = T1_MODE_ARGS[name]
            out = prng.draw(keys, counts, mode, a, b)
            ref = prng.draw_plain(keys, counts, mode, a, b)
            torch.cuda.synchronize()
            if out.dtype != ref.dtype or out.shape != ref.shape:
                raise AssertionError(f"T1 {case} {name}: {out.dtype} {tuple(out.shape)}, plain "
                                     f"{ref.dtype} {tuple(ref.shape)}")
            if mode in (prng.NORMAL, prng.TRUNC_NORMAL):
                ulps = int((out.view(torch.int32).long() - ref.view(torch.int32).long()
                            ).abs().max())
                if ulps > PRNG_NORMAL_ULPS or not torch.equal(torch.sign(out), torch.sign(ref)):
                    raise AssertionError(f"T1 {case} {name}: {ulps} ulp from its plain version")
                err = float((out - ref).abs().max())
            else:
                if not torch.equal(out, ref):
                    raise AssertionError(f"T1 {case} {name}: not its plain version bit for bit")
                ulps, err = 0, 0.0
            values = sum(counts)
            run = prng_cuda.values_per_thread(mode, values)
            issue = sass_bound.t1_bound(sass[f"threefry_kernel<{mode},{run}>"], len(counts),
                                        values, run, sms, max_mhz)
            function = sass_bound.t1_function_bound(name, values, sms, max_mhz)
            moved = values * PRNG_OUT_BYTES[name] + 8 * len(counts) + 8 * (len(counts) + 1)
            bound_ops, bound_bytes = function["bound_ms"], moved / HBM_BYTES_PER_S * 1e3
            rows[name] = dict(
                keys=len(counts), values=values, run=run, max_abs_err=err, ulps=ulps,
                ms=time_graph_ms(torch, lambda: prng.draw(keys, counts, mode, a, b)),
                plain_ms=time_ms(torch, lambda: prng.draw_plain(keys, counts, mode, a, b), 5),
                bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                bound_pipe=function["bound_by"], sass_draw_bound_ms=issue["draw_bound_ms"],
                sass_kernel_bound_ms=issue["bound_ms"], library_ms=None)
    return found


def prng_entry(launches_by_phase: dict, by_mode: dict, found: dict, ptxas: dict) -> dict:
    """T1's entry of the kernels line: not a TPU kernel (XLA lowers
    threefry itself); its launches in phase 4 (the main path) and by phase,
    its launches by mode where a phase counted them (``by_mode``: {phase:
    {mode: launches}}, and their sum), the MC-dropout masks' draw
    (bernoulli, K = 4) in the common fields, every case and mode under
    ``shapes``, and the card's ``init_uahn``. No PyTorch call computes this
    function (torch.rand is Philox), so ``library_ms`` is null."""
    row = found["cases"]["masks K=4"]["bernoulli"]
    compiled = ptxas[f"threefry_kernel<2,{row['run']}>"]
    spills = [(k["spill_stores"], k["spill_loads"]) for k in ptxas.values()]
    total = {}
    for counts in by_mode.values():
        for mode, n in counts.items():
            total[mode] = total.get(mode, 0) + n
    return dict(
        name="threefry (MC-dropout masks, K=4 bernoulli; the trainers' draws, sensor-effects "
             "normals, init_uahn's truncated normals)",
        route="cuda", source="cuahn_vio_torch/ops/cuda/prng.cu",
        replaces="jax/_src/prng.py:1184 (threefry_random_bits, lowered by XLA)",
        tpu_kernel=False, launches=launches_by_phase["4"], launches_by_phase=launches_by_phase,
        launches_by_mode=total, launches_by_mode_by_phase=by_mode,
        max_abs_err=max(r["max_abs_err"] for c in found["cases"].values() for r in c.values()),
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None, registers=compiled["registers"],
        registers_by_kernel={k: v["registers"] for k, v in sorted(ptxas.items())},
        spill_stores=max(st for st, _ in spills), spill_loads=max(ld for _, ld in spills),
        normal_max_abs_diff_from_jax=found["reference"]["normal_max_abs_diff_from_jax"],
        truncated_normal_max_abs_diff_from_jax=found["reference"][
            "truncated_normal_max_abs_diff_from_jax"],
        init_uahn=found["init"],
        shapes={f"{case} {mode}": r for case, rows in found["cases"].items()
                for mode, r in rows.items()},
    )


def expect_t1(what: str, got: int, want: int) -> None:
    """T1 launched ``got`` times where ``want`` network calls (or frames of
    noise) drew from it."""
    if got != want:
        raise AssertionError(f"{what}: {got} threefry launches, expected {want}")


def main() -> int:
    t_all = time.perf_counter()
    faulthandler.dump_traceback_later(WALL_LIMIT_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from cuahn_vio_torch.ops.cuda import conv as conv_cuda
        from cuahn_vio_torch.ops.cuda import heads as heads_cuda
        from cuahn_vio_torch.ops.cuda import prng as prng_cuda
        from cuahn_vio_torch.ops.cuda import remap as remap_cuda
        from cuahn_vio_torch.ops.cuda import warp as warp_cuda
        from cuahn_vio_torch.ops.homography import f32_parity_mode
    except ImportError as exc:
        print(f"chip_smoke: the port's sources are not beside this script: {exc}",
              file=sys.stderr)
        return 2
    if not os.path.exists(WEIGHTS):
        print(f"chip_smoke: weights missing: {WEIGHTS}", file=sys.stderr)
        return 2
    if (not all(BATCH_ATE_BARS_M) or RAW_ATE_BAR_M is None or LOOP_ATE_BAR_M is None
            or TUNE_ATE_TOL_M is None or JAX_SELFTEST is None):
        print("chip_smoke: BATCH_ATE_BARS_M, RAW_ATE_BAR_M, LOOP_ATE_BAR_M, TUNE_ATE_TOL_M or "
              "JAX_SELFTEST not set (smoke_reference.py)", file=sys.stderr)
        return 2
    import numpy as np

    from cuahn_vio_torch.eval.align import ate_rmse

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    f32_parity_mode()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build_s = build_kernels()
    ptxas = warp_cuda.ptxas_report()
    remap_ptxas = remap_cuda.ptxas_report()["remap_kernel"]
    prng_ptxas = prng_cuda.ptxas_report()
    conv_ptxas = conv_cuda.ptxas_report()
    heads_ptxas = heads_cuda.ptxas_report()
    for kern, info in (sorted(ptxas.items()) + [("remap_kernel", remap_ptxas)]
                       + sorted(prng_ptxas.items()) + sorted(conv_ptxas.items())
                       + sorted(heads_ptxas.items())):
        print(f"  {kern}: {info['registers']} registers, {info['smem_bytes']} B shared, "
              f"{info['stack_bytes']} B stack, spill stores {info['spill_stores']} B, "
              f"spill loads {info['spill_loads']} B", flush=True)
    phase("build", t0, nvcc_s="{" + ", ".join(f"{k}: {v:.3f}" for k, v in build_s.items()) + "}",
          threads_per_block=warp_cuda.threads_per_block(), band_bytes=warp_cuda.band_bytes(),
          remap_layout=remap_layout_checked(remap_cuda),
          remap_grid_n165=remap_cuda.grid(REMAP_FRAMES, H, W))

    t0 = time.perf_counter()
    warp_errs = check_kernel(torch, dev)
    rowskip_err = check_rowskip(torch, dev)
    sample_errs = check_sample(torch, dev)
    remap_err, remap_paths = check_remap(torch, dev)
    conv_errs = check_conv(torch, dev)
    conv_worst = {}  # {kernel}_max_abs_err and {kernel}_max_share_of_bound, V1's then V2's
    for kernel in conv_cuda.KERNELS:  # V2K's under the split path's launch_counts key
        errs = [(e, sh) for k, e, sh in conv_errs.values() if k is kernel]
        name = conv_cuda.SPLIT_NAME if kernel.splits else kernel.name
        conv_worst[f"{name}_max_abs_err"] = f"{max(e for e, _ in errs):.3e}"
        conv_worst[f"{name}_max_share_of_bound"] = f"{max(sh for _, sh in errs):.4f}"
    heads_errs = check_heads(torch, dev)
    for name, (err, share) in heads_errs.items():
        conv_worst[f"mc_heads_{name}_max_abs_err"] = f"{err:.3e}"
        conv_worst[f"mc_heads_{name}_max_share_of_bound"] = f"{share:.3e}"
    phase("parity", t0, warp_max_abs_err=f"{max(warp_errs.values()):.3e}",
          rowskip_max_abs_err=f"{rowskip_err:.3e}",
          sampler_frame_shapes_max_abs_err=f"{sample_errs['frame']:.3e}",
          sampler_batch_shapes_max_abs_err=f"{sample_errs['batch']:.3e}",
          sampler_max_abs_err=f"{sample_errs['all']:.3e}", remap_max_abs_err=remap_err,
          **conv_worst)

    t0 = time.perf_counter()
    times = time_kernel(torch, dev)
    sample_time = time_sample(torch, dev)
    remap_time = time_remap(torch, dev)
    conv_time = time_conv(torch, dev)
    for (label, b), row in conv_time.items():
        whole = (f", V2's whole-K tiling {row['whole_ms']:.5f} ms"
                 if row["whole_ms"] is not None else "")
        print(f"  {conv_label(row['kernel'])} {label} B={b}: {row['ms']:.5f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['gflop']:.3f} GFLOP at 67 TFLOP/s, "
              f"{100 * row['bound_ms'] / row['ms']:.1f} %), plain {row['plain_ms']:.4f} ms, "
              f"cuDNN's best (library_ms, {row['library_layout']}) {row['library_ms']:.5f} ms "
              f"+ LeakyReLU {row['leaky_ms']:.5f} ms{whole}", flush=True)
    heads_time = time_heads(torch, dev)
    for b, row in heads_time.items():
        print(f"  H1 B={b}: {row['ms']:.5f} ms, bound {row['bound_ms']:.5f} ms ({row['gflop']:.3f} "
              f"GFLOP at 67 TFLOP/s, {100 * row['bound_ms'] / row['ms']:.1f} %), eager heads "
              f"stage {row['eager_ms']:.5f} ms, plain {row['plain_ms']:.4f} ms; call to call "
              f"{row['ms_host']:.4f} ms, eager stage {row['eager_ms_host']:.4f} ms", flush=True)
    gpu = gpu_name_and_power()
    phase("timing", t0, gpu=f"'{gpu}'")

    t0 = time.perf_counter()
    prng_found = check_prng(torch, dev)
    for case, rows in prng_found["cases"].items():
        for mode, r in rows.items():
            print(f"  T1 {case} {mode}: {r['values']} values, runs of {r['run']}, "
                  f"{r['ms']:.5f} ms, plain "
                  f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}, "
                  f"{r['bound_pipe']}; the kernel's SASS {r['sass_draw_bound_ms']:.6f} ms, "
                  f"with the row search {r['sass_kernel_bound_ms']:.6f} ms), "
                  f"{r['ulps']} ulp", flush=True)
    init = prng_found["init"]
    print(f"  init_uahn: {init['leaves']} leaves, {init['values']} values, card "
          f"{init['card_build_ms']:.1f} ms, CPU {init['cpu_build_ms']:.1f} ms, "
          f"{init['max_ulps_from_cpu']} ulp apart", flush=True)
    phase("prng", t0, gpu=f"'{gpu}'", **prng_found["reference"],
          init_uahn_card_ms=f"{init['card_build_ms']:.3f}",
          init_uahn_ulps_from_cpu=init["max_ulps_from_cpu"])
    t1_launches = {}
    t1_by_mode = {"3b init_uahn": init["launches_by_mode"]}

    t0 = time.perf_counter()
    launches, steps, iekf, ms_frame, ate_pos, ate_ori, (seq, opts, model, slice_res) = \
        run_slice(torch, dev)
    warp_launches = launches[warp_cuda.KERNEL]
    t1_launches["4"] = launches[prng_cuda.KERNEL]
    t1_by_mode["4"] = launches["threefry_by_mode"]
    phase("slice", t0, frames=steps, ms_per_frame=f"{ms_frame:.3f}",
          warp_launches=warp_launches, threefry_launches=t1_launches["4"],
          lowc_conv_launches=launches[conv_cuda.V1.name],
          conv_gemm_launches=launches[conv_cuda.V2.name],
          conv_gemm_split_launches=launches[conv_cuda.SPLIT_NAME],
          mc_heads_launches=launches["mc_heads"],
          ate_pos_m=f"{ate_pos:.5f}",
          ate_ori_deg=f"{ate_ori:.4f}", ate_bar_m=f"{ATE_BAR_M:.5f}")
    if warp_launches != 3 * steps * iekf:
        raise AssertionError(
            f"warp launched {warp_launches}x, expected 3 x {steps} x {iekf}"
        )
    expect_t1("slice", t1_launches["4"], steps * iekf)
    for name, label, per_call, layers in (
            (conv_cuda.V1.name, "V1", 3, "block 3's conv0, block 4's conv0 and conv1"),
            (conv_cuda.V2.name, "V2", 14, "the other layers of blocks 2-4"),
            (conv_cuda.SPLIT_NAME, "V2K", SPLIT_LAUNCHES_PRIOR,
             "V2's split path: the split GEMM and the sum of the splits, six layers"),
            ("mc_heads", "H1", heads_cuda.LAUNCHES, "fc0 of both heads, then the tail")):
        if launches[name] != per_call * steps * iekf:
            raise AssertionError(f"{label} launched {launches[name]}x, expected "
                                 f"{per_call} x {steps} x {iekf} ({layers} a call)")
    if not ate_pos <= ATE_BAR_M:
        raise AssertionError(f"ATE {ate_pos:.5f} m above the bar {ATE_BAR_M:.5f} m")

    t0 = time.perf_counter()
    tex_seqs, tex_launches, rendered = make_textured(torch, dev)
    sample_launches = tex_launches[warp_cuda.SAMPLE_KERNEL]
    phase("textured", t0, sequences=len(tex_seqs), frames=rendered,
          sampler_launches=sample_launches)
    if sample_launches != rendered:
        raise AssertionError(f"sampler launched {sample_launches}x for {rendered} frames")
    t0 = time.perf_counter()
    blur_frames, blur_launches, unequal, unblurred = make_blurred(torch, dev)
    phase("blurred", t0, exposure_ms=EXPOSURE_S * 1e3, frames=blur_frames,
          sampler_launches=blur_launches, frames_unequal_to_tap_mean=unequal,
          frames_equal_to_sharp=unblurred)
    if blur_launches != blur_frames:
        raise AssertionError(f"sampler launched {blur_launches}x for {blur_frames} blurred frames")
    if unequal or unblurred:
        raise AssertionError(f"{unequal} blurred frames differ from the mean of their taps, "
                             f"{unblurred} equal their sharp render")

    t0 = time.perf_counter()
    batch_seqs = [seq] + tex_seqs
    results, b_launches, b_seconds = run_batched(torch, dev, batch_seqs, opts, model)
    n_frames = [len(r.times) for r in results]
    f_max = max(n_frames)
    batch_warp_launches = b_launches[warp_cuda.KERNEL]
    ates = [ate_rmse(r.times, r.pose_w, s.gt_times, s.gt_pose_w)[1]
            for r, s in zip(results, batch_seqs)]
    phase("batched", t0, sequences=len(results), frames=n_frames, lockstep_frames=f_max,
          ms_per_lockstep_frame=f"{b_seconds * 1e3 / f_max:.3f}",
          sequence_frames_per_s=f"{sum(n_frames) / b_seconds:.2f}",
          warp_launches=batch_warp_launches,
          ate_pos_m="[" + ", ".join(f"{a:.5f}" for a in ates) + "]",
          ate_bars_m="[" + ", ".join(f"{b:.5f}" for b in BATCH_ATE_BARS_M) + "]")
    if batch_warp_launches != 3 * f_max * iekf:
        raise AssertionError(f"batched warp launched {batch_warp_launches}x, "
                             f"expected 3 x {f_max} x {iekf}")
    if b_launches[warp_cuda.ROWSKIP_KERNEL] != 0:
        raise AssertionError("the row-band warp ran under BATCH_SAMPLER='full'")
    t1_launches["6"] = b_launches[prng_cuda.KERNEL]
    expect_t1("batched", t1_launches["6"], f_max * iekf)
    for i, (a, bar) in enumerate(zip(ates, BATCH_ATE_BARS_M)):
        if not a <= bar:
            raise AssertionError(f"batched sequence {i}: ATE {a:.5f} m above the bar {bar:.5f} m")

    t0 = time.perf_counter()
    skip_results, s_launches = run_rowskip(torch, dev, batch_seqs, opts, model, ROWSKIP_FRAMES)
    rowskip_launches = s_launches[warp_cuda.ROWSKIP_KERNEL]
    pos_diff = max(float(np.abs(r.pose_w[:, :3] - f.pose_w[:len(r.times), :3]).max())
                   for r, f in zip(skip_results, results))
    phase("rowskip", t0, lockstep_frames=ROWSKIP_FRAMES, rowskip_launches=rowskip_launches,
          warp_launches=s_launches[warp_cuda.KERNEL], max_pos_diff_m=f"{pos_diff:.3e}",
          tol_m=f"{ROWSKIP_POS_TOL_M:.0e}")
    if rowskip_launches != 3 * ROWSKIP_FRAMES * iekf or s_launches[warp_cuda.KERNEL] != 0:
        raise AssertionError(f"rowskip run: {s_launches}, expected "
                             f"3 x {ROWSKIP_FRAMES} x {iekf} row-band launches only")
    if not pos_diff <= ROWSKIP_POS_TOL_M:
        raise AssertionError(f"rowskip poses {pos_diff:.3e} m from the full run's")
    t1_launches["7"] = s_launches[prng_cuda.KERNEL]
    expect_t1("rowskip", t1_launches["7"], ROWSKIP_FRAMES * iekf)

    b1_launches = {"4": warp_launches}
    for staged in (True, False):
        t0 = time.perf_counter()
        sw, sw_launches, sw_seconds = run_stepwise_phase(
            torch, dev, cut_sequence(seq, slice_res, STEPWISE_FRAMES), opts, model, staged)
        mode = "staged" if staged else "fused"
        b1_launches[f"8 {mode}"] = sw_launches[warp_cuda.KERNEL]
        diff = float(np.abs(sw.pose_w[:, :3] - slice_res.pose_w[:len(sw.times), :3]).max())
        median = np.median(sw.stage_ms, axis=0)  # fused: the whole step under "net"
        phase("stepwise", t0, mode=mode, frames=len(sw.times),
              ms_per_frame=f"{sw_seconds * 1e3 / len(sw.times):.3f}",
              warp_launches=sw_launches[warp_cuda.KERNEL],
              n_recoveries=sw.n_recoveries, max_pos_diff_m=f"{diff:.3e}",
              tol_m=f"{STEPWISE_POS_TOL_M:.0e}",
              **{f"median_{c}_ms": f"{m:.3f}" for c, m in zip(
                  ("load", "prop", "net", "update", "total"), median)})
        t1_launches[f"8 {mode}"] = sw_launches[prng_cuda.KERNEL]
        expect_t1(f"stepwise {mode}", t1_launches[f"8 {mode}"], (len(sw.times) + 1) * iekf)
        want = 3 * (len(sw.times) + 1) * iekf  # + the warm-up step
        if (sw_launches[warp_cuda.KERNEL] != want
                or sw_launches[warp_cuda.ROWSKIP_KERNEL] or sw_launches[warp_cuda.SAMPLE_KERNEL]):
            raise AssertionError(f"stepwise {mode}: {sw_launches}, expected {want} warp "
                                 "launches only")
        if sw.n_recoveries or not np.isfinite(sw.pose_w).all():
            raise AssertionError(f"stepwise {mode}: {sw.n_recoveries} rollbacks or "
                                 "non-finite poses")
        if sw.stage_ms.shape != (len(sw.times), 5) or len(sw.times) != STEPWISE_FRAMES:
            raise AssertionError(f"stepwise {mode}: stage_ms {sw.stage_ms.shape}")
        if not diff <= STEPWISE_POS_TOL_M:
            raise AssertionError(f"stepwise {mode}: poses {diff:.3e} m from phase 4's")

    t0 = time.perf_counter()
    bf, bf_launches, bf_ms = run_bf16(torch, dev, seq, opts)
    b1_launches["9"] = bf_launches[warp_cuda.KERNEL]
    t1_launches["9"] = bf_launches[prng_cuda.KERNEL]
    expect_t1("bf16", t1_launches["9"], steps * iekf)
    bf_ori, bf_pos = ate_rmse(bf.times, bf.pose_w, seq.gt_times, seq.gt_pose_w)
    phase("bf16", t0, frames=len(bf.times), ms_per_frame=f"{bf_ms:.3f}",
          float32_ms_per_frame=f"{ms_frame:.3f}", warp_launches=bf_launches[warp_cuda.KERNEL],
          ate_pos_m=f"{bf_pos:.5f}", ate_ori_deg=f"{bf_ori:.4f}",
          ate_bar_m=f"{BF16_ATE_BAR_M:.5f}")
    if bf_launches[warp_cuda.KERNEL] != 3 * steps * iekf or not np.isfinite(bf.pose_w).all():
        raise AssertionError(f"bf16 run: {bf_launches}, expected 3 x {steps} x {iekf} warp "
                             "launches and finite poses")
    if not bf_pos <= BF16_ATE_BAR_M:
        raise AssertionError(f"bf16 ATE {bf_pos:.5f} m above the bar {BF16_ATE_BAR_M:.5f} m")

    cli_dir = tempfile.TemporaryDirectory()  # phase 10's files, read again in phase 12
    t0 = time.perf_counter()
    found = run_cli(cli_dir.name)
    b1_launches["10"] = found["warp_launches"]
    t1_launches["10"] = found["threefry_launches"]
    phase("cli", t0, **found)
    expect_t1("run-vio --timing-out", found["threefry_launches"], (found["poses"] + 1) * iekf)
    if found["warp_launches"] != 3 * (found["poses"] + 1) * iekf or found["other_launches"]:
        raise AssertionError(f"run-vio --timing-out: {found['warp_launches']} warp launches "
                             f"for {found['poses']} poses")

    t0 = time.perf_counter()
    trained = run_train(torch, dev, seq, opts)
    for i, run in enumerate(trained["runs"]):
        step_ms = run["ms_per_step"]
        phase("train", t0, run=i, gpu=f"'{gpu}'", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
              ms_per_step=f"{step_ms:.3f}", median_step_gap_ms=f"{run['median_gap_ms']:.3f}",
              samples_per_s=f"{run['samples_per_s']:.1f}",
              b4_share=f"{2 * sample_time[3]['ms'] / step_ms:.5f}",
              b2_share=f"{3 * times[('warp', 'float32', TRAIN_BATCH)]['ms'] / step_ms:.5f}",
              sampler_launches=run["sampler_launches"], warp_launches=run["warp_launches"],
              losses=run["logged_losses"], probe=f"'{run['probe']}'")
    draws = trained["draws"]
    phase("train", t0, weights_max_abs_diff_between_runs=f"{trained['weights_max_abs_diff']:.3e}",
          trained_ate_pos_m=f"{trained['trained_ate_pos_m']:.5f}",
          v10_ate_pos_m=f"{ate_pos:.5f}",
          step0_draws_max_abs_diff_from_jax=f"{draws['step0']['max_abs_diff_from_jax']:.3e}",
          probe_draws_max_abs_diff_from_jax=f"{draws['probe']['max_abs_diff_from_jax']:.3e}",
          batch_threefry_launches=draws["step0"]["launches_by_mode"],
          threefry_launches=trained["runs"][0]["threefry_launches"],
          threefry_launches_by_mode=trained["runs"][0]["threefry_launches_by_mode"])
    main_run = trained["runs"][0]  # the main path's launches: the first run's
    t1_launches["11"] = main_run["threefry_launches"]
    t1_by_mode["11"] = main_run["threefry_launches_by_mode"]
    batch_t1 = trained["draws"]["batch_launches"]
    probe_size = trained["probe_size"]
    phase11_weights = trained.pop("first_weights")

    loop_dir = tempfile.TemporaryDirectory()  # phase 13's files, read again in phase 16b
    parallel_dir = tempfile.TemporaryDirectory()  # phase 16's files
    # phase 10's plain run-vio and phase 13's first two verbs from here on, beside phase 12
    t_loop_run = time.perf_counter()
    plain = started(plain_run, cli_dir.name)
    loop_first = started(loop_run, loop_dir.name, iekf)
    t0 = time.perf_counter()
    raw = run_raw_chain(torch, dev, cli_dir.name, model, iekf)
    b1_launches["12"] = raw["warp_launches"]
    t1_launches["12"] = raw["threefry_launches_effects"] + raw["threefry_launches_run_vio"]
    phase("raw", t0, gpu=f"'{gpu}'", remap_device_ms=f"{remap_time[REMAP_FRAMES]['ms']:.5f}",
          remap_device_ms_n1=f"{remap_time[1]['ms']:.5f}", ate_bar_m=f"{RAW_ATE_BAR_M:.5f}",
          **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in raw.items()})
    if not raw["ate_pos_m"] <= RAW_ATE_BAR_M:
        raise AssertionError(f"raw-camera chain ATE {raw['ate_pos_m']:.5f} m above the bar "
                             f"{RAW_ATE_BAR_M:.5f} m")

    t0 = time.perf_counter()
    phase("cli", t0, part="the plain run-vio, started with phase 12", **plain.result())
    t0 = time.perf_counter()
    first = loop_first.result()
    phase("loop", t0, part="make-synthetic and run-vio, started with phase 12",
          waited_s=f"{time.perf_counter() - t0:.3f}",
          since_start_s=f"{time.perf_counter() - t_loop_run:.3f}")
    t0 = time.perf_counter()
    loop = run_loop(torch, dev, loop_dir.name, first,
                    {"selftest": lambda: selftest_verb(parallel_dir.name)})
    mesh_said = loop.pop("smooth_mesh_said")
    t1_launches["13"] = (loop["threefry_launches_effects"] + loop["threefry_launches_run_vio"]
                         + loop["threefry_launches_close_loops"])
    _, selftest_counts = loop.pop("selftest")
    phase("loop", t0, gpu=f"'{gpu}'", ate_bar_m=f"{LOOP_ATE_BAR_M:.5f}",
          jax_ate_pos_m_smoothed=f"{REF_LOOP_ATE_M:.5f}",
          **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in loop.items()})
    if not (loop["ate_pos_m_smoothed"] <= LOOP_ATE_BAR_M
            and loop["ate_pos_m_smoothed"] < loop["ate_pos_m_online"]):
        raise AssertionError(f"loop closure: smoothed ATE {loop['ate_pos_m_smoothed']:.5f} m, "
                             f"online {loop['ate_pos_m_online']:.5f} m, bar {LOOP_ATE_BAR_M:.5f}")

    t0 = time.perf_counter()
    fil_run = run_fil(torch, dev, {"cli": os.path.join(cli_dir.name, "seq_gt.txt"),
                                   "loop": os.path.join(loop_dir.name, "replay_gt.txt")},
                      seq, opts)
    t1_launches["14"] = fil_run["threefry_launches"]
    t1_by_mode["14"] = fil_run.pop("threefry_launches_by_mode")
    phase("fil", t0, gpu=f"'{gpu}'", steps=FIL_STEPS, window=FIL_WINDOW, batch=FIL_BATCH,
          v10_ate_pos_m=f"{ate_pos:.5f}",
          **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in fil_run.items()})

    t0 = time.perf_counter()
    vision = run_vision_checks(torch, dev, cli_dir.name)
    phase("diagnostics", t0, part="15a card vs CPU", **vision)
    t0 = time.perf_counter()
    diag = run_diagnostics(torch, dev, cli_dir.name)
    t1_launches["15"] = diag["threefry_launches"]
    phase("diagnostics", t0, part="15b verbs", gpu=f"'{gpu}'",
          flow_rmse_bars_px=FLOW_RMSE_BARS_PX,
          **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in diag.items()})

    t0 = time.perf_counter()
    sweep = run_sweep(torch, dev, seq, opts, parallel_dir.name)
    phase("sweep", t0, part="16a tune-filter", gpu=f"'{gpu}'", tol_m=TUNE_ATE_TOL_M, **sweep)
    t0 = time.perf_counter()
    schur = run_schur(torch, dev, loop_dir.name, mesh_said)
    phase("parallel", t0, part="16b Schur smoother", gpu=f"'{gpu}'", **schur)
    t0 = time.perf_counter()
    selftest = run_selftest_phase(torch, dev, parallel_dir.name, selftest_counts)
    phase("parallel", t0, part="16c distributed-selftest", gpu=f"'{gpu}'",
          jax=JAX_SELFTEST, **selftest)
    t0 = time.perf_counter()
    verbs = run_batch_mesh_and_verbs(torch, dev, batch_seqs, results, opts, parallel_dir.name,
                                     cli_dir.name)
    phase("parallel", t0, part="16d run-vio-batch --mesh and the eval verbs", **verbs)
    if verbs["batch_mesh_warp_launches"] != 3 * MESH_BATCH_FRAMES * iekf:
        raise AssertionError(f"run-vio-batch --mesh: {verbs['batch_mesh_warp_launches']} warp "
                             f"launches, expected 3 x {MESH_BATCH_FRAMES} x {iekf}")
    t1_launches["16"] = verbs["batch_mesh_threefry_launches"]
    expect_t1("run-vio-batch --mesh", t1_launches["16"], MESH_BATCH_FRAMES * iekf)

    t0 = time.perf_counter()
    dp = run_dp_train(torch, probe_size, batch_t1, phase11_weights)
    t1_launches["17"] = dp["threefry_launches"]
    t1_by_mode["17"] = dp["threefry_launches_by_mode"]
    phase("dp", t0, part="17a train-uahn, a one-rank NCCL job", gpu=f"'{gpu}'",
          ms_per_step=f"{dp['ms_per_step']:.3f}",
          phase11_ms_per_step=f"{main_run['ms_per_step']:.3f}",
          weights_max_abs_diff_from_phase11=f"{dp['weights_max_abs_diff_from_phase11']:.3e}",
          phase11_weights_max_abs_diff_between_runs=f"{trained['weights_max_abs_diff']:.3e}",
          tol=DP_WEIGHTS_TOL, sampler_launches=dp["sampler_launches"],
          warp_launches=dp["warp_launches"], losses=dp["logged_losses"],
          probe=f"'{dp['probe']}'")
    t0 = time.perf_counter()
    drawn = run_plots(cli_dir.name, loop_dir.name, parallel_dir.name)
    loop_dir.cleanup()
    cli_dir.cleanup()
    parallel_dir.cleanup()
    phase("plots", t0, part="17b the plot surfaces", **drawn)

    nb = len(batch_seqs)

    def compiled(kernel: str, b: int, t: str = "h") -> dict:  # a B-image launch's instantiation
        return ptxas[f"{kernel}<{t},{warp_cuda.pixels_per_thread(b, H, W)}>"]

    b4_points_per_thread = warp_cuda.pixels_per_thread(BATCH_TEXTURES, 1, 3 * H * W)
    fil_points_per_thread = warp_cuda.pixels_per_thread(FIL_BATCH, 1,
                                                        3 * (FIL_WINDOW + 1) * H * W)
    fil_pair_points_per_thread = warp_cuda.pixels_per_thread(FIL_PAIR_BATCH, 1, 3 * H * W)
    kernels = [
        kernel_entry("homography_warp (B=1, single-stream run-vio)", 154, warp_launches,
                     warp_errs[("uint8", 1)], times[("warp", "uint8", 1)],
                     compiled("warp_kernel", 1)),
        kernel_entry(f"homography_warp (B={nb}, run-vio-batch)", 468, batch_warp_launches,
                     warp_errs[("uint8", nb)], times[("warp", "uint8", nb)],
                     compiled("warp_kernel", nb)),
        kernel_entry(f"homography_warp_rowskip (B={nb}, run-vio-batch)", 403,
                     rowskip_launches, rowskip_err, times[("rowskip", "uint8", nb)],
                     compiled("rowskip_kernel", nb)),
        sample_entry(sample_launches, blur_launches, sample_errs["frame"], sample_time, ptxas,
                     warp_cuda.pixels_per_thread),
        kernel_entry(f"homography_warp (B={TRAIN_BATCH} float32, train-uahn)", 475,
                     main_run["warp_launches"],
                     max(warp_errs[("float32", b)] for b in (TRAIN_BATCH, probe_size)),
                     times[("warp", "float32", TRAIN_BATCH)],
                     compiled("warp_kernel", TRAIN_BATCH, "f")),
        kernel_entry("bilinear_sample (train-uahn batch, shape 3)", 174,
                     main_run["sampler_launches"], sample_errs["batch"], sample_time[3],
                     ptxas[f"flat_kernel<h,{b4_points_per_thread},1>"]),
    ]
    kernels[4]["launches_by_batch"] = {str(TRAIN_BATCH): 3 * TRAIN_STEPS, str(probe_size): 6}
    kernels[5]["launches_by_batch"] = {str(TRAIN_BATCH): 2 * TRAIN_STEPS, str(probe_size): 2}
    kernels[4]["launches_by_phase"] = {"11": main_run["warp_launches"],
                                       "17": dp["warp_launches"]}
    kernels[5]["launches_by_phase"] = {"11": main_run["sampler_launches"],
                                       "17": dp["sampler_launches"]}
    kernels[0]["launches_by_phase"] = b1_launches
    kernels[3]["launches_by_phase"] = {"5": sample_launches + blur_launches,
                                       "10": found["sampler_launches"],
                                       "12": raw["sampler_launches"]}
    kernels.append(remap_entry(raw["remap_launches"], remap_err, remap_time, remap_ptxas,
                               remap_paths, remap_cuda.layout()))
    kernels += [
        kernel_entry(f"homography_warp (B={b} uint8, close-loops)", 468 if b > 1 else 154,
                     row["launches"], row["max_abs_err"], row, compiled("warp_kernel", b))
        for b, row in loop["close_loops_by_batch"].items()
    ]
    kernels += [
        kernel_entry(f"homography_warp (B={FIL_BATCH} uint8, train-fil windows)", 468,
                     fil_run["warp_launches_fil"], warp_errs[("uint8", FIL_BATCH)],
                     times[("warp", "uint8", FIL_BATCH)], compiled("warp_kernel", FIL_BATCH)),
        kernel_entry(f"homography_warp (B={FIL_PAIR_BATCH} float32, train-fil pair steps)", 475,
                     fil_run["warp_launches_pair"], warp_errs[("float32", FIL_PAIR_BATCH)],
                     times[("warp", "float32", FIL_PAIR_BATCH)],
                     compiled("warp_kernel", FIL_PAIR_BATCH, "f")),
        kernel_entry(f"bilinear_sample (train-fil windows, {FIL_BATCH} textures, shape 4)", 174,
                     fil_run["sampler_launches_fil"], sample_errs["fil"], sample_time[4],
                     ptxas[f"flat_kernel<h,{fil_points_per_thread},1>"]),
        kernel_entry(f"bilinear_sample (train-fil pair steps, {FIL_PAIR_BATCH} textures, shape 5)",
                     174, fil_run["sampler_launches_pair"], sample_errs["pair"], sample_time[5],
                     ptxas[f"flat_kernel<h,{fil_pair_points_per_thread},1>"]),
    ]
    kernels.append(kernel_entry("homography_warp (B=1 float32, inspect-frame)", 165,
                                diag["inspect_warp_launches"], warp_errs[("float32", 1)],
                                times[("warp", "float32", 1)],
                                compiled("warp_kernel", 1, "f")))
    kernels += [
        kernel_entry(f"homography_warp (B={b} float32, eval-flow)", 475 if b > 1 else 165,
                     row["launches"], row["max_abs_err"], row, compiled("warp_kernel", b, "f"))
        for b, row in diag["eval_flow_by_batch"].items()
    ]
    kernels[0]["launches_by_phase"]["13"] = loop["run_vio_warp_launches"]
    kernels[1]["launches_by_phase"] = {"6": batch_warp_launches,
                                       "16": verbs["batch_mesh_warp_launches"]}
    kernels[3]["launches_by_phase"]["13"] = loop["sampler_launches"]
    kernels.append(prng_entry(t1_launches, t1_by_mode, prng_found, prng_ptxas))
    # each shape's kernel at close-loops' B = 64 (V2 there in its wide
    # tiling, `<..., 0>`; the B = 16 and B = 1 rows are phase 3's lines)
    kernels += [
        dict(name=f"{row['kernel'].name} ({label}, B=64, close-loops)", route="cuda",
             source=os.path.relpath(row["kernel"].source, REPO),
             replaces="none: cuDNN's conv2d, bias and LeakyReLU passes of the tower layer",
             launches=launches[row["kernel"].name], max_abs_err=conv_errs[label][1],
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by="flops",
             library_ms=row["library_ms"], leaky_ms=row["leaky_ms"],
             **{k: conv_ptxas_entry(conv_ptxas, row["kernel"], row["shape"])[k]
                for k in ("registers", "spill_stores", "spill_loads", "smem_bytes")})
        for (label, b), row in conv_time.items() if b == 64
    ]
    # H1 at close-loops' B = 64 (its wide tiling; B = 16 and 1 are phase 3's
    # lines): the two kernels' time together, each one's registers
    h1 = heads_time[64]
    kernels.append(dict(
        name="mc_heads (both heads, B=64, close-loops)", route="cuda",
        source=os.path.relpath(heads_cuda.SOURCE, REPO),
        replaces="none: cuBLAS's SIMT sgemm for fc0 and the eager dropout, fc1 and statistics",
        launches=launches["mc_heads"], max_abs_err=max(e for e, _ in heads_errs.values()),
        ms=h1["ms"], plain_ms=h1["plain_ms"], bound_ms=h1["bound_ms"], bound_by="flops",
        library_ms=h1["eager_ms"], compiled=heads_ptxas))
    print(f"total {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def stop_children() -> None:
    for proc in list(CHILDREN):
        proc.kill()


if __name__ == "__main__":
    watchdog = threading.Timer(WALL_LIMIT_S - 2, stop_children)  # before the wall limit's exit
    watchdog.daemon = True
    watchdog.start()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
