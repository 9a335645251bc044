#!/usr/bin/env python3
"""Where the time of the port's ``run-vio`` slice goes, on one GPU.

    python3 profile_slice.py [--batch | --train | --fil | --track]

Runs the slice of ``chip_smoke.py`` (same synthetic sequence, v10 weights,
calibrated profile, 16-member MC dropout) on its first FRAMES frame
pairs, after initialization and the first (seconds-long) IMU window: once
plain for the host-clock ms/frame, once under ``torch.profiler`` (CPU +
CUDA activity). With ``--batch``, the same for the smoke's batched phase:
its four sequences (the slice's and ``chip_smoke.TEX_SEQS``) in lockstep,
``BATCH_SAMPLER = "full"``; "frame" then means a lockstep frame of B = 4
sequences. With ``--train``, TRAIN_STEPS training steps of ``train-uahn``
(``chip_smoke.py`` phase 11's: v10 weights, batch 16, 224x320, photo
textures and effects) after TRAIN_WARMUP unprofiled ones; "frame" then
means a training step, and the labels ``train.batch`` (drawing and
rendering the batch) and ``train.step`` (forward, backward, optimizer)
split it. With ``--fil``, FIL_STEPS filter-in-the-loop steps of
``train-fil`` (``chip_smoke.py`` phase 14's: v10 weights, FIL_BATCH
windows of FIL_WINDOW frames, 224x320, 3 blur taps, on windows cut from
the loop-closure demo's pose file) after FIL_WARMUP unprofiled ones; a
"frame" is then a FIL step, split by the labels ``fil.forward`` (draws,
render, the filter recurrence with the network, the loss),
``fil.backward`` and ``fil.optimizer``. With ``--track``, the loop of
``track-features`` (``vision.klt.track_sequence``: grid detection, KLT,
the refill and the frame's one host read) over the slice sequence's first
FRAMES frame pairs, split by the labels ``track.klt`` and
``track.detect``. Prints one JSON line with:

- ``ms_per_frame``: host clock of the frame loop, profiler off;
  ``ms_per_frame_profiled``: the same under the profiler;
- ``device_busy_ms_per_frame``: the summed duration of every device
  activity (kernels, copies, memsets) in the profiled run (one stream, so
  activities do not overlap); ``idle_share``: 1 - busy / the unprofiled
  ms_per_frame (kernel durations do not change under the profiler, the host
  does); ``idle_share_profiled``: against the profiled wall time;
- ``device_ops_per_frame``: device activities per frame;
- ``stages``: host ms per frame (profiled) and device busy ms per frame of
  the ``vio.propagate``, ``vio.network`` and ``vio.update`` labels of
  ``pipeline/vio.py`` (or of the two ``train.`` labels);
- ``top_kernels``: the device activities with the most time per frame;
- ``gpu``: the card's name and power limit.

Fails without a CUDA device. Uses only the port.
"""

from __future__ import annotations

import bisect
import json
import sys
import time


FRAMES = 16  # past the 10-frame update gate; the trace stays ~1 min to read
TRAIN_STEPS = 8
TRAIN_WARMUP = 3  # cuDNN's first calls and the allocator's growth
FIL_STEPS = 2
FIL_WARMUP = 1  # cuDNN's first calls and the allocator's growth
LABELS = ("vio.", "train.", "fil.", "track.")


def train_runner(torch, dev):
    """(run, steps) of ``--train``: ``run()`` makes TRAIN_STEPS training
    steps from a fixed key chain (``train``'s) and returns (None, seconds),
    the last step closed by a synchronize."""
    import numpy as np
    from torch.profiler import record_function

    import chip_smoke
    from cuahn_vio_torch.data.textures import texture_bank_u8, train_indices
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.train import trainer
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.checkpoint import load_params

    cfg = trainer.TrainConfig(batch_size=chip_smoke.TRAIN_BATCH)
    model = build_uahn(load_params(chip_smoke.WEIGHTS), device=dev)
    c_rot_i, i_t_i2c = chip_smoke.camera(torch, dev)
    bank = texture_bank_u8(dev)
    tex_idx = torch.as_tensor(train_indices(bank.shape[0]), device=dev)
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(model, cfg, 1000))

    def steps(n):
        modes = np.random.default_rng(0)
        key = prng.prng_key(0)
        for _ in range(n):
            key, kb, ks = prng.split(key, 3)
            with record_function("train.batch"):
                batch = trainer.make_batch(cfg, kb, c_rot_i, i_t_i2c, bank=bank,
                                           tex_indices=tex_idx)
            with record_function("train.step"):
                step(batch, bool(modes.random() < cfg.prior_prob),
                     trainer.step_mask_keys(ks, cfg.batch_size, None, dev))

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(TRAIN_STEPS)
        torch.cuda.synchronize()
        return None, time.perf_counter() - t0

    steps(TRAIN_WARMUP)
    return run, TRAIN_STEPS


def fil_runner(torch, dev):
    """(run, steps) of ``--fil``: ``run()`` makes FIL_STEPS FIL steps on one
    batch of windows from a fixed key chain and returns (None, seconds),
    the last step closed by a synchronize."""
    import os
    import tempfile

    from torch.profiler import record_function

    import chip_smoke
    from cuahn_vio_torch.data.textures import texture_bank_u8, train_indices
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.pipeline.vio import VioConfig
    from cuahn_vio_torch.train import fil, trainer
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.checkpoint import load_params
    from cuahn_vio_torch.utils.config import VioOptions

    cfg = fil.FilConfig(window=chip_smoke.FIL_WINDOW, batch_size=chip_smoke.FIL_BATCH)
    with tempfile.TemporaryDirectory() as gt_dir:
        chip_smoke.write_loop_trajectory(os.path.join(gt_dir, "loop_with_gt.txt"))
        bank = fil.build_window_bank(chip_smoke.FIL_BANK, cfg, seed=0, gt_dir=gt_dir)
    win = {k: torch.as_tensor(v[:cfg.batch_size], device=dev) for k, v in bank._asdict().items()}
    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    model = build_uahn(load_params(chip_smoke.WEIGHTS), device=dev)
    c_rot_i, i_t_i2c = chip_smoke.camera(torch, dev)
    tex = texture_bank_u8(dev)
    tex_idx = torch.as_tensor(train_indices(tex.shape[0]), device=dev)
    loss_fn = fil.make_fil_loss(model, opts.filter_params(dev), cfg,
                                VioConfig(update_gate_frames=-1), c_rot_i, i_t_i2c, tex, tex_idx)
    opt = trainer.OptaxAdamW(
        model.parameters(),
        lambda count: trainer.warmup_cosine_decay(count, 0.0, 2e-5, 100, 2000, 2e-6),
        trainer.TrainConfig().weight_decay, trainer.TrainConfig().grad_clip)

    def steps(n):
        key = prng.prng_key(0)
        for _ in range(n):
            key, _, ks = prng.split(key, 3)
            opt.zero_grad()
            with record_function("fil.forward"):
                loss = loss_fn(win, ks)
            with record_function("fil.backward"):
                loss.backward()
            with record_function("fil.optimizer"):
                opt.step()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(FIL_STEPS)
        torch.cuda.synchronize()
        return None, time.perf_counter() - t0

    steps(FIL_WARMUP)
    return run, FIL_STEPS


def track_runner(torch, dev):
    """(run, steps) of ``--track``: ``run()`` tracks features over the slice
    sequence's first FRAMES + 1 frames (FRAMES pairs) on the card and
    returns (None, seconds), closed by the loop's host reads."""
    import chip_smoke
    from cuahn_vio_torch.vision.klt import track_sequence

    seq, _, _ = chip_smoke.slice_setup(torch, dev)
    frames = torch.as_tensor(seq.frames[: FRAMES + 1], device=dev)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        track_sequence(frames, FRAMES + 1)
        torch.cuda.synchronize()
        return None, time.perf_counter() - t0

    return run, FRAMES


def vio_runner(args, torch, dev):
    """(run, steps) of the slice (or, with ``--batch``, the batched
    phase): ``run()`` runs FRAMES frame pairs and returns (None, seconds)."""
    import chip_smoke
    from cuahn_vio_torch.pipeline.runner import (
        batch_frame_keys,
        prepare_batch,
        prepare_sequence,
    )
    from cuahn_vio_torch.pipeline.vio import run_sequence, sequence_mask_keys
    from cuahn_vio_torch.utils import prng

    seq, opts, model = chip_smoke.slice_setup(torch, dev)
    seqs = [seq] + (chip_smoke.textured_sequences(dev) if args.batch else [])
    n = FRAMES
    cuts = [(s.imu_t, s.imu_w, s.imu_a, s.cam_t[: n + 1], s.frames[: n + 1]) for s in seqs]

    fparams, cfg = opts.filter_params(dev), opts.vio_config()
    # initialization and the seconds-long first IMU window run once per
    # sequence: kept out of the profiled steps
    if args.batch:
        batch = prepare_batch(cuts, opts.runner_options(), fparams, dev)
        state0, frames_dev, w, a, dt = (batch.states0, batch.imgs_u8, batch.w_win,
                                        batch.a_win, batch.dt_win)
        n_used = batch.n_used.max(axis=0)
    else:
        _, state0, win, _, frames_used = prepare_sequence(
            *cuts[0], opts.runner_options(), fparams, dev
        )
        frames_dev = torch.as_tensor(frames_used, device=dev)
        w, a, dt = (torch.as_tensor(x, device=dev) for x in (win.w_mid, win.a_mid, win.dt))
        n_used = win.n_used
    steps = w.shape[-3]

    # run_offline's (run_offline_batch's) MC-dropout keys at seed 0, on the card once
    frame_keys = (batch_frame_keys(0, len(cuts), steps) if args.batch
                  else prng.split(prng.prng_key(0), steps))
    mask_keys = prng.keys_tensor(sequence_mask_keys(frame_keys, cfg.max_iekf_iterations), dev)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_sequence(state0, model, fparams, cfg, frames_dev, w, a, dt, n_used, mask_keys)
        torch.cuda.synchronize()
        return None, time.perf_counter() - t0

    return run, steps


def main() -> int:
    import argparse

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--batch", action="store_true",
                      help="profile the batched phase (B = 4, lockstep) instead")
    mode.add_argument("--train", action="store_true",
                      help="profile training steps of train-uahn instead")
    mode.add_argument("--fil", action="store_true",
                      help="profile filter-in-the-loop steps of train-fil instead")
    mode.add_argument("--track", action="store_true",
                      help="profile the track-features loop (detect + KLT) instead")
    args = ap.parse_args()
    import chip_smoke
    from cuahn_vio_torch.ops.homography import f32_parity_mode

    dev = torch.device("cuda:0")
    f32_parity_mode()
    if args.train:
        run, steps = train_runner(torch, dev)
    elif args.fil:
        run, steps = fil_runner(torch, dev)
    elif args.track:
        run, steps = track_runner(torch, dev)
    else:
        run, steps = vio_runner(args, torch, dev)

    run()  # warm-up
    _, plain_s = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = run()
    t_post = time.perf_counter()
    events = prof.events()
    cpu_ops = [e for e in events if e.device_type == DeviceType.CPU]
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    # the stage labels also appear on the device timeline as annotation
    # spans; they are not device work
    device = [e for e in on_device if not e.name.startswith(LABELS)]
    spans = [e for e in on_device if e.name.startswith(LABELS)]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    by_name: dict[str, list] = {}
    for e in device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    starts = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in device)
    stages = {}
    for e in cpu_ops:
        if e.name.startswith(LABELS):
            st = stages.setdefault(e.name, dict(host_ms=0.0, device_busy_ms=0.0, calls=0))
            st["host_ms"] += e.time_range.elapsed_us() / 1e3
            st["calls"] += 1
    for e in spans:
        st = stages.setdefault(e.name, dict(host_ms=0.0, device_busy_ms=0.0, calls=0))
        lo = bisect.bisect_left(starts, (e.time_range.start, -1.0))
        hi = bisect.bisect_right(starts, (e.time_range.end, float("inf")))
        st["device_busy_ms"] += sum(d for _, d in starts[lo:hi]) / 1e3
    stages = {
        k: dict(host_ms_per_frame=v["host_ms"] / steps,
                device_busy_ms_per_frame=v["device_busy_ms"] / steps,
                calls_per_frame=v["calls"] / steps)
        for k, v in sorted(stages.items())
    }
    out = dict(
        path=("track-features frame, 80 slots" if args.track
              else "train-fil FIL step, %d windows of %d frames" % (chip_smoke.FIL_BATCH,
                                                                    chip_smoke.FIL_WINDOW)
              if args.fil else "train-uahn step, batch %d" % chip_smoke.TRAIN_BATCH if args.train
              else "batched, B = %d" % (1 + len(chip_smoke.TEX_SEQS)) if args.batch else "single stream"),
        frames=steps,
        ms_per_frame=plain_s * 1e3 / steps,
        ms_per_frame_profiled=prof_s * 1e3 / steps,
        device_busy_ms_per_frame=busy_us / 1e3 / steps,
        idle_share=1.0 - busy_us / 1e3 / steps / (plain_s * 1e3 / steps),
        idle_share_profiled=1.0 - busy_us / 1e6 / prof_s,
        device_ops_per_frame=len(device) / steps,
        host_ops_per_frame=len(cpu_ops) / steps,
        stages=stages,
        top_kernels=[[name[:80], us / 1e3 / steps, calls / steps]
                     for name, (us, calls) in top],
        gpu=chip_smoke.gpu_name_and_power(),
        trace_processing_s=time.perf_counter() - t_post,
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
