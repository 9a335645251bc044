#!/usr/bin/env python3
"""Where the time of the port's ``run-vio`` slice goes, on one GPU.

    python3 profile_slice.py [--batch]

Runs the slice of ``chip_smoke.py`` (same synthetic sequence, v10 weights,
calibrated profile, 16-member MC dropout) on its first FRAMES frame
pairs, after initialization and the first (seconds-long) IMU window: once
plain for the host-clock ms/frame, once under ``torch.profiler`` (CPU +
CUDA activity). With ``--batch``, the same for the smoke's batched phase:
its four sequences (the slice's and ``chip_smoke.TEX_SEQS``) in lockstep,
``BATCH_SAMPLER = "full"``; "frame" then means a lockstep frame of B = 4
sequences. Prints one JSON line with:

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
  ``pipeline/vio.py``;
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


def main() -> int:
    import argparse

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", action="store_true",
                    help="profile the batched phase (B = 4, lockstep) instead")
    args = ap.parse_args()
    import chip_smoke
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.pipeline.runner import prepare_batch, prepare_sequence
    from cuahn_vio_torch.pipeline.vio import run_sequence

    dev = torch.device("cuda:0")
    f32_parity_mode()
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

    def run():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_sequence(state0, model, fparams, cfg, frames_dev, w, a, dt, n_used, gen)
        torch.cuda.synchronize()
        return None, time.perf_counter() - t0

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
    device = [e for e in on_device if not e.name.startswith("vio.")]
    spans = [e for e in on_device if e.name.startswith("vio.")]
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
        if e.name.startswith("vio."):
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
        path="batched, B = %d" % len(seqs) if args.batch else "single stream",
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
