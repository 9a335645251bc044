#!/usr/bin/env python3
"""Dissect and time the kernels of ``cuahn_vio_torch/ops/cuda/warp.cu`` on
one GPU, beside earlier or modified copies of it.

    python3 tune_warp.py [--baseline OTHER_warp.cu ...] [--out FILE.json]

Builds ``warp.cu`` and each ``--baseline`` (a warp.cu with the same C
entry points: an earlier one, e.g. from ``git show REV:...``, or a copy
with another tile size or band copy), with the same nvcc flags, all in
parallel. Then:

1. per kernel of each library: ptxas's registers, shared memory and spill
   bytes (``-Xptxas -v``), and the SASS instruction count from
   ``cuobjdump -sass``: the whole function, and its main body (before the
   first subroutine, i.e. without the IEEE division's slow path) per output
   pixel (per point of the flat sampler);
2. parity of every library with the plain version on ``chip_smoke.py``'s
   warp cases (224x320 at B = 1, 4, 8, 65 and the ragged shapes, uint8 and
   float32): max abs error must be 0.0 and NaN where the plain version has
   NaN;
3. device time per call from CUDA-graph replays (as ``chip_smoke.py`` phase
   3) of every library and of ``grid_sample`` on the same points, at the
   phase-3 cases, in turns: each case runs the libraries in one order, then
   in the reverse order, and both times are kept;
4. the flat sampler (B4) of every library at its three shapes
   (``chip_smoke.py`` phase 3: a frame's, a blurred frame's and the
   trainer batch's coordinates, uint8): bit for bit against the plain
   version, then device time beside ``grid_sample`` and the launch floor,
   in turns as above. A library whose sampler takes no batch (a
   ``warp.cu`` from before the batched sampler) is called once per
   texture at shape 3, and the output says so.

Prints one line per measurement and writes every number to ``--out``
(default ``cuahn_vio_torch/_build/tune_warp.json``), and each library's
SASS beside it (``sass_<name>.txt``; ``current`` is this ``warp.cu``).
Fails without a CUDA device. Uses only the port.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import faulthandler
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WALL_LIMIT_S = 800
# (kernel, dtype name, B): chip_smoke.py phase 3's cases, float32 at B = 4,
# and the batch sizes between 4 and 64
CASES = (("warp", "uint8", 1), ("warp", "uint8", 4), ("warp", "uint8", 8),
         ("warp", "uint8", 16), ("warp", "uint8", 32), ("warp", "uint8", 64),
         ("warp", "float32", 1), ("warp", "float32", 4), ("warp", "float32", 64),
         ("rowskip", "uint8", 4), ("rowskip", "uint8", 8), ("rowskip", "uint8", 16),
         ("rowskip", "uint8", 64))
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
LABEL = re.compile(r"^\s*([$.\w]+):\s*$")
# a call's target: a label, or an address within the function
CALL = re.compile(r"CALL\.\S*\s+(?:`\(([^)]+)\)|0x([0-9a-f]+))")
FUNC = re.compile(r"Function : (\S+)")


def sass_counts(text: str) -> dict:
    """{kernel: {"total": n, "main": n}}: SASS instructions (NOPs excluded)
    of each kernel in ``cuobjdump -sass`` output ``text``, and of its main
    body, before the first subroutine that it CALLs (the IEEE division's
    slow path)."""
    from cuahn_vio_torch.ops.cuda.build import kernel_name

    counts, name, ops, labels, calls = {}, None, [], {}, []

    def close():
        if name is not None:
            start = min((labels.get(c, c) for c in calls), default=1 << 62)
            counts[name] = dict(total=sum(op != "NOP" for _, op in ops),
                                main=sum(op != "NOP" and a < start for a, op in ops))

    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            close()
            name = kernel_name(m.group(1))
            ops, labels, calls, pending = [], {}, [], []
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            ops.append((addr, m.group(2).split(".")[0]))
            c = CALL.search(line)
            if c:
                calls.append(c.group(1) if c.group(1) else int(c.group(2), 16))
    close()
    return counts


def caller(torch, lib, kernel: str, imgs, hs):
    """A no-argument call of ``kernel`` ("warp" or "rowskip") of ``lib`` on
    (imgs, hs) into a fixed output tensor, on the current stream; returns
    (call, out). Raises on a failed launch."""
    b, hgt, wid = imgs.shape
    out = torch.empty((b, hgt, wid), dtype=torch.float32, device=imgs.device)
    sfx = "u8" if imgs.dtype == torch.uint8 else "f32"
    if kernel == "warp":
        fn = getattr(lib, f"homography_warp_{sfx}")
        args = (imgs.data_ptr(), hs.data_ptr(), out.data_ptr(), b, hgt, wid, *imgs.stride(),
                hs.stride(0))
    else:
        fn = getattr(lib, f"homography_warp_rowskip_{sfx}")
        args = (imgs.data_ptr(), hs.data_ptr(), out.data_ptr(), b, hgt, wid, hs.stride(0))

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
        return out

    return call, out


# the flat sampler's entry in a warp.cu from before it took a batch (commit
# 2e2cbb8 and earlier): img, su, sv, out, N, H, W, image strides (2), stream
UNBATCHED_SAMPLE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


def sample_caller(torch, lib, imgs, su, sv):
    """A no-argument call of ``lib``'s flat sampler on (B, H, W) ``imgs``
    at (B, N) coordinates into a fixed output, on the current stream:
    one launch, or, for a library whose sampler takes no batch, one
    launch per image. Returns (call, launches per call)."""
    b, n = su.shape
    hgt, wid = imgs.shape[1:]
    out = torch.empty((b, n), dtype=torch.float32, device=imgs.device)
    sfx = "u8" if imgs.dtype == torch.uint8 else "f32"
    batched = getattr(lib, f"bilinear_sample_batch_{sfx}", None)
    if batched is not None:
        calls = [(batched, (imgs.data_ptr(), su.data_ptr(), sv.data_ptr(), out.data_ptr(), b,
                            n, hgt, wid, *imgs.stride()))]
    else:
        fn = getattr(lib, f"bilinear_sample_{sfx}")
        fn.argtypes, fn.restype = UNBATCHED_SAMPLE_ARGTYPES, ctypes.c_int
        calls = [(fn, (imgs[k].data_ptr(), su[k].data_ptr(), sv[k].data_ptr(),
                       out[k].data_ptr(), n, hgt, wid, *imgs.stride()[1:])) for k in range(b)]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for fn, args in calls:
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError(f"flat sampler launch failed: cudaError {err}")
        return out

    return call, len(calls)


def check_libraries(torch, chip_smoke, libs: dict, imgs, hs) -> None:
    """Both warps of every library in ``libs`` against the plain version on
    (imgs, hs): max abs error 0.0 and NaN where it has NaN, or raise."""
    from cuahn_vio_torch.ops.warp import homography_warp_plain

    ref = homography_warp_plain(imgs, hs)
    for name, lib in libs.items():
        for kernel in ("warp", "rowskip"):
            call, _ = caller(torch, lib, kernel, imgs, hs)
            out = call().clone()
            torch.cuda.synchronize()
            err = chip_smoke.nan_checked_err(torch, out, ref, f"{name} {kernel}")
            if err != 0.0:
                raise AssertionError(f"{name} {kernel} {tuple(imgs.shape)} {imgs.dtype}: "
                                     f"max abs err {err:.3e}")


def main() -> int:
    faulthandler.dump_traceback_later(WALL_LIMIT_S, exit=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another warp.cu to build and time beside this one (repeatable)")
    ap.add_argument("--out", default=None,
                    help="JSON of every number (default: _build/tune_warp.json of the port)")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("tune_warp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from cuahn_vio_torch.ops.cuda import build
    from cuahn_vio_torch.ops.cuda import warp as warp_cuda

    args.out = args.out or os.path.join(build.BUILD_DIR, "tune_warp.json")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    gpu = chip_smoke.gpu_name_and_power()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}", flush=True)

    sources = {"current": warp_cuda.SOURCE}
    for i, path in enumerate(args.baseline):
        name = os.path.splitext(os.path.basename(path))[0]
        sources[name if name not in sources else f"{name}{i}"] = os.path.abspath(path)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda src: build.build(src)[0], sources.values())))
    print(f"[build] {time.perf_counter() - t0:.1f} s, {len(paths)} libraries", flush=True)

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    result = {"gpu": gpu, "libraries": {}, "times": []}
    for name, path in paths.items():
        ptxas = build.ptxas_report(path)
        text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        with open(os.path.join(os.path.dirname(os.path.abspath(args.out)),
                               f"sass_{name}.txt"), "w") as f:
            f.write(text)
        sass = sass_counts(text)
        for kern, info in sorted(ptxas.items()):
            pix = int(kern[:-1].split(",")[1]) if "," in kern else 1  # <h,P>
            per_px = sass.get(kern, {}).get("main", 0) / pix
            info.update(sass_total=sass.get(kern, {}).get("total"),
                        sass_main=sass.get(kern, {}).get("main"),
                        sass_main_per_pixel=per_px)
            print(f"  {name:13s} {kern:18s} regs {info.get('registers')} smem "
                  f"{info.get('smem_bytes')} spill st/ld {info.get('spill_stores')}/"
                  f"{info.get('spill_loads')} | SASS {info['sass_total']} total, "
                  f"{info['sass_main']} main, {per_px:.1f} per pixel", flush=True)
        result["libraries"][name] = dict(source=sources[name], kernels=ptxas)
    libs = {name: warp_cuda.bind(ctypes.CDLL(path)) for name, path in paths.items()}

    t0 = time.perf_counter()
    rng = np.random.default_rng(30)
    for dtype in (torch.uint8, torch.float32):
        for _, imgs, hs in chip_smoke.warp_parity_inputs(torch, rng, dtype, dev):
            check_libraries(torch, chip_smoke, libs, imgs, hs)
    print(f"[parity] {time.perf_counter() - t0:.1f} s: every library bit-identical to "
          "the plain version", flush=True)

    rng = np.random.default_rng(1)
    names = list(libs)
    for kernel, dname, b in CASES:
        dtype = torch.uint8 if dname == "uint8" else torch.float32
        imgs, hs = chip_smoke.parity_cases(torch, rng, b, dtype)
        hs[:] = hs[0]
        imgs = torch.as_tensor(imgs, device=dev)
        hs = torch.as_tensor(hs, device=dev)
        img_f = (imgs.float() / 255.0 if dname == "uint8" else imgs)[:, None]
        grid = chip_smoke.library_grid(torch, hs)
        calls = {n: caller(torch, libs[n], kernel, imgs, hs)[0] for n in names}
        times = {n: [] for n in names}
        lib_ms = []
        for order in (names, names[::-1]):
            lib_ms.append(chip_smoke.time_graph_ms(torch, lambda: F.grid_sample(
                img_f, grid, mode="bilinear", padding_mode="zeros", align_corners=True)))
            for n in order:
                times[n].append(chip_smoke.time_graph_ms(torch, calls[n]))
        bound = chip_smoke.warp_bound_ms(b, imgs.element_size())
        row = dict(kernel=kernel, dtype=dname, b=b, bound_ms=bound, grid_sample_ms=lib_ms,
                   ms=times)
        result["times"].append(row)
        lib_mean = sum(lib_ms) / 2
        print(f"  {kernel} {dname} B={b}: grid_sample {lib_ms[0]:.5f}/{lib_ms[1]:.5f} ms, "
              f"bound {bound:.5f} ms", flush=True)
        for n in names:
            mean = sum(times[n]) / 2
            print(f"    {n:13s} {times[n][0]:.5f}/{times[n][1]:.5f} ms, "
                  f"{mean / lib_mean:.3f}x grid_sample, {mean / bound:.2f}x bound", flush=True)

    # the flat sampler (B4) at its three shapes (chip_smoke.py phase 3):
    # parity with the plain version, then device time in turns
    from cuahn_vio_torch.ops.warp import bilinear_sample_flat

    rng = np.random.default_rng(4)
    tex = torch.as_tensor(rng.integers(0, 256, (1, 512, 512)).astype(np.uint8), device=dev)
    texs, bsu, bsv = chip_smoke.batch_sample_inputs(torch, dev, torch.uint8)
    shapes = {1: (tex, *(c[None] for c in chip_smoke.frame_sample_coords(torch, dev))),
              2: (tex, *(c[None] for c in chip_smoke.frame_sample_coords(
                  torch, dev, chip_smoke.EXPOSURE_S))),
              3: (texs, bsu, bsv)}
    one = torch.zeros(1, device=dev)
    for shape, (imgs, su, sv) in shapes.items():
        ref = bilinear_sample_flat(imgs, su, sv)
        calls = {n: sample_caller(torch, libs[n], imgs, su, sv) for n in names}
        for n, (call, _) in calls.items():
            out = call().clone()
            torch.cuda.synchronize()
            err = chip_smoke.nan_checked_err(torch, out, ref, f"{n} sampler shape {shape}")
            if err != 0.0:
                raise AssertionError(f"{n} sampler shape {shape}: max abs err {err:.3e}")
        img_f = (imgs.float() / 255.0)[:, None]
        grid = torch.stack([2 * su / 511 - 1, 2 * sv / 511 - 1], dim=-1)[:, None]
        times = {n: [] for n in names}
        lib_ms, floor_ms = [], []
        for order in (names, names[::-1]):
            lib_ms.append(chip_smoke.time_graph_ms(torch, lambda: F.grid_sample(
                img_f, grid, mode="bilinear", padding_mode="zeros", align_corners=True)))
            floor_ms.append(chip_smoke.time_graph_ms(torch, lambda: one.add_(1.0)))
            for n in order:
                times[n].append(chip_smoke.time_graph_ms(torch, calls[n][0]))
        bound, texels = chip_smoke.sample_bound_ms(torch, imgs, su, sv)
        result["times"].append(dict(kernel="sample", dtype="uint8", shape=shape,
                                    b=su.shape[0], n=su.shape[1], bound_ms=bound,
                                    grid_sample_ms=lib_ms, launch_floor_ms=floor_ms,
                                    launches={n: calls[n][1] for n in names}, ms=times))
        lib_mean = sum(lib_ms) / 2
        print(f"  sampler shape {shape} uint8 B={su.shape[0]} N={su.shape[1]} (bit-identical to "
              f"the plain version): grid_sample {lib_ms[0]:.5f}/{lib_ms[1]:.5f} ms, launch "
              f"floor {floor_ms[0]:.5f}/{floor_ms[1]:.5f} ms, bound {bound:.5f} ms "
              f"({texels} texels)", flush=True)
        for n in names:
            mean = sum(times[n]) / 2
            per = f", {calls[n][1]} launches: its sampler takes no batch" if calls[n][1] > 1 else ""
            print(f"    {n:13s} {times[n][0]:.5f}/{times[n][1]:.5f} ms, "
                  f"{mean / lib_mean:.3f}x grid_sample, {mean / bound:.2f}x bound{per}",
                  flush=True)

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result["sm_clocks_after_timing"] = clocks
    print(f"SM clock after timing, and its maximum: {clocks}", flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
