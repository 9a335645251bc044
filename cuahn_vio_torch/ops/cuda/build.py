"""Build a CUDA source into a shared library with nvcc, and load it.

The route: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a ``.so``
with a plain C interface, loaded with ``ctypes``. No PyTorch headers, no
ninja and no ``torch.utils.cpp_extension`` lock file are involved, so a
build takes seconds and a killed build cannot block the next one.

Libraries go to ``cuahn_vio_torch/_build/<hash>/``, keyed by the source's
bytes and the compiler flags. Each build writes to a temporary name and
``os.replace``s it into place, so a half-written library is never loaded.
ptxas's report of each kernel (registers, shared memory, spills;
``-Xptxas -v``) is kept beside the library (``ptxas_report``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no implicit FMA contraction: the kernel then does the plain version's
    # float32 arithmetic op for op, with fmas only where both write one
    # (the warp is bound by bytes, not flops)
    "-fmad=false",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills
    "-shared", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 300


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        toolkit = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(toolkit, "bin", "nvcc")
        nvcc = candidate if os.path.exists(candidate) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def library_path(source: str) -> str:
    """Where the library of ``source`` is (or will be) built."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, digest, f"lib{name}.so")


def build(source: str) -> tuple[str, float]:
    """Compile ``source`` unless its library exists. Returns (path, seconds
    spent compiling, 0.0 when the library was already built)."""
    out = library_path(source)
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        with open(f"{out}.ptxas.txt", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source``."""
    path, _ = build(source)
    return ctypes.CDLL(path)


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?(\w+)'?")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_KERNEL = re.compile(r"([a-z]+_kernel)I([a-z])(?:Li(\d+)E)?(?:Lb([01])E)?")


def kernel_name(mangled: str) -> str | None:
    """``warp_kernel<h,2>`` for the mangled ``warp_kernel<uint8_t, 2>`` (the
    Itanium type code: h uint8, f float), ``flat_kernel<h,8,1>`` for
    ``flat_kernel<uint8_t, 8, true>``, ``flat_kernel<f>`` for
    ``flat_kernel<float>``; None for a function that is not a kernel
    template of warp.cu."""
    k = _KERNEL.search(mangled)
    if not k:
        return None
    return "{}<{}>".format(k.group(1), ",".join(g for g in k.groups()[1:] if g))


def ptxas_report(library: str) -> dict:
    """{kernel (``kernel_name``): {registers, smem_bytes, stack_bytes,
    spill_stores, spill_loads}} from ptxas's ``-v`` report kept beside
    ``library``."""
    report, name = {}, None
    with open(f"{library}.ptxas.txt") as f:
        for line in f:
            m = _ENTRY.search(line)
            if m:
                name = kernel_name(m.group(1))
                if name:
                    report.setdefault(name, {})
                continue
            if name is None:
                continue
            m = _SPILLS.search(line)
            if m:
                report[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
            m = _USED.search(line)
            if m:
                report[name].update(registers=int(m.group(1)), smem_bytes=int(m.group(2) or 0))
    return report
