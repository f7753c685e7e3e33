"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
``nvcc`` builds it in seconds into ``_build/lib<name>-<hash>.so`` (the hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source is rebuilt).  The TMA kernels find the driver's
``cuTensorMapEncodeTiled`` at run time (``csrc/hopper.cuh``), so no
``-lcuda`` is needed.  Nothing
builds when this module is imported: the first launch of a kernel, or an
explicit :func:`build` (``chip_smoke.py`` times it), compiles.  Hopper only:
the target is ``sm_90a``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd", "slstm_scan", "slstm_scan_bwd", "adamw", "matmul",
           "copy", "stencil")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every source of ``names`` not yet built, one ``nvcc`` each,
    all started together.  Returns ``{name: {"path", "seconds", "log"}}``
    with the compiler's ``-Xptxas -v`` report as ``log`` ("" when the
    library was already built).  Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running, done = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            done[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)          # atomic: a reader never sees half a file
        done[name] = {"path": str(out),
                      "seconds": time.perf_counter() - t0, "log": log}
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build((name,))[name]["path"]
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
