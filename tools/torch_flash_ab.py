"""Card time and error of variants of the float32 flash-attention kernel
(``tf32x3``), beside the FMA kernel and SDPA, in one chip call.

    python tools/torch_flash_ab.py [--variant NAME=FLAGS ...] [--rounds 3]
    python tools/torch_flash_ab.py --host [--against DIR]
    python tools/torch_flash_ab.py --mma-peak
    python tools/torch_flash_ab.py --bwd [--dtype bfloat16]
                                   [--variant NAME=FLAGS ...]
                                   [--against DIR] [--rounds 3]
    python tools/torch_flash_ab.py --bwd --cases [--dtype bfloat16]
    python tools/torch_flash_ab.py --fwd --dtype bfloat16
                                   [--variant NAME=FLAGS ...]
                                   [--against DIR] [--rounds 3]

A variant ``NAME=FLAGS`` builds ``flash_attention.cu`` with the
space-separated ``-D`` flags in FLAGS, from this tree's ``csrc`` or, with
a token ``--csrc=DIR`` among them, from DIR (another tree's sources, for
example a commit unpacked by ``git archive`` into an ignored directory),
one ``nvcc`` each, all started together (the shipped sources have no
switches: a design to try is a ``--csrc=DIR`` copy edited by hand), and
keeps each build's
``-Xptxas -v`` report (registers, stack and spill bytes) of every kernel
of the mode's path: the 3xTF32 and the wgmma forward kernels, or the
backward's of the dtype, at every D.  Without ``--variant``: this tree's
kernel alone.

With ``--host``, no variants: the wrapper ``flash_attention`` is timed
on the host, the median over 7 rounds of the host clock around 100 calls
queued without a synchronisation (``host_us`` a call; the card runs
behind), at granite-8b's heads and S = 256 in float32 and bfloat16, and
1000 calls are profiled (``cProfile``; the functions with the most time
of their own).  With ``--against DIR``, the wrapper of the ``repro_torch``
under DIR (another tree's ``src``, loaded under another name) is timed
in the same process, the rounds alternating, so that both see the same
host.

With ``--mma-peak``: the rate of ``mma.sync.m16n8k8`` in TF32 alone, the
ceiling of the 3xTF32 kernel's products (the data sheet's 495 TFLOP/s is
wgmma's): a microkernel (``MMA_PEAK_CU`` below) in which each warp issues
products into 8 independent accumulators, at 4 to 16 warps an SM.  The shapes and inputs are
``chip_smoke.py``'s ``time_flash`` rows in float32 (granite-8b's heads at
S = 256, 512, 1024, zamba2-1.2b's shared attention at S = 1024, causal).
Each round times every variant, the FMA kernel (the shipped library's
``repro_flash_attention`` on the same inputs) and SDPA in turn, card time
from CUDA events after a spin kernel holds the stream; the medians over
the rounds are reported with each variant's largest error
``|o - plain| / (1 + |plain|)``.  Prints one JSON object and appends it to
``chiprun_out/flash_ab.jsonl``.

With ``--fwd --dtype bfloat16``: the wgmma forward at
``BF16_FWD_SHAPES`` (stablelm-3b's D-80 prefill and training shapes,
zamba2-1.2b's D 64 and granite-8b's D 128, causal), each variant through
``repro_flash_attention_wgmma``, this tree's wrapper, with ``--against
DIR`` the other tree's, and SDPA, in turns as ``--bwd`` takes them; each
call's median card time, its largest ``|o - plain| / (1 + |plain|)``, the
bound and the rate, and one profiled call of each kernel call's kernels.
(``--fwd`` in float32 is the mode without flags.)

With ``--bwd``: the backward at the training shape (q [2,32,2048,128],
k/v [2,8,2048,128], causal), float32 by default; with ``--dtype
bfloat16`` at each of ``chip_smoke.FLASH_BWD_BF16_SHAPES`` (granite-8b's,
qwen3-moe-30b-a3b's and zamba2-1.2b's training shapes).  Each variant
builds ``flash_attention_bwd.cu`` as above and is called through the
entry point of the dtype's aligned path
(``repro_flash_attention_bwd_tf32x3`` or ``_wgmma``); beside them this
tree's wrapper on the aligned path (``tf32x3`` or ``wgmma``) and on
``fma`` (q off a 16-byte boundary), SDPA's backward on a kept graph and,
with ``--against DIR``, the wrapper of the ``repro_torch`` under DIR (for
example the parent commit's ``src``, unpacked by ``git archive`` into an
ignored directory, which builds its own kernels there).  The calls take
turns, in order in even rounds and in reverse in odd ones (so the parent
and this tree run parent, this, this, parent over two rounds).  Each
reports its median card time and its largest ``|g - plain| / (1 +
|plain|)`` over dq, dk and dv, and under ``errors`` each gradient's
``chip_smoke.bwd_errors`` (SDPA's too: its own rounding beside the
kernels'); one profiled call of this tree's aligned path gives each
kernel's card time.  With ``--cases`` no times: the errors of this tree's
backward and SDPA's over ``chip_smoke.FLASH_BWD_CASES`` on
``check_flash_bwd``'s inputs, the readings its limits are set from.
"""
from __future__ import annotations

import argparse
import cProfile
import ctypes
import json
import pstats
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [(32, 8, 256, 128), (32, 8, 512, 128), (32, 8, 1024, 128),
          (32, 32, 1024, 64)]


# the bfloat16 forward's shapes (b, hq, hkv, s, t, d) by model, causal
BF16_FWD_SHAPES = (
    ("stablelm-3b prefill", (1, 32, 32, 1024, 1024, 80)),
    ("stablelm-3b train", (2, 32, 32, 2048, 2048, 80)),
    ("zamba2-1.2b prefill", (1, 32, 32, 1024, 1024, 64)),
    ("granite-8b prefill", (1, 32, 8, 1024, 1024, 128)),
)

DEFAULT_VARIANTS = ["ship="]


def _ptxas(log: str, kernels: tuple[str, ...]) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel in an ``nvcc
    -Xptxas -v`` log whose mangled name holds one of ``kernels``, and the
    codes of ptxas's notes on it (C7514, C7520: wgmma serialized)."""
    import re
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m or not any(k in m.group(1) for k in kernels):
            continue
        row = {"kernel": m.group(1),
               "notes": [n.group(1) for x in lines
                         if m.group(1) in x and "Compiling" not in x
                         and (n := re.search(r"\((C\d+)\)", x))]}
        for x in lines[i + 1:i + 4]:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
                if (n := re.search(pat, x)):
                    row[key] = int(n.group(1))
        out.append(row)
    return out


def _build(variants: dict[str, str], source: str = "flash_attention",
           kernels: tuple[str, ...] = ("tf32x3", "wgmma")) -> dict:
    """{name: (ctypes library, ``_ptxas`` report of the kernels whose name
    holds one of ``kernels``)}, ``csrc/<source>.cu`` built in parallel."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var, flags in variants.items():
        lib = out_dir / f"lib{source}-{var}.so"
        csrc, defines = build.CSRC, []
        for tok in flags.split():
            if tok.startswith("--csrc="):
                csrc = Path(tok.removeprefix("--csrc=")).resolve()
            else:
                defines.append(tok)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(lib),
               str(csrc / f"{source}.cu")]
        procs[var] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    libs = {}
    for var, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {var}:\n{log}")
        libs[var] = (ctypes.CDLL(str(lib)), _ptxas(log, kernels))
    return libs


def _entry(lib, name):
    fn = getattr(lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = ctypes.c_int
    fn.argtypes = [p, p, p, p, *([i] if name == "repro_flash_attention"
                                 else []), i, i, i, i, i, i, i,
                   ctypes.c_float, p]
    return fn


MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float acc = 0.f;
  for (int j = 0; j < 8; ++j) acc += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int launch_mma_peak(float* out, int blocks, int threads,
                               int iters, void* stream) {
  mma_peak<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _mma_peak(cs) -> int:
    """TFLOP/s of TF32 mma.sync alone at 4, 8 and 16 warps an SM."""
    import torch
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_peak.cu", out_dir / "libmma_peak.so"
    src.write_text(MMA_PEAK_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).launch_mma_peak
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, i, i, i, p], i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, rows = 4096, []
    for warps in (4, 8, 16):
        blocks, threads = sms * warps // 4, 128
        out = torch.empty(blocks * threads, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        call = lambda: fn(out.data_ptr(), blocks, threads, iters, stream)
        ms = cs._time_ms(call, iters=5)
        flops = blocks * 4 * iters * 8 * 2048   # warps x products x flops
        rows.append({"warps_per_sm": warps, "ms": ms,
                     "tflops": flops / (ms * 1e-3) / 1e12})
        print(f"[mma_peak] {rows[-1]}", flush=True)
    _append({"nvidia_smi": cs._smi(), "mma_peak": rows})
    return 0


def _bwd(cs, fa, args) -> int:
    """The backward's variants, paths, SDPA and another tree (``--bwd``)."""
    import torch
    dtype = getattr(torch, args.dtype)
    if args.cases:
        return _bwd_cases(cs, fa, dtype)
    cases = ([("granite-8b", cs.FLASH_BWD_CASES[0])] if dtype == torch.float32
             else list(cs.FLASH_BWD_BF16_SHAPES))
    aligned = "tf32x3" if dtype == torch.float32 else "wgmma"
    libs = _build(dict(v.split("=", 1) for v in args.variant or []),
                  "flash_attention_bwd",
                  ("bwd_x3",) if aligned == "tf32x3" else ("bwd_wgmma",))
    other = _other_tree(args.against) if args.against else None
    rows = [_bwd_case(cs, fa, args, model, case, dtype, aligned, libs, other)
            for model, case in cases]
    _append({"nvidia_smi": cs._smi(), "dtype": args.dtype, "bwd": rows,
             "ptxas": {var: rep for var, (_, rep) in libs.items()}})
    return 0


def _bwd_cases(cs, fa, dtype) -> int:
    """``--bwd --cases``: each of ``chip_smoke.FLASH_BWD_CASES`` on the
    inputs ``check_flash_bwd`` makes, this tree's backward (on the path the
    inputs take) and SDPA's backward (where its causal mask is the end-aligned
    one, S = T, or there is none) against the plain version, by
    ``chip_smoke.bwd_errors``, with no limit applied."""
    import torch
    import torch.nn.functional as F
    rows = []
    for i, (b, hq, hkv, s, t, d, causal, *off) in enumerate(
            cs.FLASH_BWD_CASES):
        q, k, v, o, do = cs._bwd_inputs(b, hq, hkv, s, t, d, dtype, causal,
                                        seed=200 + i)
        if off:
            q = cs._off16(q)
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
        errs = {fa.flash_bwd_path(q, k, v, o, do): cs.bwd_errors(
            fa.flash_attention_bwd(q, k, v, o, do, causal=causal), want)}
        if s == t or not causal:
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=True)
            errs["sdpa"] = cs.bwd_errors(torch.autograd.grad(out, leaves, do),
                                         want)
            del leaves, out
        rows.append({"shape": [b, hq, hkv, s, t, d], "causal": causal,
                     "q_off16": bool(off), "errors": errs})
        print(f"[ab-bwd-cases] {rows[-1]}", flush=True)
        del q, k, v, o, do, want
        torch.cuda.empty_cache()
    _append({"nvidia_smi": cs._smi(), "dtype": str(dtype).removeprefix(
        "torch."), "bwd_cases": rows})
    return 0


def _bwd_case(cs, fa, args, model, case, dtype, aligned, libs, other):
    """One shape of ``--bwd``: the calls' errors, times in turns and the
    aligned path's kernels."""
    import torch
    import torch.nn.functional as F
    b, hq, hkv, s, t, d, causal = case
    q, k, v, o, do = cs._bwd_inputs(b, hq, hkv, s, t, d, dtype, causal,
                                    seed=299)
    _require = cs._require
    _require(fa.flash_bwd_path(q, k, v, o, do) == aligned, "aligned path")
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    q_off = cs._off16(q)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)
    calls = {}
    if other is not None:
        calls["against"] = lambda: other.flash_attention_bwd(
            q, k, v, o, do, causal=causal)
    calls[aligned] = lambda: fa.flash_attention_bwd(q, k, v, o, do,
                                                    causal=causal)
    calls["fma"] = lambda: fa.flash_attention_bwd(q_off, k, v, o, do,
                                                  causal=causal)
    calls["sdpa"] = lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True)
    rows = -(-s // fa.BWD_PAD) * fa.BWD_PAD
    for var, (lib, _) in libs.items():
        fn = getattr(lib, f"repro_flash_attention_bwd_{aligned}")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype, fn.argtypes = i, [p] * 10 + [i] * 7 + [ctypes.c_float, p]

        def call(fn=fn, var=var):
            grads = [torch.empty_like(x) for x in (q, k, v)]
            scratch = [torch.empty((b, hq, rows), device=q.device)
                       for _ in range(2)]
            err = fn(*(x.data_ptr() for x in (q, k, v, o, do, *grads,
                                               *scratch)),
                     b, hq, hkv, s, t, d, int(causal), d ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {var}: CUDA error {err}")
            return grads
        calls[f"variant:{var}"] = call
    errs = {}
    for name, fn in calls.items():
        errs[name] = cs.bwd_errors(fn(), want)
    times = {name: [] for name in calls}
    for r in range(args.rounds):
        for name in list(calls)[::(-1 if r % 2 else 1)]:
            times[name].append(cs._time_ms(calls[name], iters=5))
    kernels = _kernels_ms({n: f for n, f in calls.items()
                           if n not in ("fma", "sdpa")})
    flops, nbytes = cs.attention_bwd_work(b, hq, hkv, s, t, d, dtype, causal)
    unit = "3xtf32" if aligned == "tf32x3" else "bfloat16"
    bound_ms, bound_by = cs.bound({unit: flops}, nbytes)
    ms = {n: statistics.median(x) for n, x in times.items()}
    row = {"model": model, "shape": [b, hq, hkv, s, t, d], "causal": causal,
           "dtype": str(dtype).removeprefix("torch."), "ms": ms,
           "ms_rounds": times,
           "max_rel_err": {n: max(e["max_rel_err"] for e in by.values())
                           for n, by in errs.items()},
           "errors": errs, "kernels_ms": kernels,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": {n: flops / (x * 1e-3) / 1e12 for n, x in ms.items()},
           "against": args.against}
    print(f"[ab-bwd] {row}", flush=True)
    del q, k, v, o, do, q_off, leaves, out, calls, want
    torch.cuda.empty_cache()
    return row


def _kernels_ms(calls: dict) -> dict:
    """{call: {kernel: card ms}} from one profiled run of each call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name] = {ev.key[:80]: ev.self_device_time_total / 1e3
                     for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA}
    return out


def _fwd_bf16(cs, fa, args) -> int:
    """``--fwd --dtype bfloat16``: the wgmma forward's variants, this tree's
    wrapper, another tree's and SDPA at ``BF16_FWD_SHAPES``, in turns."""
    import torch
    import torch.nn.functional as F
    libs = _build(dict(v.split("=", 1) for v in args.variant or []),
                  kernels=("flash_wgmma_bf16",))
    other = _other_tree(args.against) if args.against else None
    rows = []
    for model, (b, hq, hkv, s, t, d) in BF16_FWD_SHAPES:
        q, k, v = cs._qkv(b, hq, hkv, s, t, d, torch.bfloat16, seed=99)
        cs._require(fa.flash_path(q, k, v) == "wgmma", "aligned path")
        want = fa.flash_attention_plain(q, k, v).float()
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        if other is not None:
            calls["against"] = lambda: other.flash_attention(q, k, v)
        calls["wgmma"] = lambda: fa.flash_attention(q, k, v)
        for var, (lib, _) in libs.items():
            fn = _entry(lib, "repro_flash_attention_wgmma")

            def call(fn=fn, var=var):
                o = torch.empty_like(q)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), b, hq, hkv, s, t, d, 1, d ** -0.5,
                         stream)
                if err:
                    raise RuntimeError(f"variant {var}: CUDA error {err}")
                return o
            calls[f"variant:{var}"] = call
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        errs = {}
        for name, fn in calls.items():
            got = fn().float()
            torch.cuda.synchronize()
            errs[name] = float(((got - want).abs() / (1 + want.abs())).max())
        times = {name: [] for name in calls}
        for r in range(args.rounds):
            for name in list(calls)[::(-1 if r % 2 else 1)]:
                times[name].append(cs._time_ms(calls[name],
                                               iters=args.iters))
        flops, nbytes = cs.attention_work(b, hq, hkv, s, t, d,
                                          torch.bfloat16)
        bound_ms, bound_by = cs.bound({"bfloat16": flops}, nbytes)
        ms = {n: statistics.median(x) for n, x in times.items()}
        rows.append({
            "model": model, "shape": [b, hq, hkv, s, t, d], "causal": True,
            "ms": ms, "ms_rounds": times, "max_rel_err": errs,
            "kernels_ms": _kernels_ms({n: f for n, f in calls.items()
                                       if n != "sdpa"}),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": {n: flops / (x * 1e-3) / 1e12 for n, x in ms.items()},
            "against": args.against})
        print(f"[ab-fwd-bf16] {rows[-1]}", flush=True)
        del q, k, v, want, calls
        torch.cuda.empty_cache()
    _append({"nvidia_smi": cs._smi(), "dtype": "bfloat16", "fwd": rows,
             "ptxas": {var: rep for var, (_, rep) in libs.items()}})
    return 0


def _other_tree(src: str):
    """The flash-attention module of the ``repro_torch`` under ``src``,
    loaded as package ``other_repro_torch`` (its imports are relative)."""
    import importlib
    import importlib.util
    pkg = Path(src).resolve() / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("other_repro_torch.kernels.flash_attention")


def _host(cs, fa, args) -> int:
    import time
    import torch
    trees = {"this": fa}
    if args.against:
        trees["against"] = _other_tree(args.against)
    rows = []
    hq, hkv, s, d = SHAPES[0]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = cs._qkv(1, hq, hkv, s, s, d, dtype, seed=99)
        rounds = {name: [] for name in trees}
        for _ in range(8):                 # the first round warms up
            for name, mod in trees.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    mod.flash_attention(q, k, v)
                rounds[name].append((time.perf_counter() - t0) * 1e4)
        for name, mod in trees.items():
            torch.cuda.synchronize()
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(1000):
                mod.flash_attention(q, k, v)
            prof.disable()
            torch.cuda.synchronize()
            stats = sorted(pstats.Stats(prof).stats.items(),
                           key=lambda kv: -kv[1][2])[:10]
            rows.append({
                "tree": name, "source": mod.__file__,
                "dtype": str(dtype).removeprefix("torch."),
                "path": mod.flash_path(q, k, v),
                "shape": [1, hq, hkv, s, s, d],
                "host_us": statistics.median(rounds[name][1:]),
                "host_us_rounds": rounds[name][1:],
                "profile_us_a_call": [
                    [f"{Path(f).name}:{line}({fn})", tt * 1e3]
                    for (f, line, fn), (_, _, tt, _, _) in stats]})
    _append({"nvidia_smi": cs._smi(), "host_rows": rows})
    return 0


def _append(out: dict) -> None:
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "flash_ab.jsonl", "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=None,
                    help="NAME=FLAGS, repeatable")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--against", default=None,
                    help="with --host or --bwd: another tree's src")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--fwd", action="store_true",
                    help="the forward (the default; with --dtype bfloat16 "
                         "the wgmma kernel)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="with --bwd or --fwd")
    ap.add_argument("--cases", action="store_true",
                    help="with --bwd: errors over FLASH_BWD_CASES")
    ap.add_argument("--mma-peak", action="store_true")
    args = ap.parse_args()
    import chip_smoke as cs           # puts this tree's src on the path
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA card", file=sys.stderr)
        return 1
    if args.host:
        return _host(cs, fa, args)
    if args.mma_peak:
        return _mma_peak(cs)
    if args.bwd:
        return _bwd(cs, fa, args)
    if args.dtype == "bfloat16":
        return _fwd_bf16(cs, fa, args)
    variants = dict(v.split("=", 1)
                    for v in (args.variant or DEFAULT_VARIANTS))
    libs = _build(variants)
    kernels = {var: _entry(lib, "repro_flash_attention_tf32x3")
               for var, (lib, _) in libs.items()}
    fma = _entry(build.load("flash_attention"), "repro_flash_attention")
    rows = []
    for hq, hkv, s, d in SHAPES:
        q, k, v = cs._qkv(1, hq, hkv, s, s, d, torch.float32, seed=99)
        o = torch.empty_like(q)
        want = fa.flash_attention_plain(q, k, v)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        tail = (1, hq, hkv, s, s, d, 1, d ** -0.5, stream)

        def call(fn, *extra):
            err = fn(*ptrs, *extra, *tail)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        errs = {}
        for var, fn in kernels.items():
            call(fn)
            torch.cuda.synchronize()
            errs[var] = float(((o - want).abs() / (1 + want.abs())).max())
        call(fma, 0)
        torch.cuda.synchronize()
        errs["fma"] = float(((o - want).abs() / (1 + want.abs())).max())
        times = {name: [] for name in [*kernels, "fma", "sdpa"]}
        for _ in range(args.rounds):
            for var, fn in kernels.items():
                times[var].append(cs._time_ms(lambda: call(fn),
                                              iters=args.iters))
            times["fma"].append(cs._time_ms(lambda: call(fma, 0),
                                            iters=args.iters))
            times["sdpa"].append(cs._time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                iters=args.iters))
        rows.append({"shape": [1, hq, hkv, s, s, d],
                     "ms": {n: statistics.median(t) for n, t in times.items()},
                     "ms_rounds": times, "max_rel_err": errs})
        print(f"[ab] {rows[-1]}", flush=True)
    out = {"nvidia_smi": cs._smi(), "variants": variants,
           "ptxas": {var: rep for var, (_, rep) in libs.items()},
           "rows": rows}
    _append(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
