"""Card time of the sLSTM scan kernels (forward and backward), for
comparing two trees of the port in one chip call and for taking apart what
sets a step's time.

    python tools/torch_slstm_ab.py [--src DIR] [--label NAME] [--iters 20]
                                   [--variants] [--l2] [--check] [--host]
                                   [--sass] [--variant NAME ...]
                                   [--repeat N] [--seeds 0-15]

Imports ``repro_torch`` from ``DIR`` (default: this tree's ``src``; another
tree, for example the parent commit unpacked by ``git archive`` into an
ignored directory, is loaded as package ``other_repro_torch``), so the
kernels of two checkouts are timed by the same code: run parent, change,
change, parent, one process each.  The shapes and inputs are
``chip_smoke.py``'s (``SLSTM_PREFILL``, ``SLSTM_TRAIN``, ``_slstm_inputs``),
float32: the forward at the prefill [1, 1024, 768] keeping nothing, at the
training shape [2, 2048, 768] keeping the carry, and the backward at the
training shape on that forward's hs and kept carry.  Card time from CUDA
events around ``--iters`` calls after a spin kernel holds the stream
(``chip_smoke._time_ms``); ``ns_per_step`` is that over S.

``--variants`` adds the forward at the training shape keeping nothing, at
B 1 x S 2048 and at B 2 x S 1024 (each with and without the kept carry).
``--l2`` times single calls, each after gx was read by a reduction just
before it (L2-resident as far as it fits) or after a 256 MB write
(flushed), events around the call alone.  ``--check`` gives, for every
case of ``chip_smoke.SLSTM_CASES`` in both dtypes, the largest
``|kernel - plain| / (1 + |plain|)`` of each output (the plain versions
this tree's, for either tree's kernels), the forward's and the backward's
worst, and in float32 the
part of dr's error that is its sum's (each dr against its own dgx times
the h each step started from, summed in float64) and the kernel's and the
plain version's hs, kept carry, dgx and dr against the same function run
in float64 on the same inputs (``*_vs64_kernel``, ``*_vs64_plain``).
``--host`` times the wrapper's host time a call at S = 1 (a decode step's
shape, B 1 x d 768, no grad), 1,000 calls a round.  ``--sass`` runs the
toolkit's ``cuobjdump -sass`` on the tree's built libraries, writes the
listing to ``chiprun_out/slstm_sass_<label>_<lib>.txt`` and reports, per
kernel, its instruction count and each loop's (a backward branch's span)
count and opcode histogram, and nvcc's ``-Xptxas -v`` lines (registers,
spills) of a fresh build.  ``--variant NAME`` (one of ``PATCHES``) builds
a copy of this tree's backward source with a few lines replaced, written
to ``_build/ab/`` (the shipped source holds no switches): ``np4`` and
``np16`` producer warps for 8, ``tc16`` steps a chunk for 32, and the
probes ``skip_chain`` and ``skip_producers``, which leave one side of the
kernel out (wrong gradients, by design) to time the other alone, and
``chain64``, the chain's carried gradient in float64.  It times the copy
at the training shape beside the shipped build (shipped, variant,
variant, shipped) and gives the largest difference of its outputs from
the shipped build's, and with ``--seeds`` its errors over those seeds.

``--repeat N`` runs the forward keeping the carry and the backward N
times on one input at the training shape, in both dtypes, and gives for
each output (hs, the kept carry, the last carry, dgx, dr, the initial
carry's gradient) whether every run equals the first bit for bit, and
the largest difference where one does not.  ``--seeds A-B,C`` (ranges
and single seeds) gives, for each seed, the float32 backward's largest ``|kernel -
plain| / (1 + |plain|)`` of each gradient at the training shape (the
inputs of ``chip_smoke.slstm_grad_inputs``: zero carry, dhs and the last
carry's gradient from a seeded generator), dr's summation part of its
error (``dr_sum``, as ``--check`` splits it), and the worst over the
seeds.

Prints one JSON object (label, source, the card's name and power limit,
the rows) and appends it to ``chiprun_out/slstm_ab.jsonl``.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out"

# (label, (b, s, d), keep): the forward variants of --variants
VARIANTS = (("train_nokeep", (2, 2048, 768), False),
            ("b1_s2048", (1, 2048, 768), False),
            ("b1_s2048_kept", (1, 2048, 768), True),
            ("b2_s1024", (2, 1024, 768), False),
            ("b2_s1024_kept", (2, 1024, 768), True))
FLUSH_BYTES = 256 << 20
# --variant NAME: (the kernel, its source's lines replaced: each old text
# is found exactly once)
PATCHES = {
    "np4": ("bwd", [("constexpr int NP = 8;", "constexpr int NP = 4;")]),
    "np16": ("bwd", [("constexpr int NP = 8;", "constexpr int NP = 16;")]),
    "tc16": ("bwd", [("constexpr int TC = 32;", "constexpr int TC = 16;")]),
    "skip_chain": ("bwd", [("      if (p < nc) {\n        const float4* kb",
                            "      if (false) {\n        const float4* kb")]),
    "skip_producers": ("bwd", [("    issue(p + NS - 1);",
                                "    block_sync();\n    continue;\n"
                                "    issue(p + NS - 1);")]),
    # the chain's carried gradient in float64 (its coefficients, and the
    # copy each step hands the producers, float32) in place of float32
    # with dc, dn and dm summed compensated: what the chain's rounding
    # still costs dgx and dr
    "chain64": ("bwd", [
        ("template <typename T>\n__global__ void __launch_bounds__"
         "(blk::THREADS, 1) slstm_scan_bwd(",
         "__device__ __forceinline__ double4 chain64(const slstm::Coef& k, "
         "double4 g) {\n"
         "  double4 o;\n"
         "  o.x = fma((double)k.a.w, g.w, fma((double)k.a.z, g.z, "
         "fma((double)k.a.y, g.y, fma((double)k.a.x, g.x, "
         "(double)k.bias.x))));\n"
         "  o.y = fma((double)k.c.z, g.y, fma((double)k.c.x, g.x, "
         "(double)k.bias.y));\n"
         "  o.z = fma((double)k.c.z, g.z, fma((double)k.c.y, g.x, "
         "(double)k.bias.z));\n"
         "  o.w = fma((double)k.b.w, g.w, fma((double)k.b.z, g.z, "
         "fma((double)k.b.y, g.y, fma((double)k.b.x, g.x, "
         "(double)k.bias.w))));\n"
         "  return o;\n}\n\n"
         "template <typename T>\n__global__ void __launch_bounds__"
         "(blk::THREADS, 1) slstm_scan_bwd("),
        ("    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "    float4 lo = g;                                // the "
         "compensated rest",
         "    double4 g = make_double4(0., 0., 0., 0.);"),
        ("      g = make_float4(slstm::to_f32(dh_last[row]),",
         "      g = make_double4(slstm::to_f32(dh_last[row]),"),
        ("          gb[j * UNITS] = g;",
         "          gb[j * UNITS] = make_float4((float)g.x, (float)g.y, "
         "(float)g.z, (float)g.w);"),
        ("          g = slstm::chain(co, g, lo);",
         "          g = chain64(co, g);"),
        ("      dh0[row] = slstm::from_f32<T>(g.x);",
         "      dh0[row] = slstm::from_f32<T>((float)g.x);"),
        ("      dc0[row] = slstm::from_f32<T>(g.y);",
         "      dc0[row] = slstm::from_f32<T>((float)g.y);"),
        ("      dn0[row] = slstm::from_f32<T>(g.z);",
         "      dn0[row] = slstm::from_f32<T>((float)g.z);"),
        ("      dm0[row] = slstm::from_f32<T>(g.w);",
         "      dm0[row] = slstm::from_f32<T>((float)g.w);")]),
}


def _tree(src: str):
    """(the tree's ``kernels.slstm_scan`` module, its ``kernels.build``):
    this tree's own package, or another tree's as ``other_repro_torch``."""
    pkg = Path(src).resolve() / "repro_torch"
    if pkg == (ROOT / "src" / "repro_torch").resolve():
        name = "repro_torch"
    else:
        name = "other_repro_torch"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.kernels.slstm_scan"),
            importlib.import_module(f"{name}.kernels.build"))


def _fwd(cs, sl, b, s, d, keep, seed=700):
    import torch
    gx, r, carry = cs._slstm_inputs(b, s, d, torch.float32, "zero", seed)
    if keep:
        return gx, lambda: sl.slstm_scan_keep(gx, r, carry)
    return gx, lambda: sl.slstm_scan(gx, r, carry)


def _bwd(cs, sl, b, s, d):
    import torch
    gx, r, carry = cs._slstm_inputs(b, s, d, torch.float32, "zero", 700)
    hs, last, kept = sl.slstm_scan_keep(gx, r, carry)
    g = torch.Generator(device=cs.DEVICE)
    g.manual_seed(701)
    dhs = torch.randn(hs.shape, generator=g, device=cs.DEVICE)
    dlast = tuple(torch.zeros_like(t) for t in last)
    return lambda: sl.slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)


def _timing(cs, sl, args) -> list[dict]:
    import torch
    cases = [("prefill", cs.SLSTM_PREFILL, False),
             ("train_kept", cs.SLSTM_TRAIN, True)]
    if args.variants:
        cases += list(VARIANTS)
    rows = []
    with torch.no_grad():
        for label, (b, s, d), keep in cases:
            _, fn = _fwd(cs, sl, b, s, d, keep)
            ms = cs._time_ms(fn, iters=args.iters)
            rows.append({"case": label, "kernel": "forward",
                         "shape": [b, s, d], "kept": keep, "ms": ms,
                         "ns_per_step": ms * 1e6 / s})
            torch.cuda.empty_cache()
        b, s, d = cs.SLSTM_TRAIN
        ms = cs._time_ms(_bwd(cs, sl, b, s, d), iters=args.iters)
        rows.append({"case": "train_bwd", "kernel": "backward",
                     "shape": [b, s, d], "ms": ms,
                     "ns_per_step": ms * 1e6 / s})
    return rows


def _variants(cs, sl, build, specs: list[str], args) -> list[dict]:
    """Each ``PATCHES`` name: a copy of ``csrc``'s kernel source with its
    lines replaced, built into ``_build/ab/``, put in place of the
    wrapper's library, timed at its training-shape case and held to the
    shipped build's outputs (max abs difference); the shipped build timed
    in the same turn."""
    import ctypes
    import torch
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = {"fwd": ("slstm_scan", "_lib"), "bwd": ("slstm_scan_bwd",
                                                    "_bwd_lib")}
    procs = {}
    for name in specs:
        kind, edits = PATCHES[name]
        src, _ = names[kind]
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not found "
                                   f"exactly once in {src}.cu")
            text = text.replace(old, new)
        copy = out_dir / f"{src}-{name}.cu"
        copy.write_text(text)
        lib = out_dir / f"lib{src}-{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(lib), str(copy)]
        procs[name] = (kind, name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    b, s, d = cs.SLSTM_TRAIN
    gx, r, carry = cs._slstm_inputs(b, s, d, torch.float32, "zero", 700)
    hs, last, kept = sl.slstm_scan_keep(gx, r, carry)
    g = torch.Generator(device=cs.DEVICE)
    g.manual_seed(701)
    dhs = torch.randn(hs.shape, generator=g, device=cs.DEVICE)
    dlast = tuple(torch.zeros_like(t) for t in last)
    calls = {"fwd": lambda: sl.slstm_scan_keep(gx, r, carry),
             "bwd": lambda: sl.slstm_scan_bwd(gx, r, carry, hs, kept, dhs,
                                              dlast)}
    shipped = {k: [t.clone() for t in _flat(fn())] for k, fn in calls.items()}
    rows = []
    for spec, (kind, name, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        attr = names[kind][1]
        ship_lib = getattr(sl, attr)()
        var_lib = ctypes.CDLL(str(lib))
        fn_name = ("repro_slstm_scan" if kind == "fwd"
                   else "repro_slstm_scan_bwd")
        getattr(var_lib, fn_name).restype = ctypes.c_int
        getattr(var_lib, fn_name).argtypes = getattr(ship_lib,
                                                     fn_name).argtypes
        row = {"variant": spec,
               "ptxas": [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln]}
        try:
            ms = {}
            for turn in ("shipped", name, name, "shipped"):
                setattr(sl, attr, (lambda lb=var_lib: lb) if turn == name
                        else (lambda lb=ship_lib: lb))
                ms.setdefault(turn, []).append(
                    cs._time_ms(calls[kind], iters=args.iters))
                if turn == name:
                    got = _flat(calls[kind]())
                    row["max_abs_diff"] = max(
                        float((u.float() - v.float()).abs().max())
                        for u, v in zip(got, shipped[kind]))
            row["ms"] = ms
            if args.seeds:                # the variant's errors over seeds
                setattr(sl, attr, lambda lb=var_lib: lb)
                row["seeds"] = _seeds(cs, sl, args.seeds)
        except RuntimeError as err:       # a launch the variant cannot make
            row["error"] = str(err)
        setattr(sl, attr, lambda lb=ship_lib: lb)
        rows.append(row)
    return rows


def _flat(out) -> list:
    import torch
    flat = []
    for t in out:
        if isinstance(t, torch.Tensor):
            flat.append(t)
        elif t is not None:
            flat.extend(_flat(t))
    return flat


def _per_call_ms(cs, fn, prep, iters: int) -> list[float]:
    """Card time of each of ``iters`` calls of ``fn``, ``prep`` run on the
    stream before each, events around ``fn`` alone; a spin kernel holds the
    stream while the host queues them."""
    import torch
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.RUN_AHEAD_CYCLES)
    for st, en in zip(starts, ends):
        prep()
        st.record()
        fn()
        en.record()
    torch.cuda.synchronize()
    return [st.elapsed_time(en) for st, en in zip(starts, ends)]


def _l2(cs, sl, args) -> list[dict]:
    import torch
    scratch = torch.empty(FLUSH_BYTES // 4, device=cs.DEVICE)
    rows = []
    with torch.no_grad():
        for label, (b, s, d), keep in (("prefill", cs.SLSTM_PREFILL, False),
                                       ("train_nokeep", cs.SLSTM_TRAIN,
                                        False),
                                       ("train_kept", cs.SLSTM_TRAIN, True)):
            gx, fn = _fwd(cs, sl, b, s, d, keep)
            preps = {"gx_read_before": lambda: gx.sum(),
                     "l2_flushed": lambda: scratch.fill_(1.0)}
            for how, prep in preps.items():
                ms = _per_call_ms(cs, fn, prep, args.iters)
                rows.append({"case": label, "shape": [b, s, d],
                             "kept": keep, "l2": how,
                             "ms": statistics.median(ms),
                             "ms_min": min(ms), "ms_max": max(ms),
                             "ns_per_step": statistics.median(ms) * 1e6 / s})
            torch.cuda.empty_cache()
    return rows


def _dr64(dgx, carry, hs):
    """dr summed in float64 from ``dgx`` (float32: dpre itself) and the h
    each step started from."""
    import torch
    h = torch.cat([carry[0][:, None], hs[:, :-1]], 1).double()
    return (dgx.double() * h[:, :, None, :]).sum((0, 1))


def _check(cs, sl) -> dict:
    import torch
    from repro_torch.kernels import slstm_scan as plain   # this tree's
    worst, rows = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, s, d, carry_kind) in enumerate(cs.SLSTM_CASES):
            gx, r, carry = cs._slstm_inputs(b, s, d, dtype, carry_kind,
                                            500 + i)
            hs, last, kept = sl.slstm_scan_keep(gx, r, carry)
            g = torch.Generator(device=cs.DEVICE)
            g.manual_seed(600 + i)
            dhs = torch.randn(hs.shape, generator=g,
                              device=cs.DEVICE).to(dtype)
            dlast = tuple(torch.randn(t.shape, generator=g,
                                      device=cs.DEVICE).to(dtype)
                          for t in last)
            grads = sl.slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)
            want_hs, want_last, want_kept = plain.slstm_scan_plain(
                gx, r, carry, keep=True)
            want = plain.slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs,
                                              dlast)
            row = {"dtype": name, "shape": [b, s, d], "carry": carry_kind}
            if dtype == torch.float32:
                # each dr against its own dgx summed in float64: the
                # summation's part of dr's error, kernel and plain apart
                for who, (dg, dr) in (("kernel", grads[:2]),
                                      ("plain", want[:2])):
                    d64 = _dr64(dg, carry, hs)
                    row[f"dr_sum_rel_{who}"] = float(
                        ((dr.double() - d64).abs() / (1 + d64.abs())).max())
                # the same function in float64 on the same inputs (hs and
                # the kept carry as the kernel kept them): kernel and plain
                # float32 each against it
                f64 = lambda ts: tuple(t.double().cpu() for t in ts)
                hs64, last64, kept64 = plain.slstm_scan_plain(
                    *f64((gx, r)), f64(carry), keep=True)
                g64 = plain.slstm_scan_bwd_plain(
                    *f64((gx, r)), f64(carry), *f64((hs, kept, dhs)),
                    f64(dlast))
                vs64 = {"hs": (hs, want_hs, hs64),
                        "kept": (kept, want_kept, kept64),
                        "dgx": (grads[0], want[0], g64[0]),
                        "dr": (grads[1], want[1], g64[1])}
                for k, (kern, pl, ex) in vs64.items():
                    for who, v in (("kernel", kern), ("plain", pl)):
                        row[f"{k}_vs64_{who}"] = float(
                            ((v.double().cpu() - ex).abs()
                             / (1 + ex.abs())).max())
            pairs = {"fwd": [("hs", hs, want_hs), ("kept", kept, want_kept),
                             *((f"last_{k}", u, v)
                               for k, u, v in zip("hcnm", last, want_last))],
                     "bwd": [("dgx", grads[0], want[0]),
                             ("dr", grads[1], want[1]),
                             *((f"d{k}0", u, v)
                               for k, u, v in zip("hcnm", grads[2],
                                                  want[2]))]}
            for part, items in pairs.items():
                for label, got, ref in items:
                    ref = ref.float()
                    rel = float(((got.float() - ref).abs()
                                 / (1.0 + ref.abs())).max())
                    row[f"{label}_rel"] = rel
                    key = f"{part}_{name}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    wk = f"{part}_{name}_{label}"
                    worst[wk] = max(worst.get(wk, 0.0), rel)
            rows.append(row)
            torch.cuda.empty_cache()
    return {"worst_rel": worst, "rows": rows}


def _outputs(sl, gx, r, carry, dhs, dlast) -> dict:
    """Every output of a forward keeping the carry and of the backward on
    its hs and kept carry, by name."""
    hs, last, kept = sl.slstm_scan_keep(gx, r, carry)
    grads = sl.slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)
    return {"hs": hs, "kept": kept,
            **{f"last_{k}": t for k, t in zip("hcnm", last)},
            "dgx": grads[0], "dr": grads[1],
            **{f"d{k}0": t for k, t in zip("hcnm", grads[2])}}


def _repeat(cs, sl, runs: int) -> dict:
    import torch
    out = {}
    b, s, d = cs.SLSTM_TRAIN
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        ins = cs.slstm_grad_inputs(b, s, d, dtype, "zero", 0)
        first = _outputs(sl, *ins)
        row = {"runs": runs, "equal": True, "max_diff": {}}
        for _ in range(runs - 1):
            again = _outputs(sl, *ins)
            for k, t in again.items():
                if not torch.equal(t, first[k]):
                    row["equal"] = False
                    diff = float((t.float() - first[k].float()).abs().max())
                    row["max_diff"][k] = max(row["max_diff"].get(k, 0.0),
                                             diff)
        out[name] = row
        torch.cuda.empty_cache()
    return out


def _seeds(cs, sl, seeds: list[int]) -> dict:
    import torch
    from repro_torch.kernels import slstm_scan as plain   # this tree's
    b, s, d = cs.SLSTM_TRAIN
    rows, worst = [], {}
    for seed in seeds:
        gx, r, carry, dhs, dlast = cs.slstm_grad_inputs(
            b, s, d, torch.float32, "zero", seed)
        hs, last, kept = sl.slstm_scan_keep(gx, r, carry)
        got = sl.slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)
        want = plain.slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs, dlast)
        row = {"seed": seed}
        for k, u, v in (("dgx", got[0], want[0]), ("dr", got[1], want[1]),
                        *((f"d{c}0", u, v)
                          for c, u, v in zip("hcnm", got[2], want[2]))):
            v = v.float()
            row[k] = float(((u.float() - v).abs() / (1 + v.abs())).max())
            worst[k] = max(worst.get(k, 0.0), row[k])
        # dr against its own dgx summed in float64: the sum's part of dr's
        # error (the rest is dgx's, carried into dr)
        d64 = _dr64(got[0], carry, hs)
        row["dr_sum"] = float(((got[1].double() - d64).abs()
                               / (1 + d64.abs())).max())
        worst["dr_sum"] = max(worst.get("dr_sum", 0.0), row["dr_sum"])
        rows.append(row)
        torch.cuda.empty_cache()
    return {"shape": [b, s, d], "worst": worst, "rows": rows}


def _seed_list(text: str) -> list[int]:
    """"0-15,2816" -> 0, 1, ..., 15, 2816"""
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += range(int(lo), int(hi or lo) + 1)
    return seeds


def _host(sl, args) -> dict:
    import torch
    gx = torch.randn(1, 1, 4, 768, device="cuda")
    r = torch.randn(4, 768, device="cuda") * 0.1
    carry = tuple(torch.zeros(1, 768, device="cuda") for _ in range(4))
    rounds = []
    with torch.no_grad():
        for _ in range(6):                       # the first round warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                sl.slstm_scan(gx, r, carry)
            rounds.append((time.perf_counter() - t0) * 1e3)   # us a call
            torch.cuda.synchronize()
    return {"shape": [1, 1, 768], "host_us": statistics.median(rounds[1:]),
            "host_us_rounds": rounds[1:]}


_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def _loops(text: str) -> dict:
    """Per kernel function in a ``cuobjdump -sass`` listing: its
    instruction count and, for each backward branch, the span it closes
    (instructions and an opcode histogram)."""
    out, name, insts, labels, pending = {}, None, [], {}, []

    def close():
        if name is None:
            return
        loops = []
        for i, (_, op, target) in enumerate(insts):
            if target is None:
                continue
            j = labels.get(target)
            if j is None and target.startswith("0x"):
                addr = int(target, 16)
                j = next((k for k, (a, _, _) in enumerate(insts)
                          if a == addr), None)
            if j is not None and j <= i:
                span = [o for _, o, _ in insts[j:i + 1]]
                loops.append({"instructions": len(span),
                              "opcodes": dict(collections.Counter(
                                  s.split(".")[0] for s in span)
                                  .most_common())})
        out[name] = {"instructions": len(insts), "loops": loops}

    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, insts, labels, pending = (line.split("Function :")[1]
                                            .strip(), [], {}, [])
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _LINE.search(line)
        if not m or name is None:
            continue
        body = m.group(2)
        if body.startswith("@"):
            body = body.split(None, 1)[1]
        op = body.split()[0]
        target = None
        if op.startswith("BRA"):
            t = re.search(r"\(?`?\(?(\.L_x_\d+)\)?|(0x[0-9a-f]+)", body)
            if t:
                target = t.group(1) or t.group(2)
        for p in pending:
            labels[p] = len(insts)
        pending = []
        insts.append((int(m.group(1), 16), op, target))
    close()
    return out


def _sass(built: dict, args) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    OUT.mkdir(exist_ok=True)
    report = {}
    for lib, info in built.items():
        text = subprocess.run([tool, "-sass", info["path"]],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        (OUT / f"slstm_sass_{args.label}_{lib}.txt").write_text(text)
        report[lib] = _loops(text)
        report[lib]["ptxas"] = [line for line in info["log"].splitlines()
                                if "slstm" in line or "registers" in line
                                or "spill" in line]
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--l2", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(PATCHES), help="repeatable")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--seeds", type=_seed_list, default=[])
    args = ap.parse_args()
    import chip_smoke as cs           # puts this tree's src on the path
    import torch
    if not torch.cuda.is_available():
        print("torch_slstm_ab: no CUDA card", file=sys.stderr)
        return 1
    sl, build = _tree(args.src)
    built = (build.build(("slstm_scan", "slstm_scan_bwd")) if args.sass
             else None)                      # first, so that nvcc reports
    out = {"label": args.label, "source": sl.__file__,
           "nvidia_smi": cs._smi(), "rows": _timing(cs, sl, args)}
    if args.l2:
        out["l2"] = _l2(cs, sl, args)
    if args.check:
        out["check"] = _check(cs, sl)
    if args.repeat:
        out["repeat"] = _repeat(cs, sl, args.repeat)
    if args.seeds:
        out["seeds"] = _seeds(cs, sl, args.seeds)
    if args.host:
        out["host"] = _host(sl, args)
    if args.sass:
        out["sass"] = _sass(built, args)
    if args.variant:
        out["variants"] = _variants(cs, sl, build, args.variant, args)
    OUT.mkdir(exist_ok=True)
    with open(OUT / "slstm_ab.jsonl", "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
