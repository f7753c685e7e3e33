"""Card time of the SSD scan kernel at the served shapes, or of its
backward at the training shapes, for comparing two trees of the port in
one chip call.

    python tools/torch_ssd_ab.py [--src DIR] [--label NAME] [--iters 20]
                                 [--profile] [--bwd] [--train]
                                 [--dtype float32|bfloat16] [--errors]
                                 [--seeds 0-15]

Imports ``repro_torch`` from ``DIR`` (default: this tree's ``src``;
another tree, for example the parent commit unpacked by ``git archive``
into an ignored directory, is loaded as package ``other_repro_torch``,
since ``chip_smoke`` has already imported this tree's), so the kernel of
another checkout is timed by the same code: run parent, change, change,
parent, one process each.  The shapes and inputs are
``chip_smoke.py``'s: zamba2's heads, the mLSTM values and the mLSTM
normalizer at S = 256, 1024 and 4096, float32, card time from CUDA events
around ``--iters`` calls after a spin kernel holds the stream; with
``--profile``, also each pass's card time from ``torch.profiler``.  With
``--bwd``, the backward kernel instead (``ssd_scan_bwd``) at
``chip_smoke.py``'s training shapes (``SSD_BWD_TRAIN``): zamba2's heads at
B 2 x S 2048, the mLSTM values and normalizer at B 8 (2 x 4 heads
folded) x S 2048, as training calls it: reading the forward's kept
scratch (``ssd_scan_keep``), route "kept", or in a tree that keeps none
computing C . B^T, Acum and h_c again, route "recompute".  ``--train``
times the forward at those training shapes too (keeping nothing, as a
no-grad call does).  ``--dtype bfloat16`` makes the inputs bfloat16 (the
same draws, rounded).  ``--errors`` also gives, in that dtype, for every
case of ``chip_smoke.SSD_CASES`` (the forward) and ``SSD_BWD_CASES`` (the
backward, on the tree's own forward kernel's kept scratch), and of the
card tests' ``SSD_FWD_CASES``, ``SSD_BWD_CASES`` and (bfloat16)
``SSD_ROUTE_CASES`` on the inputs those tests draw, each output's
``||g - plain|| / ||plain||`` and its largest ``|g - plain| / (1 +
|plain|)``, and the worst of each over the cases: the readings that
ground ``chip_smoke.SSD_BF16_KEEP``.  ``--seeds A-B,C`` (ranges and
single seeds) gives, in that dtype, for each seed and each of the
backward's training shapes (``chip_smoke.SSD_BWD_TRAIN``), the largest
``|g - plain| / (1 + |plain|)`` of dx, da, db and dc, on inputs drawn as
``chip_smoke._ssd_bwd_inputs`` draws them at that seed and the tree's own
forward's kept scratch, and the worst of each over the seeds with its
seed, beside ``chip_smoke.SSD_BWD_F32_KEEP``.  Prints one JSON object (label,
source, the card's name and power limit, ms by shape and the route
timed) and appends it to ``chiprun_out/ssd_ab.jsonl``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = {"zamba2": (1, 32, 128, 64, "mild"),
         "mlstm_values": (4, 1, 384, 384, "mlstm"),
         "mlstm_normalizer": (4, 1, 1, 384, "mlstm")}


def _tree(src: str):
    """The tree's ``kernels.ssd_scan`` module: this tree's own, or another
    tree's loaded as package ``other_repro_torch``."""
    pkg = Path(src).resolve() / "repro_torch"
    if pkg == (ROOT / "src" / "repro_torch").resolve():
        return importlib.import_module("repro_torch.kernels.ssd_scan")
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("other_repro_torch.kernels.ssd_scan")


def _route(ssd_scan, bwd) -> str:
    if not bwd:
        return "forward"
    return "kept" if hasattr(ssd_scan, "ssd_scan_keep") else "recompute"


def _call(cs, ssd_scan, route, dtype, b, s, h, d, n, decay):
    """A call of the forward kernel (``route`` "forward") or of the
    backward on that route, on ``chip_smoke.py``'s inputs of these
    shapes in ``dtype`` (the backward's dy drawn as
    ``chip_smoke._ssd_bwd_inputs`` draws it)."""
    import torch
    x, a, bm, cm = cs._ssd_inputs(b, s, h, d, n, dtype, decay, seed=99)
    if route == "forward":
        return lambda: ssd_scan.ssd_scan(x, a, bm, cm)
    with torch.no_grad():
        y = ssd_scan.ssd_scan(x, a, bm, cm)
    g = torch.Generator(device=cs.DEVICE)
    g.manual_seed(99 + 1000)
    dy = torch.randn(y.shape, generator=g, device=cs.DEVICE).to(dtype)
    kept = ({"saved": ssd_scan.ssd_scan_keep(x, a, bm, cm)[1]}
            if route == "kept" else {})
    return lambda: ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, dy, **kept)


def _passes_us(fn, calls=10) -> dict:
    """Card time of each kernel that one call of ``fn`` launches, in
    microseconds (the mean over ``calls`` calls, from ``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        name = re.search(r"ssd_\w+(<[^>]*>)?", evt.key)
        if us and name:
            out[name.group(0)] = out.get(name.group(0), 0.0) + us / calls
    return out


def _errs(got, want, names) -> dict:
    """``||g - plain|| / ||plain||`` and the largest ``|g - plain| / (1 +
    |plain|)`` of each output, by name."""
    out = {}
    for name, g, w in zip(names, got, want):
        g, w = g.float(), w.float()
        out[f"{name}_norm"] = float((g - w).norm() / w.norm())
        out[f"{name}_elem"] = float(((g - w).abs() / (1 + w.abs())).max())
    return out


def _card_tests():
    """``tests/test_torch_cuda.py`` as a module: its SSD cases and the
    inputs it draws for them."""
    spec = importlib.util.spec_from_file_location(
        "_card_tests", ROOT / "tests" / "test_torch_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bwd_case(ssd_scan, x, a, bm, cm, dy):
    """The backward's outputs and its plain version's on the tree's own
    forward (its y and kept scratch)."""
    y, saved = ssd_scan.ssd_scan_keep(x, a, bm, cm)
    ins = (x, a, bm, cm, y, dy.to(x.dtype))
    got = ssd_scan.ssd_scan_bwd(*ins, saved=saved)
    del saved
    return got, ssd_scan.ssd_scan_bwd_plain(*ins)


def _cases(cs, tests, ssd_scan, dtype):
    """(kind, shape, decay or case, a call giving (got, want)) of every SSD
    case in ``dtype``: chip_smoke's forward and backward cases as
    ``check_ssd`` and ``check_ssd_bwd`` draw them, then the card tests'
    (``SSD_FWD_CASES``, ``SSD_BWD_CASES`` and in bfloat16
    ``SSD_ROUTE_CASES``) as they draw them."""
    import torch

    def dy_of(seed, shape):
        g = torch.Generator(device=cs.DEVICE)
        g.manual_seed(seed)
        return torch.randn(shape, generator=g, device=cs.DEVICE)

    def fwd(ins):
        return lambda: ((ssd_scan.ssd_scan(*ins),),
                        (ssd_scan.ssd_scan_plain(*ins),))

    out = []
    for i, (b, s, h, d, n, decay) in enumerate(cs.SSD_CASES):
        out.append(("fwd", (b, s, h, d, n), decay, fwd(
            cs._ssd_inputs(b, s, h, d, n, dtype, decay, seed=i))))
    for i, (b, s, h, d, n, decay) in enumerate(cs.SSD_BWD_CASES):
        ins = cs._ssd_inputs(b, s, h, d, n, dtype, decay, seed=300 + i)
        out.append(("bwd", (b, s, h, d, n), decay,
                    lambda ins=ins, seed=1300 + i, sh=(b, s, h, d): _bwd_case(
                        ssd_scan, *ins, dy_of(seed, sh))))
    card = cs.DEVICE
    for (b, s, h, d, n, strong) in tests.SSD_FWD_CASES:
        out.append(("card_fwd", (b, s, h, d, n), strong, fwd(
            tests._ssd_inputs(card, b, s, h, d, n, dtype, strong))))
    for (b, s, h, d, n, strong) in tests.SSD_BWD_CASES:
        ins = tests._ssd_inputs(card, b, s, h, d, n, dtype, strong)
        out.append(("card_bwd", (b, s, h, d, n), strong,
                    lambda ins=ins, seed=s * 13 + d + n, sh=(b, s, h, d):
                    _bwd_case(ssd_scan, *ins, dy_of(seed, sh))))
    if dtype == torch.bfloat16:
        for (b, s, h, d, n, off, _) in tests.SSD_ROUTE_CASES:
            *ins, dy = tests._ssd_route_inputs(card, b, s, h, d, n, off)
            out.append(("card_route", (b, s, h, d, n), off,
                        lambda ins=ins, dy=dy: _route_case(ssd_scan, ins,
                                                           dy)))
    return out


def _route_case(ssd_scan, ins, dy):
    """y and the backward's outputs, and their plain versions'."""
    got, want = _bwd_case(ssd_scan, *ins, dy)
    return ((ssd_scan.ssd_scan(*ins), *got),
            (ssd_scan.ssd_scan_plain(*ins), *want))


def _errors(cs, ssd_scan, dtype) -> dict:
    """Each output's error against the plain version over chip_smoke's
    forward and backward cases and the card tests' (``_cases``), and the
    worst of each over all of them."""
    import torch
    rows, worst = [], {}
    names = {1: ("y",), 4: ("dx", "da", "db", "dc"),
             5: ("y", "dx", "da", "db", "dc")}
    for kind, shape, decay, call in _cases(cs, _card_tests(), ssd_scan,
                                           dtype):
        got, want = call()
        row = {"kind": kind, "shape": list(shape), "decay": decay,
               **_errs(got, want, names[len(got)])}
        for k, v in row.items():
            if k.endswith(("_norm", "_elem")):
                worst[k] = max(worst.get(k, 0.0), v)
        rows.append(row)
        del got, want
        torch.cuda.empty_cache()
    return {"worst": worst, "rows": rows}


def _seeds(cs, ssd_scan, dtype, seeds: list[int]) -> dict:
    """The backward's largest ``|g - plain| / (1 + |plain|)`` of each
    gradient at each training shape and seed, and the worst over the
    seeds (value and seed) beside its keep-limit."""
    import torch
    names = ("dx", "da", "db", "dc")
    out = {}
    for label, (b, s, h, d, n, decay) in cs.SSD_BWD_TRAIN.items():
        rows, worst = [], {}
        for seed in seeds:
            x, a, bm, cm = cs._ssd_inputs(b, s, h, d, n, dtype, decay, seed)
            g = torch.Generator(device=cs.DEVICE)
            g.manual_seed(seed + 1000)
            dy = torch.randn((b, s, h, d), generator=g, device=cs.DEVICE)
            got, want = _bwd_case(ssd_scan, x, a, bm, cm, dy)
            row = {"seed": seed}
            for name, u, v in zip(names, got, want):
                u, v = u.float(), v.float()
                row[name] = float(((u - v).abs() / (1 + v.abs())).max())
                if row[name] >= worst.get(name, (-1.0, None))[0]:
                    worst[name] = (row[name], seed)
            rows.append(row)
            del x, a, bm, cm, dy, got, want
            torch.cuda.empty_cache()
        out[label] = {"shape": [b, s, h, d, n], "decay": decay,
                      "worst": {k: {"value": v, "seed": sd}
                                for k, (v, sd) in worst.items()},
                      "keep": cs.SSD_BWD_F32_KEEP,
                      "within_keep": all(v <= cs.SSD_BWD_F32_KEEP[k]
                                         for k, (v, _) in worst.items()),
                      "rows": rows}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also the card time of each pass (torch.profiler) "
                         "at S = 1024 (the backward: at its shapes)")
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward kernel at the training shapes")
    ap.add_argument("--train", action="store_true",
                    help="time the forward at the training shapes")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--errors", action="store_true",
                    help="each output's error over chip_smoke's cases")
    ap.add_argument("--seeds", default="",
                    help="the backward's error over these seeds (0-15,99) "
                         "at the training shapes")
    args = ap.parse_args()
    import chip_smoke as cs           # puts this tree's src on the path
    import torch
    ssd_scan = _tree(args.src)
    if not torch.cuda.is_available():
        print("torch_ssd_ab: no CUDA card", file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    if args.bwd or args.train:
        cases = cs.SSD_BWD_TRAIN
    else:
        cases = {f"{label}@{s}": (b, s, h, d, n, decay)
                 for s in (256, 1024, 4096)
                 for label, (b, h, d, n, decay) in CASES.items()}
    rows = []
    route = _route(ssd_scan, args.bwd)
    for label, spec in cases.items():
        ms = cs._time_ms(_call(cs, ssd_scan, route, dtype, *spec),
                         iters=args.iters)
        rows.append({"case": label.split("@")[0], "shape": list(spec[:5]),
                     "route": route, "ms": ms})
        torch.cuda.empty_cache()
    out = {"label": args.label, "source": ssd_scan.__file__,
           "nvidia_smi": cs._smi(), "bwd": args.bwd, "dtype": args.dtype,
           "rows": rows}
    if args.profile:
        at = (cs.SSD_BWD_TRAIN if args.bwd or args.train else
              {label: (b, 1024, h, d, n, decay)
               for label, (b, h, d, n, decay) in CASES.items()})
        out["passes_us"] = {
            label: _passes_us(_call(cs, ssd_scan, route, dtype, *spec))
            for label, spec in at.items()}
    if args.errors:
        out["errors"] = _errors(cs, ssd_scan, dtype)
    if args.seeds:
        from torch_slstm_ab import _seed_list     # a sibling in tools/
        out["seeds"] = _seeds(cs, ssd_scan, dtype, _seed_list(args.seeds))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "ssd_ab.jsonl", "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
