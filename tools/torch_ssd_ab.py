"""Card time of the SSD scan kernel at the served shapes, or of its
backward at the training shapes, for comparing two trees of the port in
one chip call.

    python tools/torch_ssd_ab.py [--src DIR] [--label NAME] [--iters 20]
                                 [--profile] [--bwd]

Imports ``repro_torch`` from ``DIR`` (default: this tree's ``src``), so
the kernel of another checkout (for example the parent commit unpacked
into an ignored directory) is timed by the same code: run parent, change,
change, parent, one process each.  The shapes and inputs are
``chip_smoke.py``'s: zamba2's heads, the mLSTM values and the mLSTM
normalizer at S = 256, 1024 and 4096, float32, card time from CUDA events
around ``--iters`` calls after a spin kernel holds the stream; with
``--profile``, also each pass's card time from ``torch.profiler``.  With
``--bwd``, the backward kernel instead (``ssd_scan_bwd``) at
``chip_smoke.py``'s training shapes (``SSD_BWD_TRAIN``): zamba2's heads at
B 2 x S 2048, the mLSTM values and normalizer at B 8 (2 x 4 heads
folded) x S 2048, as training calls it: reading the forward's kept
scratch (``ssd_scan_keep``), route "kept", or in a tree that keeps none
computing C . B^T, Acum and h_c again, route "recompute".  Prints one
JSON object (label, source, the card's name and power limit, ms by shape
and the route timed) and appends it to ``chiprun_out/ssd_ab.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = {"zamba2": (1, 32, 128, 64, "mild"),
         "mlstm_values": (4, 1, 384, 384, "mlstm"),
         "mlstm_normalizer": (4, 1, 1, 384, "mlstm")}


def _route(ssd_scan, bwd) -> str:
    if not bwd:
        return "forward"
    return "kept" if hasattr(ssd_scan, "ssd_scan_keep") else "recompute"


def _call(cs, ssd_scan, route, b, s, h, d, n, decay):
    """A call of the forward kernel (``route`` "forward") or of the
    backward on that route, on ``chip_smoke.py``'s inputs of these
    shapes (the backward's dy drawn as ``chip_smoke._ssd_bwd_inputs``
    draws it)."""
    import torch
    x, a, bm, cm = cs._ssd_inputs(b, s, h, d, n, torch.float32, decay,
                                  seed=99)
    if route == "forward":
        return lambda: ssd_scan.ssd_scan(x, a, bm, cm)
    with torch.no_grad():
        y = ssd_scan.ssd_scan(x, a, bm, cm)
    g = torch.Generator(device=cs.DEVICE)
    g.manual_seed(99 + 1000)
    dy = torch.randn(y.shape, generator=g, device=cs.DEVICE)
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
    args = ap.parse_args()
    import chip_smoke as cs           # puts this tree's src on the path
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import ssd_scan
    if not torch.cuda.is_available():
        print("torch_ssd_ab: no CUDA card", file=sys.stderr)
        return 1
    if args.bwd:
        cases = cs.SSD_BWD_TRAIN
    else:
        cases = {f"{label}@{s}": (b, s, h, d, n, decay)
                 for s in (256, 1024, 4096)
                 for label, (b, h, d, n, decay) in CASES.items()}
    rows = []
    route = _route(ssd_scan, args.bwd)
    for label, spec in cases.items():
        ms = cs._time_ms(_call(cs, ssd_scan, route, *spec), iters=args.iters)
        rows.append({"case": label.split("@")[0], "shape": list(spec[:5]),
                     "route": route, "ms": ms})
        torch.cuda.empty_cache()
    out = {"label": args.label, "source": ssd_scan.__file__,
           "nvidia_smi": cs._smi(), "bwd": args.bwd, "rows": rows}
    if args.profile:
        at = (cs.SSD_BWD_TRAIN if args.bwd else
              {label: (b, 1024, h, d, n, decay)
               for label, (b, h, d, n, decay) in CASES.items()})
        out["passes_us"] = {
            label: _passes_us(_call(cs, ssd_scan, route, *spec))
            for label, spec in at.items()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "ssd_ab.jsonl", "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
