"""Summarise a directory of the port's dry-run records
(``python -m repro_torch.launch.dryrun --out DIR``): the cells' status
counts and seconds, the roofline's dominant term per cell, and beside it
the verdict the dry-run gave before its step ran as DTensors (the whole
step's flops, bytes and peak split evenly over the devices, the
collectives derived from the specs), which the records keep
(``work.whole``, ``collectives_derived``): the cells whose ``fits_hbm`` or
``dominant`` differ, the per-device counts over the even split, and the
observed collectives over the derived ones.

    python tools/dryrun_summary.py DIR [--cells]

(DIR: the records' directory, the dry-run's ``--out``.)
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.kernels import work  # noqa: E402

HBM = work.H100_HBM_BYTES


def _even_split(rec: dict) -> dict:
    """The verdict of the even split: the whole step over the devices, the
    derived collectives."""
    n = rec["n_devices"]
    whole = rec["work"]["whole"]
    peaks = rec["roofline"]["peaks"]
    terms = {"compute": whole["flops"] / n / peaks["flops"],
             "memory": whole["bytes"] / n / peaks["bytes_per_s"],
             "collective": rec["collectives_derived"]["bytes"]["total"]
             / peaks["net_bytes_per_s"]}
    args = rec["memory"]["argument_bytes_per_device"]
    return {"dominant": max(terms, key=terms.get),
            "fits_hbm": args + whole["peak_bytes"] / n <= HBM,
            "per_device_bytes": args + whole["peak_bytes"] / n}


def _span(values) -> str:
    values = sorted(values)
    return f"{values[0]:.3f}–{values[-1]:.3f}" if values else "none"


def summarise(recs: list[dict], cells: bool) -> dict:
    counts = {s: sum(r["status"] == s for r in recs)
              for s in ("OK", "SKIPPED", "FAIL")}
    ok = [r for r in recs if r["status"] == "OK"]
    out = {"counts": counts,
           "seconds": sum(r.get("seconds", 0.0) for r in recs),
           "dominant": {}, "dominant_even_split": {},
           "fits_changed": [], "dominant_changed": [],
           "over_even_split": {}, "observed_over_derived": {}}
    for term in ("compute", "memory", "collective"):
        out["dominant"][term] = sum(r["roofline"]["dominant"] == term
                                    for r in ok)
        out["dominant_even_split"][term] = sum(
            _even_split(r)["dominant"] == term for r in ok)
    for r in ok:
        tag = f"{r['arch']}__{r['shape']}__{r['mesh']}"
        old = _even_split(r)
        if old["fits_hbm"] != r["fits_hbm"]:
            out["fits_changed"].append(
                (tag, old["per_device_bytes"],
                 r["memory"]["per_device_bytes"]))
        if old["dominant"] != r["roofline"]["dominant"]:
            out["dominant_changed"].append(
                (tag, old["dominant"], r["roofline"]["dominant"]))
    for kind in ("train", "prefill", "decode"):
        rs = [r for r in ok if SHAPES[r["shape"]].kind == kind]
        out["over_even_split"][kind] = {
            k: _span(r["work"]["whole"]["per_device_over_even_split"][k]
                     for r in rs) for k in ("flops", "bytes", "peak_bytes")}
        out["observed_over_derived"][kind] = _span(
            r["collectives_observed_over_derived"] for r in rs
            if r["collectives_observed_over_derived"] is not None)
    if cells:
        out["cells"] = {
            f"{r['arch']}__{r['shape']}__{r['mesh']}": {
                "flops": r["work"]["flops"], "bytes": r["work"]["bytes"],
                "peak_bytes": r["work"]["peak_bytes"],
                "over_even_split":
                    r["work"]["whole"]["per_device_over_even_split"],
                "collectives_observed": r["collectives"]["bytes"]["total"],
                "collectives_derived":
                    r["collectives_derived"]["bytes"]["total"],
                "fits_hbm": r["fits_hbm"],
                "dominant": r["roofline"]["dominant"],
                "seconds": r["seconds"]} for r in ok}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--cells", action="store_true",
                    help="also each OK cell's numbers")
    args = ap.parse_args()
    recs = [json.loads(p.read_text())
            for p in sorted(Path(args.dir).glob("*.json"))]
    print(json.dumps(summarise(recs, args.cells), indent=1,
                     ensure_ascii=False))


if __name__ == "__main__":
    main()
