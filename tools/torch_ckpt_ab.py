"""Time the port's checkpoint write and restore on the card, beside another
tree's checkpointer in the same call.

    python tools/torch_ckpt_ab.py [--gb 12] [--rounds 2] [--against DIR]

A state of ``--gb`` GB on the card, as a bfloat16 trainer holds it
(bfloat16 "params" and float32 "opt" leaves, 1 GB and 2 GB each, drawn from
a seed), is checkpointed as the ``Trainer`` does it (``save_async``, then
``wait``) into ``.train_ckpt/ab/`` (removed after) and restored into a
template of the same shapes; the restored leaves must equal the state bit
for bit.  With ``--against DIR`` (a tree with ``src/repro_torch/``, such as
the parent unpacked by ``git archive`` into an ignored directory), that
tree's ``checkpoint/checkpointer.py`` is timed too, in turns (DIR, this,
this, DIR each round).  Prints one JSON line per run (``snapshot_s``: until
``save_async`` returns; ``write_s``: until the write is done; ``restore_s``)
and a last line with each side's medians, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / ".train_ckpt" / "ab"


def _checkpointer(src_root: Path):
    """The ``Checkpointer`` class of ``src_root``'s port, its one relative
    import pointed at this tree's package."""
    path = src_root / "src" / "repro_torch" / "checkpoint" / "checkpointer.py"
    text = path.read_text().replace("from ..", "from repro_torch.")
    mod = type(sys)(f"_ckpt_{abs(hash(str(src_root)))}")
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod.Checkpointer


def _state(gb: float):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    n = 512 * 1024 * 1024
    tree, total, i = {"params": {}, "opt": {}}, 0, 0
    while total < gb * 1e9:
        if i % 2 == 0:
            tree["params"][f"w{i}"] = torch.randn(
                n, generator=g, device="cuda").to(torch.bfloat16)
        else:
            tree["opt"][f"m{i}"] = torch.randn(n, generator=g, device="cuda")
        total += n * (2 if i % 2 == 0 else 4)
        i += 1
    return tree, total


def _leaves(tree):
    for key in sorted(tree):
        for name in sorted(tree[key]):
            yield tree[key][name]


def run_once(cls, tree) -> dict:
    import torch
    shutil.rmtree(OUT, ignore_errors=True)
    ck = cls(str(OUT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_async(1, tree)
    snapshot = time.perf_counter() - t0
    ck.wait()
    write = time.perf_counter() - t0
    template = {k: {n: torch.empty_like(t) for n, t in v.items()}
                for k, v in tree.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = ck.restore(template)
    torch.cuda.synchronize()
    restore = time.perf_counter() - t0
    same = all(torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8))
               for a, b in zip(_leaves(got), _leaves(tree)))
    shutil.rmtree(OUT, ignore_errors=True)
    del got, template
    torch.cuda.empty_cache()
    return {"snapshot_s": snapshot, "write_s": write, "restore_s": restore,
            "bit_for_bit": same}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=12.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--against", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_ckpt_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sides = {"this": _checkpointer(ROOT)}
    if args.against:
        sides["against"] = _checkpointer(args.against.resolve())
    order = (["against", "this", "this", "against"] if args.against
             else ["this"])
    tree, total = _state(args.gb)
    runs = {side: [] for side in sides}
    for r in range(args.rounds):
        for side in order:
            out = run_once(sides[side], tree)
            if not out["bit_for_bit"]:
                raise SystemExit(f"{side}'s restore is not bit for bit")
            out.update(side=side, round=r, gb=total / 1e9,
                       write_gbps=total / 1e9 / out["write_s"],
                       restore_gbps=total / 1e9 / out["restore_s"])
            runs[side].append(out)
            print(json.dumps(out), flush=True)
    summary = {"nvidia_smi": smi, "gb": total / 1e9, "medians": {
        side: {key: statistics.median(r[key] for r in rs)
               for key in ("snapshot_s", "write_s", "restore_s")}
        for side, rs in runs.items()}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
