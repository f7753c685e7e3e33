"""Card time of the AdamW update with its gradient norm over each training
configuration's whole parameter tree, and of one train step split into its
gradient and its update, for comparing two trees of the port in one chip
call.

    python tools/torch_adamw_ab.py [--src DIR] [--label NAME] [--iters 3]
                                   [--configs KEY,...] [--split]

Imports ``repro_torch`` from ``DIR`` (default: this tree's ``src``; another
tree, for example the parent commit unpacked by ``git archive`` into an
ignored directory, is loaded as package ``other_repro_torch``), so two
checkouts are timed by the same code: run parent, change, change, parent,
one process each.  The configurations are ``chip_smoke.py``'s phase-8 runs
(``TRAIN_RUNS``, ``TRAIN_PREFIXED``; keys as ``chip_smoke._train_key``
names them, ``stablelm-3bx32:bfloat16``), each at full width and its
phase-8 depth.

For each, the tree's ``init_params`` (seed 0) and ``init_opt_state`` on
the card, and gradients in the params' dtypes drawn N(0, 1) x 1e-4 from a
generator seeded 0 (their norm under the clip for every configuration).
Then, in turns over ``--iters`` rounds, the tree's ``apply_updates`` (the
kernels where the tree has them) and this tree's plain update
(``optim.adamw.apply_updates_plain``: the eager update as it ran before
the kernels), each one call timed by CUDA events on a stream held by a
spin kernel (``chip_smoke._time_ms``, one call, no warm-up: each call
moves the state): ms, GB/s of the bytes the update needs
(``kernels/work.py``: ``adamw_work`` a leaf and ``adamw_norm_work``; the
gradient norm's read of g included) and the bound, those bytes at 3.35
TB/s.  The tree's gradient norm and the plain one against a float64 sum
of the same gradients (relative error).

``--split`` instead takes one train step of each configuration, traced
(``chip_smoke._traced_step``) after two untraced ones, run as
``chip_smoke.split_step`` composes it from the tree's ``make_grad_step``
and ``apply_updates``: the card time of the gradient's range and of the
update's, each by class of kernel (``card_ms_by_range``).

Prints one JSON object (label, source, the card's name and power limit,
a row per configuration) and appends it to ``chiprun_out/adamw_ab.jsonl``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GRAD_SCALE = 1e-4


def _tree(src: str) -> str:
    """The package name of the tree at ``src``: this tree's ``repro_torch``,
    or another tree's loaded as ``other_repro_torch``."""
    pkg = Path(src).resolve() / "repro_torch"
    if pkg == (ROOT / "src" / "repro_torch").resolve():
        return "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return "other_repro_torch"


def _runs(cs) -> dict:
    """Phase 8's configurations by key: (run, prefixed)."""
    out = {}
    for runs, prefixed in ((cs.TRAIN_RUNS, False), (cs.TRAIN_PREFIXED, True)):
        for run in runs:
            out[_key(cs, run)] = (run, prefixed)
    return out


def _key(cs, run) -> str:
    cfg = cs._train_cfg(run)
    return cs._train_key({"arch": cfg.name, "layers": cfg.n_layers,
                          "dtype": cfg.dtype})


def _grads(params):
    import torch
    from repro_torch.optim.adamw import tree_map
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return tree_map(lambda p: (torch.randn(p.shape, generator=g,
                                           device=p.device)
                               * GRAD_SCALE).to(p.dtype), params)


def _norm_err(norm, grads) -> float:
    import torch
    from repro_torch.optim.adamw import leaves
    want = torch.sqrt(sum(torch.sum(torch.square(g.double()))
                          for g in leaves(grads)))
    return float(abs(norm.double() - want) / want)


def _timing(cs, pkg: str, run, iters: int) -> dict:
    import torch
    from repro_torch.kernels import work
    from repro_torch.kernels.adamw import global_norm_plain
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import apply_updates_plain, leaves
    tree_models = importlib.import_module(f"{pkg}.models")
    tree_optim = importlib.import_module(f"{pkg}.optim")
    cfg = cs._train_cfg(run)
    params = tree_models.init_params(cfg, seed=0, device="cuda")
    state = tree_optim.init_opt_state(params)
    grads = _grads(params)
    opt = AdamWConfig(lr=run["lr"], warmup_steps=cs.TRAIN_WARMUP,
                      total_steps=run["steps"])
    tree_opt = tree_optim.AdamWConfig(**dataclasses.asdict(opt))
    master = "master" in state
    nbytes = sum(work.adamw_work(g.numel(), p.dtype, g.dtype, master)[1]
                 for p, g in zip(leaves(params), leaves(grads)))
    nbytes += work.adamw_norm_work(
        [(g.numel(), g.dtype) for g in leaves(grads)])[1]
    bound_ms, bound_by = work.bound({}, nbytes)
    calls = {"tree": lambda: tree_optim.apply_updates(params, grads, state,
                                                      tree_opt),
             "plain": lambda: apply_updates_plain(params, grads, state,
                                                  opt)}
    calls["tree"]()                       # builds the kernels, if any
    ms = {"tree": [], "plain": []}
    for _ in range(iters):
        for name in ("tree", "plain", "plain", "tree"):
            ms[name].append(cs._time_ms(calls[name], iters=1, warmup=0))
    row = {"shape": {"params_b": sum(p.numel() for p in leaves(params))
                     / 1e9, "leaves": len(list(leaves(params))),
                     "largest_leaf": max(p.numel() for p in leaves(params)),
                     "param_dtype": cfg.dtype},
           "ms": ms, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "gb_per_s": {k: nbytes / (min(v) * 1e-3) / 1e9
                        for k, v in ms.items()},
           "norm_rel_err": {
               "tree": _norm_err(tree_optim.global_norm(grads), grads),
               "plain": _norm_err(global_norm_plain(list(leaves(grads))),
                                  grads)}}
    del params, state, grads
    torch.cuda.empty_cache()
    return row


def _split(cs, pkg: str, run, prefixed: bool) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.data import DataConfig, SyntheticStream
    tree_models = importlib.import_module(f"{pkg}.models")
    tree_optim = importlib.import_module(f"{pkg}.optim")
    tree_train = importlib.import_module(f"{pkg}.train")
    cfg = cs._train_cfg(run)
    opt = tree_optim.AdamWConfig(lr=run["lr"], warmup_steps=cs.TRAIN_WARMUP,
                                 total_steps=run["steps"])
    params = tree_models.init_params(cfg, seed=0, device="cuda")
    state = tree_optim.init_opt_state(params)
    if prefixed:
        shape = InputShape("train", "train", run["seq"], run["batch"])
        batch = cs.prefixed_batch(cfg, shape, 0, "cuda")
    else:
        stream = SyntheticStream(DataConfig(vocab=cfg.vocab,
                                            seq_len=run["seq"],
                                            global_batch=run["batch"],
                                            seed=0))
        batch = {k: torch.as_tensor(np.asarray(v), device="cuda")
                 for k, v in stream.batch_at(0).items()}
    step = cs.split_step(
        tree_train.make_grad_step(cfg, remat=False),
        lambda p, g, s: tree_optim.apply_updates(p, g, s, opt))
    held = {"params": params, "state": state}

    def run_step():
        held["params"], held["state"], met = step(held["params"],
                                                  held["state"], batch)
        float(met["loss"])

    run_step()
    run_step()
    per_step = cs._step_launches(cfg)
    if pkg != "repro_torch":        # another tree: its kernels not required
        per_step = {k: 0 for k in per_step}
    traced = cs._traced_step(run_step, per_step, cfg.dtype)
    del params, state, batch, held, step
    torch.cuda.empty_cache()
    return {k: traced[k] for k in ("card_ms", "kernels", "card_ms_by_class",
                                   "card_ms_by_range")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--configs", default="",
                    help="comma-separated keys (default: every phase-8 run)")
    ap.add_argument("--split", action="store_true",
                    help="one traced train step each, split into its "
                         "gradient and its update")
    args = ap.parse_args()
    import chip_smoke as cs           # puts this tree's src on the path
    import torch
    pkg = _tree(args.src)
    if not torch.cuda.is_available():
        print("torch_adamw_ab: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = _runs(cs)
    keys = args.configs.split(",") if args.configs else list(runs)
    rows = {}
    for key in keys:
        run, prefixed = runs[key]
        rows[key] = (_split(cs, pkg, run, prefixed) if args.split else
                     _timing(cs, pkg, run, args.iters))
        print(f"[adamw_ab] {args.label} {key} {rows[key]}", flush=True)
    out = {"label": args.label,
           "source": importlib.import_module(pkg).__file__,
           "nvidia_smi": cs._smi(), "split": args.split, "rows": rows}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "adamw_ab.jsonl", "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
