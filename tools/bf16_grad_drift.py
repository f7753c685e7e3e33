"""How far bfloat16 training drifts from the exact function, on the CPU: the
ground of the PyTorch port's rule for bfloat16 gradients.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bf16_grad_drift.py \
        --seeds 0,1,2,3,4,5,6,7 > tools/bf16_grad_drift.jsonl

``tools/bf16_grad_drift.jsonl`` holds this command's output (a few minutes
on a CPU).

For each trainable layer plan's reduced model (dense granite-8b, MoE
qwen3-moe-30b-a3b with its aux loss, the hybrid zamba2-1.2b, the ssm
xlstm-125m, and musicgen-large with its frontend prefix of 16), each seed:
the JAX package's params drawn in bfloat16 from ``PRNGKey(seed)`` and the
same params cast up to float32; the batch of ``tests/test_torch_train.py``'s
``_batch`` (B 2 x S 48, a loss mask; its numpy seed ``4 + seed``, so that
seed 0 is that test's batch), a prefixed model's frontend [2, 16, d] drawn
N(0, 1) after it.  It prints one JSON line per (arch, seed) with, for the
loss and for the gradients (each leaf's largest error over its largest
magnitude in the float32 run, the worst leaf named):

- ``ref_bf16_vs_f32``: the reference's bfloat16 run against its own float32
  run of the same weights and batch (what the rule is grounded on);
- ``port_bf16_vs_ref_f32``: the port's bfloat16 run, on the same bfloat16
  weights bridged through numpy, against the reference's float32 run (what
  the rule holds);
- ``port_bf16_vs_ref_bf16``: the port's against the reference's bfloat16
  run (two noisy runs against each other: reported, not held);

and ``steps``, the losses of 3 AdamW steps (lr 1e-2, 2 warm-up steps, the
batches of ``_batch`` with numpy seeds 10-12, no mask) of the reference in
bfloat16 (a float32 master copy and moments) and in float32, and of the
port in bfloat16, with each comparison's largest rel over the 3 steps.

The batch, the optimizer and the step seeds are ``chip_smoke.py``'s
(``bf16_drift_batch``, ``BF16_STEP_OPT``, ``BF16_STEP_SEEDS``).  The last
line gives each arch's limits as ``chip_smoke.bf16_grad_limits`` reads them
from the lines above: twice the reference's own largest drift
over the seeds, for the loss, the gradients (none for zamba2-1.2b, held on
its loss only: its reduced bfloat16 gradients carry no signal in either
package) and the step losses.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.models import init_params, loss_and_metrics
from repro.optim import AdamWConfig, init_opt_state
from repro.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "xlstm-125m",
         "musicgen-large")


def _chip_smoke():
    """``chip_smoke.py`` as a module: the rule's inputs and its limits are
    kept there, where the card's checks and the CPU tests read them."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_rule", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
batch = CS.bf16_drift_batch
OPT, STEP_SEEDS = CS.BF16_STEP_OPT, CS.BF16_STEP_SEEDS


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def drift(loss, grads, loss_want, grads_want) -> dict:
    """The loss's rel and the worst gradient leaf's largest error over its
    largest magnitude in ``grads_want``."""
    want = dict(_flat(grads_want))
    got = dict(_flat(grads))
    assert sorted(got) == sorted(want)
    rels = {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
            for k, w in want.items()}
    worst = max(rels, key=rels.get)
    return {"loss": abs(float(loss) - float(loss_want)) / abs(float(loss_want)),
            "grad": rels[worst], "worst_leaf": worst}


@functools.cache
def _grad_fn(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, x: loss_and_metrics(p, cfg, x), has_aux=True))


@functools.cache
def _step_fn(cfg):
    return jax.jit(make_train_step(cfg, AdamWConfig(**OPT)))


def ref_grads(params, cfg, b: dict):
    (total, _), grads = _grad_fn(cfg)(params, jax.tree.map(jnp.asarray, b))
    return float(total), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      grads)


def ref_steps(params, cfg) -> list[float]:
    step = _step_fn(cfg)
    state = init_opt_state(params)
    losses = []
    for seed in STEP_SEEDS:
        params, state, met = step(params, state, jax.tree.map(
            jnp.asarray, batch(cfg, seed, mask=False)))
        losses.append(float(met["loss"]))
    return losses


def port_run(arch: str, params_b, b: dict, n_layers: int):
    """The port's bfloat16 loss and gradients on the bridged ``params_b``,
    and its 3 AdamW steps' losses from them."""
    import torch
    from repro_torch.bridge import to_numpy, to_torch
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.optim import AdamWConfig as PAdamWConfig
    from repro_torch.optim import init_opt_state as pinit_opt_state
    from repro_torch.train import make_grad_step, make_train_step as pstep
    cfg = dataclasses.replace(PORT_ARCHS[arch].reduced(), n_layers=n_layers,
                              dtype="bfloat16")
    grads, met = make_grad_step(cfg, remat=False)(
        to_torch(params_b), {k: torch.as_tensor(v) for k, v in b.items()})
    params = to_torch(params_b)
    state = pinit_opt_state(params)
    step = pstep(cfg, PAdamWConfig(**OPT), remat=False)
    losses = []
    for seed in STEP_SEEDS:
        params, state, m = step(params, state, {
            k: torch.as_tensor(v)
            for k, v in batch(cfg, seed, mask=False).items()})
        losses.append(float(m["loss"]))
    return float(met["total_loss"]), to_numpy(grads), losses


def _steps_rel(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def run(arch: str, seed: int) -> dict:
    base = configs.ARCHS[arch].reduced()
    cfg_b = dataclasses.replace(base, dtype="bfloat16")
    params_b = init_params(cfg_b, jax.random.PRNGKey(seed))
    params_f = jax.tree.map(lambda a: a.astype(jnp.float32), params_b)
    b = batch(base, 4 + seed)
    loss_b, grads_b = ref_grads(params_b, cfg_b, b)
    loss_f, grads_f = ref_grads(params_f, base, b)
    loss_p, grads_p, steps_p = port_run(arch, params_b, b, base.n_layers)
    steps_b = ref_steps(params_b, cfg_b)
    steps_f = ref_steps(params_f, base)
    return {"arch": arch, "seed": seed, "tokens": list(b["tokens"].shape),
            "prefix": base.frontend_len,
            "ref_bf16_vs_f32": drift(loss_b, grads_b, loss_f, grads_f),
            "port_bf16_vs_ref_f32": drift(loss_p, grads_p, loss_f, grads_f),
            "port_bf16_vs_ref_bf16": drift(loss_p, grads_p, loss_b, grads_b),
            "steps": {"ref_bf16": steps_b, "ref_f32": steps_f,
                      "port_bf16": steps_p,
                      "ref_bf16_vs_f32": _steps_rel(steps_b, steps_f),
                      "port_bf16_vs_ref_f32": _steps_rel(steps_p, steps_f),
                      "port_bf16_vs_ref_bf16": _steps_rel(steps_p, steps_b)}}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--archs", default=",".join(ARCHS))
    args = ap.parse_args(argv)
    rows = []
    for arch in args.archs.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            row = run(arch, seed)
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(json.dumps({"runs": len(rows),
                      "limits": CS.bf16_grad_limits(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
