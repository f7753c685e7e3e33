"""How far the MoE models drift in bfloat16, on the CPU: the ground of the
PyTorch port's bfloat16 model tolerances.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_bf16_drift.py \
        --layers 4 --batch 2 --seq 130 --caps 1.25,16 --port
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_bf16_drift.py \
        --layers 48 --batch 1 --seq 300 --caps 16

For qwen3-moe-30b-a3b and moonshot-v1-16b-a3b at the reduced width (with
``--layers`` blocks), each seed and capacity factor: the JAX package's
model with bfloat16 weights, run in bfloat16 and, on the same weights cast
up, in float32.  It prints one JSON line per run with, for each token, the
rel of its logits (largest error over the vocabulary over the largest
logit), summarised as median, 90th percentile and largest:

- ``fwd_bf16_vs_f32``: the reference's forward in bfloat16 against its
  float32 forward, over every token;
- ``dec_vs_fwd_bf16``: the reference's prefill of all but the last
  ``--decode`` tokens and teacher-forced decode steps of those, against
  its bfloat16 forward (what ``chip_smoke.py`` checks the port for);
- with ``--port``, ``port_vs_ref_bf16``: the port's bfloat16 forward
  against the reference's, and ``port_dec_vs_fwd_bf16``: the port's
  prefill and decode steps against its own bfloat16 forward, as
  ``dec_vs_fwd_bf16`` for the reference.

A routing flip (two router probabilities within bfloat16's rounding of
each other) moves one token's logits by 0.2-0.9, so the largest is set by
flips; the median is not.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.models import decode_step, forward, init_params
from repro.models.transformer import prefill

ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")


def rel_by_token(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.abs(got - want).max(-1) / np.abs(want).max(-1)).ravel()


def summary(r: np.ndarray) -> dict:
    return {"median": float(np.median(r)),
            "q90": float(np.quantile(r, 0.9)), "max": float(r.max())}


def port_run(params, arch, cfg, tokens, n_dec) -> tuple:
    """The port's forward of the reduced ``arch`` as ``cfg`` cuts it, and
    its prefill of all but the last ``n_dec`` tokens and decode steps of
    those: (forward logits, decode logits [B, n_dec, V])."""
    import torch
    from repro_torch.bridge import to_torch
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.models import decode_step as port_step
    from repro_torch.models import forward as port_fwd
    from repro_torch.models import prefill as port_prefill
    pcfg = dataclasses.replace(PORT_ARCHS[arch].reduced(),
                               n_layers=cfg.n_layers,
                               capacity_factor=cfg.capacity_factor,
                               dtype=cfg.dtype)
    p, t = to_torch(params), torch.from_numpy(tokens)
    seq = tokens.shape[1]
    with torch.inference_mode():
        fwd = port_fwd(p, pcfg, t)[0].numpy()
        _, state = port_prefill(p, pcfg, t[:, :-n_dec], seq + 4)
        dec = [port_step(p, pcfg, state, t[:, i])[0].numpy()
               for i in range(seq - n_dec, seq)]
    return fwd, np.stack(dec, 1)


def run(arch, layers, seed, cap, batch, seq, n_dec, port) -> dict:
    base = dataclasses.replace(configs.ARCHS[arch].reduced(),
                               n_layers=layers, capacity_factor=cap)
    cfg_b = dataclasses.replace(base, dtype="bfloat16")
    params_b = init_params(cfg_b, jax.random.PRNGKey(seed))
    params_f = jax.tree.map(lambda a: a.astype(jnp.float32), params_b)
    tokens = np.random.default_rng(seed).integers(0, base.vocab,
                                                  (batch, seq))
    fwd = jax.jit(forward, static_argnums=1)
    fwd_b = np.asarray(fwd(params_b, cfg_b, jnp.asarray(tokens))[0])
    fwd_f = np.asarray(fwd(params_f, base, jnp.asarray(tokens))[0])
    _, state = prefill(params_b, cfg_b, jnp.asarray(tokens[:, :-n_dec]),
                       max_len=seq + 4)
    step = jax.jit(decode_step, static_argnums=1)
    dec = []
    for i in range(seq - n_dec, seq):
        out, state = step(params_b, cfg_b, state,
                          jnp.asarray(tokens[:, i], jnp.int32))
        dec.append(np.asarray(out, np.float32))
    out = {"arch": arch, "layers": layers, "seed": seed,
           "capacity_factor": cap, "tokens": [batch, seq],
           "fwd_bf16_vs_f32": summary(rel_by_token(fwd_b, fwd_f)),
           "dec_vs_fwd_bf16": summary(rel_by_token(
               np.stack(dec, 1), fwd_b[:, seq - n_dec:]))}
    if port:
        p_fwd, p_dec = port_run(params_b, arch, cfg_b, tokens, n_dec)
        out["port_vs_ref_bf16"] = summary(rel_by_token(p_fwd, fwd_b))
        out["port_dec_vs_fwd_bf16"] = summary(rel_by_token(
            p_dec, p_fwd[:, seq - n_dec:]))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--caps", default="16")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=130)
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--port", action="store_true",
                    help="also the port's bfloat16 forward (needs torch)")
    args = ap.parse_args(argv)
    rows = []
    for arch in ARCHS:
        for cap in (float(c) for c in args.caps.split(",")):
            for seed in (int(s) for s in args.seeds.split(",")):
                row = run(arch, args.layers, seed, cap, args.batch,
                          args.seq, args.decode, args.port)
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
