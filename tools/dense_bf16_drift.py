"""How far a dense model drifts in bfloat16, on the CPU: the ground of the
PyTorch port's bfloat16 tolerances for the dense models it serves in
bfloat16 (internvl2-76b with its prefix, qwen2.5-14b, nemotron-4-15b).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dense_bf16_drift.py \
        --layers 4 --batch 2 --seq 130 --seeds 0,1,2,3,4,5,6,7 --port
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dense_bf16_drift.py \
        --layers 32 --batch 1 --seq 300 --prefix 256 --decode 16 \
        --seeds 0,1,2,3,4,5,6,7 --port
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dense_bf16_drift.py \
        --layers 32 --batch 1 --seq 300 --prefix 0 --decode 16 \
        --seeds 0,1,2,3,4,5,6,7 --port

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dense_bf16_drift.py \
        --arch qwen2.5-14b --layers 48 --batch 1 --seq 300 --decode 16 \
        --seeds 0,1,2,3,4,5,6,7 --port
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dense_bf16_drift.py \
        --arch nemotron-4-15b --layers 32 --batch 1 --seq 300 --decode 16 \
        --seeds 0,1,2,3,4,5,6,7 --port

``tools/dense_bf16_drift.jsonl`` holds these five commands' output, in
this order (a minute or two each on a CPU).

For the plan of ``--arch`` (internvl2-76b by default) at the reduced
width (``--layers`` blocks; a frontend prefix of ``--prefix`` positions
drawn N(0, 1), the reduced config's by default: 16 for internvl2-76b, none
for an arch without a frontend), each seed: the JAX package's model with bfloat16
weights, run in bfloat16 and, on the same weights cast up, in float32.  It
prints one JSON line per run with, for each token, the rel of its logits
(largest error over the vocabulary over the largest logit), summarised as
median, 90th percentile and largest:

- ``fwd_bf16_vs_f32``: the reference's prefixed forward in bfloat16
  against its float32 forward, over every text token (what the port's
  reduced model on the card is held to against the CPU path);
- ``dec_vs_fwd_bf16``: the reference's prefixed prefill of all but the
  last ``--decode`` tokens and teacher-forced decode steps of those,
  against its bfloat16 forward (what ``chip_smoke.py`` checks the served
  model for);
- with ``--port``, ``port_vs_ref_bf16``: the port's bfloat16 forward
  against the reference's, and ``port_dec_vs_fwd_bf16``: the port's
  prefill and decode steps against its own bfloat16 forward.

A last line gives each comparison's largest median over the runs (and,
since the qwen2.5-14b and nemotron-4-15b runs, the arch).
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

ARCH = "internvl2-76b"   # the default --arch


def rel_by_token(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.abs(got - want).max(-1) / np.abs(want).max(-1)).ravel()


def summary(r: np.ndarray) -> dict:
    return {"median": float(np.median(r)),
            "q90": float(np.quantile(r, 0.9)), "max": float(r.max())}


def port_run(arch, params, cfg, tokens, front, n_dec) -> tuple:
    """The port's prefixed forward of ``cfg``, and its prefixed prefill of
    all but the last ``n_dec`` tokens and decode steps of those: (forward
    logits, decode logits [B, n_dec, V])."""
    import torch
    from repro_torch.bridge import to_torch
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.models import decode_step as port_step
    from repro_torch.models import forward as port_fwd
    from repro_torch.models import prefill as port_prefill
    pcfg = dataclasses.replace(PORT_ARCHS[arch].reduced(),
                               n_layers=cfg.n_layers, dtype=cfg.dtype)
    p, t = to_torch(params), torch.from_numpy(tokens)
    f = None if front is None else torch.from_numpy(front)
    pre = 0 if front is None else front.shape[1]
    seq = tokens.shape[1]
    with torch.inference_mode():
        fwd = port_fwd(p, pcfg, t, f)[0].numpy()
        _, state = port_prefill(p, pcfg, t[:, :-n_dec],
                                pre + seq + 4, f)
        dec = [port_step(p, pcfg, state, t[:, i])[0].numpy()
               for i in range(seq - n_dec, seq)]
    return fwd, np.stack(dec, 1)


def run(arch, layers, seed, batch, seq, prefix, n_dec, port) -> dict:
    base = dataclasses.replace(configs.ARCHS[arch].reduced(), n_layers=layers)
    cfg_b = dataclasses.replace(base, dtype="bfloat16")
    params_b = init_params(cfg_b, jax.random.PRNGKey(seed))
    params_f = jax.tree.map(lambda a: a.astype(jnp.float32), params_b)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, base.vocab, (batch, seq)).astype(np.int32)
    # a model without a frontend takes none (a prefixed one a prefix of
    # --prefix positions, zero positions included)
    front = (rng.standard_normal((batch, prefix, base.d_model)).astype(
        np.float32) if base.frontend != "none" else None)
    jfront = None if front is None else jnp.asarray(front)
    fwd = jax.jit(forward, static_argnums=1)
    fwd_b = np.asarray(fwd(params_b, cfg_b, jnp.asarray(tokens), jfront)[0])
    fwd_f = np.asarray(fwd(params_f, base, jnp.asarray(tokens), jfront)[0])
    _, state = prefill(params_b, cfg_b, jnp.asarray(tokens[:, :-n_dec]),
                       prefix + seq + 4, jfront)
    step = jax.jit(decode_step, static_argnums=1)
    dec = []
    for i in range(seq - n_dec, seq):
        out, state = step(params_b, cfg_b, state, jnp.asarray(tokens[:, i]))
        dec.append(np.asarray(out, np.float32))
    out = {"arch": arch, "layers": layers, "seed": seed,
           "tokens": [batch, seq], "prefix": prefix, "decode": n_dec,
           "fwd_bf16_vs_f32": summary(rel_by_token(fwd_b, fwd_f)),
           "dec_vs_fwd_bf16": summary(rel_by_token(
               np.stack(dec, 1), fwd_b[:, seq - n_dec:]))}
    if port:
        p_fwd, p_dec = port_run(arch, params_b, cfg_b, tokens, front, n_dec)
        out["port_vs_ref_bf16"] = summary(rel_by_token(p_fwd, fwd_b))
        out["port_dec_vs_fwd_bf16"] = summary(rel_by_token(
            p_dec, p_fwd[:, seq - n_dec:]))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=130)
    ap.add_argument("--prefix", type=int, default=None,
                    help="prefix positions (default: the reduced config's)")
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--port", action="store_true",
                    help="also the port's bfloat16 forward (needs torch)")
    args = ap.parse_args(argv)
    reduced = configs.ARCHS[args.arch].reduced()
    prefix = (reduced.frontend_len if args.prefix is None else args.prefix)
    if reduced.frontend == "none":
        prefix = 0
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = run(args.arch, args.layers, seed, args.batch, args.seq, prefix,
                  args.decode, args.port)
        print(json.dumps(row), flush=True)
        rows.append(row)
    head = {} if args.arch == ARCH else {"arch": args.arch}
    print(json.dumps({**head, "layers": args.layers, "runs": len(rows),
                      "largest_median": {
                          key: max(r[key]["median"] for r in rows)
                          for key in rows[0] if isinstance(rows[0][key], dict)}
                      }), flush=True)
    return rows


if __name__ == "__main__":
    main()
