"""Where the MoE models' bfloat16 decode departs from their forward, on the
card: which part of the path each share of the drift comes from, how far
it is from float32, and how far a planted decode fault moves it.

    python tools/torch_moe_drift.py [--archs A,B] [--depths 6,24]
        [--steps 16] [--reduced --device cpu]

qwen3-moe-30b-a3b and moonshot-v1-16b-a3b at full width, random weights
from seed 0 and the 300-token prompt that ``chip_smoke.py`` checks (its
third prompt), at capacity factor 16: a prefill of all but the last
``--steps`` tokens and teacher-forced decode steps of those, against a
forward of the whole prompt.  Each comparison is summarised over its
tokens by the rel of each token's logits (largest error over the vocabulary
over the largest logit): median, 90th percentile, largest.

At 48 layers in bfloat16 (the served model), decode against forward:

- ``served``: as served (the forward's attention in the flash kernel,
  whose bfloat16 path rounds P to bfloat16 for the P.V product; decode's
  MoE by pairs);
- ``plain_attention``: the forward's and prefill's attention in the plain
  version (float32 scores, P and P.V, as decode attention computes them);
- ``slots_decode``: decode's MoE in the slots form, as the forward's;
- ``plain_attention+slots_decode``: both;
- ``flash_vs_plain_forward``: the forward with the flash kernel against
  the forward with the plain version;
- ``fault:<name>``: a fault planted in decode only, the path otherwise as
  served: ``no_shared`` (the shared expert skipped; moonshot),
  ``top_k_minus_1`` (one expert fewer), ``unnormalised_gates`` (the top-k
  gates not renormalised) and ``stale_kv`` (the token does not attend to
  its own new cache row).

At each of ``--depths`` layers, float32 weights and then the same weights
rounded to bfloat16: ``f32_dec_vs_f32_fwd`` and the planted faults in
float32 (``f32_fault:<name>``), ``bf16_fwd_vs_f32_fwd``,
``bf16_dec_vs_f32_fwd`` and ``bf16_dec_vs_bf16_fwd``.

Prints one JSON line per model and depth, and writes them all to
``chiprun_out/moe_drift-<device>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PROMPT_LENS = (256, 1024, 300)   # chip_smoke.py's first three prompts
CAPACITY = 16.0


def _summary(got, want) -> dict:
    import torch
    got, want = got.double().cpu(), want.double().cpu()
    r = ((got - want).abs().amax(-1) / want.abs().amax(-1)).flatten()
    return {"median": float(r.median()),
            "q90": float(torch.quantile(r, 0.9)), "max": float(r.max()),
            "tokens": int(r.numel())}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _moe_by_slots(params, x, *, top_k, capacity_factor=1.25,
                  group_size=2048, with_aux=True):
    """``moe_block`` with its slots form whatever the token count."""
    from repro_torch.models import moe
    bsz, s, d = x.shape
    sg = min(group_size, bsz * s)
    if (bsz * s) % sg:
        sg = bsz * s
    xg = x.reshape(-1, sg, d)
    expert_idx, gates, pos, keep, capacity, aux = moe.route(
        params, xg, top_k, capacity_factor, with_aux)
    out = moe._experts_by_slot(params, xg, expert_idx, pos, keep, capacity)
    w = gates.to(x.dtype).reshape(*out.shape[:2], 1)
    y = (w.float() * out.float()).reshape(*xg.shape[:2], top_k, d).sum(2)
    y = y.to(x.dtype)
    if "shared" in params:
        y = y + moe.ffn(params["shared"], xg, "swiglu")
    return y.reshape(bsz, s, d), aux


def _route_unnormalised(route):
    import torch

    def faulty(params, xg, top_k, capacity_factor, with_aux=True):
        out = route(params, xg, top_k, capacity_factor, with_aux)
        probs = torch.softmax(xg.float() @ params["router"].float(), -1)
        mass = probs.sort(-1, descending=True).values[..., :top_k].sum(-1)
        return (out[0], out[1] * mass[..., None], *out[2:])
    return faulty


def _decode_against(params, cfg, toks, n_dec, fwd):
    """Prefill of all but the last ``n_dec`` tokens, teacher-forced decode
    steps of those; the summary against ``fwd``'s last ``n_dec``."""
    import torch
    from repro_torch.models import decode_step, prefill
    _, state = prefill(params, cfg, toks[:, :-n_dec], toks.shape[1])
    steps = []
    for i in range(n_dec, 0, -1):
        logits, state = decode_step(params, cfg, state, toks[:, -i])
        steps.append(logits)
    got = torch.stack(steps, 1)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("decode: logits not finite")
    return _summary(got, fwd[:, -n_dec:])


def _config(arch, reduced, **kw):
    from repro_torch.configs import ARCHS
    cfg = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    return dataclasses.replace(cfg, capacity_factor=CAPACITY, **kw)


def planted_faults(params, cfg, toks, n_dec, fwd) -> dict:
    """Each planted fault in decode only, against ``fwd``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models import decode_step, moe, prefill
    faults = {}
    moe_stack = params["stacks"]["attn_moe"]["moe"]
    if "shared" in moe_stack:
        no_shared = {**params, "stacks": {**params["stacks"], "attn_moe": {
            **params["stacks"]["attn_moe"],
            "moe": {k: v for k, v in moe_stack.items() if k != "shared"}}}}
        faults["no_shared"] = (no_shared, cfg, contextlib.nullcontext())
    faults["top_k_minus_1"] = (
        params, dataclasses.replace(cfg, top_k=cfg.top_k - 1),
        contextlib.nullcontext())
    faults["unnormalised_gates"] = (
        params, cfg, _patched(moe, "route", _route_unnormalised(moe.route)))
    stale = lambda q, k, v, lengths, **kw: decode_attention_ref(
        q, k, v, lengths - 1, **kw)
    faults["stale_kv"] = (params, cfg,
                          _patched(ops, "decode_attention", stale))
    out = {}
    for name, (p, c, ctx) in faults.items():
        _, state = prefill(params, cfg, toks[:, :-n_dec], toks.shape[1])
        steps = []
        with ctx:
            for i in range(n_dec, 0, -1):
                logits, state = decode_step(p, c, state, toks[:, -i])
                steps.append(logits)
        out[f"fault:{name}"] = _summary(torch.stack(steps, 1),
                                        fwd[:, -n_dec:])
    return out


def served_model(arch, n_dec, toks_np, reduced, device) -> dict:
    """The 48-layer bfloat16 model: decode against forward, by part."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import forward, init_params, transformer

    cfg = _config(arch, reduced, dtype="bfloat16")
    params = init_params(cfg, seed=0, device=device)
    toks = torch.as_tensor(toks_np, device=device)[None]
    plain = lambda: _patched(ops, "flash_attention", flash_attention_plain)
    slots = lambda: _patched(transformer, "moe_block", _moe_by_slots)
    out = {"arch": arch, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "tokens": int(toks.shape[1]), "decode_steps": n_dec}
    fwd = forward(params, cfg, toks)[0]
    with plain():
        fwd_plain = forward(params, cfg, toks)[0]
    out["flash_vs_plain_forward"] = _summary(fwd, fwd_plain)
    out["served"] = _decode_against(params, cfg, toks, n_dec, fwd)
    with slots():
        out["slots_decode"] = _decode_against(params, cfg, toks, n_dec, fwd)
    with plain():
        out["plain_attention"] = _decode_against(params, cfg, toks, n_dec,
                                                 fwd_plain)
        with slots():
            out["plain_attention+slots_decode"] = _decode_against(
                params, cfg, toks, n_dec, fwd_plain)

    out.update(planted_faults(params, cfg, toks, n_dec, fwd))
    del params
    torch.cuda.empty_cache()
    return out


def cut_depth(arch, layers, n_dec, toks_np, reduced, device) -> dict:
    """``layers`` blocks at full width: float32 weights, then the same
    weights rounded to bfloat16."""
    import torch
    from repro_torch.models import forward, init_params

    cfg_f = _config(arch, reduced, n_layers=layers, dtype="float32")
    cfg_b = dataclasses.replace(cfg_f, dtype="bfloat16")
    params = init_params(cfg_f, seed=0, device=device)
    toks = torch.as_tensor(toks_np, device=device)[None]
    out = {"arch": arch, "layers": layers, "tokens": int(toks.shape[1]),
           "decode_steps": n_dec}
    fwd_f = forward(params, cfg_f, toks)[0]
    out["f32_dec_vs_f32_fwd"] = _decode_against(params, cfg_f, toks, n_dec,
                                                fwd_f)
    out.update({f"f32_{k}": v for k, v in planted_faults(
        params, cfg_f, toks, n_dec, fwd_f).items()})

    def to_bf16(tree):       # leaf by leaf, each float32 leaf freed
        for k, v in tree.items():
            tree[k] = (to_bf16(v) if isinstance(v, dict)
                       else v.to(torch.bfloat16))
        return tree
    params = to_bf16(params)
    fwd_b = forward(params, cfg_b, toks)[0]
    out["bf16_fwd_vs_f32_fwd"] = _summary(fwd_b, fwd_f)
    out["bf16_dec_vs_f32_fwd"] = _decode_against(params, cfg_b, toks, n_dec,
                                                 fwd_f)
    out["bf16_dec_vs_bf16_fwd"] = _decode_against(params, cfg_b, toks,
                                                  n_dec, fwd_b)
    del params
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> list[dict]:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--archs",
                    default="qwen3-moe-30b-a3b,moonshot-v1-16b-a3b")
    ap.add_argument("--depths", default="6,24")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a check of the tool)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = []
    with torch.inference_mode():
        for arch in args.archs.split(","):
            rng = np.random.default_rng(0)
            vocab = _config(arch, args.reduced).vocab
            toks = [rng.integers(0, vocab, n) for n in PROMPT_LENS][2]
            for depth in (int(d) for d in args.depths.split(",") if d):
                rows.append(cut_depth(arch, depth, args.steps, toks,
                                      args.reduced, args.device))
                print(json.dumps(rows[-1]), flush=True)
            rows.append(served_model(arch, args.steps, toks, args.reduced,
                                     args.device))
            print(json.dumps(rows[-1]), flush=True)
    out = ROOT / "chiprun_out" / f"moe_drift-{args.device}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
