"""Decoder LM for the dense ``attn`` layer plan (port of the dense part of
``repro/models/transformer.py``).

Params mirror the reference's tree: ``embed``, ``final_norm``, ``lm_head``
and one stacked tree per block kind under ``stacks`` (leading layer axis).
The reference scans over that axis with ``jax.lax.scan``; here a Python
loop indexes it.  Logits come back in float32.

In place, unlike the reference: ``prefill`` writes each layer's K/V into a
preallocated ``max_len`` cache, and ``decode_step`` writes the new K/V row
and advances ``length`` inside the ``state`` it is given (the reference
returns a fresh state through ``dynamic_update_slice_in_dim``).  The state
it returns is that same object.

Block kinds other than ``attn`` raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from .attention import (attention_block, attention_decode, init_attention,
                        init_kv_cache)
from .layers import ffn, init_ffn, init_linear, rms_norm

Params = dict
PyTree = Any

_NOT_PORTED = {
    "attn_moe": "ROADMAP Queue 1 item 5 (MoE)",
    "mamba2": "ROADMAP Queue 1 item 4 (SSM families)",
    "shared_attn": "ROADMAP Queue 1 item 4 (SSM families)",
    "mlstm": "ROADMAP Queue 1 item 4 (SSM families)",
    "slstm": "ROADMAP Queue 1 item 4 (SSM families)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_plan(cfg: ModelConfig) -> list[str]:
    """Block type per layer index (as the reference's ``layer_plan``)."""
    if cfg.family in ("dense", "vlm", "audio"):
        return ["attn"] * cfg.n_layers
    if cfg.family == "moe":
        return ["attn_moe"] * cfg.n_layers
    if cfg.family == "hybrid":
        plan = []
        for i in range(cfg.n_layers):
            plan.append("mamba2")
            if cfg.shared_attn_every and (i + 1) % cfg.shared_attn_every == 0:
                plan.append("shared_attn")
        return plan
    if cfg.family == "ssm":
        k = cfg.slstm_every
        return ["slstm" if (k and i % k == k - 1) else "mlstm"
                for i in range(cfg.n_layers)]
    raise ValueError(f"unknown family {cfg.family}")


def _require_dense(cfg: ModelConfig) -> None:
    for kind in layer_plan(cfg):
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet; see "
                f"{_NOT_PORTED[kind]}")


def _layer(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> Params:
    """Random weights with the reference's init scales, drawn on ``device``
    from a seeded ``torch.Generator`` (none on the meta device, where the
    tree has shapes only)."""
    _require_dense(cfg)
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = _dtype(cfg)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    kw = dict(gen=gen, device=device, dtype=dt)
    params: Params = {
        "embed": init_linear((cfg.vocab, d), scale=0.02, **kw),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear((d, cfg.vocab), **kw)
    params["stacks"] = {"attn": {
        "ln1": torch.ones((n, d), dtype=dt, device=device),
        "attn": init_attention(d, cfg.n_heads, cfg.n_kv_heads, hd,
                               cfg.qkv_bias, stack=(n,), **kw),
        "ln2": torch.ones((n, d), dtype=dt, device=device),
        "ffn": init_ffn(d, cfg.d_ff, cfg.act, stack=(n,), **kw),
    }}
    return params


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------

def _block_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor):
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    y, kv = attention_block(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        positions=positions, return_kv=True)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + ffn(p["ffn"], h, cfg.act), kv


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (logits [B, S, V] float32, aux_loss 0)."""
    _require_dense(cfg)
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    stack = params["stacks"]["attn"]
    for i in range(cfg.n_layers):
        x, _ = _block_prefill(cfg, _layer(stack, i), x, positions)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x @ _head(params, cfg)).float()
    return logits, torch.zeros((), device=x.device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int) -> tuple[torch.Tensor, PyTree]:
    """Process the full prompt; return (last-token logits [B,V] float32,
    decode state sized for ``max_len``) — the serving engine's prefill."""
    _require_dense(cfg)
    x = params["embed"][tokens]
    bsz, s = x.shape[0], x.shape[1]
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt {s}")
    positions = torch.arange(s, device=x.device)[None, :]
    state = init_decode_state(cfg, bsz, max_len, device=x.device)
    kv = state["kv"]
    stack = params["stacks"]["attn"]
    for i in range(cfg.n_layers):
        x, (k, v) = _block_prefill(cfg, _layer(stack, i), x, positions)
        kv["k"][i, :, :s] = k
        kv["v"][i, :, :s] = v
    kv["length"].fill_(s)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x[:, -1] @ _head(params, cfg)).float()
    return logits, state


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> PyTree:
    """Stacked KV caches for every attention layer: {"kv": {"k", "v":
    [L,B,T,Hkv,D], "length": [L,B]}}."""
    _require_dense(cfg)
    return {"kv": init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                cfg.resolved_head_dim, _dtype(cfg), device,
                                stack=(cfg.n_layers,))}


def decode_step(params: Params, cfg: ModelConfig, state: PyTree,
                tokens: torch.Tensor) -> tuple[torch.Tensor, PyTree]:
    """One decode step.  tokens: [B] -> (logits [B, V] float32, state),
    with ``state`` updated in place."""
    _require_dense(cfg)
    x = params["embed"][tokens][:, None, :]          # [B, 1, d]
    kv = state["kv"]
    stack = params["stacks"]["attn"]
    for i in range(cfg.n_layers):
        p = _layer(stack, i)
        cache = {"k": kv["k"][i], "v": kv["v"][i], "length": kv["length"][i]}
        h = rms_norm(x, p["ln1"], cfg.rms_eps)
        y, _ = attention_decode(
            p["attn"], h, cache, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta)
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.rms_eps)
        x = x + ffn(p["ffn"], h, cfg.act)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x[:, 0] @ _head(params, cfg)).float()
    return logits, state
