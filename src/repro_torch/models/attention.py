"""GQA attention block: prefill (flash kernel) and decode (cached)
(port of ``repro/models/attention.py``).

Cache layout [B, T, Hkv, D], as the reference.  Decode writes the new K/V
row into the cache *in place* and advances ``length`` in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from .layers import apply_rope, init_linear


def init_attention(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool, *,
                   gen: Optional[torch.Generator], device,
                   dtype=torch.float32, stack: tuple[int, ...] = ()) -> dict:
    kw = dict(gen=gen, device=device, dtype=dtype, stack=stack)
    p = {
        "wq": init_linear((d_model, n_heads * head_dim), **kw),
        "wk": init_linear((d_model, n_kv_heads * head_dim), **kw),
        "wv": init_linear((d_model, n_kv_heads * head_dim), **kw),
        "wo": init_linear((n_heads * head_dim, d_model), **kw),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros(tuple(stack) + (width * head_dim,),
                                  dtype=dtype, device=device)
    return p


def _project_qkv(params: dict, x: torch.Tensor, n_heads: int,
                 n_kv_heads: int, head_dim: int):
    b = x.shape[0]
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, -1, n_heads, head_dim)
    k = k.reshape(b, -1, n_kv_heads, head_dim)
    v = v.reshape(b, -1, n_kv_heads, head_dim)
    return q, k, v


def attention_block(params: dict, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int, rope_theta: float,
                    positions: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Full-sequence causal attention (prefill).  With ``return_kv`` also
    returns the rotated K/V [B,S,Hkv,D] for the cache fill."""
    bsz, s, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    # kernels expect [B, H, S, D]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True)
    out = out.transpose(1, 2).reshape(bsz, s, n_heads * head_dim)
    out = out @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(params: dict, x: torch.Tensor, cache: dict, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: [B, 1, d]; cache: {"k","v": [B,T,Hkv,D],
    "length": [B]} -> (out [B,1,d], cache).  Updates ``cache`` in place."""
    bsz = x.shape[0]
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    length = cache["length"]
    pos = length[:, None]                                   # [B,1]
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    # The reference adds a one-hot row at `length` (attention.py:90-92).
    # The slots from `length` on are still zero, so writing the row there
    # gives the same cache.
    rows = torch.arange(bsz, device=x.device)
    cache["k"][rows, length] = k[:, 0]
    cache["v"][rows, length] = v[:, 0]
    length += 1
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], length)
    out = out.reshape(bsz, 1, n_heads * head_dim)
    return out @ params["wo"], cache


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.float32, device=None,
                  stack: tuple[int, ...] = ()) -> dict:
    shape = tuple(stack) + (batch, max_len, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros(tuple(stack) + (batch,), dtype=torch.int32,
                              device=device),
    }
