"""GQA attention block: prefill (flash kernel) and decode (cached)
(port of ``repro/models/attention.py``).

Cache layout [B, T, Hkv, D], as the reference.  Decode writes the new K/V
row into the cache *in place* and advances ``length`` in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from ..parallel.sharding import (constrain, is_distributed, merge_heads,
                                 split_heads)
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
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (split_heads(q, n_heads, head_dim),
            split_heads(k, n_kv_heads, head_dim),
            split_heads(v, n_kv_heads, head_dim))


def attention_block(params: dict, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int, rope_theta: float,
                    positions: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Full-sequence causal attention (prefill).  With ``return_kv`` also
    returns the rotated K/V [B,S,Hkv,D] for the cache fill."""
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    # kernels expect [B, H, S, D]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True)
    out = merge_heads(out.transpose(1, 2)) @ params["wo"]
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
    # gives the same cache.  Pinned as the reference pins it: the cache
    # sequence-sharded over the model axis (SP), the output replicated
    # over it.
    rows = torch.arange(bsz, device=x.device)
    _write_row(cache["k"], k[:, 0], length, rows)
    _write_row(cache["v"], v[:, 0], length, rows)
    length += 1
    out = ops.decode_attention(q[:, 0], constrain(cache["k"], _KV_SPEC),
                               constrain(cache["v"], _KV_SPEC), length)
    out = constrain(out, ("dp", None, None))
    out = out.reshape(bsz, 1, n_heads * head_dim)
    return out @ params["wo"], cache


_KV_SPEC = ("dp", "model", None, None)


def _write_row(cache: torch.Tensor, row: torch.Tensor,
               length: torch.Tensor, rows: torch.Tensor) -> None:
    """``cache[b, length[b]] = row[b]`` in place.  A DTensor cache sharded
    on its batch or its sequence is written on its shards: the row goes to
    the cache's batch sharding, whole over the rest, and the shard that
    holds position ``length[b]`` writes it (the reference's one-hot add
    pinned to the cache's sharding writes the same)."""
    if not is_distributed(cache) or all(p.is_replicate()
                                        for p in cache.placements):
        cache[rows, length] = row
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    batch = tuple(Shard(0) if p == Shard(0) else Replicate()
                  for p in cache.placements)
    local = cache.to_local()
    row_l = row.redistribute(mesh, batch).to_local()
    len_l = length.redistribute(mesh, batch).to_local()
    start = 0       # where this shard's slice of the sequence starts
    for i, p in enumerate(cache.placements):
        if p == Shard(1):
            start = start * mesh.shape[i] + mesh.get_local_rank(i)
    start *= local.shape[1]
    pos = len_l.long() - start
    inside = (pos >= 0) & (pos < local.shape[1])
    pos = pos.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, pos] = torch.where(inside[:, None, None], row_l,
                                   local[rows, pos])


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
