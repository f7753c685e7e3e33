"""Mamba-2 block (SSD) for the hybrid architecture (port of
``repro/models/mamba2.py``).

The full-sequence path runs the chunked SSD scan (``ops.ssd_scan``: the
CUDA kernel on the card); decode keeps a per-layer recurrent state
{ssm: [B,H,D,N], conv: [B,W-1,Di]}, constant in sequence length.

The reference's simplifications, kept: scalar per-head decay
a_t = -softplus(dt) * exp(a_log), B/C shared across heads, a causal
depthwise conv of width 4.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.sharding import (is_distributed, merge_heads, on_shards,
                                 split_heads)
from ..parallel.sharding import pad as zero_pad
from .layers import init_linear, rms_norm

CONV_W = 4


def init_mamba2(d_model: int, n_heads: int, head_dim: int, ssm_state: int, *,
                gen: Optional[torch.Generator], device, dtype=torch.float32,
                stack: tuple[int, ...] = ()) -> dict:
    """Separate projection leaves, as the reference (x/z/dt column-shard
    under tensor parallelism while B/C stay replicated)."""
    d_inner = n_heads * head_dim
    kw = dict(gen=gen, device=device, dtype=dtype, stack=stack)
    return {
        "wx": init_linear((d_model, d_inner), **kw),
        "wz": init_linear((d_model, d_inner), **kw),
        "wb": init_linear((d_model, ssm_state), **kw),
        "wc": init_linear((d_model, ssm_state), **kw),
        "wdt": init_linear((d_model, n_heads), **kw),
        "conv_w": init_linear((CONV_W, d_inner), scale=0.2, **kw),
        "dt_bias": torch.zeros(stack + (n_heads,), dtype=dtype, device=device),
        "a_log": torch.zeros(stack + (n_heads,), dtype=dtype, device=device),
        "norm_z": torch.ones(stack + (d_inner,), dtype=dtype, device=device),
        "w_out": init_linear((d_inner, d_model), **kw),
    }


def _split_proj(params: dict, x: torch.Tensor):
    return (x @ params["wx"], x @ params["wz"], x @ params["wb"],
            x @ params["wc"], x @ params["wdt"])


def _decay_of(dt: torch.Tensor, bias: torch.Tensor,
              a_log: torch.Tensor) -> torch.Tensor:
    return -F.softplus(dt + bias) * torch.exp(a_log)


def _decay(params: dict, dt: torch.Tensor) -> torch.Tensor:
    """a_t = dt * A with dt = softplus(dt_raw + bias), A = -exp(a_log).  On
    a mesh it runs on the shards of the heads (elementwise a head; the
    per-head leaves' gradients partial sums over the batch's shards), where
    DTensor would decompose softplus and move the leaves by its own rules."""
    if not is_distributed(dt):
        return _decay_of(dt, params["dt_bias"], params["a_log"])
    from torch.distributed.tensor import Partial, Replicate, Shard
    heads = dt.ndim - 1
    dp = tuple(Replicate() if p.is_partial() else p for p in dt.placements)
    hp = tuple(Shard(0) if p.is_shard(heads) else Replicate() for p in dp)
    hg = tuple(Partial() if p.is_shard() and not p.is_shard(heads) else h
               for p, h in zip(dp, hp))
    return on_shards(_decay_of, dt.device_mesh,
                     (dt, params["dt_bias"], params["a_log"]), (dp, hp, hp),
                     dp, (dp, hg, hg))


def mamba2_block(params: dict, x: torch.Tensor, *, n_heads: int,
                 head_dim: int, ssm_state: int, return_state: bool = False,
                 length: Optional[torch.Tensor] = None):
    """Full-sequence path.  x: [B, S, d] -> [B, S, d].  With
    ``return_state`` also returns the decode state after the last token:
    the closed-form final SSM state and the conv tail (the last W-1 raw
    inputs, zeros in front when S < W-1).  ``length`` [B] (a padded
    prefill's real lengths): positions from it on are no input, so the
    state is the one after the last real token."""
    s = x.shape[1]
    xs_raw, z, b, c, dt = _split_proj(params, x)

    # causal depthwise conv of width 4 along S
    pad = zero_pad(xs_raw, (0, 0, CONV_W - 1, 0))
    conv = sum(pad[:, i:i + s] * params["conv_w"][i] for i in range(CONV_W))
    xs = F.silu(conv)

    a = _decay(params, dt)                                # [B,S,H]
    if length is not None:
        # a pad's decay 0 and input 0: exp(0) = 1 and no added term carry
        # the state at the real end through the pads unchanged
        live = (torch.arange(s, device=x.device) < length[:, None])[..., None]
        a = torch.where(live, a, 0.0)
        xs = torch.where(live, xs, 0.0)
    xh = split_heads(xs, n_heads, head_dim)
    y = merge_heads(ops.ssd_scan(xh, a, b, c))
    y = rms_norm(y * F.silu(z), params["norm_z"])         # gated output norm
    out = y @ params["w_out"]
    if not return_state:
        return out
    # closed-form final state: h_T = sum_u exp(Acum_T - Acum_u) x_u (x) B_u
    if length is None:
        tail = pad[:, s:s + CONV_W - 1]
    else:   # the W-1 raw inputs before the real end, by the device length
        at = length.long()[:, None] + torch.arange(CONV_W - 1,
                                                   device=x.device)
        tail = pad.gather(1, at[..., None].expand(-1, -1, pad.shape[-1]))
    state = {"ssm": _final_state(xh, a, b).to(x.dtype), "conv": tail}
    return out, state


def _final_state_of(xh: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """h_T = sum_u exp(Acum_T - Acum_u) x_u (x) B_u, float32 [B,H,D,N]."""
    acum = torch.cumsum(a.float(), dim=1)
    w = torch.exp(acum[:, -1:] - acum)                    # [B,S,H]
    return torch.einsum("bshd,bsh,bsn->bhdn", xh.float(), w, b.float())


def _final_state(xh: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """The closed-form final state; on a mesh on the shards of the batch
    and the heads (b whole over the heads' mesh dims): a head's state reads
    only its own x and decay."""
    if not is_distributed(xh):
        return _final_state_of(xh, a, b)
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
               for p in xh.placements)
    bp = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    out = tuple(Shard(1) if p.is_shard(2) else p for p in pl)
    return on_shards(_final_state_of, xh.device_mesh, (xh, a, b),
                     (pl, pl, bp), out)


def mamba2_decode(params: dict, x: torch.Tensor, state: dict, *,
                  n_heads: int, head_dim: int,
                  ssm_state: int) -> tuple[torch.Tensor, dict]:
    """One-token step.  x: [B,1,d]; state: {"ssm": [B,H,D,N], "conv":
    [B,W-1,Di]} -> (out [B,1,d], new state)."""
    bsz = x.shape[0]
    d_inner = n_heads * head_dim
    xs, z, b, c, dt = _split_proj(params, x[:, 0])

    window = torch.cat([state["conv"], xs[:, None, :]], dim=1)   # [B,W,Di]
    conv = torch.einsum("bwd,wd->bd", window, params["conv_w"])
    xs = F.silu(conv)

    a = _decay(params, dt)                                # [B,H]
    xh = split_heads(xs, n_heads, head_dim)
    h = (torch.exp(a)[..., None, None] * state["ssm"]
         + xh[..., None] * b[:, None, None, :])
    y = torch.einsum("bhdn,bn->bhd", h, c).reshape(bsz, d_inner)
    y = rms_norm(y * F.silu(z), params["norm_z"])
    return (y @ params["w_out"])[:, None, :], {"ssm": h,
                                                "conv": window[:, 1:]}


def init_mamba2_state(batch: int, n_heads: int, head_dim: int,
                      ssm_state: int, dtype=torch.float32, device=None,
                      stack: tuple[int, ...] = ()) -> dict:
    return {
        "ssm": torch.zeros(stack + (batch, n_heads, head_dim, ssm_state),
                           dtype=dtype, device=device),
        "conv": torch.zeros(stack + (batch, CONV_W - 1, n_heads * head_dim),
                            dtype=dtype, device=device),
    }
