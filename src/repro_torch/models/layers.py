"""Shared building blocks: norms, rotary embeddings, FFNs, initializers
(port of ``repro/models/layers.py``).

Params are nested dicts of tensors with the reference's leaf names.  The
initializers draw from a ``torch.Generator`` with the reference's scales
(torch cannot reproduce ``jax.random``; tests bridge the reference's
weights instead).  ``stack`` prepends a layer axis, so a whole layer stack
is drawn in one call, on the device it will live on.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# -- rotary ------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Half-split
    rotation (not interleaved), as the reference."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # [D/2]
    angles = positions[..., :, None, None].float() * freqs        # [...,S,1,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- FFN ---------------------------------------------------------------------

def ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain (gelu / squared-ReLU) FFN by leaf set.
    ``jax.nn.gelu`` is the tanh approximation, so is this one."""
    if "w_gate" in params:
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        if act == "swiglu":
            h = F.silu(g) * u
        elif act == "geglu":
            h = F.gelu(g, approximate="tanh") * u
        else:
            raise ValueError(f"gated ffn with act={act!r}")
        return h @ params["w_down"]
    h = x @ params["w_up"]
    if act == "sq_relu":                  # Primer / Nemotron-4 squared ReLU
        h = torch.square(F.relu(h))
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu":
        h = F.relu(h)
    else:
        raise ValueError(f"ungated ffn with act={act!r}")
    return h @ params["w_down"]


# -- init --------------------------------------------------------------------

def init_linear(shape: tuple[int, ...], *,
                gen: Optional[torch.Generator], device,
                dtype=torch.float32, scale: float | None = None,
                stack: tuple[int, ...] = ()) -> torch.Tensor:
    """Normal(0, scale) of ``stack + shape``; scale defaults to
    ``shape[0] ** -0.5`` (fan-in), as the reference's ``init_linear``.
    Drawn straight into a tensor of ``dtype`` (``normal_`` computes in
    float32 and rounds), so a bfloat16 leaf needs no float32 copy of itself
    (qwen3-moe's ``experts_gate`` stack would take 38.7 GB of float32)."""
    scale = shape[0] ** -0.5 if scale is None else scale
    w = torch.empty(tuple(stack) + tuple(shape), dtype=dtype, device=device)
    return w.normal_(0.0, scale, generator=gen)


def init_ffn(d_model: int, d_ff: int, act: str, *,
             gen: Optional[torch.Generator], device, dtype=torch.float32,
             stack: tuple[int, ...] = ()) -> dict:
    kw = dict(gen=gen, device=device, dtype=dtype, stack=stack)
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": init_linear((d_model, d_ff), **kw),
            "w_up": init_linear((d_model, d_ff), **kw),
            "w_down": init_linear((d_ff, d_model), **kw),
        }
    return {
        "w_up": init_linear((d_model, d_ff), **kw),
        "w_down": init_linear((d_ff, d_model), **kw),
    }
