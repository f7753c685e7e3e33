"""Plain torch oracles for the attention ops (port of the attention half of
``repro/kernels/ref.py``).  The JAX originals pin shardings with
``constrain``; a single card has nothing to pin, so those lines are gone."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """GQA attention oracle.

    q: [B, Hq, S, D]; k/v: [B, Hkv, T, D] with Hq % Hkv == 0.  Softmax in
    f32; the causal mask aligns the *ends* of the q and kv windows.
    """
    s, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    t = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) * scale
    if causal:
        q_pos = torch.arange(s, device=q.device)[:, None] + (t - s)
        k_pos = torch.arange(t, device=q.device)[None, :]
        logits = logits.masked_fill(k_pos > q_pos, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, vv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """Single-token decode attention oracle.

    q: [B, Hq, D]; k/v_cache: [B, T, Hkv, D]; lengths: [B] (valid prefix).
    GQA groups the query [B, Hkv, G, D] rather than repeating the cache.
    """
    bsz, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(bsz, hkv, hq // hkv, d).float()
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) * scale
    mask = (torch.arange(t, device=q.device)[None, None, None, :]
            < lengths[:, None, None, None])
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", w, v_cache.float())
    return out.reshape(bsz, hq, d).to(q.dtype)
