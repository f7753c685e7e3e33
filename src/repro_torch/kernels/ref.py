"""Plain torch oracles for every kernel (port of ``matmul_ref``,
``copy_ref``, ``stencil_ref``, ``attention_ref``, ``decode_attention_ref``
and ``ssd_ref`` of ``repro/kernels/ref.py``).  ``decode_attention_ref``
pins its logits with ``constrain`` as the reference does (a step on
DTensors moves them; a plain tensor stays as it is); the reference's
chunked XLA attention, whose pins are the others, has no counterpart
here: on a mesh the flash kernel's sharding rule takes their place."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain, is_distributed


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation, in a's dtype, with ``jnp.dot``'s
    semantics at any rank: a 0-d operand multiplies, otherwise a's last
    axis contracts with b's second-to-last (its only one for a vector)."""
    af, bf = a.float(), b.float()
    if a.ndim == 0 or b.ndim == 0:
        return (af * bf).to(a.dtype)
    return torch.tensordot(af, bf, dims=([a.ndim - 1],
                                         [max(b.ndim - 2, 0)])).to(a.dtype)


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Streaming identity (the paper's memory-intensive node): a fresh
    buffer, never an alias of x."""
    return x.clone(memory_format=torch.contiguous_format)


def stencil_ref(u: torch.Tensor) -> torch.Tensor:
    """One Jacobi step of the 5-point 2D heat stencil with zero (Dirichlet)
    boundary: u'[i,j] = 0.25*(u[i-1,j]+u[i+1,j]+u[i,j-1]+u[i,j+1]).  As the
    reference: the neighbour sum is taken in u's dtype, then scaled."""
    up = F.pad(u, (1, 1, 1, 1))
    return 0.25 * (up[:, :-2, 1:-1] + up[:, 2:, 1:-1]
                   + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]).to(u.dtype)


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
    q = constrain(q, ("dp", None, None))   # every head meets each shard
    qg = q.reshape(bsz, hkv, hq // hkv, d).float()
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) * scale
    logits = constrain(logits, ("dp", None, None, "model"))
    mask = (torch.arange(t, device=q.device)[None, None, None, :]
            < lengths[:, None, None, None])
    logits = logits.masked_fill(~mask, float("-inf"))
    if is_distributed(logits) and any(p.is_shard(3)
                                      for p in logits.placements):
        # a softmax over a sequence-sharded cache, as the reference's pin
        # lowers it: each (b, h) row's max and sum reduced over the shards
        # (a softmax op would gather the logits)
        e = torch.exp(logits - logits.amax(3, keepdim=True))
        w = e / e.sum(3, keepdim=True)
    else:
        w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", w, v_cache.float())
    return out.reshape(bsz, hq, d).to(q.dtype)


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD (scalar-A state space) oracle by a plain sequential scan.

    x: [B, S, H, D]; a: [B, S, H] log-decay (a <= 0); b, c: [B, S, N]
    shared across heads.  Returns y: [B, S, H, D] in x's dtype with
      h_t = exp(a_t) * h_{t-1} + x_t (x) b_t    (h: [B, H, D, N], float32)
      y_t = h_t @ c_t
    """
    bs, s, h, d = x.shape
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    state = torch.zeros((bs, h, d, b.shape[-1]), device=x.device)
    ys = []
    for t in range(s):
        state = (torch.exp(af[:, t])[..., None, None] * state
                 + xf[:, t, :, :, None] * bf[:, t, None, None, :])
        ys.append(torch.einsum("bhdn,bn->bhd", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)
