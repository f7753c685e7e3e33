"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallel) and
sLSTM (scalar memory, sequential) (port of ``repro/models/xlstm.py``).

mLSTM is a gated linear recurrence over a matrix state C: [H, D, N],
    C_t = f_t C_{t-1} + i_t v_t k_tᵀ,   h_t = C_t q_t / max(|n_t q_t|, 1),
evaluated over the whole sequence with the SSD scan (``ops.ssd_scan``: the
CUDA kernel on the card), heads folded into the batch; the normalizer
n_t q_t is a second, D = 1 scan over the input gate, so prefill and decode
agree to numerical precision.

sLSTM keeps per-unit scalar state with exponential gating.  The input
half of its four gate pre-activations is one product per gate over the
whole sequence; the recurrent half is ``ops.slstm_scan`` (the CUDA kernel
on the card, forward and backward; the reference's ``lax.scan``), which
prefill, decode (S = 1, the request's carry) and training share.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.slstm_scan import slstm_cell
from ..parallel.sharding import constrain, merge_heads, split_heads
from .layers import init_linear, rms_norm


def _ones(stack, n, dtype, device) -> torch.Tensor:
    return torch.ones(tuple(stack) + (n,), dtype=dtype, device=device)


# -- mLSTM -------------------------------------------------------------------

def init_mlstm(d_model: int, n_heads: int, proj_factor: float = 2.0, *,
               gen: Optional[torch.Generator], device, dtype=torch.float32,
               stack: tuple[int, ...] = ()) -> dict:
    d_inner = int(d_model * proj_factor)
    kw = dict(gen=gen, device=device, dtype=dtype, stack=stack)
    return {
        "w_x": init_linear((d_model, d_inner), **kw),
        "w_gate_proj": init_linear((d_model, d_inner), **kw),
        "wq": init_linear((d_inner, d_inner), **kw),
        "wk": init_linear((d_inner, d_inner), **kw),
        "wv": init_linear((d_inner, d_inner), **kw),
        "w_if": init_linear((d_inner, 2 * n_heads), **kw),   # i/f gates
        "norm_h": _ones(stack, d_inner, dtype, device),
        "w_down": init_linear((d_inner, d_model), **kw),
    }


def _fold_heads(t: torch.Tensor) -> torch.Tensor:
    """[B,S,H,...] -> [B*H,S,...]: one scan "batch" per head."""
    t = t.movedim(2, 1)
    return t.reshape((t.shape[0] * t.shape[1],) + t.shape[2:])


def _unfold_heads(t: torch.Tensor, bsz: int, n_heads: int) -> torch.Tensor:
    """A scan's output [B*H,S,1,D] -> [B,S,H,D]."""
    return t.reshape(bsz, n_heads, t.shape[1], -1).transpose(1, 2)


def mlstm_block(params: dict, x: torch.Tensor, *, n_heads: int,
                return_state: bool = False,
                length: Optional[torch.Tensor] = None):
    """Parallel path: the forget gate is the decay (a = log f), the input
    gate scales v, B = k and C = q.  With ``return_state`` also returns
    the exact (C, n) decode state after the last token.  ``length`` [B] (a
    padded prefill's real lengths): a pad's decay and input gate are 0, so
    the closed form at the last position is the state at the real end."""
    bsz = x.shape[0]
    xi = x @ params["w_x"]
    gate = x @ params["w_gate_proj"]
    d_inner = xi.shape[-1]
    head_dim = d_inner // n_heads

    q = split_heads(xi @ params["wq"], n_heads, head_dim)
    k = split_heads(xi @ params["wk"], n_heads, head_dim) * head_dim ** -0.5
    v = split_heads(xi @ params["wv"], n_heads, head_dim)
    # on a mesh the gates (a partial sum where xi is sharded) go whole over
    # the model axis, batch-sharded: each shard of the heads then reads its
    # own, as the folded scans take them
    gates = constrain(xi @ params["w_if"], ("dp", None, None))
    i_gate = torch.sigmoid(gates[..., :n_heads])          # [B,S,H]
    f_gate = torch.sigmoid(gates[..., n_heads:])          # [B,S,H]

    a = torch.log(f_gate + 1e-6)
    if length is not None:
        live = (torch.arange(x.shape[1], device=x.device)
                < length[:, None])[..., None]
        a = torch.where(live, a, 0.0)
        i_gate = torch.where(live, i_gate, 0.0)
    xv = v * i_gate[..., None]                            # [B,S,H,D]

    af, kf, qf = _fold_heads(a)[..., None], _fold_heads(k), _fold_heads(q)
    y = ops.ssd_scan(_fold_heads(xv)[:, :, None, :], af, kf, qf)
    y = _unfold_heads(y, bsz, n_heads)                    # [B,S,H,D]
    # normalizer n_t . q_t as a D = 1 scan over the input gate
    den = ops.ssd_scan(_fold_heads(i_gate[..., None])[:, :, None, :],
                       af, kf, qf)
    den = _unfold_heads(den, bsz, n_heads)                # [B,S,H,1]
    y = y / torch.clamp(den.abs(), min=1.0)
    h = rms_norm(merge_heads(y), params["norm_h"]) * F.silu(gate)
    out = h @ params["w_down"]
    if not return_state:
        return out
    # exact final state: C_T = sum_u exp(acum_T - acum_u) (i_u v_u) (x) k_u
    acum = torch.cumsum(a.float(), dim=1)                 # [B,S,H]
    w = torch.exp(acum[:, -1:] - acum)
    kf32 = k.float()
    c_fin = torch.einsum("bshd,bsh,bshn->bhdn", xv.float(), w, kf32)
    n_fin = torch.einsum("bsh,bsh,bshn->bhn", i_gate.float(), w, kf32)
    return out, {"C": c_fin.to(x.dtype), "n": n_fin.to(x.dtype)}


def mlstm_decode(params: dict, x: torch.Tensor, state: dict, *,
                 n_heads: int) -> tuple[torch.Tensor, dict]:
    """Exact recurrence with normalizer.  state: {"C": [B,H,D,N],
    "n": [B,H,N]} -> (out [B,1,d], new state)."""
    bsz = x.shape[0]
    xi = x[:, 0] @ params["w_x"]
    gate = x[:, 0] @ params["w_gate_proj"]
    d_inner = xi.shape[-1]
    head_dim = d_inner // n_heads

    q = split_heads(xi @ params["wq"], n_heads, head_dim)
    k = split_heads(xi @ params["wk"], n_heads, head_dim) * head_dim ** -0.5
    v = split_heads(xi @ params["wv"], n_heads, head_dim)
    gates = xi @ params["w_if"]
    i_g = torch.sigmoid(gates[..., :n_heads])[..., None]   # [B,H,1]
    f_g = torch.sigmoid(gates[..., n_heads:])[..., None]

    c_st = (f_g[..., None] * state["C"]
            + i_g[..., None] * v[..., None] * k[:, :, None, :])
    n_st = f_g * state["n"] + i_g * k
    num = torch.einsum("bhdn,bhn->bhd", c_st, q)
    den = torch.einsum("bhn,bhn->bh", n_st, q).abs()[..., None]
    h = (num / torch.clamp(den, min=1.0)).reshape(bsz, d_inner)
    h = rms_norm(h, params["norm_h"]) * F.silu(gate)
    return (h @ params["w_down"])[:, None, :], {"C": c_st, "n": n_st}


def init_mlstm_state(batch: int, n_heads: int, head_dim: int,
                     dtype=torch.float32, device=None,
                     stack: tuple[int, ...] = ()) -> dict:
    return {
        "C": torch.zeros(stack + (batch, n_heads, head_dim, head_dim),
                         dtype=dtype, device=device),
        "n": torch.zeros(stack + (batch, n_heads, head_dim), dtype=dtype,
                         device=device),
    }


# -- sLSTM -------------------------------------------------------------------

_GATES = ("w_i", "w_f", "w_z", "w_o")


def init_slstm(d_model: int, n_heads: int, proj_factor: float = 4 / 3, *,
               gen: Optional[torch.Generator], device, dtype=torch.float32,
               stack: tuple[int, ...] = ()) -> dict:
    d_up = int(d_model * proj_factor)
    kw = dict(gen=gen, device=device, dtype=dtype, stack=stack)
    p = {name: init_linear((d_model, d_model), **kw) for name in _GATES}
    # the recurrent per-head block diagonal, approximated per unit
    p["r_gates"] = init_linear((4, d_model), scale=0.1, **kw)
    p["norm_h"] = _ones(stack, d_model, dtype, device)
    p["w_up_a"] = init_linear((d_model, d_up), **kw)
    p["w_up_b"] = init_linear((d_model, d_up), **kw)
    p["w_down"] = init_linear((d_up, d_model), **kw)
    return p


def _gate_inputs(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., d] -> [..., 4, d]: x @ w_i, w_f, w_z, w_o."""
    return torch.stack([x @ params[name] for name in _GATES], dim=-2)


def _slstm_cell(params: dict, carry: tuple, gx: torch.Tensor) -> tuple:
    """One sLSTM step with exponential gating and the stabilizer state m
    (``slstm_scan.slstm_cell``, the kernel's arithmetic).  ``gx`` [B, 4, d]
    is the input half of the gate pre-activations."""
    return slstm_cell(gx, params["r_gates"], carry)


def _slstm_out(params: dict, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["norm_h"])
    h = (F.gelu(h @ params["w_up_a"], approximate="tanh")
         * (h @ params["w_up_b"]))
    return h @ params["w_down"]


def slstm_block(params: dict, x: torch.Tensor, *, n_heads: int,
                return_state: bool = False,
                length: Optional[torch.Tensor] = None):
    """The recurrence over x [B, S, d]; with ``length`` [B] (a padded
    prefill's real lengths, int32) the carry stops at each row's real end
    (the scan holds it through the pads: their inputs cannot hold it)."""
    bsz, _, d = x.shape
    carry = tuple(torch.zeros((bsz, d), dtype=x.dtype, device=x.device)
                  for _ in range(4))
    hs, carry = ops.slstm_scan(_gate_inputs(params, x), params["r_gates"],
                               carry, lengths=length)
    out = _slstm_out(params, hs)
    if not return_state:
        return out
    return out, dict(zip(("h", "c", "n", "m"), carry))


def slstm_decode(params: dict, x: torch.Tensor, state: dict, *,
                 n_heads: int) -> tuple[torch.Tensor, dict]:
    carry = (state["h"], state["c"], state["n"], state["m"])
    hs, new = ops.slstm_scan(_gate_inputs(params, x), params["r_gates"],
                             carry)
    return _slstm_out(params, hs), dict(zip(("h", "c", "n", "m"), new))


def init_slstm_state(batch: int, d_model: int, dtype=torch.float32,
                     device=None, stack: tuple[int, ...] = ()) -> dict:
    return {name: torch.zeros(stack + (batch, d_model), dtype=dtype,
                              device=device)
            for name in ("h", "c", "n", "m")}
