"""Mixture-of-Experts FFN: top-k routing with capacity, grouped dispatch
and combine, optional DeepSeek-style shared expert (port of
``repro/models/moe.py``).

The routing is the reference's, step for step: router logits and softmax
in float32, top-k with ties broken toward the lower expert index (as
``jax.lax.top_k``; ``torch.topk`` makes no such promise, so a stable
descending sort is sliced), gates renormalised, tokens grouped by up to
``group_size``, per-group capacity ``max(1, int(factor * S_g * K / E))``,
each (token, k) placed in its expert's queue by the running count over the
flattened (token, k) order, and a (token, k) past capacity dropped (it
falls through the residual).  The Switch aux loss ``E * sum_e f_e * p_e``
is in float32.

Where the reference forms one-hot dispatch and combine tensors and runs
every expert on its capacity slots, the port moves the same rows by index
and runs only what can hold a kept row, in one of two forms of one
function:

- **slots** (prefill and forward): every expert on its slots
  ``[G, E, C, d]``, C cut to the group's token count (a slot past it is
  never filled); tokens scattered to ``e * C + pos``, outputs gathered back
  from there.  It reads every expert's weights once.
- **pairs** (decode): when the group's (token, k) pairs are fewer than
  the experts, each pair runs its own expert, whose weights are gathered
  for it; a dropped pair gets weight 0.  It reads only the chosen experts'
  weights, not all E of them.

An empty slot of the reference holds zeros and has combine weight 0, so
both forms give its result.  Combine weights are in ``x.dtype``, the sum
over k in float32, rounded once to ``x.dtype``.

A padded prefill (``pad``: the serving engine's graph of a length bucket,
whose tokens past the prompt's real length S are padding) routes the
bucket's tokens as one group, with the real length's routing written into
it by the host (:func:`real_routing`, from the functions the unpadded path
uses): tokens a routing group of S and an expert's slots in such a group.
Each (token, k) takes its place by the running count from the start of
its real group, and is kept below that capacity and only for a token
before S.  Pads come after every real (token, k) in the flattened order,
so they move no real one's place, and none is kept.  A real group of 2,048
tokens (S a multiple of 2,048) is a run of the bucket's one group, its
slots after the groups before it: the slots ``[E, C, d]`` at the bucket's
capacity hold them all (S / 2,048 groups of ``cap(2048)`` slots are at
most ``cap(S)``).  So the bucket drops exactly what the reference drops
for the prompt alone, at any capacity factor, whatever S.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import (axis_sizes, constrain, dp_axes,
                                 is_distributed, model_coordinate,
                                 model_size, on_shards, placements)
from .layers import ffn, init_linear


def init_moe(d_model: int, n_experts: int, expert_ff: int,
             shared_ff: int = 0, *, gen: Optional[torch.Generator], device,
             dtype=torch.float32, stack: tuple[int, ...] = ()) -> dict:
    """Router [d, E], stacked SwiGLU experts [E, d, ff] / [E, ff, d] and,
    with ``shared_ff``, a shared SwiGLU expert; the reference's scales."""
    kw = dict(gen=gen, device=device, dtype=dtype, stack=stack)
    scale_in, scale_out = d_model ** -0.5, expert_ff ** -0.5
    p = {
        "router": init_linear((d_model, n_experts), scale=scale_in, **kw),
        "experts_gate": init_linear((n_experts, d_model, expert_ff),
                                    scale=scale_in, **kw),
        "experts_up": init_linear((n_experts, d_model, expert_ff),
                                  scale=scale_in, **kw),
        "experts_down": init_linear((n_experts, expert_ff, d_model),
                                    scale=scale_out, **kw),
    }
    if shared_ff > 0:
        p["shared"] = {
            "w_gate": init_linear((d_model, shared_ff), **kw),
            "w_up": init_linear((d_model, shared_ff), **kw),
            "w_down": init_linear((shared_ff, d_model), **kw),
        }
    return p


def group_capacity(sg: int, top_k: int, n_experts: int,
                   capacity_factor: float) -> int:
    """Slots an expert has in a group of ``sg`` tokens."""
    return max(1, int(capacity_factor * sg * top_k / n_experts))


def dispatch_plan(n_tokens: int, top_k: int, n_experts: int,
                  capacity_factor: float, group_size: int = 2048
                  ) -> tuple[int, int, bool, int]:
    """How ``moe_block`` lays out ``n_tokens``: (groups, tokens a group,
    whether it runs the pairs form, rows a group dispatches to the
    experts: every expert's capacity slots, or one a (token, k) pair)."""
    sg = min(group_size, n_tokens)
    if n_tokens % sg:
        sg = n_tokens           # degenerate small case: one group
    if sg * top_k < n_experts:
        return n_tokens // sg, sg, True, sg * top_k
    cap = group_capacity(sg, top_k, n_experts, capacity_factor)
    return n_tokens // sg, sg, False, n_experts * min(cap, sg)


def real_routing(n_tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float, group_size: int = 2048
                 ) -> tuple[int, int]:
    """How ``moe_block`` routes ``n_tokens`` unpadded, for a padded prefill
    of them: (tokens a routing group, the slots an expert takes in one:
    its capacity, at most the group's tokens)."""
    _, sg, _, _ = dispatch_plan(n_tokens, top_k, n_experts, capacity_factor,
                                group_size)
    return sg, min(group_capacity(sg, top_k, n_experts, capacity_factor), sg)


def _top_k(params: dict, xg: torch.Tensor, top_k: int):
    """(router probabilities [..., E] float32, the top-k gates renormalised
    and their experts [..., K])."""
    logits = xg.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # [G,S,E]
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :top_k], expert_idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def route(params: dict, xg: torch.Tensor, top_k: int,
          capacity_factor: float, with_aux: bool = True):
    """Routing of the groups ``xg`` [G, S_g, d]: (expert_idx [G,S_g,K],
    gates [G,S_g,K] float32 with a dropped (token, k) at 0, pos [G,S_g,K],
    keep [G,S_g,K], capacity, aux loss float32, or None without
    ``with_aux``)."""
    n_groups, sg, _ = xg.shape
    n_experts = params["router"].shape[-1]
    probs, gate_vals, expert_idx = _top_k(params, xg, top_k)

    # one-hot [G, E, S*K] over the flattened (s, k) order, (s, k) last so
    # that the running count below scans the innermost axis (a scan over
    # an outer axis took half of a qwen3-moe prefill's card time)
    flat = expert_idx.reshape(n_groups, 1, sg * top_k)
    oh = (flat == torch.arange(n_experts, device=xg.device)[:, None]).int()
    aux = None
    if with_aux:
        me = probs.mean(dim=(0, 1))
        ce = oh.sum(-1).float().mean(dim=0) / (sg * top_k)
        aux = n_experts * torch.sum(me * ce)

    capacity = group_capacity(sg, top_k, n_experts, capacity_factor)
    # the place of each (s, k) in its expert's queue: the running count of
    # that expert over the flattened (s, k) order
    # (dim 2, not -1: DTensor's scan rule reads a negative dim as none of
    # the tensor's and would scan each shard of a sharded one apart)
    pos = (oh.cumsum(2) - 1).gather(1, flat).reshape(n_groups, sg, top_k)
    keep = pos < capacity
    gates = torch.where(keep, gate_vals, 0.0)
    return expert_idx, gates, pos, keep, capacity, aux


def route_padded(params: dict, xg: torch.Tensor, top_k: int, pad):
    """Routing of a padded prefill's one group ``xg`` [1, S_b, d] as the
    real length's groups route it (``pad``: the real length and
    :func:`real_routing`'s numbers, on the device): (expert_idx, gates
    with a dropped or pad (token, k) at 0, each (token, k)'s place among
    its expert's slots (its real group's first slot + its running count
    there), keep), each [1, S_b, K].  No host synchronisation."""
    _, sb, _ = xg.shape
    n_experts = params["router"].shape[-1]
    _, gate_vals, expert_idx = _top_k(params, xg, top_k)
    e = expert_idx.reshape(sb * top_k)
    oh = (e == torch.arange(n_experts, device=xg.device)[:, None]).int()
    # before[e, j]: pairs of expert e ahead of pair j in the flattened order
    before = F.pad(oh.cumsum(1), (1, 0))                       # [E, S*K+1]
    j = torch.arange(sb * top_k, device=xg.device)
    group = torch.div(j // top_k, pad.moe_group, rounding_mode="floor")
    first = group * pad.moe_group * top_k      # the first pair of its group
    pos = before[e, j] - before[e, first]
    keep = (pos < pad.moe_capacity) & (j // top_k < pad.length[0])
    place = group * pad.moe_capacity + pos
    gates = torch.where(keep.reshape(1, sb, top_k), gate_vals, 0.0)
    return (expert_idx, gates, place.reshape(1, sb, top_k),
            keep.reshape(1, sb, top_k))


def _per_pair(xg, top_k):
    """[G, S, d] -> [G, S*K, d], each token's row once per k, in the
    flattened (s, k) order."""
    n_groups, sg, d = xg.shape
    return xg[:, :, None].expand(-1, -1, top_k, -1).reshape(
        n_groups, sg * top_k, d)


def _swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _experts_by_slot(params, xg, expert_idx, pos, keep, capacity,
                     group_tokens=None):
    """Every expert on its capacity slots, each (s, k) at slot ``pos`` of
    its expert's; returns each (s, k)'s expert output [G, S*K, d] (a
    dropped one's is read from slot 0: its weight is 0).
    ``group_tokens``: a group's tokens where ``xg`` holds a part of each
    group (a shard of them on a mesh); the slots are the whole group's."""
    n_groups, sg, d = xg.shape
    n_experts, top_k = params["experts_gate"].shape[0], expert_idx.shape[-1]
    cap = min(capacity, group_tokens or sg)
    slot = (expert_idx * cap + pos).reshape(n_groups, sg * top_k)
    keep = keep.reshape(n_groups, sg * top_k)
    rows = _per_pair(xg, top_k)                                # [G,S*K,d]
    # a dropped (s, k) goes to a spare last slot, cut off after the scatter
    to = torch.where(keep, slot, n_experts * cap)
    expert_in = xg.new_zeros(n_groups, n_experts * cap + 1, d)
    expert_in.scatter_(1, to[..., None].expand(-1, -1, d), rows)
    expert_in = expert_in[:, :-1].reshape(n_groups, n_experts, cap, d)
    out = _swiglu(expert_in, params["experts_gate"], params["experts_up"],
                  params["experts_down"])                      # [G,E,C,d]
    back = torch.where(keep, slot, 0)
    return out.reshape(n_groups, n_experts * cap, d).gather(
        1, back[..., None].expand(-1, -1, d))


def _experts_by_pair(params, xg, expert_idx):
    """Each (s, k) on its own expert, whose weights are gathered for it;
    returns the outputs [G, S*K, d]."""
    n_groups, sg, d = xg.shape
    e = expert_idx.reshape(-1)
    rows = _per_pair(xg, expert_idx.shape[-1]).reshape(-1, 1, d)
    out = _swiglu(rows, params["experts_gate"][e], params["experts_up"][e],
                  params["experts_down"][e])                   # [P,1,d]
    return out.reshape(n_groups, -1, d)


def _experts_sharded(params, xg, expert_idx, pos, keep, capacity,
                     pairs: bool):
    """The experts on DTensors (expert parallelism): each device runs, in
    the form ``moe_block`` takes, the (token, k) pairs of its groups that
    its own experts (the stacks' shard over "model", where it divides E)
    take, and gives 0 for the others, so the outputs are partial sums over
    "model"; the groups go over the data axes as they arrive, the routing
    whole over "model".  The weights' gradients are partial sums over the
    data axes, the tokens' over "model"."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = xg.device_mesh
    names = mesh.mesh_dim_names
    m = model_size(mesh)
    n_experts = params["experts_gate"].shape[0]
    ep = m > 1 and n_experts % m == 0
    tok = tuple(Replicate() if n == "model" else p
                for n, p in zip(names, xg.placements))
    data = [n for n, p in zip(names, tok) if not p.is_replicate()]
    wp = placements(mesh, {"model": 0 if ep else None})
    wg = tuple(Partial() if n in data else p for n, p in zip(names, wp))
    out_p = tuple(Partial() if n == "model" and ep else p
                  for n, p in zip(names, tok))
    tok_g = out_p
    coord = model_coordinate(mesh)

    def local(xl, idx, posl, keepl, gate, up, down):
        e0 = coord * gate.shape[0] if ep else 0
        mine = (idx >= e0) & (idx < e0 + gate.shape[0])
        idx = torch.where(mine, idx - e0, 0)
        p = {"experts_gate": gate, "experts_up": up, "experts_down": down}
        if pairs:
            out = _experts_by_pair(p, xl, idx)
        else:
            out = _experts_by_slot(p, xl, idx, posl, keepl & mine, capacity,
                                   group_tokens=xg.shape[1])
        return out * mine.reshape(*out.shape[:2], 1).to(out.dtype)

    return on_shards(local, mesh, (xg, expert_idx, pos, keep,
                                   params["experts_gate"],
                                   params["experts_up"],
                                   params["experts_down"]),
                     (tok,) * 4 + (wp,) * 3, out_p,
                     (tok_g,) + (tok,) * 3 + (wg,) * 3)


def moe_block(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              group_size: int = 2048, with_aux: bool = True, pad=None
              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: [B, S, d] -> (y [B, S, d] in x's dtype, aux_loss float32, or None
    without ``with_aux``: prefill and decode skip its reductions).  With
    ``pad`` (a padded prefill's real length and routing, B = 1) the S
    tokens are routed as the real length's are (:func:`route_padded`)."""
    bsz, s, d = x.shape
    n_experts = params["router"].shape[-1]
    if pad is not None:
        if bsz != 1 or with_aux or is_distributed(x):
            raise ValueError("moe_block: a padded prefill takes one plain "
                             "row and no aux loss")
        xg = x
        expert_idx, gates, place, keep = route_padded(params, xg, top_k, pad)
        slots = min(group_capacity(s, top_k, n_experts, capacity_factor), s)
        out = _experts_by_slot(params, xg, expert_idx, place, keep, slots)
        return _combine(params, x, xg, gates, out, top_k), None
    groups, sg, pairs, _ = dispatch_plan(bsz * s, top_k, n_experts,
                                         capacity_factor, group_size)
    # on a mesh the groups (or, where they do not divide, their tokens) go
    # over the data axes, whole over the model axis, and so does their
    # gradient
    if is_distributed(x):       # the tokens whole over the model axis
        x = constrain(x, ("dp", None, None))
    xg = x.reshape(groups, sg, d)
    if is_distributed(xg):
        dp = math.prod(axis_sizes(xg.device_mesh)[a]
                       for a in dp_axes(xg.device_mesh))
        xg = constrain(xg, ("dp", None, None) if groups % dp == 0
                       else (None, "dp", None))
    expert_idx, gates, pos, keep, capacity, aux = route(
        params, xg, top_k, capacity_factor, with_aux)
    if is_distributed(xg) and xg.device_mesh.size() > 1:
        out = _experts_sharded(params, xg, expert_idx, pos, keep, capacity,
                               pairs)
    elif pairs:
        out = _experts_by_pair(params, xg, expert_idx)
    else:
        out = _experts_by_slot(params, xg, expert_idx, pos, keep, capacity)
    return _combine(params, x, xg, gates, out, top_k), aux


def _combine(params, x, xg, gates, out, top_k: int) -> torch.Tensor:
    """Each token's expert outputs ``out`` [G, S*K, d] weighted by its
    ``gates`` and summed over k (and the shared expert's output added), in
    x's dtype and shape."""
    d = x.shape[-1]
    w = gates.to(x.dtype).reshape(*out.shape[:2], 1)
    y = (w.float() * out.float()).reshape(*xg.shape[:2], top_k, d).sum(2)
    y = y.to(x.dtype)
    if "shared" in params:
        y = y + ffn(params["shared"], xg, "swiglu")
    return y.reshape(x.shape)
