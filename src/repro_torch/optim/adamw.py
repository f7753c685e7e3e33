"""AdamW with decoupled weight decay, warmup+cosine schedule, global-norm
clipping, and mixed-precision support (bf16 params keep fp32 moments and an
fp32 master copy) — port of ``repro/optim/adamw.py``.

Over the same nested-dict tree as the reference and with the same
arithmetic, leaf by leaf: the step as a float32 count, the schedule and the
bias corrections in float32, the gradients cast to float32 and scaled by
the clip factor.  One difference of form: :func:`apply_updates` writes the
new moments, master copy and params into the tensors it is given (under
``torch.no_grad()``) and returns those same trees, where the reference
builds new ones (the step count too).  The values are the reference's;
what the update saves is memory (granite-8b at 8 layers holds 2.15 B
parameters: a functional update would hold a second set of params and
moments, 25.8 GB, beside the first).

What runs where.  The step's scalars (lr, the clip factor, the bias
corrections) are eager 0-d tensors on the params' device.  The gradient
norm and each leaf's update go to ``kernels/adamw.py``: on the card its
kernels (``csrc/adamw.cu``: the norm summed in float64 in a fixed order,
one update pass a leaf, bit for bit the eager update given the same
scalars), the counterpart of the reference's update fused by ``jit``; on
the CPU the eager arithmetic, bit for bit as before the kernels; on the
meta device (the dry-run) their work reported, nothing computed.
:func:`apply_updates_plain` runs the eager update on any device: the
update as it ran on the card before the kernels, the kernels' yardstick.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch

from ..kernels import adamw as _kernels

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree: PyTree) -> Iterator[Any]:
    """The leaves of a tree of dicts and lists, in the order of its keys
    (anything else, a tuple too, is a leaf)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, into a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                           1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: PyTree) -> dict:
    """Moments in fp32; fp32 master copy only when params are low-precision.
    Every tensor on its param's device; ``step`` an int32 scalar on the
    first param's."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(leaves(params)).device
    state = {
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if any(p.dtype != torch.float32 for p in leaves(params)):
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: PyTree) -> torch.Tensor:
    """The L2 norm of the tree's leaves, a 0-d float32 tensor (the module
    doc says what computes it where)."""
    return _kernels.global_norm(list(leaves(tree)))


@torch.no_grad()
def apply_updates_with(params: PyTree, grads: PyTree, state: dict,
                       cfg: AdamWConfig, *, norm,
                       update) -> tuple[PyTree, dict, dict]:
    """:func:`apply_updates` with the gradient norm ``norm(grads)`` and the
    leaf update ``update`` given (``kernels/adamw.py``'s ``global_norm``,
    ``update`` or their plain versions): the step's scalars, then one
    ``update`` a leaf."""
    step = state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = norm(list(leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    masters = state.get("master", params)
    for p, p32, g, m, v in zip(leaves(params), leaves(masters), leaves(grads),
                               leaves(state["m"]), leaves(state["v"])):
        update(p, p32, g, m, v, lr, scale, b1c, b2c, b1=cfg.b1, b2=cfg.b2,
               eps=cfg.eps, weight_decay=cfg.weight_decay)
    # into the step count's own tensor, which a captured step reads by
    # address (``train/step_graph.py``)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def apply_updates(params: PyTree, grads: PyTree, state: dict,
                  cfg: AdamWConfig) -> tuple[PyTree, dict, dict]:
    """One AdamW step.  Returns (new_params, new_state, info); the new
    params, moments and master copy are the given tensors, updated in place
    (the module doc says why, and what computes it where)."""
    return apply_updates_with(params, grads, state, cfg,
                              norm=_kernels.global_norm,
                              update=_kernels.update)


@torch.no_grad()
def apply_updates_plain(params: PyTree, grads: PyTree, state: dict,
                        cfg: AdamWConfig) -> tuple[PyTree, dict, dict]:
    """:func:`apply_updates` with the eager norm and leaf updates on any
    device (``kernels/adamw.py``'s plain versions)."""
    return apply_updates_with(params, grads, state, cfg,
                              norm=_kernels.global_norm_plain,
                              update=_kernels.update_plain)
