"""The train/prefill/decode step functions (port of
``repro/train/train_step.py``).

``torch.autograd.grad`` over the params' leaves takes the place of
``jax.value_and_grad``; there is no ``jit`` (the steps run eagerly, and the
attention in them runs the flash kernels, forward and backward, on the
card).  A step sets ``requires_grad`` on the params' leaves before its
forward; the optimizer updates them in place under ``torch.no_grad()``
(``optim/adamw.py``).
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models import decode_step as _decode_step
from ..models import loss_and_metrics
from ..models.transformer import forward as _forward
from ..models.transformer import prefill as _prefill
from ..optim import AdamWConfig, apply_updates
from ..optim.adamw import leaves, tree_map

PyTree = Any


def _value_and_grad(params: PyTree, cfg: ModelConfig, batch: dict,
                    remat: bool) -> tuple[torch.Tensor, dict, PyTree]:
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = loss_and_metrics(params, cfg, batch, remat=remat)
    grads = iter(torch.autograd.grad(loss, flat))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: bool = True):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _value_and_grad(params, cfg, batch, remat)
        new_params, new_opt, info = apply_updates(params, grads, opt_state,
                                                  opt_cfg)
        return new_params, new_opt, {**metrics, **info, "total_loss": loss}

    return train_step


def make_grad_step(cfg: ModelConfig, *, remat: bool = True):
    """Gradient-only step for grad-accum / compression paths."""

    def grad_step(params, batch):
        loss, metrics, grads = _value_and_grad(params, cfg, batch, remat)
        return grads, {**metrics, "total_loss": loss}

    return grad_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """(params, batch) -> (last-token logits, decode state)."""

    def prefill_step(params, batch):
        return _prefill(params, cfg, batch["tokens"], max_len,
                        batch.get("frontend"))

    return prefill_step


def make_forward_step(cfg: ModelConfig):
    """Inference forward (logits only) — the compute body of prefill."""

    def forward_step(params, batch):
        logits, _ = _forward(params, cfg, batch["tokens"],
                             batch.get("frontend"))
        return logits

    return forward_step


def make_decode_step(cfg: ModelConfig):
    """(params, state, tokens[B]) -> (logits [B,V], state)."""

    def serve_step(params, state, tokens):
        return _decode_step(params, cfg, state, tokens)

    return serve_step
