"""Weights and optimizer state between the JAX package and the port, leaf
for leaf.

The reference's params are nested dicts of arrays with one stacked leading
layer axis per block kind (``repro/models/transformer.py::init_params``:
``attn``, ``mamba2``, ``mlstm``, ``slstm``) and, for the hybrid, the
unstacked ``shared_attn``; the port keeps that tree.  Its AdamW state is
``{"m", "v", "step"}`` and, for low-precision params, ``"master"``
(``repro/optim/adamw.py::init_opt_state``); the port's is the same tree.
Torch cannot reproduce ``jax.random``, so a parity test initialises in JAX,
converts the leaves to numpy, and hands them over here (:func:`to_torch`);
:func:`to_numpy` brings the port's tree back.  bfloat16 leaves (numpy
dtype ``bfloat16``) cross into torch as their raw 16-bit words; back, they
come out as float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(tree: Any, device="cpu") -> Any:
    """Nested dicts of numpy-convertible arrays -> the same tree of torch
    tensors on ``device`` (every leaf copied)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def to_numpy(tree: Any) -> Any:
    """Nested dicts of torch tensors -> the same tree of numpy arrays (every
    leaf copied to the host; bfloat16 as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
