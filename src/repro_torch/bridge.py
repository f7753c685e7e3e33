"""Weights from the JAX package into the port, leaf for leaf.

The reference's params are nested dicts of arrays with one stacked leading
layer axis per block kind (``repro/models/transformer.py::init_params``:
``attn``, ``mamba2``, ``mlstm``, ``slstm``) and, for the hybrid, the
unstacked ``shared_attn``; the port keeps that tree.  Torch cannot reproduce ``jax.random``, so a
parity test initialises in JAX, converts the leaves to numpy, and hands
them over here.  bfloat16 leaves (numpy dtype ``bfloat16``) cross as their
raw 16-bit words.
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
