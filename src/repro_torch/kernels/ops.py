"""Public attention ops that the model calls (port of the attention half of
``repro/kernels/ops.py``).

``flash_attention`` goes to the CUDA kernel for every CUDA tensor, whatever
its length: the kernel masks a ragged S or T itself, so there is no shape
gate and no quiet fallback.  ``decode_attention`` is plain torch, as the
reference keeps it plain XLA (a single-token GEMV chain).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


__all__ = ["decode_attention", "flash_attention"]
