"""Public ops that the model calls (port of ``repro/kernels/ops.py``).

``flash_attention`` and ``ssd_scan`` go to their CUDA kernels for every
CUDA tensor, whatever its length: each kernel masks a ragged sequence
itself, so there is no shape gate and no quiet fallback (the reference's
``ssd_scan`` gave S % 128 != 0 to ``ssd_ref``; here that is the kernel's
work too).  A CPU tensor takes the kernel's plain version.
``decode_attention`` is plain torch, as the reference keeps it plain XLA (a
single-token GEMV chain).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .ref import decode_attention_ref
from .ssd_scan import ssd_scan


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


__all__ = ["decode_attention", "flash_attention", "ssd_scan"]
