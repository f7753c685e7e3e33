"""Public ops that the model and the task runtime's payloads call (port of
``repro/kernels/ops.py``).

``matmul``, ``copy``, ``stencil``, ``flash_attention``, ``ssd_scan`` and
``slstm_scan`` go to their CUDA kernels for every CUDA tensor, whatever its shape: each
kernel masks a ragged edge itself, so there is no shape gate and no quiet
fallback (the reference gave shapes off its (8, 128) tiling to its jnp
oracles; here those are the kernels' work too).  Each raises on a dtype or
rank its kernel does not take.  A CPU tensor takes the kernel's plain
version.  One exception: ``matmul`` of operands that are not both
matrices is ``matmul_ref``'s ``jnp.dot`` product on either device, as in
the reference, which never gives those to its kernel.
``decode_attention`` is plain torch, as the reference keeps it plain XLA (a
single-token GEMV chain).
"""
from __future__ import annotations

import torch

from . import matmul as _matmul
from .copy import copy
from .flash_attention import flash_attention
from .ref import decode_attention_ref, matmul_ref
from .slstm_scan import slstm_scan
from .ssd_scan import ssd_scan
from .stencil import stencil


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.ndim != 2 or b.ndim != 2:
        return matmul_ref(a, b)
    return _matmul.matmul(a, b)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


__all__ = ["copy", "decode_attention", "flash_attention", "matmul",
           "slstm_scan", "ssd_scan", "stencil"]
