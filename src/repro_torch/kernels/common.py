"""What every kernel wrapper shares: its launch counter and, for a kernel
without a backward, its refusal of inputs that need a gradient."""
from __future__ import annotations

import threading

import torch


class LaunchCounter:
    """Kernel launches, counted under a lock: the serving engine launches
    from several worker threads at once.  A wrapper adds one where it
    launches its kernel; a CUDA graph's replay, which runs no wrapper, adds
    the launches its graph holds (``serve/decode_graph.py``)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through a CUDA kernel
    that has no backward.

    Flash attention, the SSD scan and the sLSTM scan have one
    (``FlashAttention``, ``SSDScan``, ``SLSTMScan``); the matmul, copy and stencil kernels have none (nor have
    the TPU kernels they replace: no custom VJP), so their output would
    carry no ``grad_fn`` and the gradient would be lost without a word.
    Run them under ``torch.no_grad()`` or ``torch.inference_mode()``; on
    the CPU the plain version is differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; an input requires "
            f"grad under grad mode, so its gradient would be lost. Call it "
            f"under torch.no_grad() or torch.inference_mode().")
