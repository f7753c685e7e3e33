"""Streaming copy (the paper's memory-intensive node): the CUDA kernel's
wrapper, its plain version and its launch counter.

Port of ``repro/kernels/copy.py`` (``copy_pallas``).  Same function: a
fresh buffer holding x bit for bit, never an alias of it.

:func:`copy` launches ``csrc/copy.cu`` for a CUDA tensor of any dtype, rank
and size (an empty tensor launches nothing), and takes :func:`copy_plain`
only for a tensor on the CPU.  Both raise on a non-contiguous input: the
kernel moves bytes in memory order.  The kernel has no backward; on the card
it refuses inputs that require grad under grad mode.

The plain version walks the TPU kernel's (512, 1024) tiles over x seen as a
2-D array (rows of its last axis) into ``torch.empty``.  It is the CPU path
and the kernel's yardstick of correctness on the card, not of speed.
"""
from __future__ import annotations

import ctypes

import torch

from .common import LaunchCounter, refuse_grad

BM, BN = 512, 1024     # the plain version's tiles (copy_pallas's defaults)

launches = LaunchCounter()


def _check(x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"copy takes a contiguous tensor; got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")


def copy(x: torch.Tensor) -> torch.Tensor:
    _check(x)
    if x.device.type == "cpu":
        return copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no copy kernel for device {x.device}")
    refuse_grad("copy", x)
    return _launch(x)


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("copy")
    fn = lib.repro_copy
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_longlong, p]
    return lib


def stage_bytes() -> int:
    """Bytes a stage of the kernel's bulk copy ring (``kStageBytes`` in
    ``csrc/copy.cu``); builds the kernel on first use."""
    return _lib().repro_copy_stage_bytes()


def _launch(x: torch.Tensor) -> torch.Tensor:
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_copy(x.data_ptr(), y.data_ptr(),
                             x.numel() * x.element_size(), stream)
    if err:
        raise RuntimeError(f"copy kernel launch failed: CUDA error {err}")
    launches.add()
    return y


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's tile walk in torch, into a fresh buffer."""
    _check(x)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return y
    x2 = x.reshape(-1, x.shape[-1]) if x.ndim else x.reshape(1, 1)
    y2 = y.view(x2.shape)
    m, n = x2.shape
    for i in range(0, m, BM):
        for j in range(0, n, BN):
            y2[i:i + BM, j:j + BN] = x2[i:i + BM, j:j + BN]
    return y
