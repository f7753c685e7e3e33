"""Tiled matrix product (the paper's compute-intensive node): the CUDA
kernel's wrapper, its plain version and its launch counter.

Port of ``repro/kernels/matmul.py`` (``matmul_pallas``).  Same function:
a ``[M, K]`` @ b ``[K, N]`` summed in float32, in a's dtype.

:func:`matmul` launches ``csrc/matmul.cu`` for CUDA tensors (both float32
or both bfloat16, any M, N and K; an empty output launches nothing) or
raises; it takes :func:`matmul_plain` only for tensors on the CPU.  The
kernel has no backward; on the card it refuses inputs that require grad
under grad mode.

The plain version walks the kernel's ``BM x BN`` output tiles with a
float32 accumulator over K in slices of ``BK_PLAIN`` (the TPU kernel's
block; the CUDA kernel steps through each slice 8 at a time), the ragged
edge tiles cut short.  Its tile products are ``torch.matmul``: it is the
CPU path and the kernel's yardstick of correctness on the card, not of
speed, and nothing on the card's path calls it.
"""
from __future__ import annotations

import ctypes

import torch

from .common import LaunchCounter, refuse_grad

BM, BN = 128, 128   # output tile (BM, BN in csrc/matmul.cu)
BK_PLAIN = 128      # K slice of the plain version (matmul_pallas's bk)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes a [M,K] and b [K,N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"matmul takes two float32 or two bfloat16 "
                         f"matrices; got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no matmul kernel for device {a.device}")
    refuse_grad("matmul", a, b)
    return _launch(a, b)


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("matmul")
    fn = lib.repro_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, k) >= 2 ** 31 or -(-m // BM) > 65535:
        raise ValueError(f"matmul kernel takes M <= {65535 * BM} and N, K "
                         f"< 2**31; got M={m}, N={n}, K={k}")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               _DTYPE_CODE[a.dtype], m, n, k, stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    launches.add()
    return c


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's tile walk in torch, with a float32 accumulator."""
    _check(a, b)
    (m, k), n = a.shape, b.shape[1]
    af, bf = a.float(), b.float()
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    for i in range(0, m, BM):
        for j in range(0, n, BN):
            acc = torch.zeros((min(BM, m - i), min(BN, n - j)),
                              device=a.device)
            for l in range(0, k, BK_PLAIN):
                acc += af[i:i + BM, l:l + BK_PLAIN] @ bf[l:l + BK_PLAIN,
                                                         j:j + BN]
            c[i:i + BM, j:j + BN] = acc
    return c
