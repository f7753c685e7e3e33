"""Tiled matrix product (the paper's compute-intensive node): the CUDA
kernel's wrapper, its plain version and its launch counter.

Port of ``repro/kernels/matmul.py`` (``matmul_pallas``).  Same function:
a ``[M, K]`` @ b ``[K, N]`` summed in float32, in a's dtype.

:func:`matmul` launches a kernel of ``csrc/matmul.cu`` for CUDA tensors
(both float32 or both bfloat16, any M, N and K; an empty output launches
nothing) or raises; it takes :func:`matmul_plain` only for tensors on the
CPU.  The kernels have no backward; on the card the wrapper refuses inputs
that require grad under grad mode.

Which kernel runs is :func:`matmul_path`, a plain function of the dtype,
the shapes and the alignment of the contiguous operands (no ``try``, no
fallback on failure):

- ``"wgmma"``: bfloat16 with K and N multiples of 8 (rows of a multiple of
  16 bytes, as TMA needs), both pointers on a 16-byte boundary, K > 0.
  Tensor cores: TMA into a 4-stage ring, wgmma on 128 x 256 tiles of C.
- ``"fma_pipelined"``: float32 with K and N multiples of 4 and the same
  alignment, K > 0.  float32 FMAs on 128 x 256 tiles (8 x 16 a thread),
  K in steps of 32 through a 4-stage ``cp.async`` ring.  The node path's
  4096^3 runs here.
- ``"general"``: everything else (a row that is not a multiple of 16
  bytes, a pointer off a 16-byte boundary, K = 0), either dtype: the first
  design, 128 x 128 tiles, K in steps of 8, float32 FMAs.

``launches`` counts every launch; ``path_launches[path]`` those of one
path.

The plain version walks the output tiles (``TILES[path]``) of the kernel
that :func:`matmul_path` picks for the same operands, with a float32
accumulator over K in slices of ``BK_PLAIN`` (the TPU kernel's block; the
kernels step through each slice 64, 32 or 8 at a time), the ragged edge
tiles cut short.  Its tile products are ``torch.matmul``: it is the CPU
path and the kernels' yardstick of correctness on the card, not of speed,
and nothing on the card's path calls it.
"""
from __future__ import annotations

import ctypes

import torch

from .common import LaunchCounter, refuse_grad

PATHS = ("wgmma", "fma_pipelined", "general")
# each path's output tile (BM x BN in csrc/matmul.cu: wg::, pf:: and the
# general kernel's)
TILES = {"wgmma": (128, 256), "fma_pipelined": (128, 256),
         "general": (128, 128)}
BK_PLAIN = 128      # K slice of the plain version (matmul_pallas's bk)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()
path_launches = {path: LaunchCounter() for path in PATHS}


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes a [M,K] and b [K,N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"matmul takes two float32 or two bfloat16 "
                         f"matrices; got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")


def matmul_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that takes ``a @ b`` for these contiguous operands: one
    of :data:`PATHS` (the module doc says which inputs go where)."""
    _check(a, b)
    k, n = a.shape[1], b.shape[1]
    per_16_bytes = 16 // a.element_size()
    if (k == 0 or k % per_16_bytes or n % per_16_bytes
            or a.data_ptr() % 16 or b.data_ptr() % 16):
        return "general"
    return "wgmma" if a.dtype == torch.bfloat16 else "fma_pipelined"


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
        for fast in (lib.repro_matmul_wgmma_bf16,
                     lib.repro_matmul_f32_pipelined):
            fast.restype = ctypes.c_int
            fast.argtypes = [p, p, p, i, i, i, p]
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (m, k), n = a.shape, b.shape[1]
    bm = TILES["general"][0]      # every path's BM
    if max(m, n, k) >= 2 ** 31 or -(-m // bm) > 65535:
        raise ValueError(f"matmul kernel takes M <= {65535 * bm} and N, K "
                         f"< 2**31; got M={m}, N={n}, K={k}")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    path = matmul_path(a, b)
    lib = _lib()
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr())
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if path == "wgmma":
            err = lib.repro_matmul_wgmma_bf16(*args, m, n, k, stream)
        elif path == "fma_pipelined":
            err = lib.repro_matmul_f32_pipelined(*args, m, n, k, stream)
        else:
            err = lib.repro_matmul(*args, _DTYPE_CODE[a.dtype], m, n, k,
                                   stream)
    if err:
        raise RuntimeError(f"matmul kernel ({path}) launch failed: CUDA "
                           f"error {err}")
    launches.add()
    path_launches[path].add()
    return c


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tile walk of the kernel that :func:`matmul_path` picks, in
    torch, with a float32 accumulator."""
    _check(a, b)
    (m, k), n = a.shape, b.shape[1]
    bm, bn = TILES[matmul_path(a.contiguous(), b.contiguous())]
    af, bf = a.float(), b.float()
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    for i in range(0, m, bm):
        for j in range(0, n, bn):
            acc = torch.zeros((min(bm, m - i), min(bn, n - j)),
                              device=a.device)
            for l in range(0, k, BK_PLAIN):
                acc += af[i:i + bm, l:l + BK_PLAIN] @ bf[l:l + BK_PLAIN,
                                                         j:j + bn]
            c[i:i + bm, j:j + bn] = acc
    return c
