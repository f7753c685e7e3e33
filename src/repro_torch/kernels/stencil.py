"""5-point Jacobi step (the paper's cache-intensive node, the body of the
Heat app): the CUDA kernel's wrapper, its plain version and its launch
counter.

Port of ``repro/kernels/stencil.py`` (``stencil_pallas``).  Same function:
u ``[B, H, W]``, ``out = 0.25 * (up + down + left + right)`` with a zero
(Dirichlet) boundary, in u's dtype.  The sum is taken in float32 and
rounded once; the reference sums bfloat16 in bfloat16, so the two may
differ in the last bit of a bfloat16 output.

:func:`stencil` launches ``csrc/stencil.cu`` for a CUDA tensor (float32 or
bfloat16, rank 3, any H and W; an empty tensor launches nothing) or raises;
it takes :func:`stencil_plain` only for a tensor on the CPU.  The kernel has
no backward; on the card it refuses inputs that require grad under grad
mode.

The plain version walks the kernel's tiles (``TH`` rows by ``TW`` columns)
in torch: each tile reads its one-cell halo from the zero-padded grid and
sums its neighbours in float32 in the kernel's order.  It is the CPU path
and the kernel's yardstick of correctness on the card, not of speed.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .common import LaunchCounter, refuse_grad

TH, TW = 32, 64     # rows and columns of a tile (TH, TW in csrc/stencil.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()


def _check(u: torch.Tensor) -> None:
    if u.ndim != 3:
        raise ValueError(f"stencil takes u [B,H,W]; got {tuple(u.shape)}")
    if u.dtype not in _DTYPE_CODE:
        raise ValueError(f"stencil takes float32 or bfloat16, not {u.dtype}")


def stencil(u: torch.Tensor) -> torch.Tensor:
    _check(u)
    if u.device.type == "cpu":
        return stencil_plain(u)
    if u.device.type != "cuda":
        raise ValueError(f"no stencil kernel for device {u.device}")
    refuse_grad("stencil", u)
    return _launch(u)


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("stencil")
    fn = lib.repro_stencil
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p]
    return lib


def _launch(u: torch.Tensor) -> torch.Tensor:
    b, h, w = u.shape
    if b > 65535 or -(-h // TH) > 65535:
        raise ValueError(f"stencil kernel takes B <= 65535 and H <= "
                         f"{65535 * TH}; got {tuple(u.shape)}")
    u = u.contiguous()
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.repro_stencil(u.data_ptr(), out.data_ptr(),
                                _DTYPE_CODE[u.dtype], b, h, w, stream)
    if err:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {err}")
    launches.add()
    return out


def stencil_plain(u: torch.Tensor) -> torch.Tensor:
    """The kernel's tile walk in torch, summing in float32."""
    _check(u)
    _, h, w = u.shape
    padded = F.pad(u.float(), (1, 1, 1, 1))     # the halo is zero outside
    out = torch.empty_like(u)
    for i0 in range(0, h, TH):
        i1 = min(i0 + TH, h)
        for j0 in range(0, w, TW):
            j1 = min(j0 + TW, w)
            s = padded[:, i0:i1 + 2, j0:j1 + 2]
            out[:, i0:i1, j0:j1] = 0.25 * (s[:, :-2, 1:-1] + s[:, 2:, 1:-1]
                                           + s[:, 1:-1, :-2] + s[:, 1:-1, 2:])
    return out
