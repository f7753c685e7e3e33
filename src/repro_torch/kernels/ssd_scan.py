"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper, its plain version
and its launch counter.

Port of ``repro/kernels/ssd_scan.py`` (``ssd_scan_pallas``).  Same
function: x ``[B, S, H, D]``, log-decay a ``[B, S, H]`` (a <= 0), b and c
``[B, S, N]`` shared across the H heads; y ``[B, S, H, D]`` in x's dtype with

    h_t = exp(a_t) h_{t-1} + x_t (x) b_t,   y_t = h_t c_t

and the state h ``[D, N]`` of each (batch, head) in float32, zero at the
start.  Per chunk of ``CHUNK`` tokens, with Acum the cumulative sum of a
from the chunk's start:

    y  = tril(exp(Acum_t - Acum_u) * (C_t . B_u)) @ x + exp(Acum_t) * (C_t . h)
    h <- exp(A_tot) h + (x * exp(A_tot - Acum))^T @ B

:func:`ssd_scan` launches ``csrc/ssd_scan.cu`` for a CUDA tensor (all four
inputs float32 or all bfloat16, any S and D, and N up to what a block's
shared memory holds) or raises;
it takes :func:`ssd_scan_plain` only for a tensor on the CPU.  The kernel
reads the ``[B, S, H, D]`` layout with its own offsets: the wrapper makes the
inputs contiguous and transposes nothing (the TPU wrapper moved H before S).
It has no backward, and refuses inputs that require grad under grad mode.

The plain version walks the kernel's schedule in torch: the same chunk
length, the same chunk-relative cumulative sum, the same select of the
causal triangle before the exponential (above the diagonal
exp(Acum_t - Acum_u) overflows), the same carried float32 state; a ragged
last chunk is the kernel's zero-padded one.  It is the CPU path and the
kernel's yardstick of correctness on the card, not of speed.
"""
from __future__ import annotations

import ctypes

import torch

from .common import LaunchCounter, refuse_grad

CHUNK = 64     # tokens per chunk (L in csrc/ssd_scan.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_STATE_TOO_WIDE = -1   # kStateTooWide in csrc/ssd_scan.cu

launches = LaunchCounter()


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor) -> None:
    if x.ndim != 4 or a.ndim != 3 or b.ndim != 3 or b.shape != c.shape:
        raise ValueError(f"want x [B,S,H,D], a [B,S,H], b, c [B,S,N]; got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if tuple(a.shape) != tuple(x.shape[:3]) or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"x {tuple(x.shape)} does not fit a "
                         f"{tuple(a.shape)} and b {tuple(b.shape)}")
    if not (x.dtype == a.dtype == b.dtype == c.dtype):
        raise ValueError(f"mixed dtypes {x.dtype}, {a.dtype}, {b.dtype}, "
                         f"{c.dtype}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError("x, a, b and c must lie on one device")


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    _check(x, a, b, c)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan for device {x.device}")
    refuse_grad("ssd_scan", x, a, b, c)
    return _launch(x, a, b, c)


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    return lib


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    bsz, s, h, d = x.shape
    n = b.shape[2]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"SSD scan kernel takes float32 or bfloat16, not "
                         f"{x.dtype}")
    if min(bsz, s, h, d, n) == 0:
        raise ValueError(f"SSD scan kernel needs non-empty inputs; got x "
                         f"{tuple(x.shape)}, N={n}")
    if bsz > 65535 or h > 65535:
        raise ValueError(f"SSD scan kernel takes B and H <= 65535; got "
                         f"{bsz}, {h}")
    x, a, b, c = (t.contiguous() for t in (x, a, b, c))
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[x.dtype], bsz, s, h, d, n, stream)
    if err == _STATE_TOO_WIDE:
        raise ValueError(f"SSD scan kernel: a block's rows of the [D, N] "
                         f"state do not fit in shared memory at N = {n}")
    if err:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error {err}")
    launches.add()
    return y


def ssd_scan_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch, chunk by chunk, in float32."""
    _check(x, a, b, c)
    bsz, s, h, d = x.shape
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    state = torch.zeros((bsz, h, d, b.shape[2]), device=x.device)
    ys = []
    for t0 in range(0, s, CHUNK):
        t1 = min(t0 + CHUNK, s)
        xc, bc, cc = xf[:, t0:t1], bf[:, t0:t1], cf[:, t0:t1]
        acum = torch.cumsum(af[:, t0:t1], dim=1)                # [B,L,H]
        a_tot = acum[:, -1]                                     # [B,H]
        live = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool,
                          device=x.device).tril()[None, :, :, None]
        diff = acum[:, :, None, :] - acum[:, None, :, :]        # [B,t,u,H]
        decay = torch.exp(torch.where(live, diff, float("-inf")))
        g = torch.einsum("btn,bun->btu", cc, bc)[..., None] * decay
        y = torch.einsum("btuh,buhd->bthd", g, xc)
        y = y + torch.exp(acum)[..., None] * torch.einsum(
            "btn,bhdn->bthd", cc, state)
        ys.append(y)
        w = torch.exp(a_tot[:, None] - acum)                    # [B,L,H]
        state = torch.exp(a_tot)[..., None, None] * state + torch.einsum(
            "buhd,buh,bun->bhdn", xc, w, bc)
    return torch.cat(ys, dim=1).to(x.dtype)
