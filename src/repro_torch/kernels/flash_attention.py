"""Causal GQA flash attention: the CUDA kernel's wrapper, its plain version
and its launch counter.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``).
Same semantics: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, T, D]``; query head h
reads KV head ``h // (Hq // Hkv)``; the causal mask aligns the ends of the
windows (key j is live for row i when ``j <= i + T - S``); float32 online
softmax; output in q's dtype.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for a CUDA
tensor (float32 or bfloat16, D in 32/64/128, any S and T) or raises; it
takes :func:`flash_attention_plain` only for a tensor on the CPU.  The plain
version walks the kernel's tile schedule in torch: the same 64x64 tiles,
the same skip of KV tiles past the causal diagonal, the same online-softmax
rescale.  It is the CPU path and the kernel's yardstick of correctness on
the card, not of speed.
"""
from __future__ import annotations

import ctypes
import threading

import torch

BQ = 64     # query rows per tile (BQ in csrc/flash_attention.cu)
BK = 64     # keys per tile (BK in csrc/flash_attention.cu)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Kernel launches, counted under a lock: the serving engine launches
    from several worker threads at once."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


launches = LaunchCounter()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,S,D] and k, v [B,Hkv,T,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if causal and k.shape[2] < s:
        raise ValueError(f"causal attention needs T >= S; got S={s}, "
                         f"T={k.shape[2]}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, causal, q.shape[3] ** -0.5 if scale is None
                   else scale)


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes D in {HEAD_DIMS}, "
                         f"not {d}")
    if s == 0 or t == 0 or b == 0:
        raise ValueError("flash attention kernel needs non-empty inputs")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODE[q.dtype], b, hq, hkv, s, t, d, int(causal),
            float(scale), stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{err}")
    launches.add()
    return o


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's arithmetic in torch, tile by tile, in float32."""
    _check(q, k, v, causal)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    # group the query heads by KV head instead of repeating K/V
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(qf)
    offset = t - s
    n_all = -(-t // BK)
    for q0 in range(0, s, BQ):
        q1 = min(q0 + BQ, s)
        qi = qf[:, :, :, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device)[:, None] + offset
        n_kv = min(n_all, (q1 - 1 + offset) // BK + 1) if causal else n_all
        m = torch.full(qi.shape[:-1], float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qi)
        for j in range(n_kv):
            k0, k1 = j * BK, min(j * BK + BK, t)
            sc = torch.einsum("bhgsd,bhtd->bhgst", qi, kf[:, :, k0:k1]) * scale
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                sc = sc.masked_fill(kpos > qpos, float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_use = m_new.masked_fill(m_new == float("-inf"), 0.0)
            alpha = torch.exp(m - m_use)
            p = torch.exp(sc - m_use[..., None])
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc + p @ vf[:, :, None, k0:k1]
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)
