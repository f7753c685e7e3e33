"""Causal GQA flash attention: the CUDA kernel's wrapper, its plain version
and its launch counter.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``).
Same semantics: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, T, D]``; query head h
reads KV head ``h // (Hq // Hkv)``; the causal mask aligns the ends of the
windows (key j is live for row i when ``j <= i + T - S``); float32 online
softmax; output in q's dtype.

:func:`flash_attention` launches a kernel of ``csrc/flash_attention.cu``
for a CUDA tensor (float32 or bfloat16, D in 32/64/80/128, any S and T) or
raises; it takes :func:`flash_attention_plain` only for a tensor on the
CPU.  Which kernel is :func:`flash_path`, a plain function of the dtype and
the alignment of the contiguous inputs:

- ``"wgmma"``: bfloat16 with q, k and v on 16-byte boundaries.  Tensor
  cores: TMA loads of q and a 2-stage K/V ring by a producer warp, S = QK^T
  and O += PV by wgmma, the softmax on the accumulator in registers, P
  rounded to bfloat16 for the PV product (the reference keeps P in
  float32: at most 2^-9 of |v| a key, inside the bfloat16 tolerance).  At
  D = 80 a tile is a 64-column box and a 16-column one, PV an n64 and an
  n16 product, the ring 3 stages, and the next tile's S is computed while
  this tile's softmax runs.
- ``"tf32x3"``: float32 with q, k and v on 16-byte boundaries.  Tensor
  cores in 3xTF32 (``mma.sync``; each operand split into a TF32 high and
  low part, three products summed in float32, which keeps float32's
  accuracy): K and V by 16-byte ``cp.async``, the next tile's loading
  while this one is computed, the softmax and P in registers, the
  heaviest causal q tiles first.
- ``"fma"``: float32 or bfloat16 off a 16-byte boundary: float32 FMAs on
  the CUDA cores.

``launches`` counts every launch; ``path_launches[path]`` those of one
path.  The plain version walks the kernels' tile schedule
in torch: the same 64-row q tiles and 64-key KV tiles, the same skip of KV
tiles past the causal diagonal, the same online-softmax rescale.  It is
the CPU path and the kernels' yardstick of correctness on the card, not
of speed.

The gradient.  :func:`flash_attention` goes through :class:`FlashAttention`,
a ``torch.autograd.Function`` that saves q, k, v and the output.  Its
backward launches ``csrc/flash_attention_bwd.cu`` for CUDA tensors (float32
or bfloat16, D in 32/64/80/128, any S and T; one C call, one count in
``bwd_launches``, and in ``bwd_path_launches`` of its path).  Which kernels
is :func:`flash_bwd_path`, a plain function of the dtype and the alignment
of q, k, v, o and dO:

- ``"wgmma"``: bfloat16 with all five on 16-byte boundaries.  Tensor
  cores, two kernels of a producer warp and a consumer warpgroup, as the
  forward's: dQ per 64-row q tile (a first pass over its live 64-key
  tiles for each row's log-sum-exp, and ``rowsum(dO * O)``, then dQ), and
  dK and dV per 64-key tile over the group's q heads and their live
  64-row q tiles; tiles by TMA through 2-stage rings, the products by
  wgmma, P and dS in registers, rounded to bfloat16 for the products that
  take them (at most 2^-9 of a term, inside the bfloat16 tolerance).  At
  D = 80 the tiles are the forward's two boxes, and the dK/dV kernel has
  no producer warp (its consumers load a 3-stage ring themselves), so
  that two blocks an SM keep dK, dV, S^T and dP^T in registers.
- ``"tf32x3"``: float32 with all five on 16-byte boundaries.  Tensor cores
  in 3xTF32 (``mma.sync``), the same two kernels with 32-key tiles in dQ
  and 16-row q steps in dK/dV; Q, dO or K, V through ``cp.async`` rings,
  P and dS in registers.
- ``"fma"``: either dtype with any of the five off a 16-byte boundary:
  three kernels on float32 FMAs (a pre-pass for the log-sum-exp and
  ``rowsum(dO * O)``, then dK and dV per 64-key tile over 64-row q tiles,
  then dQ per q tile over 64-key tiles).

Each path keeps every gradient element to one block and one order of summation
(no atomics), so a result repeats bit for bit.  On the CPU the backward
takes :func:`flash_attention_bwd_plain`, which walks the loops of the
kernels that would take the inputs (``BWD_SCHEDULE``).  The TPU kernel has
no backward; this one computes what the JAX package's autodiff of
``attention_ref`` computes.  Under ``torch.no_grad()`` or
``torch.inference_mode()`` the forward launches as it always did.

On the meta device (a dry-run's abstract step) the forward and the
backward compute nothing: they return tensors of the outputs' shapes and
dtypes and report the work a launch would do (``work.attention_work``,
``work.attention_bwd_work``, the flops and bytes ``chip_smoke.py`` prices
in the bound) through ``work.report``.  Any device but the CPU, CUDA and
meta raises.

On DTensors (a step run on a device mesh, as the dry-run runs it) the
forward and the backward run on each device's shard, as on one device,
by the sharding rule of ``_sharded`` (batch over the data axes, heads over
"model" where they divide; the K/V heads that a shard's query heads read).
"""
from __future__ import annotations

import ctypes

import torch

from ..parallel import sharding
from . import work
from .common import LaunchCounter

BQ = 64     # query rows per tile (BQ, x3::BQ, fa::BQ in the .cu)
BK = 64     # keys per tile (BK, x3::BKV, fa::BKV)
HEAD_DIMS = (32, 64, 80, 128)
PATHS = ("wgmma", "tf32x3", "fma")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

BWD_PATHS = ("wgmma", "tf32x3", "fma")
# The backward kernels' tile schedules, which the plain version walks: the
# log-sum-exp pass (q rows a tile, keys a tile), dK/dV (keys a block, q rows
# a step) and dQ (q rows a tile, keys a tile); tf32x3's x3::BQ, BKQ, BKV,
# BQS, and one schedule of 64-row tiles for wgmma's fb::BQ, BKV and the
# FMA kernels' BQ, BK in csrc/flash_attention_bwd.cu
_TILES_64 = {"lse": (64, 64), "dkdv": (64, 64), "dq": (64, 64)}
BWD_SCHEDULE = {"wgmma": _TILES_64,
                "tf32x3": {"lse": (64, 32), "dkdv": (64, 16), "dq": (64, 32)},
                "fma": _TILES_64}
BWD_PAD = 64   # the tensor-core paths' LSE and Delta scratch: S rounded up

launches = LaunchCounter()
path_launches = {path: LaunchCounter() for path in PATHS}
bwd_launches = LaunchCounter()
bwd_path_launches = {path: LaunchCounter() for path in BWD_PATHS}


def flash_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these contiguous inputs: one of
    :data:`PATHS` (the module doc says which inputs go where)."""
    return _path(q.dtype, (q.data_ptr(), k.data_ptr(), v.data_ptr()))


def _path(dtype: torch.dtype, ptrs: tuple[int, ...]) -> str:
    if any(p % 16 for p in ptrs):
        return "fma"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def flash_bwd_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor) -> str:
    """The backward kernels that take these contiguous inputs: one of
    :data:`BWD_PATHS` (the module doc says which inputs go where)."""
    return _path(q.dtype, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), do.data_ptr()))


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
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if sharding.is_distributed(q, k, v):
        return _sharded(q, k, v, causal, scale)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no flash attention for device {q.device}")
    return FlashAttention.apply(q, k, v, causal, scale)


def _sharded(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """The sharding rule of attention on DTensors: the kernels (forward and
    backward) run on each device's shard.  Batch over the data axes where
    they divide it; query heads over "model" where it divides them, and
    K/V heads with them where it divides those too.  Where it divides the
    query heads but not the K/V heads (granite-8b's 8 on 16), K/V stay
    whole on every device, each shard reads the K/V heads its query heads
    map to (``h // group``, not its first ones), and their gradients are
    partial sums over "model".  Where a shard's heads would straddle
    groups unevenly, or "model" divides no heads, the heads stay whole."""
    from torch.distributed.tensor import Partial
    mesh = q.device_mesh
    b, hq = q.shape[:2]
    hkv = k.shape[1]
    group = hq // hkv
    m = sharding.model_size(mesh)
    n = hq // m
    heads = m > 1 and hq % m == 0 and (n % group == 0 or group % n == 0)
    kv_heads = heads and hkv % m == 0
    dims = dict.fromkeys(sharding.batch_axes(mesh, b), 0)
    qp = sharding.placements(mesh, {**dims, "model": 1 if heads else None})
    kvp = sharding.placements(mesh, {**dims,
                                     "model": 1 if kv_heads else None})
    kvg = kvp
    if heads and not kv_heads:
        kvg = tuple(Partial() if name == "model" else p
                    for name, p in zip(mesh.mesh_dim_names, kvp))
    coord = sharding.model_coordinate(mesh)

    def local(ql, kl, vl):
        if heads and not kv_heads:      # the K/V heads of this shard's
            lo = coord * n // group     # query heads
            hi = ((coord + 1) * n - 1) // group + 1
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        return flash_attention(ql, kl, vl, causal=causal, scale=scale)

    return sharding.on_shards(local, mesh, (q, k, v), (qp, kvp, kvp), qp,
                              (qp, kvg, kvg))


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' forward and backward on the card and
    their plain versions on the CPU (the module doc says which)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            o = flash_attention_plain(q, k, v, causal=causal, scale=scale)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            o = (_meta(q, k, v, causal) if q.device.type == "meta"
                 else _launch(q, k, v, causal, scale))
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                    scale=ctx.scale)
        return (*grads, None, None)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None
                        ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of attention from q, k, v, its output ``o`` and the
    output's gradient ``do``: the backward kernel for CUDA tensors, its
    plain version for CPU ones."""
    _check(q, k, v, causal)
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash attention backward for device "
                         f"{q.device}")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    if q.device.type == "meta":
        return _meta_bwd(q, k, v, causal)
    return _launch_bwd(q, k, v, o, do, causal, scale)


_ENTRY = {"wgmma": "repro_flash_attention_wgmma",
          "tf32x3": "repro_flash_attention_tf32x3",
          "fma": "repro_flash_attention"}
_fns: dict = {}


def _fn(path: str):
    """The C entry point of ``path``, typed on first use and then cached
    (the wrapper's host time counts beside a kernel of a few microseconds)."""
    fn = _fns.get(path)
    if fn is None:
        from .build import load
        fn = getattr(load("flash_attention"), _ENTRY[path])
        p, i = ctypes.c_void_p, ctypes.c_int
        dtype = [i] if path == "fma" else []
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, *dtype, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        _fns[path] = fn
    return fn


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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    path = _path(q.dtype, ptrs)
    args = (*ptrs, o.data_ptr(),
            *([_DTYPE_CODE[q.dtype]] if path == "fma" else []), b, hq, hkv,
            s, t, d, int(causal), float(scale))
    fn = _fn(path)
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel ({path}) launch failed: "
                           f"CUDA error {err}")
    launches.add()
    path_launches[path].add()
    return o


def _meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool) -> torch.Tensor:
    """The forward on the meta device: the output's shape and dtype, and
    the kernel's work reported (``work.report``) in place of a launch."""
    b, hq, s, d = q.shape
    flops, nbytes = work.attention_work(b, hq, k.shape[1], s, k.shape[2], d,
                                        q.dtype, causal)
    # the kind of unit of the aligned path's products: wgmma or tf32x3
    unit = "bfloat16" if q.dtype == torch.bfloat16 else "3xtf32"
    work.report("flash_attention", {unit: flops}, nbytes)
    return torch.empty_like(q)


def _meta_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> tuple[torch.Tensor, ...]:
    """The backward on the meta device: (dq, dk, dv) and, while the call
    lasts, the log-sum-exp and Delta scratch the kernels allocate; the
    work reported in place of a launch at the unit of the aligned path's
    products (float32 on ``tf32x3``, bfloat16 on ``wgmma``)."""
    b, hq, s, d = q.shape
    flops, nbytes = work.attention_bwd_work(b, hq, k.shape[1], s, k.shape[2],
                                            d, q.dtype, causal)
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = -(-s // BWD_PAD) * BWD_PAD
    scratch = torch.empty((2, b, hq, rows), dtype=torch.float32,
                          device=q.device)
    unit = "bfloat16" if q.dtype == torch.bfloat16 else "3xtf32"
    work.report("flash_attention_bwd", {unit: flops}, nbytes)
    del scratch
    return grads


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


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, do: torch.Tensor, causal: bool,
                scale: float) -> tuple[torch.Tensor, ...]:
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or d not in HEAD_DIMS or not s * t * b:
        raise ValueError(f"flash attention backward kernel takes float32 or "
                         f"bfloat16, D in {HEAD_DIMS} and non-empty inputs; "
                         f"got {q.dtype}, {tuple(q.shape)}, {tuple(k.shape)}")
    for name, x in (("output", o), ("output gradient", do)):
        if (x.shape != q.shape or x.dtype != q.dtype
                or x.device != q.device):
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} on "
                             f"{x.device} does not fit q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    path = flash_bwd_path(q, k, v, o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = s if path == "fma" else -(-s // BWD_PAD) * BWD_PAD
    lse = torch.empty((b, hq, rows), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *([_DTYPE_CODE[q.dtype]] if path == "fma" else []), b, hq, hkv,
            s, t, d, int(causal), float(scale))
    with torch.cuda.device(q.device):
        err = _bwd_entry(path)(*args,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash attention backward kernel ({path}) launch "
                           f"failed: CUDA error {err}")
    bwd_launches.add()
    bwd_path_launches[path].add()
    return dq, dk, dv


_BWD_ENTRY = {"wgmma": "repro_flash_attention_bwd_wgmma",
              "tf32x3": "repro_flash_attention_bwd_tf32x3",
              "fma": "repro_flash_attention_bwd"}


def _bwd_entry(path: str):
    """The C entry point of the backward's ``path``, typed on first use and
    then cached."""
    fn = _fns.get(("bwd", path))
    if fn is None:
        from .build import load
        fn = getattr(load("flash_attention_bwd"), _BWD_ENTRY[path])
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = ([p] * 10 + [i] * (8 if path == "fma" else 7)
                       + [ctypes.c_float, p])
        _fns[("bwd", path)] = fn
    return fn


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              scale: float | None = None,
                              schedule: str | None = None
                              ) -> tuple[torch.Tensor, ...]:
    """The backward kernels' arithmetic in torch, tile by tile, in float32:
    (dq, dk, dv) in the inputs' dtype from q, k, v, the forward's output o
    and its gradient do.  It walks the tiles of the path ``schedule`` (one
    of :data:`BWD_PATHS`; by default the path that would take these inputs,
    :func:`flash_bwd_path`), by ``BWD_SCHEDULE``: each q tile's log-sum-exp
    by the online max and sum over its live key tiles; dK and dV per key
    block, over the group's q heads and then the q steps that see it; dQ
    per q tile over its live key tiles."""
    _check(q, k, v, causal)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    tiles = BWD_SCHEDULE[schedule or flash_bwd_path(q, k, v, o, do)]
    qf = q.float().reshape(b, hkv, g, s, d)
    of = o.float().reshape(b, hkv, g, s, d)
    dof = do.float().reshape(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    offset = t - s
    neg_inf = float("-inf")

    def live_tiles(q1: int, bk: int) -> int:
        n_all = -(-t // bk)
        return min(n_all, (q1 - 1 + offset) // bk + 1) if causal else n_all

    def scores(qi, q0, q1, k0, k1):
        sc = qi @ kf[:, :, None, k0:k1].transpose(-1, -2) * scale
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)[:, None] + offset
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, neg_inf)
        return sc

    # 1. log-sum-exp (-inf for a row with no live key) and
    # delta = rowsum(dO * O)
    bq, bk = tiles["lse"]
    lse = torch.empty((b, hkv, g, s), device=q.device)
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        m = torch.full((b, hkv, g, q1 - q0), neg_inf, device=q.device)
        l = torch.zeros_like(m)
        for j in range(live_tiles(q1, bk)):
            sc = scores(qf[..., q0:q1, :], q0, q1, j * bk,
                        min(j * bk + bk, t))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_use = m_new.masked_fill(m_new == neg_inf, 0.0)
            l = torch.exp(m - m_use) * l + torch.exp(
                sc - m_use[..., None]).sum(dim=-1)
            m = m_new
        lse[..., q0:q1] = torch.where(l > 0, m + torch.log(l),
                                      torch.full_like(l, neg_inf))
    delta = (dof * of).sum(dim=-1)
    lse_use = lse.masked_fill(lse == neg_inf, float("inf"))   # p = 0

    def p_ds(heads: slice, q0, q1, k0, k1):
        """P and dS of one tile, for the q heads ``heads`` of each group."""
        sc = scores(qf[:, :, heads, q0:q1], q0, q1, k0, k1)
        p = torch.exp(sc - lse_use[:, :, heads, q0:q1, None])
        dp = dof[:, :, heads, q0:q1] @ vf[:, :, None, k0:k1].transpose(-1, -2)
        return p, p * (dp - delta[:, :, heads, q0:q1, None])

    # 2. dK and dV: per key block, over the group's q heads, then the q
    # steps that see the block
    bk, bq = tiles["dkdv"]
    dk = torch.zeros((b, hkv, t, d), device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, t, bk):
        k1 = min(k0 + bk, t)
        first = max(0, k0 - offset) // bq * bq if causal else 0
        for gi in range(g):
            for q0 in range(first, s, bq):
                q1 = min(q0 + bq, s)
                p, ds = p_ds(slice(gi, gi + 1), q0, q1, k0, k1)
                dv[:, :, k0:k1] += (p.transpose(-1, -2)
                                    @ dof[:, :, gi:gi + 1, q0:q1])[:, :, 0]
                dk[:, :, k0:k1] += (ds.transpose(-1, -2)
                                    @ qf[:, :, gi:gi + 1, q0:q1])[:, :, 0]
    dk *= scale

    # 3. dQ: per q tile, over its live key tiles
    bq, bk = tiles["dq"]
    dq = torch.zeros_like(qf)
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        for j in range(live_tiles(q1, bk)):
            k0, k1 = j * bk, min(j * bk + bk, t)
            _, ds = p_ds(slice(None), q0, q1, k0, k1)
            dq[..., q0:q1, :] += ds @ kf[:, :, None, k0:k1]
    dq *= scale
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
