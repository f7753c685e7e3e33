"""The sLSTM recurrence: the CUDA kernels' wrapper (forward and backward),
their plain versions and their launch counters.

Replaces no TPU kernel.  The JAX package runs sLSTM as one
``jax.lax.scan`` of its ``_slstm_cell`` (``repro/models/xlstm.py:176``)
and differentiates it by autodiff; here the scan is ``csrc/slstm_scan.cu``
and its reverse ``csrc/slstm_scan_bwd.cu``.  The function: the input half
of the gate pre-activations gx ``[B, S, 4, d]`` (gates i, f, z, o), the
recurrent weights r ``[4, d]`` (one a unit and gate) and a carry (h, c, n,
m) of four ``[B, d]``; per step (:func:`slstm_cell`)

    pre = gx_t + r h,  m' = max(pre_f + m, pre_i),
    i = exp(pre_i - m'),  f = exp(pre_f + m - m'),
    c' = f c + i tanh(pre_z),  n' = f n + i,
    h' = sigmoid(pre_o) c' / max(|n'|, 1)

in float32, the new carry rounded to the inputs' dtype (the reference
keeps its carry in x's dtype).  Out: hs ``[B, S, d]`` (every step's h)
and the last carry.  Each (batch row, unit) is an independent scalar
recurrence over t, since r is per unit.

:func:`slstm_scan` launches the forward kernel for CUDA tensors (float32
or bfloat16, contiguous, non-empty) or raises, and takes
:func:`slstm_scan_plain`, the per-token loop, only for tensors on the CPU.
A padded prefill (the serving engine's graph of a length bucket runs S
past the prompt) passes ``lengths`` ``[B]`` (int32, on gx's device): row
b's steps from ``lengths[b]`` on hold the carry as it was, so the last
carry is the one after step ``lengths[b] - 1`` (bit for bit the unpadded
run's) and hs holds that step's h from there on.  It is a forward without
a gradient: the padded prefill runs under inference mode.
When grad mode is on and an input requires grad it goes through
:class:`SLSTMScan`, whose forward also keeps the carry (c, n, m) after
every step, ``[B, S, 3, d]`` in the inputs' dtype, and whose backward
launches the backward kernel (one count in ``bwd_launches``) for CUDA
tensors and takes :func:`slstm_scan_bwd_plain` for CPU ones: the kernel's
reverse recurrence, step by step in torch and in float64.  The backward
gives dgx, dr (the kernel's per-row float32 parts summed over B here) and
the initial carry's gradient.  Where the forward has a tie, at ``max(pre_f + m,
pre_i)`` or at ``max(|n'|, 1)``, each side takes half the gradient, as
JAX's ``lax.max`` rule gives (``torch.clamp`` would give it all to n');
the kernel's source note says where the tie occurs and what it reaches.

Both kernels keep the chain on one warp and the loads, stores and
(backward) every step's coefficients on others; their source notes give
the design.  Their 16-byte copies need a row of d elements to be a whole
number of 16 bytes (d % 4 == 0 in float32, d % 8 == 0 in bfloat16; every
model's d): for another d the wrapper pads every input with zero units up
to :func:`padded_width` and slices the outputs back.  The units are
independent and a zero unit stays finite (its gradient zero), so the
padding changes no value of the others.  The copies also need the copied
tensors on a 16-byte boundary: a contiguous input that lies off one (a
view at an odd offset) is copied to a fresh tensor first.  A failed build
or launch raises.  :func:`slstm_scan_bwd_linear` is the backward as the
kernel computes it, in torch: every step's coefficients at once, then the
linear chain, then the gate gradients.

On the meta device (a dry-run's abstract step) the forward and the
backward compute nothing: they return tensors of the shapes and dtypes the
kernels give (the kept carry too) and report the work a launch would do
(``work.slstm_work``, ``work.slstm_bwd_work``) through ``work.report``.
Any device but the CPU, CUDA and meta raises.

On DTensors (a step run on a device mesh, as the dry-run runs it) the
forward and the backward run on each device's shard, as on one device,
by the sharding rule of ``_sharded``: the units are independent, so a
shard of d runs its own with no exchange.

This module imports nothing of ``repro_torch.models``: the model's
``xlstm.slstm_block`` and ``slstm_decode`` call it, and its
``_slstm_cell`` is :func:`slstm_cell`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..parallel import sharding
from . import work
from .common import LaunchCounter

_DEVICES = ("cpu", "cuda", "meta")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CARRY = ("h", "c", "n", "m")

launches = LaunchCounter()
bwd_launches = LaunchCounter()


def padded_width(d: int, dtype: torch.dtype) -> int:
    """The width the kernels run d units of ``dtype`` (float32 or
    bfloat16) at: d rounded up to a whole number of 16 bytes."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"no sLSTM kernel for {dtype}")
    per = 16 // dtype.itemsize
    return -(-d // per) * per


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last dim padded with zeros to ``width``."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy when it lies off a 16-byte boundary."""
    return t.clone() if t.data_ptr() % 16 else t


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a step is computed in: float32, or float64 for float64
    inputs (the CPU's gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


class Step(NamedTuple):
    """One step's values, as ``csrc/slstm_cell.cuh``'s ``slstm::Step``:
    pre_i, fm = pre_f + m, the stabilizer m', the gates ig, fg, z, o, and
    c', n', den = max(|n'|, 1) and h'."""
    pre_i: torch.Tensor
    fm: torch.Tensor
    m: torch.Tensor
    ig: torch.Tensor
    fg: torch.Tensor
    z: torch.Tensor
    o: torch.Tensor
    c: torch.Tensor
    n: torch.Tensor
    den: torch.Tensor
    h: torch.Tensor


def _step(gx: torch.Tensor, r: torch.Tensor, carry: tuple) -> Step:
    """One step's values in float32 (float64 for float64 inputs) from
    ``gx`` ``[B, 4, d]``, ``r`` ``[4, d]`` and the carry (h, c, n, m) it
    starts from, each ``[B, d]``: the forward's step, which the plain
    backward computes again."""
    wide = _wide(gx.dtype)
    h, c, n, m = (t.to(wide) for t in carry)
    pre_i, pre_f, pre_z, pre_o = (gx.to(wide) + r.to(wide)
                                  * h[:, None, :]).unbind(-2)
    fm = pre_f + m
    m_new = torch.maximum(fm, pre_i)                      # stabilizer
    ig = torch.exp(pre_i - m_new)
    fg = torch.exp(fm - m_new)
    z, o = torch.tanh(pre_z), torch.sigmoid(pre_o)
    c_new = fg * c + ig * z
    n_new = fg * n + ig
    den = torch.clamp(n_new.abs(), min=1.0)
    return Step(pre_i, fm, m_new, ig, fg, z, o, c_new, n_new, den,
                o * c_new / den)


def slstm_cell(gx: torch.Tensor, r: torch.Tensor, carry: tuple) -> tuple:
    """One step: ``gx`` ``[B, 4, d]``, ``r`` ``[4, d]`` and the carry (h,
    c, n, m), each ``[B, d]`` -> the next carry, computed in float32 and
    rounded to ``gx``'s dtype (the kernel's arithmetic)."""
    st = _step(gx, r, carry)
    return tuple(t.to(gx.dtype) for t in (st.h, st.c, st.n, st.m))


def _check_lengths(gx: torch.Tensor, lengths) -> None:
    if lengths is None:
        return
    if (tuple(lengths.shape) != (gx.shape[0],) or lengths.dtype != torch.int32
            or lengths.device != gx.device or not lengths.is_contiguous()):
        raise ValueError(f"sLSTM scan lengths: want a contiguous int32 "
                         f"[{gx.shape[0]}] on {gx.device}; got "
                         f"{tuple(lengths.shape)} {lengths.dtype} on "
                         f"{lengths.device}")


def _check(gx: torch.Tensor, r: torch.Tensor, carry: tuple) -> None:
    if gx.ndim != 4 or gx.shape[2] != 4 or len(carry) != 4:
        raise ValueError(f"want gx [B,S,4,d] and a carry of 4; got gx "
                         f"{tuple(gx.shape)}, {len(carry)} carry tensors")
    bsz, _, _, d = gx.shape
    if tuple(r.shape) != (4, d) or any(tuple(t.shape) != (bsz, d)
                                       for t in carry):
        raise ValueError(f"gx {tuple(gx.shape)} wants r [4, {d}] and a "
                         f"carry of [{bsz}, {d}]; got r {tuple(r.shape)}, "
                         f"carry {[tuple(t.shape) for t in carry]}")
    ts = (gx, r, *carry)
    if any(t.dtype != gx.dtype for t in ts):
        raise ValueError(f"mixed dtypes {[t.dtype for t in ts]}")
    if any(t.device != gx.device for t in ts):
        raise ValueError("gx, r and the carry must lie on one device")
    if gx.device.type not in _DEVICES:
        raise ValueError(f"no sLSTM scan for device {gx.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the sLSTM scan takes contiguous gx, r and carry")
    if gx.device.type == "cuda":
        if gx.dtype not in _DTYPE_CODE:
            raise ValueError(f"sLSTM scan kernel takes float32 or bfloat16, "
                             f"not {gx.dtype}")
        if gx.numel() == 0 or bsz > 65535:
            raise ValueError(f"sLSTM scan kernel takes non-empty gx with "
                             f"B <= 65535; got {tuple(gx.shape)}")


def slstm_scan(gx: torch.Tensor, r: torch.Tensor, carry: tuple,
               lengths: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, tuple]:
    """(hs ``[B, S, d]``, the last carry) of the recurrence over gx's S
    steps from ``carry`` (h, c, n, m), or over each row's first
    ``lengths[b]`` steps: the kernel for CUDA tensors, the plain loop for
    CPU ones; through :class:`SLSTMScan` when a gradient is asked for."""
    carry = tuple(carry)
    _check(gx, r, carry)
    _check_lengths(gx, lengths)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (gx, r, *carry))
    if lengths is not None and (grad or sharding.is_distributed(
            gx, r, *carry, lengths)):
        raise ValueError("sLSTM scan lengths: a padded prefill's forward "
                         "takes no gradient and no DTensor")
    if sharding.is_distributed(gx, r, *carry):
        return _sharded(gx, r, carry)
    if grad:
        hs, *last = SLSTMScan.apply(gx, r, *carry)
        return hs, tuple(last)
    hs, last, _ = _forward(gx, r, carry, keep=False, lengths=lengths)
    return hs, last


def _sharded(gx, r, carry) -> tuple[torch.Tensor, tuple]:
    """The sharding rule of the recurrence on DTensors: the kernels (forward
    and backward) run on each device's shard.  Each unit's recurrence reads
    its own gate inputs, its own column of r and its own carry, so a shard
    of the units (d over "model" where it divides d) runs with no exchange
    between the shards, from a token to the next or in the backward; the
    batch goes over the data axes where they divide it.  r's gradient sums
    over the batch: a partial sum over the data axes."""
    from torch.distributed.tensor import Partial
    mesh = gx.device_mesh
    units = ({"model": 1} if sharding.model_size(mesh) > 1
             and gx.shape[3] % sharding.model_size(mesh) == 0 else {})
    batch = sharding.batch_axes(mesh, gx.shape[0])
    dims = dict.fromkeys(batch, 0)
    gp = sharding.placements(mesh, {**dims, **{k: 3 for k in units}})
    rp = sharding.placements(mesh, units)
    rg = tuple(Partial() if name in batch else p
               for name, p in zip(mesh.mesh_dim_names, rp))
    cp = sharding.placements(mesh, {**dims, **units})
    hp = sharding.placements(mesh, {**dims, **{k: 2 for k in units}})

    def local(gxl, rl, *cl):
        hs, last = slstm_scan(gxl, rl, cl)
        return (hs, *last)

    hs, *last = sharding.on_shards(
        local, mesh, (gx, r, *carry), (gp, rp) + (cp,) * 4,
        (hp,) + (cp,) * 4, (gp, rg) + (cp,) * 4)
    return hs, tuple(last)


def _forward(gx, r, carry, keep: bool, lengths=None):
    """(hs, the last carry, the kept carry ``[B, S, 3, d]`` or None)."""
    if gx.device.type == "cpu":
        return (_plain(gx, r, carry, keep) if lengths is None
                else _plain(gx, r, carry, keep, lengths))
    if gx.device.type == "meta":
        return _meta_forward(gx, keep)
    return _launch(gx, r, carry, keep, lengths)


def _plain(gx, r, carry, keep: bool, lengths=None):
    bsz, s, _, d = gx.shape
    hs = torch.empty((bsz, s, d), dtype=gx.dtype, device=gx.device)
    kept = (torch.empty((bsz, s, 3, d), dtype=gx.dtype, device=gx.device)
            if keep else None)
    for t in range(s):
        new = slstm_cell(gx[:, t], r, carry)
        if lengths is not None:         # rows past their length hold
            live = (t < lengths)[:, None]
            new = tuple(torch.where(live, u, v) for u, v in zip(new, carry))
        carry = new
        hs[:, t] = carry[0]
        if keep:
            kept[:, t] = torch.stack(carry[1:], dim=1)
    return hs, carry, kept


def slstm_scan_plain(gx: torch.Tensor, r: torch.Tensor, carry: tuple,
                     keep: bool = False, lengths: torch.Tensor | None = None):
    """The forward kernel's recurrence in torch, a step at a time: (hs,
    the last carry), with ``keep`` also the kept carry ``[B, S, 3, d]``;
    with ``lengths`` row b's steps from ``lengths[b]`` on hold the carry."""
    carry = tuple(carry)
    _check(gx, r, carry)
    _check_lengths(gx, lengths)
    hs, last, kept = _plain(gx, r, carry, keep, lengths)
    return (hs, last, kept) if keep else (hs, last)


def slstm_scan_keep(gx: torch.Tensor, r: torch.Tensor, carry: tuple):
    """(hs, the last carry, the kept carry ``[B, S, 3, d]``): the carry
    (c, n, m) after every step, which the backward reads; the kernel's own
    on the card, the plain loop's on the CPU."""
    carry = tuple(carry)
    _check(gx, r, carry)
    return _forward(gx, r, carry, keep=True)


def _meta_forward(gx, keep: bool):
    bsz, s, _, d = gx.shape
    flops, nbytes = work.slstm_work(bsz, s, d, gx.dtype, keep)
    work.report("slstm_scan", flops, nbytes)
    hs = torch.empty((bsz, s, d), dtype=gx.dtype, device=gx.device)
    last = tuple(torch.empty((bsz, d), dtype=gx.dtype, device=gx.device)
                 for _ in _CARRY)
    kept = (torch.empty((bsz, s, 3, d), dtype=gx.dtype, device=gx.device)
            if keep else None)
    return hs, last, kept


class SLSTMScan(torch.autograd.Function):
    """The recurrence with the kernels' forward and backward on the card
    and their plain versions on the CPU; the forward keeps the carry after
    every step for the backward.  Outputs: hs and the last carry."""

    @staticmethod
    def forward(ctx, gx, r, h, c, n, m):
        carry = (h, c, n, m)
        hs, last, kept = _forward(gx, r, carry, keep=True)
        ctx.save_for_backward(gx, r, *carry, hs, kept)
        return (hs, *last)

    @staticmethod
    def backward(ctx, dhs, *dlast):
        gx, r, h, c, n, m, hs, kept = ctx.saved_tensors
        dgx, dr, dcarry = slstm_scan_bwd(gx, r, (h, c, n, m), hs, kept, dhs,
                                         dlast)
        return (dgx, dr, *dcarry)


def slstm_scan_bwd(gx: torch.Tensor, r: torch.Tensor, carry: tuple,
                   hs: torch.Tensor, kept: torch.Tensor, dhs: torch.Tensor,
                   dlast: tuple) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """(dgx, dr, the initial carry's gradient) from the forward's inputs,
    its output hs and kept carry (:func:`slstm_scan_keep`), the gradient
    of hs and that of the last carry (h, c, n, m), in the inputs' dtype:
    the backward kernel for CUDA tensors, its plain version for CPU ones."""
    carry = tuple(carry)
    _check(gx, r, carry)
    bsz, s, _, d = gx.shape
    dhs = dhs.to(gx.dtype).contiguous()
    dlast = tuple(t.to(gx.dtype).contiguous() for t in dlast)
    for name, t, shape in (("hs", hs, (bsz, s, d)), ("kept", kept,
                                                      (bsz, s, 3, d)),
                           ("dhs", dhs, (bsz, s, d)),
                           *((f"d{k}", t, (bsz, d))
                             for k, t in zip(_CARRY, dlast))):
        if (tuple(t.shape) != shape or t.dtype != gx.dtype
                or t.device != gx.device or not t.is_contiguous()):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not fit gx {tuple(gx.shape)} "
                             f"{gx.dtype} on {gx.device}")
    if len(dlast) != 4:
        raise ValueError(f"want the gradient of a carry of 4, got "
                         f"{len(dlast)}")
    if gx.device.type == "cpu":
        return slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs, dlast)
    if gx.device.type == "meta":
        flops, nbytes = work.slstm_bwd_work(bsz, s, d, gx.dtype,
                                            kept=True)
        work.report("slstm_scan_bwd", flops, nbytes)
        return (torch.empty_like(gx), torch.empty_like(r),
                tuple(torch.empty_like(t) for t in carry))
    return _launch_bwd(gx, r, carry, hs, kept, dhs, dlast)


def slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs, dlast):
    """The backward kernel's reverse recurrence in torch, a step at a time
    and in float64 whatever the inputs' dtype: each step's forward values
    computed again (:func:`_step`) from the carry it started from (hs and
    ``kept`` at t - 1, ``carry`` at t = 0), then the gradients of its
    inputs (JAX's tie rule: half to each side); the results rounded to the
    inputs' dtype.  Given the kept carry the gradient is a fixed function
    of these inputs, and float64 computes it to well under a float32 ulp:
    the same recurrence in float32 (sequentially, as the first kernel did)
    is off by up to 4e-4 of (1 + |dr|) at S 1024-2048, its rounding carried
    along the reverse chain and summed into dr (PERF.md, row 6)."""
    bsz, s, _, d = gx.shape
    dtype, wide = gx.dtype, torch.float64
    gx, r, hs, kept, dhs = (t.to(wide) for t in (gx, r, hs, kept, dhs))
    carry = tuple(t.to(wide) for t in carry)
    dh, dc, dn, dm = (t.to(wide) for t in dlast)
    dgx = torch.empty((bsz, s, 4, d), dtype=wide, device=gx.device)
    dr = torch.zeros((4, d), dtype=wide, device=gx.device)
    for t in reversed(range(s)):
        start = ((hs[:, t - 1], *kept[:, t - 1].unbind(1)) if t
                 else carry)                   # the carry step t began from
        st = _step(gx[:, t], r, start)
        h, c, n = (v.to(wide) for v in start[:3])
        # h' = o c' / den
        q = (dhs[:, t].to(wide) + dh) / st.den
        d_o = q * st.c
        dc = dc + q * st.o
        dden = -q * (st.o * st.c) / st.den
        an = st.n.abs()
        w = torch.where(an > 1, 1.0, torch.where(an == 1, 0.5, 0.0))
        dn = dn + dden * w * torch.sign(st.n)
        # c' = fg c + ig z, n' = fg n + ig
        df = dc * c + dn * n
        di = dc * st.z + dn
        dz = dc * st.ig
        # ig = exp(pre_i - m'), fg = exp(fm - m'); m' = max(fm, pre_i)
        dpre_i, dfm = di * st.ig, df * st.fg
        dmt = dm - dpre_i - dfm
        share_f = torch.where(st.fm > st.pre_i, 1.0,
                              torch.where(st.pre_i > st.fm, 0.0, 0.5))
        dfm = dfm + share_f * dmt
        dpre_i = dpre_i + (1.0 - share_f) * dmt
        dpre = torch.stack([dpre_i, dfm, dz * (1 + st.z) * (1 - st.z),
                            d_o * st.o * (1 - st.o)], dim=1)   # [B, 4, d]
        dgx[:, t] = dpre
        dr += (dpre * h[:, None, :]).sum(0)
        dh = (dpre * r).sum(1)
        dc, dn, dm = dc * st.fg, dn * st.fg, dfm
    return (dgx.to(dtype), dr.to(dtype),
            tuple(t.to(dtype) for t in (dh, dc, dn, dm)))


def _coefficients(st: Step, r: torch.Tensor, c: torch.Tensor,
                  n: torch.Tensor, dy: torch.Tensor) -> dict:
    """A step's backward as the linear map ``csrc/slstm_cell.cuh``'s
    ``slstm::coef`` writes it, elementwise over any shape: rows of
    coefficients on (x, dc, dn, dm), x = dh + dy, for the input carry's
    gradient (``a`` dh, ``b`` dm, and dc = ``cx`` x + ``fg`` dc, dn = ``nx``
    x + ``fg`` dn) and the gate gradients (``b`` pre_f, whose first three
    entries negated and ``1 - b[3]`` are pre_i's, ``z_x``, ``z_c`` pre_z,
    ``o_x`` pre_o).  ``r`` broadcasts as ``[4, 1, ..., d]``; c and n are
    the carry the step started from."""
    iv = 1.0 / st.den
    an = st.n.abs()
    w = torch.where(an > 1, 1.0, torch.where(an == 1, 0.5, 0.0))
    a1 = iv * st.o                                  # dc~ = dc + a1 x
    a2 = -(st.o * st.c) * iv * iv * w * torch.sign(st.n)   # dn~ = dn + a2 x
    az = st.ig * (1 + st.z) * (1 - st.z)
    pi = (st.ig * (st.z * a1 + a2), st.ig * st.z, st.ig)
    fm = (st.fg * (c * a1 + n * a2), st.fg * c, st.fg * n)
    sf = torch.where(st.fm > st.pre_i, 1.0,
                     torch.where(st.pre_i > st.fm, 0.0, 0.5))
    si = 1 - sf
    b = [si * f - sf * p for f, p in zip(fm, pi)] + [sf]
    o_x = iv * st.c * st.o * (1 - st.o)
    z_x = az * a1
    rf = r[1] - r[0]                         # pre_i's row is -b's, + si dm
    a = [rf * b[0] + r[2] * z_x + r[3] * o_x, rf * b[1] + r[2] * az,
         rf * b[2], r[0] * si + r[1] * sf]
    return {"a": a, "b": b, "cx": st.fg * a1, "nx": st.fg * a2,
            "fg": st.fg, "o_x": o_x, "z_x": z_x, "z_c": az, "dy": dy}


def slstm_scan_bwd_linear(gx, r, carry, hs, kept, dhs, dlast):
    """The backward as its kernel computes it, in torch and in float32
    (float64 for float64 inputs): every step's forward values
    and coefficients (:func:`_coefficients`) at once from the carry it
    started from; then the serial chain, which maps the carried gradient
    (dh, dc, dn, dm) of a step's output carry to its input carry's by those
    coefficients alone; then every step's gate gradients from the carried
    gradient each step saw.  The same (dgx, dr, the initial carry's
    gradient) as :func:`slstm_scan_bwd_plain`."""
    bsz, s, _, d = gx.shape
    wide = _wide(gx.dtype)
    starts = [torch.cat([carry[0][:, None], hs[:, :-1]], 1)]
    starts += [torch.cat([carry[k + 1][:, None], kept[:, :-1, k]], 1)
               for k in range(3)]                          # each [B, S, d]
    st = _step(gx.reshape(bsz * s, 4, d), r,
               tuple(v.reshape(bsz * s, d) for v in starts))
    st = Step(*(v.reshape(bsz, s, d) for v in st))
    h, c, n = (v.to(wide) for v in starts[:3])
    co = _coefficients(st, r.to(wide)[:, None, None, :], c, n,
                       dhs.to(wide))
    g = [t.to(wide) for t in dlast]
    seen = torch.empty((4, bsz, s, d), dtype=wide, device=gx.device)
    for t in reversed(range(s)):
        for k in range(4):
            seen[k, :, t] = g[k]
        u = (g[0] + co["dy"][:, t], g[1], g[2], g[3])
        g = [sum(a[:, t] * v for a, v in zip(co["a"], u)),
             co["cx"][:, t] * u[0] + co["fg"][:, t] * u[1],
             co["nx"][:, t] * u[0] + co["fg"][:, t] * u[2],
             sum(b[:, t] * v for b, v in zip(co["b"], u))]
    x, dc, dn, dm = seen[0] + co["dy"], seen[1], seen[2], seen[3]
    b = co["b"]
    lin = b[0] * x + b[1] * dc + b[2] * dn
    dpre = torch.stack([(1 - b[3]) * dm - lin, lin + b[3] * dm,
                        co["z_x"] * x + co["z_c"] * dc, co["o_x"] * x],
                       dim=2)                               # [B, S, 4, d]
    dr = (dpre * h[:, :, None, :]).sum((0, 1))
    return (dpre.to(gx.dtype), dr.to(r.dtype),
            tuple(t.to(gx.dtype) for t in g))


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("slstm_scan")
    fn = lib.repro_slstm_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 4 + [p]
    return lib


def _launch(gx, r, carry, keep: bool, lengths=None):
    bsz, s, _, d = gx.shape
    width = padded_width(d, gx.dtype)
    if width != d:
        hs, last, kept = _launch(_pad(gx, width), _pad(r, width),
                                 tuple(_pad(t, width) for t in carry), keep,
                                 lengths)
        return (hs[..., :d].contiguous(),
                tuple(t[:, :d].contiguous() for t in last),
                kept[..., :d].contiguous() if keep else None)
    gx = _aligned(gx)
    hs = torch.empty((bsz, s, d), dtype=gx.dtype, device=gx.device)
    last = tuple(torch.empty_like(t) for t in carry)
    kept = (torch.empty((bsz, s, 3, d), dtype=gx.dtype, device=gx.device)
            if keep else None)
    lib = _lib()
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.repro_slstm_scan(
            gx.data_ptr(), r.data_ptr(), *(t.data_ptr() for t in carry),
            hs.data_ptr(), *(t.data_ptr() for t in last),
            kept.data_ptr() if keep else None,
            None if lengths is None else lengths.data_ptr(),
            _DTYPE_CODE[gx.dtype], bsz, s, d, stream)
    if err:
        raise RuntimeError(f"sLSTM scan kernel launch failed: CUDA error "
                           f"{err}")
    launches.add()
    return hs, last, kept


def _bwd_lib() -> ctypes.CDLL:
    from .build import load
    lib = load("slstm_scan_bwd")
    fn = lib.repro_slstm_scan_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 19 + [i] * 4 + [p]
    return lib


def _launch_bwd(gx, r, carry, hs, kept, dhs, dlast):
    bsz, s, _, d = gx.shape
    width = padded_width(d, gx.dtype)
    if width != d:
        dgx, dr, dcarry = _launch_bwd(
            *(_pad(t, width) for t in (gx, r)),
            tuple(_pad(t, width) for t in carry),
            *(_pad(t, width) for t in (hs, kept, dhs)),
            tuple(_pad(t, width) for t in dlast))
        return (dgx[..., :d].contiguous(), dr[:, :d].contiguous(),
                tuple(t[:, :d].contiguous() for t in dcarry))
    gx, hs, kept, dhs = (_aligned(t) for t in (gx, hs, kept, dhs))
    dgx = torch.empty_like(gx)
    dcarry = tuple(torch.empty_like(t) for t in carry)
    dr_rows = torch.empty((bsz, 4, d), dtype=torch.float32, device=gx.device)
    lib = _bwd_lib()
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.repro_slstm_scan_bwd(
            *(t.data_ptr() for t in (gx, r, *carry, hs, kept, dhs, *dlast,
                                     dgx, dr_rows, *dcarry)),
            _DTYPE_CODE[gx.dtype], bsz, s, d, stream)
    if err:
        raise RuntimeError(f"sLSTM scan backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches.add()
    return dgx, dr_rows.sum(0).to(r.dtype), dcarry
