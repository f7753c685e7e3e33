"""AdamW's update and its gradient norm: the CUDA kernels' wrapper, their
plain versions and their launch counters.

Replaces no TPU kernel.  The reference jits its whole train step
(``repro/train/trainer.py:56``), so XLA fuses AdamW's update
(``repro/optim/adamw.py:62``) into a few passes over each leaf; these
kernels (``csrc/adamw.cu``) are the port's counterpart, one pass over a
leaf where the eager update took about 23.  ``optim/adamw.py`` computes
the step's scalars (the schedule's lr, the clip factor, the bias
corrections, each a 0-d float32 tensor) and hands each leaf here.

:func:`update` updates one leaf in place: the moments m and v (float32),
the float32 weight ``p32`` (the master copy, or the float32 param itself
when there is none: ``p is p32``) and the param ``p`` (float32 or
bfloat16, written only when it is not ``p32``), from the gradient g
(float32 or bfloat16).  :func:`global_norm` is the gradients' L2 norm, a
0-d float32 tensor on their device.  For CUDA tensors both launch their
kernels or raise (device, dtype, shape, contiguity, the scalars' place;
no fallback); for CPU tensors they take the plain versions,
:func:`update_plain` and :func:`global_norm_plain`: the eager per-leaf
arithmetic of the port's AdamW as it was before the kernels, which the
CPU path runs bit for bit as before.  On the card the update kernel is
bit for bit the plain version given the same scalars (its source note
says how); the norm kernel sums in float64 in a fixed order, where the
plain version sums float32 in PyTorch's order.  On the meta device (the
dry-run's abstract step) both compute nothing and report their work
(``work.adamw_work``, ``work.adamw_norm_work``: bytes, no flops) through
``work.report``.  Any other device raises.  On DTensors (a step run on a
device mesh, as the dry-run runs it) each device updates its shard, and
the norm sums each leaf's squares over the mesh dims that shard it
(``_update_sharded``, ``_global_norm_sharded``).

Counters: ``launches``, one a leaf update; ``norm_launches``, the norm's
kernels: one partial pass a leaf and one finalize a norm.
"""
from __future__ import annotations

import ctypes

import torch

from ..parallel import sharding
from . import work
from .common import LaunchCounter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()
norm_launches = LaunchCounter()


def update_plain(p, p32, g, m, v, lr, scale, b1c, b2c, *, b1: float,
                 b2: float, eps: float, weight_decay: float) -> None:
    """One leaf's update in place, eagerly: the port's AdamW arithmetic
    before the kernels, op for op."""
    g = g.to(torch.float32) * scale
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    w = p32.to(torch.float32)
    new = w - lr * ((m / b1c) / (torch.sqrt(v / b2c) + eps)
                    + weight_decay * w)
    p32.copy_(new)
    if p is not p32:
        p.copy_(new)           # rounded to the param's dtype


def global_norm_plain(grads: list) -> torch.Tensor:
    """The gradients' L2 norm, eagerly: float32 squares summed a leaf at a
    time, the leaves' sums added in order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads))


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("adamw")
    if lib.repro_adamw_update.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_float
        lib.repro_adamw_norm_blocks.restype = i
        lib.repro_adamw_norm_blocks.argtypes = []
        lib.repro_adamw_norm_partials.restype = i
        lib.repro_adamw_norm_partials.argtypes = [p, i, ll, p, p]
        lib.repro_adamw_norm_finalize.restype = i
        lib.repro_adamw_norm_finalize.argtypes = [p, i, p, p]
        lib.repro_adamw_update.restype = i
        lib.repro_adamw_update.argtypes = [p, i, p, p, i, p, p, ll, p, p, p,
                                           p, f, f, f, f, f, f, p]
    return lib


def _device(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"adamw: tensors on several devices {devices}")
    return devices.pop()


def _check_leaf(p, p32, g, m, v, scalars) -> None:
    for name, t, dtypes in (("p", p, _DTYPE_CODE), ("p32", p32, (torch.float32,)),
                            ("g", g, _DTYPE_CODE), ("m", m, (torch.float32,)),
                            ("v", v, (torch.float32,))):
        if t.dtype not in dtypes:
            raise ValueError(f"adamw: {name} is {t.dtype}; the kernel takes "
                             f"{list(dtypes)}")
        if t.shape != p.shape:
            raise ValueError(f"adamw: {name} has shape {tuple(t.shape)}, "
                             f"the param {tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adamw: {name} is not contiguous (strides "
                             f"{t.stride()})")
    for name, t in scalars.items():
        if (t.device != p.device or t.dtype != torch.float32
                or t.dim() != 0):
            raise ValueError(f"adamw: {name} must be a 0-d float32 tensor on "
                             f"{p.device}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (p, p32, g, m, v)):
        raise RuntimeError("adamw: the update writes its tensors in place; "
                           "run it under torch.no_grad()")


def update(p, p32, g, m, v, lr, scale, b1c, b2c, *, b1: float, b2: float,
           eps: float, weight_decay: float) -> None:
    """One leaf's AdamW update in place (the module doc)."""
    if sharding.is_distributed(p, p32, g, m, v):
        return _update_sharded(p, p32, g, m, v, lr, scale, b1c, b2c, b1=b1,
                               b2=b2, eps=eps, weight_decay=weight_decay)
    dev = _device((p, p32, g, m, v))
    consts = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if dev.type == "cpu":
        return update_plain(p, p32, g, m, v, lr, scale, b1c, b2c, **consts)
    if dev.type == "meta":
        work.report("adamw", *work.adamw_work(p.numel(), p.dtype, g.dtype,
                                              p is not p32))
        return None
    if dev.type != "cuda":
        raise ValueError(f"no adamw kernel for device {dev}")
    _check_leaf(p, p32, g, m, v, {"lr": lr, "scale": scale, "b1c": b1c,
                                  "b2c": b2c})
    if p is not p32 and p.data_ptr() == p32.data_ptr():
        raise ValueError("adamw: the param aliases its master copy")
    if p.numel() == 0:
        return None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_adamw_update(
            p.data_ptr(), -1 if p is p32 else _DTYPE_CODE[p.dtype],
            p32.data_ptr(), g.data_ptr(), _DTYPE_CODE[g.dtype], m.data_ptr(),
            v.data_ptr(), p.numel(), lr.data_ptr(), scale.data_ptr(),
            b1c.data_ptr(), b2c.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps,
            weight_decay, stream)
    if err:
        raise RuntimeError(f"adamw update kernel launch failed: CUDA error "
                           f"{err}")
    launches.add()
    for t in {id(t): t for t in (p, p32, m, v)}.values():
        torch.autograd.graph.increment_version(t)   # written in place
    return None


def global_norm(grads) -> torch.Tensor:
    """The L2 norm of ``grads`` (a sequence of tensors on one device), a
    0-d float32 tensor there (the module doc)."""
    grads = list(grads)
    if not grads:
        raise ValueError("global_norm of no gradients")
    if sharding.is_distributed(*grads):
        return _global_norm_sharded(grads)
    dev = _device(grads)
    if dev.type == "cpu":
        return global_norm_plain(grads)
    if dev.type == "meta":
        work.report("adamw_norm", *work.adamw_norm_work(
            [(g.numel(), g.dtype) for g in grads]))
        return torch.empty((), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"no adamw norm kernel for device {dev}")
    for g in grads:
        if g.dtype not in _DTYPE_CODE or not g.is_contiguous():
            raise ValueError(f"adamw norm: a gradient of {g.dtype}, strides "
                             f"{g.stride()}; the kernel takes contiguous "
                             f"float32 or bfloat16")
    lib = _lib()
    blocks = lib.repro_adamw_norm_blocks()
    partials = torch.empty(len(grads) * blocks, dtype=torch.float64,
                           device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, g in enumerate(grads):
            err = lib.repro_adamw_norm_partials(
                g.data_ptr(), _DTYPE_CODE[g.dtype], g.numel(),
                partials.data_ptr() + 8 * blocks * i, stream)
            if err:
                raise RuntimeError(f"adamw norm kernel launch failed: CUDA "
                                   f"error {err}")
            norm_launches.add()
        err = lib.repro_adamw_norm_finalize(partials.data_ptr(), len(grads),
                                            out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"adamw norm finalize launch failed: CUDA error "
                           f"{err}")
    norm_launches.add()
    return out


def _local(t):
    return t.to_local() if sharding.is_distributed(t) else t


def _update_sharded(p, p32, g, m, v, lr, scale, b1c, b2c, **consts) -> None:
    """:func:`update` on DTensors: elementwise, so each device updates its
    shard with the kernel.  The shard is the moments' (ZeRO-1): the param
    and its gradient are cut to the moments' placements first (the
    gradient normally arrives there), and the updated param goes back to
    its own placements, an all-gather where the moments shard a dim the
    param does not."""
    mesh, target = m.device_mesh, tuple(m.placements)

    def on_moments(t):
        return (t if tuple(t.placements) == target
                else t.redistribute(mesh, target))

    pm = on_moments(p)
    p32m = pm if p32 is p else on_moments(p32)
    update(_local(pm), _local(p32m), _local(on_moments(g)), _local(m),
           _local(v), *(_local(t) for t in (lr, scale, b1c, b2c)), **consts)
    for t, moved in ((p, pm), (p32, p32m)):
        if moved is not t:
            t.copy_(moved.redistribute(mesh, t.placements))


def _global_norm_sharded(grads) -> torch.Tensor:
    """:func:`global_norm` of DTensors, a replicated DTensor.  A norm is no
    sum of the shards' norms: each leaf's sum of squares is summed over
    the mesh dims on which it is sharded (a leaf replicated on a dim counts
    once, not once a device), then the root is taken.  The leaves are
    grouped by those dims; a group's local sum of squares is the square of
    the kernel's norm of its local shards, in float64.  Where no leaf is
    sharded (one device) the norm is the kernel's own, bit for bit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = grads[0].device_mesh
    whole = tuple(Replicate() for _ in mesh.mesh_dim_names)
    grads = [g.redistribute(mesh, tuple(
        Replicate() if p.is_partial() else p for p in g.placements))
        if any(p.is_partial() for p in g.placements) else g for g in grads]
    groups: dict[tuple, list] = {}
    for g in grads:
        key = tuple(i for i, p in enumerate(g.placements) if p.is_shard())
        groups.setdefault(key, []).append(g.to_local())
    if list(groups) == [()]:
        return DTensor.from_local(global_norm(groups[()]), mesh, whole,
                                  run_check=False)
    total = None
    for key, local in groups.items():
        sq = global_norm(local).double() ** 2
        if key:
            sq = DTensor.from_local(sq, mesh, tuple(
                Partial() if i in key else Replicate()
                for i in range(mesh.ndim)), run_check=False).full_tensor()
        total = sq if total is None else total + sq
    return DTensor.from_local(total.sqrt().float(), mesh, whole,
                              run_check=False)
