"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper, its plain version
and its launch counter.

Port of ``repro/kernels/ssd_scan.py`` (``ssd_scan_pallas``).  Same
function: x ``[B, S, H, D]``, log-decay a ``[B, S, H]`` (a <= 0), b and c
``[B, S, N]`` shared across the H heads; y ``[B, S, H, D]`` in x's dtype with

    h_t = exp(a_t) h_{t-1} + x_t (x) b_t,   y_t = h_t c_t

and the state h ``[D, N]`` of each (batch, head) in float32, zero at the
start.  Per chunk c of ``CHUNK`` tokens, with Acum the cumulative sum of a
from the chunk's start and h_c the state at the chunk's start:

    y  = tril(exp(Acum_t - Acum_u) * (C_t . B_u)) @ x + exp(Acum_t) * (C_t . h_c)
    h_{c+1} = exp(A_tot) h_c + s_c,   s_c = (x * exp(A_tot - Acum))^T @ B

The chunks are computed in parallel, as the Mamba-2 paper splits its
chunked algorithm (Dao & Gu, arXiv:2405.21060, section 6), in four passes:
(1) C . B^T of every chunk, once for all heads, and Acum; (2) every
chunk's local end state s_c; (3) the states passed from chunk to chunk,
the only sequential step, elementwise over the state; (4) every chunk's
output.

:func:`ssd_scan` launches ``csrc/ssd_scan.cu`` for a CUDA tensor (all four
inputs float32 or all bfloat16, any S, D and N: every pass tiles N) or
raises; it takes :func:`ssd_scan_plain` only for a
tensor on the CPU.  The four passes are one C call and count as one launch,
in ``launches`` and in ``path_launches`` of its load route.  The route
(:func:`ssd_route`, a plain function of the dtype, D, N and the pointers'
alignment, which the C entry points check again) is how the input tiles
reach shared memory; a row is "on 16 bytes" where its length is a whole
number of 16 bytes (4 floats, 8 halves) and its pointer is aligned:

- ``"bf16_async"``: bfloat16 with b's and c's rows on 16 bytes, and x's
  (with y's, and dy's and dx's in the backward) too or D below
  :data:`NARROW_D`: bfloat16 shared tiles by 16-byte ``cp.async``,
  widened at the fragment read, each product on as many TF32 ``mma.sync``
  as its float32 operands need (1 for two bfloat16 operands, 2 for one);
- ``"f32_async"``: float32 with x's, b's and c's rows on 16 bytes: every
  tile by ``cp.async``;
- ``"f32_async_bc"``: float32 with b's and c's rows only;
- ``"plain"``: any other input: loads converted to float32 tiles.

The float32 scratch (C . B^T, Acum, the chunk states, M) arrives by
``cp.async`` on every route where its rows sit on 16 bytes (D a multiple
of 4).  Every route computes the same function in float32 with the same
tiles and sums; a failed build or launch raises, and no route gives way
to another.
The wrapper makes the inputs contiguous, transposes nothing (the TPU
wrapper moved H before S), and allocates the passes' float32 scratch with
``torch.empty``: C . B^T ``[B, nc, L, L]``, Acum ``[B, nc, H, L]`` and the
states ``[B, nc, H, N, D]`` (nc chunks of L = ``CHUNK``).

The plain version walks the same schedule in torch: all chunks' C . B^T
and local states at once as batched einsums, the states passed in a loop
over the chunks, then all outputs at once; the same chunk length, the same
chunk-relative cumulative sum, the same select of the causal triangle
before the exponential (above the diagonal exp(Acum_t - Acum_u) overflows),
float32 throughout; a ragged last chunk is zero-padded, as in the kernel.
It is the CPU path and the kernel's yardstick of correctness on the card,
not of speed.

The gradient.  When grad mode is on and an input requires grad,
:func:`ssd_scan` goes through :class:`SSDScan`, a
``torch.autograd.Function`` that saves x, a, b and c (made contiguous), y
and the forward's float32 scratch (C . B^T, Acum and h_c, "kept": the
forward kernel's own bits, or on the CPU the plain version's, laid out
alike; :func:`ssd_scan_keep`).  Its backward launches
``csrc/ssd_scan_bwd.cu`` for CUDA tensors (float32 or bfloat16, any S, D
and N; one C call, one count in ``bwd_launches``), which reads that
scratch and launches none of the forward's passes (one count in
``bwd_launches`` and in ``bwd_path_launches`` of its route, which reads
y, dy and dx's rows beside x's), and takes
:func:`ssd_scan_bwd_plain` for CPU ones.  :func:`ssd_scan_bwd` called
without ``saved`` runs the forward first to get it.
With g_u the dual state (the loss's gradient at h_u),
``sum_{t >= u} exp(Acum_t - Acum_u) dy_t (x) c_t``:

    dx_u = g_u b_u,   db_u = sum_h x_u . g_u,   dc_t = sum_h dy_t . h_t,
    da_t = sum_{k >= t} (dy_k . y_k - x_k . dx_k)   (per head, over D)

per chunk as masked, decayed L x L products and the carries of the
forward's chunk states h_c and of the dual's R_c, which are passed
backwards along the chunks.  The kernel sums over heads and chunks in one
fixed order with no atomics, so a result repeats bit for bit.  The TPU
kernel has no backward; this one computes what the JAX package's autodiff
of ``ssd_ref`` computes.  Under ``torch.no_grad()`` or
``torch.inference_mode()``, or with no input that requires grad, the
forward launches as it always did, outside the Function, and saves
nothing.

On the meta device (a dry-run's abstract step) the forward, the kept
scratch and the backward compute nothing: they return tensors of the
shapes and dtypes the kernels give (the scratch too, so that ``SSDScan``
saves what its backward reads) and report the work a launch would do
(``work.ssd_work``, ``work.ssd_bwd_work`` with the scratch kept, the flops
and bytes ``chip_smoke.py`` prices in the bound) through ``work.report``.
Any device but the CPU, CUDA and meta raises.

On DTensors (a step run on a device mesh, as the dry-run runs it) the
forward and the backward run on each device's shard, as on one device,
by the sharding rule of ``_sharded`` (batch rows and heads are scans of
their own).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..parallel import sharding
from . import work
from .common import LaunchCounter

CHUNK = 64     # tokens per chunk (L in csrc/ssd_scan.cu)
# D below which passes 2 and 4 run as FMAs (NARROW_D in csrc/ssd_chunk.cuh,
# which :func:`narrow_d` reads from the built kernel); the meta path prices
# the products by it
NARROW_D = 16
_DEVICES = ("cpu", "cuda", "meta")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the load routes and their codes (Route in csrc/ssd_chunk.cuh)
ROUTES = ("bf16_async", "f32_async", "f32_async_bc", "plain")
_ROUTE_CODE = {"plain": 0, "f32_async_bc": 1, "f32_async": 2,
               "bf16_async": 3}

launches = LaunchCounter()
path_launches = {route: LaunchCounter() for route in ROUTES}
bwd_launches = LaunchCounter()
bwd_path_launches = {route: LaunchCounter() for route in ROUTES}


def ssd_route(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              *rows: torch.Tensor) -> str:
    """The load route of these contiguous inputs: one of :data:`ROUTES`
    (the module doc says which inputs go where).  ``rows``: the other
    tensors with x's rows (y; dy and dx in the backward)."""
    return route_of(x.dtype, x.shape[3], b.shape[2], b.data_ptr(),
                    c.data_ptr(), [t.data_ptr() for t in (x, *rows)])


def route_of(dtype: torch.dtype, d: int, n: int, b_ptr: int, c_ptr: int,
             row_ptrs) -> str:
    """:func:`ssd_route` from the dtype, D, N, b's and c's addresses and
    those of the tensors with rows of D elements (``best_route`` in
    ``csrc/ssd_chunk.cuh``)."""
    per16 = 16 // dtype.itemsize
    bc = n % per16 == 0 and b_ptr % 16 == 0 and c_ptr % 16 == 0
    xa = d % per16 == 0 and all(p % 16 == 0 for p in row_ptrs)
    if dtype == torch.bfloat16:
        return "bf16_async" if bc and (xa or d < NARROW_D) else "plain"
    if bc and xa:
        return "f32_async"
    return "f32_async_bc" if bc else "plain"


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
    if sharding.is_distributed(x, a, b, c):
        return _sharded(x, a, b, c)
    if x.device.type not in _DEVICES:
        raise ValueError(f"no SSD scan for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, b, c)):
        return SSDScan.apply(x, a, b, c)
    return _forward(x, a, b, c)       # no graph, nothing saved


def _sharded(x, a, b, c) -> torch.Tensor:
    """The sharding rule of the scan on DTensors: the kernels (forward and
    backward) run on each device's shard.  Each batch row and each head is
    a scan of its own.  Where "model" divides the heads, x and a are
    sharded on their heads and b and c, which every head reads, stay whole
    (their gradients partial sums over "model"), the batch over the data
    axes where they divide it.  Otherwise (mLSTM folds its heads into the
    batch) all four take the batch sharding of the input that arrives
    sharded on the most mesh dims and on nothing but its batch (the others
    are cut to it, on their own device), and else the data axes' alone."""
    from torch.distributed.tensor import Partial
    mesh = x.device_mesh
    m = sharding.model_size(mesh)
    if m > 1 and x.shape[2] % m == 0:
        dims = dict.fromkeys(sharding.batch_axes(mesh, x.shape[0]), 0)
        xp = sharding.placements(mesh, {**dims, "model": 2})
        bp = sharding.placements(mesh, dims)
        bg = tuple(Partial() if name == "model" else p
                   for name, p in zip(mesh.mesh_dim_names, bp))
        ins, grads = (xp, xp, bp, bp), (xp, xp, bg, bg)
    else:
        batch_only = [tuple(t.placements) for t in (x, a, b, c)
                      if all(p.is_replicate() or getattr(p, "dim", None) == 0
                             for p in t.placements)]
        xp = max(batch_only, default=None, key=lambda pl: sum(
            not p.is_replicate() for p in pl))
        if xp is None:
            xp = sharding.placements(mesh, dict.fromkeys(
                sharding.batch_axes(mesh, x.shape[0]), 0))
        ins = grads = (xp,) * 4
    return sharding.on_shards(ssd_scan, mesh, (x, a, b, c), ins, ins[0],
                              grads)


def _forward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, keep: bool = False):
    """y, or with ``keep`` (y, the forward's scratch)."""
    if x.device.type == "cpu":
        y, saved = _plain_forward(x, a, b, c, keep)
        return (y, saved) if keep else y
    if x.device.type == "meta":       # with the copies _launch makes
        x, a, b, c = (t.contiguous() for t in (x, a, b, c))
        return _meta_forward(x, b.shape[2], keep)
    return _launch(x, a, b, c, keep)


def _meta_forward(x: torch.Tensor, n: int, keep: bool):
    """The forward on the meta device: y, with ``keep`` also the scratch
    the kernel keeps; its work reported in place of a launch."""
    bsz, s, h, d = x.shape
    flops, nbytes = work.ssd_work(bsz, s, h, d, n, x.dtype, NARROW_D)
    work.report("ssd_scan", flops, nbytes)
    y = torch.empty_like(x)
    if not keep:
        return y
    return y, torch.empty(scratch_floats(bsz, s, h, d, n),
                          dtype=torch.float32, device=x.device)


def ssd_scan_keep(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan's output y and the forward's float32 scratch, kept for
    :func:`ssd_scan_bwd`'s ``saved``: C . B^T ``[B, nc, L, L]``, Acum
    ``[B, nc, H, L]`` and h_c ``[B, nc, H, N, D]``, flat, one after the
    other (``scratch_floats`` of them).  The kernel's own scratch on the
    card, the plain version's on the CPU."""
    _check(x, a, b, c)
    if x.device.type not in _DEVICES:
        raise ValueError(f"no SSD scan for device {x.device}")
    return _forward(x, a, b, c, True)


class SSDScan(torch.autograd.Function):
    """The scan with the kernels' forward and backward on the card and
    their plain versions on the CPU (the module doc says which); the
    forward's scratch is kept for the backward."""

    @staticmethod
    def forward(ctx, x, a, b, c):
        x, a, b, c = (t.contiguous() for t in (x, a, b, c))
        y, saved = _forward(x, a, b, c, True)
        ctx.save_for_backward(x, a, b, c, y, saved)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ins, saved = ctx.saved_tensors
        return ssd_scan_bwd(*ins, dy, saved=saved)


def ssd_scan_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                 saved: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """(dx, da, db, dc) of the scan from its inputs, its output ``y`` and
    the output's gradient ``dy``, in the inputs' dtype: the backward kernel
    for CUDA tensors, its plain version for CPU ones.  ``saved``: the
    forward's scratch on these inputs (:func:`ssd_scan_keep`); without
    it, the forward runs first to give it."""
    _check(x, a, b, c)
    for name, t in (("output", y), ("output gradient", dy)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not fit x {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if x.device.type not in _DEVICES:
        raise ValueError(f"no SSD scan backward for device {x.device}")
    if saved is None:
        saved = _forward(x, a, b, c, True)[1]
    _check_saved(x, b.shape[2], saved)
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, a, b, c, y, dy, saved)
    ins = tuple(t.contiguous() for t in (x, a, b, c, y, dy))
    if x.device.type == "meta":
        return _meta_bwd(*ins[:4])
    return _launch_bwd(*ins, saved)


def _check_saved(x: torch.Tensor, n: int, saved: torch.Tensor) -> None:
    want = scratch_floats(*x.shape, n)
    if (saved.dtype != torch.float32 or saved.device != x.device
            or saved.ndim != 1 or saved.numel() < want
            or not saved.is_contiguous()):
        raise ValueError(f"saved {tuple(saved.shape)} {saved.dtype} on "
                         f"{saved.device} is not the forward's scratch of x "
                         f"{tuple(x.shape)}, N={n} ({want} contiguous "
                         f"float32 on {x.device})")


def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i,
                       i, i, p]
    return lib


def narrow_d() -> int:
    """D below which the kernel runs passes 2 and 4 as float32 FMAs
    (``NARROW_D`` in ``csrc/ssd_scan.cu``); wider D runs their products
    on the tensor cores in 3xTF32.  Builds the kernel on first use."""
    return _lib().repro_ssd_narrow_d()


def scratch_floats(bsz: int, s: int, h: int, d: int, n: int) -> int:
    """Floats of scratch the kernel's passes use: C . B^T, Acum and the
    chunk states, one after the other."""
    nc = -(-s // CHUNK)
    return bsz * nc * (CHUNK * CHUNK + h * CHUNK + h * n * d)


def _kernel_check(x: torch.Tensor, n: int) -> None:
    """What the forward and backward kernels take beyond :func:`_check`."""
    bsz, s, h, d = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"SSD scan kernel takes float32 or bfloat16, not "
                         f"{x.dtype}")
    if min(bsz, s, h, d, n) == 0:
        raise ValueError(f"SSD scan kernel needs non-empty inputs; got x "
                         f"{tuple(x.shape)}, N={n}")
    if h > 65535 or bsz * -(-s // CHUNK) > 65535:
        raise ValueError(f"SSD scan kernel takes H <= 65535 and "
                         f"B * ceil(S / {CHUNK}) <= 65535; got x "
                         f"{tuple(x.shape)}")


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, keep: bool = False):
    bsz, s, h, d = x.shape
    n = b.shape[2]
    _kernel_check(x, n)
    x, a, b, c = (t.contiguous() for t in (x, a, b, c))
    y = torch.empty_like(x)
    route = ssd_route(x, b, c, y)
    n_scratch = scratch_floats(bsz, s, h, d, n)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), n_scratch, _ROUTE_CODE[route],
            _DTYPE_CODE[x.dtype], bsz, s, h, d, n, stream)
    if err:
        raise RuntimeError(f"SSD scan kernel launch failed on route "
                           f"{route}: CUDA error {err}")
    launches.add()
    path_launches[route].add()
    return (y, scratch) if keep else y


def _bwd_lib() -> ctypes.CDLL:
    from .build import load
    lib = load("ssd_scan_bwd")
    fn = lib.repro_ssd_scan_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = ([p] * 10 + [ctypes.c_longlong, p, ctypes.c_longlong]
                       + [i] * 7 + [p])
    return lib


def bwd_scratch_floats(bsz: int, s: int, h: int, d: int, n: int) -> int:
    """Floats of the backward's own scratch: M, the da terms, the dual's
    chunk states, and db's and dc's per-head parts (the forward's kept
    scratch comes beside it)."""
    nc = -(-s // CHUNK)
    return (bsz * nc * h * (CHUNK * CHUNK + CHUNK + n * d)
            + 2 * bsz * s * h * n)


def _meta_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The backward on the meta device: (dx, da, db, dc) and, while the
    call lasts, the kernel's own scratch; its work (the scratch kept)
    reported in place of a launch."""
    bsz, s, h, d = x.shape
    n = b.shape[2]
    flops, nbytes = work.ssd_bwd_work(bsz, s, h, d, n, x.dtype, kept=True)
    grads = tuple(torch.empty_like(t) for t in (x, a, b, c))
    scratch = torch.empty(bwd_scratch_floats(bsz, s, h, d, n),
                          dtype=torch.float32, device=x.device)
    work.report("ssd_scan_bwd", flops, nbytes)
    del scratch
    return grads


def _launch_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                saved: torch.Tensor) -> tuple[torch.Tensor, ...]:
    bsz, s, h, d = x.shape
    n = b.shape[2]
    _kernel_check(x, n)
    grads = tuple(torch.empty_like(t) for t in (x, a, b, c))
    route = ssd_route(x, b, c, y, dy, grads[0])
    n_scratch = bwd_scratch_floats(bsz, s, h, d, n)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    lib = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan_bwd(
            *(t.data_ptr() for t in (x, b, c, y, dy, *grads)),
            saved.data_ptr(), saved.numel(), scratch.data_ptr(), n_scratch,
            _ROUTE_CODE[route], _DTYPE_CODE[x.dtype], bsz, s, h, d, n,
            stream)
    if err:
        raise RuntimeError(f"SSD scan backward kernel launch failed on "
                           f"route {route}: CUDA error {err}")
    bwd_launches.add()
    bwd_path_launches[route].add()
    return grads


def _chunker(bsz: int, s: int):
    """zero-pads S of a [B, S, ...] tensor to whole chunks, in float32,
    then [B, nc, L, ...]"""
    nc = -(-s // CHUNK)

    def chunks(t, *tail):
        t = F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, nc * CHUNK - s))
        return t.reshape(bsz, nc, CHUNK, *tail)
    return chunks


def _plain_forward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, keep: bool = True):
    """(y, the forward's scratch laid out as the kernel's; None without
    ``keep``)."""
    bsz, s, h, d = x.shape
    n = b.shape[2]
    nc = -(-s // CHUNK)
    chunks = _chunker(bsz, s)
    xc, bc, cc = chunks(x, h, d), chunks(b, n), chunks(c, n)

    # pass 1: C . B^T once per (batch, chunk) for all heads; Acum
    cb = torch.einsum("bctn,bcun->bctu", cc, bc)             # [B,nc,L,L]
    acum = torch.cumsum(chunks(a, h), dim=2)                 # [B,nc,L,H]
    a_tot = acum[:, :, -1]                                   # [B,nc,H]

    # pass 2: each chunk's local end state, [N, D] per (batch, chunk, head)
    w = torch.exp(a_tot[:, :, None] - acum)                  # [B,nc,L,H]
    local = torch.einsum("bcun,bcuh,bcuhd->bchnd", bc, w, xc)

    # pass 3: the states passed along the chunks; h_c at chunk c's start
    run = torch.zeros((bsz, h, n, d), device=x.device)
    starts = []
    for ci in range(nc):
        starts.append(run)
        run = torch.exp(a_tot[:, ci])[..., None, None] * run + local[:, ci]
    hs = torch.stack(starts, dim=1)                          # [B,nc,H,N,D]

    # pass 4: every chunk's output (select the triangle, then decay)
    live = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                      device=x.device).tril()[:, :, None]
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # [B,nc,t,u,H]
    decay = torch.exp(torch.where(live, diff, float("-inf")))
    y = torch.einsum("bctu,bctuh,bcuhd->bcthd", cb, decay, xc)
    y = y + torch.exp(acum)[..., None] * torch.einsum(
        "bctn,bchnd->bcthd", cc, hs)
    y = y.reshape(bsz, nc * CHUNK, h, d)[:, :s].to(x.dtype)
    if not keep:
        return y, None
    return y, torch.cat([cb.flatten(), acum.transpose(2, 3).flatten(),
                         hs.flatten()])


def _unpack_saved(saved: torch.Tensor, bsz: int, nc: int, h: int, n: int,
                  d: int):
    """C . B^T, Acum ``[B, nc, L, H]`` (contiguous, as the plain forward
    computes it) and h_c from the forward's scratch."""
    k1 = bsz * nc * CHUNK * CHUNK
    k2 = k1 + bsz * nc * h * CHUNK
    cb = saved[:k1].view(bsz, nc, CHUNK, CHUNK)
    acum = saved[k1:k2].view(bsz, nc, h, CHUNK).transpose(2, 3).contiguous()
    hs = saved[k2:k2 + bsz * nc * h * n * d].view(bsz, nc, h, n, d)
    return cb, acum, hs


def ssd_scan_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """The kernel's four passes in torch, in float32."""
    _check(x, a, b, c)
    return _plain_forward(x, a, b, c, keep=False)[0]


def ssd_scan_bwd_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                       saved: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, ...]:
    """The backward kernel's passes in torch, in float32: (dx, da, db, dc)
    in the inputs' dtype.  Per chunk, G = tril(exp(Acum_t - Acum_u) C_t .
    B_u), M = tril(exp(Acum_t - Acum_u) dy_t . x_u) and E = exp(A_tot -
    Acum_u); h_c and R_c are the forward's and the dual's chunk carries
    (the module doc gives the identities).  C . B^T, Acum and h_c come
    from ``saved`` (the forward's scratch, :func:`ssd_scan_keep`), or
    without it from the plain forward run first."""
    _check(x, a, b, c)
    bsz, s, h, d = x.shape
    n = b.shape[2]
    nc = -(-s // CHUNK)
    chunks = _chunker(bsz, s)
    xc, yc, dyc = chunks(x, h, d), chunks(y, h, d), chunks(dy, h, d)
    bc, cc = chunks(b, n), chunks(c, n)
    if saved is None:
        saved = _plain_forward(x, a, b, c)[1]
    cb, acum, hs = _unpack_saved(saved, bsz, nc, h, n, d)
    a_tot = acum[:, :, -1]                                   # [B,nc,H]
    ew = torch.exp(a_tot[:, :, None] - acum)                 # E, [B,nc,L,H]

    # the dual: its local states, [N, D] each, and R_c passed backward
    dual = torch.einsum("bctn,bcth,bcthd->bchnd", cc, torch.exp(acum), dyc)
    gs = [None] * nc
    run = torch.zeros((bsz, h, n, d), device=x.device)
    for ci in reversed(range(nc)):
        gs[ci] = run
        run = torch.exp(a_tot[:, ci])[..., None, None] * run + dual[:, ci]
    gs = torch.stack(gs, dim=1)                              # [B,nc,H,N,D]

    # pass 4: M, dx and each token's dy . y - x . dx (select, then decay)
    live = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                      device=x.device).tril()[:, :, None]
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # [B,nc,t,u,H]
    decay = torch.exp(torch.where(live, diff, float("-inf")))
    m = torch.einsum("bcthd,bcuhd->bctuh", dyc, xc) * decay
    dx = torch.einsum("bctu,bctuh,bcthd->bcuhd", cb, decay, dyc)
    dx = dx + ew[..., None] * torch.einsum("bcun,bchnd->bcuhd", bc, gs)
    q = (dyc * yc - xc * dx).sum(dim=-1)                     # [B,nc,L,H]

    # pass 5: each head's db and dc
    dc = torch.einsum("bctuh,bcun->bcthn", m, bc) + torch.exp(acum)[
        ..., None] * torch.einsum("bcthd,bchnd->bcthn", dyc, hs)
    db = torch.einsum("bctuh,bctn->bcuhn", m, cc) + ew[..., None] * (
        torch.einsum("bcuhd,bchnd->bcuhn", xc, gs))

    # pass 6: summed over the heads; pass 7: da, reverse cumsum over S
    db, dc = db.sum(dim=3), dc.sum(dim=3)                    # [B,nc,L,N]
    q = q.reshape(bsz, nc * CHUNK, h)[:, :s]
    da = torch.flip(torch.cumsum(torch.flip(q, (1,)), dim=1), (1,))

    def cut(t, like):
        return t.reshape(bsz, nc * CHUNK, *t.shape[3:])[:, :s].to(like.dtype)

    return cut(dx, x), da.to(a.dtype), cut(db, b), cut(dc, c)
