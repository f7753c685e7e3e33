"""The SSD scan's load routes and the checks ``chip_smoke.py`` holds the
bfloat16 route to, on the CPU.

``ssd_scan.ssd_route`` is the Python mirror of ``best_route`` in
``csrc/ssd_chunk.cuh``: it names the route a launch takes ("bf16_async",
"f32_async", "f32_async_bc" or "plain"), the wrapper passes that route to
the C entry points, which refuse one the inputs do not fit, and the
per-route counters (``path_launches``, ``bwd_path_launches``) count it.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here the choice of route, the bound's pricing of bfloat16 and the keep
rule ``chip_smoke._ssd_ok`` are held on the plain version, which the CPU
path runs, against the JAX package's ``ssd_ref`` where a value is
compared.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ssd_scan

torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_ssd_routes",
        Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,d,n,off,route", [
    (BF16, 128, 64, None, "bf16_async"),     # zamba2's heads
    (BF16, 384, 384, None, "bf16_async"),    # the mLSTM values
    (BF16, 1, 384, None, "bf16_async"),      # the mLSTM normalizer
    (BF16, 8, 64, "x", "bf16_async"),        # narrow: x read by loads
    (BF16, 32, 16, None, "bf16_async"),
    (BF16, 48, 100, None, "plain"),          # N % 8 == 4
    (BF16, 1, 100, None, "plain"),
    (BF16, 20, 64, None, "plain"),           # D % 8 == 4, D >= 16
    (BF16, 128, 64, "x", "plain"),           # x off 16 bytes
    (BF16, 128, 64, "y", "plain"),           # y (or dy, dx) off 16 bytes
    (BF16, 128, 64, "b", "plain"),           # b off 16 bytes
    (BF16, 128, 64, "c", "plain"),
    (F32, 128, 64, None, "f32_async"),       # today's float32 routes
    (F32, 48, 100, None, "f32_async"),       # N % 4 == 0 in float32
    (F32, 1, 384, None, "f32_async_bc"),
    (F32, 18, 100, None, "f32_async_bc"),
    (F32, 128, 64, "x", "f32_async_bc"),
    (F32, 128, 64, "y", "f32_async_bc"),
    (F32, 18, 98, None, "plain"),
    (F32, 128, 64, "c", "plain"),
])
def test_ssd_route_of(dtype, d, n, off, route):
    """The route by dtype, D, N and the pointers: 16-byte rows are 8
    bfloat16 or 4 float32 elements; "bf16_async" needs b's and c's rows
    on 16 bytes and x's (with y's, dy's and dx's) too unless D < 16."""
    ptrs = {"x": 4096, "y": 8192, "b": 12288, "c": 16384}
    if off is not None:
        ptrs[off] += dtype.itemsize        # one element past a boundary
    got = ssd_scan.route_of(dtype, d, n, ptrs["b"], ptrs["c"],
                            [ptrs["x"], ptrs["y"]])
    assert got == route
    assert route in ssd_scan.ROUTES
    # the C entry's code of each route: Route in csrc/ssd_chunk.cuh
    assert ssd_scan._ROUTE_CODE[route] == {
        "plain": 0, "f32_async_bc": 1, "f32_async": 2, "bf16_async": 3}[route]


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ssd_route_reads_the_tensors(dtype):
    """``ssd_route`` on tensors: fresh contiguous tensors are on 16 bytes;
    a contiguous view one element into a buffer is not."""
    b_, s, h, d, n = 1, 20, 2, 32, 16
    x, y = (torch.zeros(b_, s, h, d, dtype=dtype) for _ in range(2))
    bm, cm = (torch.zeros(b_, s, n, dtype=dtype) for _ in range(2))
    fast = "bf16_async" if dtype == BF16 else "f32_async"
    assert ssd_scan.ssd_route(x, bm, cm, y) == fast
    off = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert ssd_scan.ssd_route(x, bm, cm, off) == (
        "plain" if dtype == BF16 else "f32_async_bc")


def test_cpu_ssd_counts_no_route_launch():
    """The CPU path runs the plain version: no launch and no route is
    counted, forward or backward."""
    rng = np.random.default_rng(0)
    x, a, bm, cm = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(BF16) for sh in ((1, 70, 2, 16), (1, 70, 2),
                                         (1, 70, 8), (1, 70, 8)))
    a = -a.abs() * 0.1
    counts = lambda: ([c.count for c in ssd_scan.path_launches.values()],
                      [c.count for c in ssd_scan.bwd_path_launches.values()])
    before = counts()
    y = ops.ssd_scan(x, a, bm, cm)
    ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, torch.ones_like(y))
    assert counts() == before


def test_chip_smoke_holds_the_bf16_ssd_outputs_as_a_whole():
    """``chip_smoke._ssd_ok``, the check of every SSD run on the card: the
    plain version's own bfloat16 y and gradients pass (and y is the JAX
    reference's at the bfloat16 tolerance); a dx one bfloat16 step off on
    every element stays inside the elementwise 2e-2 x (1 + |g|) but fails
    ``SSD_BF16_KEEP`` on its norm; float32 is held elementwise at its keep
    limits, not on the norm."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    b_, s, h, d, n = 2, 130, 3, 32, 16
    ins = [rng.standard_normal((b_, s, h, d)) * 0.5,
           -np.abs(rng.standard_normal((b_, s, h))) * 0.1,
           rng.standard_normal((b_, s, n)) * n ** -0.25,
           rng.standard_normal((b_, s, n)) * n ** -0.25]
    x, a, bm, cm = (torch.from_numpy(t.astype(np.float32)).to(BF16)
                    for t in ins)
    y = ssd_scan.ssd_scan_plain(x, a, bm, cm)
    ref_y = np.asarray(jref.ssd_ref(*(jnp.asarray(t.float().numpy())
                                      for t in (x, a, bm, cm))))
    assert np.abs(y.float().numpy() - ref_y).max() <= 2e-2 * (
        1 + np.abs(ref_y).max())
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(
        np.float32)).to(BF16)
    grads = ssd_scan.ssd_scan_bwd_plain(x, a, bm, cm, y, dy)
    names = ("dx", "da", "db", "dc")
    ys, shapes = (tuple(y.shape),), tuple(tuple(t.shape)
                                          for t in (x, a, bm, cm))
    ok = lambda got, want, dtype=BF16, shapes=shapes: cs._ssd_ok(
        got, want, cs.ssd_errors(names if len(got) == 4 else ("y",), got,
                                 want), dtype, shapes)
    assert ok((y,), (y,), shapes=ys)
    assert ok(grads, grads)
    off = ((grads[0].float() * 1.01).to(BF16), *grads[1:])
    errs = cs.ssd_errors(names, off, grads)
    assert errs["dx"]["max_rel_err"] < 2e-2
    assert errs["dx"]["norm_rel_err"] > cs.SSD_BF16_KEEP["dx"]
    assert errs["da"]["norm_rel_err"] == errs["db"]["norm_rel_err"] == 0.0
    assert not ok(off, grads)
    # held to the inputs' dtype and shapes, not to the plain version's
    assert not ok((y.float(),), (y.float(),), shapes=ys)
    assert not ok((y[:, 1:],), (y[:, 1:],), shapes=ys)
    # float32: the same slip is held elementwise, at SSD_BWD_F32_KEEP
    g32 = tuple(t.float() for t in grads)
    off32 = (g32[0] * (1 + 1e-5), *g32[1:])
    assert ok(off32, g32, torch.float32)
    off32 = (g32[0] * (1 + 1e-3), *g32[1:])
    assert not ok(off32, g32, torch.float32)


def test_bf16_ssd_keep_sits_inside_the_tolerance():
    """One keep limit for y and each gradient, each inside the bfloat16
    SSD tolerance and above the float32 keep limits' scale of a correct
    kernel's rounding flips (the readings in chip_smoke's note)."""
    cs = _chip_smoke()
    assert set(cs.SSD_BF16_KEEP) == {"y", "dx", "da", "db", "dc"}
    assert all(1e-5 < v < cs.SSD_TOL["bfloat16"]
               for v in cs.SSD_BF16_KEEP.values())


@pytest.mark.parametrize("arch,dtype", [("zamba2-1.2b", "bfloat16"),
                                        ("xlstm-125m", "bfloat16"),
                                        ("zamba2-1.2b", "float32")])
@pytest.mark.parametrize("remat", [False, True])
def test_step_launches_put_bf16_ssd_on_its_route(arch, dtype, remat):
    """Phase 8's expected launches a step (``chip_smoke._step_launches``):
    a bfloat16 step's every SSD forward and backward on "bf16_async" and
    none on "plain"; a float32 step's on neither (its float32 routes)."""
    import dataclasses
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    per = cs._step_launches(cfg, remat)
    assert per["ssd_scan"] > 0 and per["ssd_scan_bwd"] > 0
    assert per["ssd_plain"] == per["ssd_bwd_plain"] == 0
    bf16 = dtype == "bfloat16"
    assert per["ssd_bf16_async"] == (per["ssd_scan"] if bf16 else 0)
    assert per["ssd_bwd_bf16_async"] == (per["ssd_scan_bwd"] if bf16 else 0)
    assert set(per) >= {f"ssd_{r}" for r in cs.TRAIN_SSD_ROUTES}
