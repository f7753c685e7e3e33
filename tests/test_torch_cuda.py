"""The CUDA kernels on the card, against their plain versions.

Skipped where there is no CUDA card (the kernels have no CPU mode); on the
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Beside the kernels: the MoE block on the card against its CPU path, the
memory a stacked bfloat16 initialisation needs, and reduced models (with
the vlm and audio frontend prefix too) on the card against the CPU path.
This file imports no jax: the machine with the card need not have it.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.kernels import (copy, matmul, ops, ref, slstm_scan,
                                 ssd_scan, stencil)
from repro_torch.models import init_moe, moe_block
from repro_torch.models.layers import init_linear
from repro_torch.kernels.flash_attention import (bwd_launches,
                                                 bwd_path_launches,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_bwd_path, launches,
                                                 path_launches)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(card, b, hq, hkv, s, t, d, dtype):
    g = torch.Generator(device=card)
    g.manual_seed(s * 7 + t)
    return [torch.randn(shape, generator=g, device=card).to(dtype)
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", [
    (1, 32, 8, 256, 256, 128, True),
    (1, 32, 32, 300, 300, 64, True),    # zamba2's shared attention, ragged
    (2, 32, 32, 2048, 2048, 64, True),  # musicgen-large's training shape
    (2, 8, 2, 100, 100, 64, True),
    (1, 4, 1, 37, 301, 32, True),
    (1, 8, 8, 130, 70, 128, False),
    (1, 32, 32, 300, 300, 80, True),    # stablelm-3b's heads, ragged
    (1, 40, 8, 256, 256, 128, True),    # qwen2.5-14b's: GQA group 5
    (1, 10, 2, 130, 70, 80, False),     # D = 80, group 5, non-causal
])
def test_flash_kernel_matches_plain(card, dtype, tol, b, hq, hkv, s, t, d,
                                    causal):
    q, k, v = _qkv(card, b, hq, hkv, s, t, d, dtype)
    before = launches.count
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# stablelm-3b's head dim 80 (32 heads over 32) and qwen2.5-14b's GQA group
# of 5 (40 heads over 8): aligned and ragged, T > S, non-causal, one tile
D80_GROUP5_CASES = [
    (1, 32, 32, 1024, 1024, 80, True),  # stablelm-3b's prefill
    (2, 4, 4, 100, 100, 80, True),      # D = 80, ragged S = T
    (1, 8, 2, 37, 301, 80, True),       # D = 80, T > S, both ragged
    (1, 8, 8, 130, 70, 80, False),      # D = 80, non-causal, T < S
    (1, 4, 4, 40, 40, 80, True),        # D = 80, S < 64: one ragged tile
    (1, 40, 8, 1024, 1024, 128, True),  # qwen2.5-14b's prefill, group 5
    (1, 10, 2, 300, 300, 80, True),     # group 5 at D = 80, ragged
    (2, 10, 2, 200, 330, 128, False),   # group 5, non-causal, T > S
]


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", [
    (1, 32, 8, 1024, 1024, 128, True),  # granite-8b's heads, GQA group 4
    (1, 8, 8, 256, 256, 32, True),      # D = 32, group 1
    (1, 8, 2, 256, 256, 64, True),      # D = 64, group 4
    (2, 4, 4, 100, 100, 128, True),     # ragged S = T
    (1, 8, 2, 37, 301, 64, True),       # T > S, both ragged
    (1, 8, 8, 200, 520, 32, True),      # T > S
    (1, 8, 2, 130, 70, 128, False),     # non-causal, T < S
    (1, 4, 1, 64, 64, 32, False),       # one tile
    (1, 32, 4, 1024, 1024, 128, True),  # qwen3-moe's heads, GQA group 8
    (1, 16, 16, 300, 300, 128, True),   # moonshot's heads, ragged
    (1, 64, 8, 1280, 1280, 128, True),  # internvl2's: P 256 + 1024
    (1, 64, 8, 556, 556, 128, True),    # the same, P 256 + 300: ragged
    (2, 64, 8, 200, 330, 128, True),    # the same, T > S, B 2
] + D80_GROUP5_CASES)
def test_flash_bf16_takes_the_wgmma_path(card, b, hq, hkv, s, t, d, causal):
    q, k, v = _qkv(card, b, hq, hkv, s, t, d, torch.bfloat16)
    before = (launches.count, path_launches["wgmma"].count)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (launches.count, path_launches["wgmma"].count) == (before[0] + 1,
                                                              before[1] + 1)
    want = flash_attention_plain(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert bool((err <= 2e-2 * (1 + want.float().abs())).all())


# the D-80 wgmma tile is a 128-byte-swizzled box of columns 0..63 and a
# 32-byte-swizzled box of columns 64..79: inputs live in one part only, so
# a box loaded at the wrong column or read in the wrong swizzle shows
D80_PARTS = {"tail": slice(64, 80), "wide": slice(0, 64)}


def _d80_part(xs, part):
    out = []
    for x in xs:
        y = torch.zeros_like(x)
        y[..., D80_PARTS[part]] = x[..., D80_PARTS[part]]
        out.append(y)
    return out


@pytest.mark.parametrize("part", sorted(D80_PARTS))
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", [
    (1, 8, 8, 300, 300, 80, True),      # ragged S = T
    (1, 10, 2, 130, 300, 80, False),    # group 5, non-causal, T > S
])
def test_flash_bf16_d80_reads_each_part_of_the_tile(card, part, b, hq, hkv,
                                                    s, t, d, causal):
    q, k, v = _d80_part(_qkv(card, b, hq, hkv, s, t, d, torch.bfloat16),
                        part)
    before = path_launches["wgmma"].count
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert path_launches["wgmma"].count == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2e-2 * (1 + want.float().abs())).all()), float(
        err.max())
    other = [c for c in range(d) if c not in range(80)[D80_PARTS[part]]]
    assert not bool(got[..., other].any())


def _off16(x):
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    flat.copy_(x.reshape(-1))
    return flat.view(x.shape)


def test_flash_bf16_off_a_16_byte_boundary_takes_the_fma_path(card):
    q, k, v = _qkv(card, 1, 4, 2, 128, 128, 64, torch.bfloat16)
    q_off = _off16(q)
    assert q_off.data_ptr() % 16 and q_off.is_contiguous()
    before = path_launches["fma"].count
    got = flash_attention(q_off, k, v)
    torch.cuda.synchronize()
    assert path_launches["fma"].count == before + 1
    torch.testing.assert_close(got.float(), flash_attention(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("offset,path", [(False, "tf32x3"), (True, "fma")])
def test_flash_float32_takes_the_fma_path(card, offset, path):
    """float32 on 16-byte boundaries takes the 3xTF32 kernel; with q off
    one, the FMA kernel."""
    q, k, v = _qkv(card, 1, 4, 2, 128, 128, 64, torch.float32)
    if offset:
        q = _off16(q)
        assert q.data_ptr() % 16 and q.is_contiguous()
    before = {p: c.count for p, c in path_launches.items()}
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert {p: c.count - before[p] for p, c in path_launches.items()} == {
        p: int(p == path) for p in path_launches}
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-4)


FLASH_F32_KEEP = 2e-5   # the float32 error under which 3xTF32 is kept


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", [
    (1, 32, 8, 1024, 1024, 128, True),  # granite-8b's heads, GQA group 4
    (1, 32, 32, 1024, 1024, 64, True),  # zamba2-1.2b's shared attention
    (2, 32, 32, 2048, 2048, 64, True),  # musicgen-large's training shape
    (1, 8, 8, 256, 256, 32, True),      # D = 32, group 1
    (1, 8, 2, 256, 256, 64, True),      # D = 64, group 4
    (2, 4, 4, 100, 100, 128, True),     # ragged S = T
    (1, 8, 2, 37, 301, 64, True),       # T > S, both ragged
    (1, 8, 8, 200, 520, 32, True),      # T > S
    (1, 8, 2, 130, 70, 128, False),     # non-causal, T < S
    (1, 4, 1, 300, 300, 128, False),    # non-causal, ragged, group 4
    (1, 4, 1, 40, 40, 32, True),        # S < 64: one ragged tile
    (2, 8, 2, 1, 65, 64, True),         # one query row
] + D80_GROUP5_CASES)
def test_flash_float32_takes_the_tf32x3_path(card, b, hq, hkv, s, t, d,
                                             causal):
    q, k, v = _qkv(card, b, hq, hkv, s, t, d, torch.float32)
    before = (launches.count, path_launches["tf32x3"].count)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (launches.count, path_launches["tf32x3"].count) == (before[0] + 1,
                                                               before[1] + 1)
    want = flash_attention_plain(q, k, v, causal=causal)
    err = (got - want).abs()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert bool((err <= FLASH_F32_KEEP * (1 + want.abs())).all())


@pytest.mark.parametrize("scale", [0.3, -0.3])
def test_flash_float32_explicit_scale(card, scale):
    """The 3xTF32 kernel folds the scale into q: a given scale, of either
    sign, gives the plain version's result."""
    q, k, v = _qkv(card, 1, 4, 2, 130, 130, 64, torch.float32)
    got = flash_attention(q, k, v, scale=scale)
    want = flash_attention_plain(q, k, v, scale=scale)
    assert bool(((got - want).abs() <= FLASH_F32_KEEP * (1 + want.abs()))
                .all())


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float32, 48),
                                     (torch.float32, 96), (torch.bfloat16, 96)])
def test_flash_kernel_refuses_what_it_does_not_take(card, dtype, d):
    """A dtype or a head size the kernels have no instantiation for raises,
    forward and backward: no quiet plain path, no padding."""
    q, k, v = _qkv(card, 1, 4, 2, 64, 64, d, dtype)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, q, q)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", D80_GROUP5_CASES)
def test_flash_d80_and_group5_off_16_bytes_take_the_fma_path(
        card, dtype, tol, b, hq, hkv, s, t, d, causal):
    q, k, v = _qkv(card, b, hq, hkv, s, t, d, dtype)
    k = _off16(k)
    before = {p: c.count for p, c in path_launches.items()}
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert {p: c.count - before[p] for p, c in path_launches.items()} == {
        p: int(p == "fma") for p in path_launches}
    want = flash_attention_plain(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol * (1 + want.float().abs())).all())


SSD_F32_KEEP = 3e-4   # the float32 error under which 3xTF32 is kept


def _ssd_inputs(card, b, s, h, d, n, dtype, strong=False):
    g = torch.Generator(device=card)
    g.manual_seed(s * 31 + d + n)
    rn = lambda *shape: torch.randn(shape, generator=g, device=card)
    if strong:       # down to log 1e-6 a token, as mLSTM's forget gate
        a = -13.8 * torch.rand((b, s, h), generator=g, device=card)
    else:
        a = -rn(b, s, h).abs() * 0.1
    return [t.to(dtype) for t in (rn(b, s, h, d) * 0.5, a,
                                  rn(b, s, n) * n ** -0.25,
                                  rn(b, s, n) * n ** -0.25)]


SSD_FWD_CASES = [      # (b, s, h, d, n, strong)
    (1, 256, 32, 128, 64, False),     # zamba2's heads
    (1, 300, 32, 128, 64, False),     # ragged S
    (4, 200, 1, 384, 384, True),      # mLSTM values, strong decay
    (4, 130, 1, 1, 384, True),        # mLSTM normalizer (D = 1)
    (2, 37, 4, 32, 16, False),        # S shorter than one chunk
    (3, 150, 2, 48, 100, False),      # D and N the tiles do not divide
    (1, 4096, 32, 128, 64, False),    # 64 chunks of state passing
    (2, 1024, 32, 128, 64, True),     # B > 1 and H > 1, states underflow
    (4, 1024, 1, 1, 384, True),       # the normalizer at the served length
    (2, 300, 3, 18, 98, False),       # D, N off 16 bytes: plain loads
    (1, 40, 2, 1, 100, True),         # S < 64 with D = 1
    (1, 130, 2, 16, 4096, False),     # N wider than shared memory's tiles
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,d,n,strong", SSD_FWD_CASES)
def test_ssd_kernel_matches_plain(card, dtype, tol, b, s, h, d, n, strong):
    x, a, bm, cm = _ssd_inputs(card, b, s, h, d, n, dtype, strong)
    before = ssd_scan.launches.count
    got = ops.ssd_scan(x, a, bm, cm)
    torch.cuda.synchronize()
    assert ssd_scan.launches.count == before + 1
    want = ssd_scan.ssd_scan_plain(x, a, bm, cm)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.float32:    # 3xTF32 is kept only this far inside
        torch.testing.assert_close(got, want, rtol=SSD_F32_KEEP,
                                   atol=SSD_F32_KEEP)
    else:                         # and bfloat16 this far, as a whole
        assert _norm_rel(got, want) <= SSD_BF16_KEEP["y"]


def _norm_rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _off16_copy(t):
    """t's values in a contiguous tensor off a 16-byte boundary (2 bytes
    past one)."""
    base = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = base[1:1 + t.numel()].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16
    return off


SSD_ROUTE_CASES = [     # (b, s, h, d, n, which input off 16 bytes, route)
    (1, 256, 32, 128, 64, None, "bf16_async"),   # zamba2's heads
    (4, 130, 1, 1, 384, None, "bf16_async"),     # the mLSTM normalizer
    (4, 130, 1, 1, 384, "x", "bf16_async"),      # ... its x read by loads
    (2, 100, 3, 8, 32, None, "bf16_async"),      # D = 8: narrow, x's rows
                                                 # on 16 bytes
    (2, 37, 4, 32, 16, None, "bf16_async"),      # S shorter than a chunk
    (3, 150, 2, 48, 100, None, "plain"),         # N % 8 == 4
    (1, 130, 2, 1, 100, None, "plain"),          # ... with D = 1
    (2, 300, 2, 20, 64, None, "plain"),          # D % 8 == 4, D >= 16
    (1, 256, 4, 128, 64, "x", "plain"),          # x off 16 bytes
    (1, 256, 4, 128, 64, "c", "plain"),          # c off 16 bytes
]


def _ssd_route_inputs(card, b, s, h, d, n, off):
    """The bfloat16 inputs of a ``SSD_ROUTE_CASES`` case (``off``: the one
    copied off a 16-byte boundary) and its dy."""
    ins = _ssd_inputs(card, b, s, h, d, n, torch.bfloat16)
    if off is not None:
        i = "xabc".index(off)
        ins[i] = _off16_copy(ins[i])
    g = torch.Generator(device=card)
    g.manual_seed(s + d + n)
    dy = torch.randn((b, s, h, d), generator=g, device=card).to(
        torch.bfloat16)
    return (*ins, dy)


@pytest.mark.parametrize("b,s,h,d,n,off,route", SSD_ROUTE_CASES)
def test_ssd_bf16_takes_its_route(card, b, s, h, d, n, off, route):
    """A bfloat16 scan on the route ``ssd_route`` names: "bf16_async" where
    b's and c's rows are on 16 bytes (N a multiple of 8) and x's too or D
    is below 16, else "plain"; one launch on it forward and backward, each
    against the plain version at 2e-2 x (1 + |v|) and ``SSD_BF16_KEEP``."""
    x, a, bm, cm, dy = _ssd_route_inputs(card, b, s, h, d, n, off)
    assert ssd_scan.ssd_route(x, bm, cm) == route
    counts = lambda: ({k: c.count for k, c in ssd_scan.path_launches.items()},
                      {k: c.count
                       for k, c in ssd_scan.bwd_path_launches.items()})
    fwd0, bwd0 = counts()
    y, saved = ssd_scan.ssd_scan_keep(x, a, bm, cm)
    got = ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, dy, saved=saved)
    torch.cuda.synchronize()
    fwd1, bwd1 = counts()
    assert {k: fwd1[k] - fwd0[k] for k in fwd0 if fwd1[k] != fwd0[k]} == {
        route: 1}
    assert {k: bwd1[k] - bwd0[k] for k in bwd0 if bwd1[k] != bwd0[k]} == {
        route: 1}
    want_y = ssd_scan.ssd_scan_plain(x, a, bm, cm)
    want = ssd_scan.ssd_scan_bwd_plain(x, a, bm, cm, y, dy)
    for name, u, v in (("y", y, want_y), *zip(("dx", "da", "db", "dc"), got,
                                              want)):
        assert u.dtype == torch.bfloat16 and torch.isfinite(u).all()
        err = (u.float() - v.float()).abs()
        assert bool((err <= 2e-2 * (1 + v.float().abs())).all()), name
        assert _norm_rel(u, v) <= SSD_BF16_KEEP[name], name


@pytest.mark.parametrize("b,s,h,d,n", [
    (2, 300, 4, 128, 64),     # zamba2's heads, ragged
    (2, 200, 1, 384, 384),    # the mLSTM values
    (2, 130, 3, 48, 96),      # D and N the tiles do not divide
])
def test_ssd_bf16_route_computes_what_the_plain_route_does(card, b, s, h, d,
                                                          n):
    """"bf16_async" drops only products with an exactly zero low part and
    keeps every sum's order, so on x off 16 bytes (the "plain" route, the
    same values in float tiles) the forward's scratch (C . B^T, Acum, the
    chunk states) and y are bit for bit the same, and so is the backward
    on the same kept scratch."""
    x, a, bm, cm = _ssd_inputs(card, b, s, h, d, n, torch.bfloat16, True)
    xo = _off16_copy(x)
    assert ssd_scan.ssd_route(x, bm, cm) == "bf16_async"
    assert ssd_scan.ssd_route(xo, bm, cm) == "plain"
    y, saved = ssd_scan.ssd_scan_keep(x, a, bm, cm)
    yo, saved_o = ssd_scan.ssd_scan_keep(xo, a, bm, cm)
    torch.cuda.synchronize()
    assert torch.equal(saved, saved_o)
    assert torch.equal(y, yo)
    g = torch.Generator(device=card)
    g.manual_seed(7)
    dy = torch.randn(y.shape, generator=g, device=card).to(torch.bfloat16)
    got = ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, dy, saved=saved)
    plain = ssd_scan.ssd_scan_bwd(xo, a, bm, cm, y, dy, saved=saved)
    torch.cuda.synchronize()
    for name, u, v in zip(("dx", "da", "db", "dc"), got, plain):
        assert torch.equal(u, v), name


def test_ssd_kernel_refuses_what_it_does_not_take(card):
    x, a, bm, cm = _ssd_inputs(card, 1, 64, 2, 16, 8, torch.float32)
    with pytest.raises(ValueError):                      # float16
        ops.ssd_scan(*(t.half() for t in (x, a, bm, cm)))
    with pytest.raises(ValueError):                      # mixed devices
        ops.ssd_scan(x, a.cpu(), bm, cm)
    with pytest.raises(ValueError):                      # b and c differ
        ops.ssd_scan(x, a, bm, cm[:, :, :4])
    with pytest.raises(ValueError):                      # a does not fit x
        ops.ssd_scan(x, a[:, :, :1], bm, cm)
    # B * ceil(S / 64) chunks past a grid dimension (65535)
    many = [torch.zeros(shape, device=card) for shape in
            ((65536, 64, 1, 4), (65536, 64, 1), (65536, 64, 4),
             (65536, 64, 4))]
    with pytest.raises(ValueError):
        ops.ssd_scan(*many)


def test_ssd_kernel_reads_no_stale_scratch(card):
    """The passes' scratch is ``torch.empty``: every pass writes all that a
    later one reads.  A block of NaNs freed just before the call (the
    caching allocator hands it out again), then a second call on other
    inputs, each against the plain version; each call counts one launch
    for its four passes."""
    shapes = (1, 300, 4, 64, 64)
    poison = torch.full((ssd_scan.scratch_floats(*shapes),), float("nan"),
                        device=card)
    del poison
    for strong in (False, True):
        x, a, bm, cm = _ssd_inputs(card, *shapes, torch.float32, strong)
        before = ssd_scan.launches.count
        got = ops.ssd_scan(x, a, bm, cm)
        torch.cuda.synchronize()
        assert ssd_scan.launches.count == before + 1
        want = ssd_scan.ssd_scan_plain(x, a, bm, cm)
        torch.testing.assert_close(got, want, rtol=SSD_F32_KEEP,
                                   atol=SSD_F32_KEEP)


def test_kernels_refuse_inputs_that_need_a_gradient(card):
    """No kernel answers an input that requires grad with a result cut off
    from autograd: flash attention and the SSD scan have backwards, so
    their outputs carry a ``grad_fn`` (``FlashAttention``, ``SSDScan``);
    the node kernels, which have none, refuse (the test after the node
    kernels').  With no gradient asked, each forward kernel runs once and
    saves nothing."""
    q, k, v = _qkv(card, 1, 4, 2, 64, 64, 32, torch.float32)
    x, a, bm, cm = _ssd_inputs(card, 1, 64, 2, 16, 8, torch.float32)
    assert flash_attention(q.requires_grad_(), k, v).grad_fn is not None
    out = ops.ssd_scan(x, a, bm.requires_grad_(), cm)
    assert isinstance(out.grad_fn, ssd_scan.SSDScan._backward_cls)
    with torch.no_grad():                 # no gradient asked: the kernel runs
        assert flash_attention(q, k, v).grad_fn is None
        before = ssd_scan.launches.count
        assert ops.ssd_scan(x, a, bm, cm).grad_fn is None
        assert ssd_scan.launches.count == before + 1


SSD_BWD_CASES = [       # (b, s, h, d, n, strong)
    (2, 2048, 32, 128, 64, False),    # zamba2's heads at its training shape
    (32, 512, 1, 384, 384, False),    # mLSTM values (B 8 x 4 heads folded)
    (32, 512, 1, 1, 384, True),       # mLSTM normalizer (D = 1)
    (1, 300, 32, 128, 64, False),     # ragged S
    (2, 37, 4, 32, 16, False),        # S shorter than one chunk
    (3, 150, 2, 48, 100, False),      # D and N the tiles do not divide
    (4, 300, 1, 384, 384, True),      # strong decay, down to log 1e-6
    (2, 1024, 32, 128, 64, True),     # B > 1 and H > 1, states underflow
]


def _ssd_bwd_inputs(card, b, s, h, d, n, dtype, strong):
    x, a, bm, cm = _ssd_inputs(card, b, s, h, d, n, dtype, strong)
    with torch.no_grad():
        y = ops.ssd_scan(x, a, bm, cm)
    g = torch.Generator(device=card)
    g.manual_seed(s * 13 + d + n)
    return x, a, bm, cm, y, torch.randn(y.shape, generator=g,
                                        device=card).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,d,n,strong", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain(card, dtype, tol, b, s, h, d, n,
                                      strong):
    """dx, da, db and dc of the backward kernel, reading the forward
    kernel's kept scratch (``ssd_scan_keep``, as training runs it),
    against its plain version at the SSD tolerance x (1 + |g|), float32
    also at ``chip_smoke.SSD_BWD_F32_KEEP`` x (1 + |g|); one call, one
    launch, and no forward launched by the backward."""
    ins = _ssd_bwd_inputs(card, b, s, h, d, n, dtype, strong)
    y, saved = ssd_scan.ssd_scan_keep(*ins[:4])
    assert torch.equal(y, ins[4])
    assert saved.numel() == ssd_scan.scratch_floats(b, s, h, d, n)
    before = (ssd_scan.launches.count, ssd_scan.bwd_launches.count)
    got = ssd_scan.ssd_scan_bwd(*ins, saved=saved)
    torch.cuda.synchronize()
    assert (ssd_scan.launches.count, ssd_scan.bwd_launches.count) == (
        before[0], before[1] + 1)
    want = ssd_scan.ssd_scan_bwd_plain(*ins)
    for name, g, w, like in zip(("dx", "da", "db", "dc"), got, want, ins):
        assert g.dtype == dtype and g.shape == like.shape
        assert torch.isfinite(g).all()
        err = (g.float() - w.float()).abs()
        assert bool((err <= tol * (1.0 + w.float().abs())).all()), float(
            err.max())
        if dtype == torch.float32:
            rel = float((err / (1.0 + w.float().abs())).max())
            assert rel <= SSD_BWD_F32_KEEP[name], (name, rel)
        else:
            assert _norm_rel(g, w) <= SSD_BF16_KEEP[name], name


@pytest.mark.parametrize("dtype,n", [(torch.float32, 100),
                                     (torch.bfloat16, 96)])
def test_ssd_bwd_kernel_repeats_bit_for_bit(card, dtype, n):
    """No atomics: the sums over heads and chunks have one order, so two
    runs on one input agree bit for bit (bfloat16 on "bf16_async")."""
    ins = _ssd_bwd_inputs(card, 2, 300, 4, 48, n, dtype, True)
    first = ssd_scan.ssd_scan_bwd(*ins)
    second = ssd_scan.ssd_scan_bwd(*ins)
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)


def test_ssd_bwd_reads_no_stale_scratch(card):
    """The backward's scratch is ``torch.empty``: a block of NaNs freed
    just before the call is handed out again (the forward's scratch, which
    a backward without ``saved`` runs the forward to fill, and the
    backward's own, one after the other), and no NaN comes through.  Kept
    scratch at the head of a larger buffer whose tail is NaN: the backward
    reads only its used part, and gives the same bits."""
    shapes = (1, 300, 4, 64, 64)
    fwd = ssd_scan.scratch_floats(*shapes)
    poison = torch.full((fwd + ssd_scan.bwd_scratch_floats(*shapes),),
                        float("nan"), device=card)
    del poison
    ins = _ssd_bwd_inputs(card, *shapes, torch.float32, False)
    got = ssd_scan.ssd_scan_bwd(*ins)
    torch.cuda.synchronize()
    want = ssd_scan.ssd_scan_bwd_plain(*ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-3, atol=3e-3)
    _, saved = ssd_scan.ssd_scan_keep(*ins[:4])
    padded = torch.full((fwd + 4096,), float("nan"), device=card)
    padded[:fwd] = saved
    poison = torch.full((ssd_scan.bwd_scratch_floats(*shapes),),
                        float("nan"), device=card)
    del poison, saved
    kept = ssd_scan.ssd_scan_bwd(*ins, saved=padded)
    torch.cuda.synchronize()
    for g, u in zip(kept, got):
        assert torch.equal(g, u)


def test_ssd_gradients_flow_through_the_kernels(card):
    """Autograd through ``ops.ssd_scan`` on the card launches the forward
    and the backward kernel once each and gives the plain version's
    gradients (float32, 3e-3)."""
    x, a, bm, cm = _ssd_inputs(card, 2, 200, 3, 32, 16, torch.float32)
    dy = torch.randn(x.shape, device=card)
    leaves = [t.clone().requires_grad_() for t in (x, a, bm, cm)]
    fwd, bwd = ssd_scan.launches.count, ssd_scan.bwd_launches.count
    out = ops.ssd_scan(*leaves)
    got = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    assert (ssd_scan.launches.count, ssd_scan.bwd_launches.count) == (
        fwd + 1, bwd + 1)
    want = ssd_scan.ssd_scan_bwd_plain(x, a, bm, cm, out.detach(), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-3, atol=3e-3)


FLASH_BWD_F32_KEEP = 4e-5   # the float32 error under which the 3xTF32
                            # backward is kept (a 1xTF32 slip exceeds it)
# the bfloat16 wgmma backward's ||g - plain|| / ||plain|| on each of dq, dk
# and dv: chip_smoke.py's
FLASH_BWD_BF16_KEEP = 5.5e-3
# the sLSTM kernels' float32 keep-limits, x (1 + |v|): chip_smoke.py's
SLSTM_F32_KEEP = {"fwd": 4.5e-5, "bwd": 1.2e-4}


def _slstm_inputs(card, b, s, d, dtype, random_carry, seed=0):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=card)
    gx, r = rn(b, s, 4, d), rn(4, d) * 0.1
    carry = ([rn(b, d) * 0.5, rn(b, d), rn(b, d).abs() + 1.0, rn(b, d)]
             if random_carry else [torch.zeros(b, d, device=card)] * 4)
    return gx.to(dtype), r.to(dtype), tuple(t.to(dtype) for t in carry)


def _slstm_grad_inputs(card, b, s, d, dtype, random_carry, seed):
    """``_slstm_inputs`` and a backward's output gradients, dhs [B, S, d]
    and the last carry's four [B, d], from a generator seeded ``seed +
    100``: the same inputs in every run, whatever ran before."""
    gx, r, carry = _slstm_inputs(card, b, s, d, dtype, random_carry, seed)
    g = torch.Generator(device=card)
    g.manual_seed(seed + 100)
    dhs = torch.randn((b, s, d), generator=g, device=card).to(dtype)
    dlast = tuple(torch.randn((b, d), generator=g, device=card).to(dtype)
                  for _ in range(4))
    return gx, r, carry, dhs, dlast


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,d,random_carry", [
    (1, 1024, 768, False),     # xlstm-125m's prefill
    (2, 2048, 768, False),     # its training shape
    (1, 1, 768, True),         # a decode step
    (3, 37, 100, True),        # ragged S, d off the warp's 32
    (2, 9, 33, False),
])
def test_slstm_kernels_match_plain(card, dtype, tol, b, s, d, random_carry):
    """The sLSTM forward kernel (hs, the last carry, the kept carry) and
    backward kernel (dgx, dr, the initial carry's gradient, on the
    kernel's own hs and kept carry) against their plain versions at tol x
    (1 + |v|), in float32 also at ``SLSTM_F32_KEEP`` (as ``chip_smoke.py``
    holds it; the plain backward computes in float64); one launch a call
    each (a d off 16 bytes through the wrapper's zero padding)."""
    gx, r, carry, dhs, dlast = _slstm_grad_inputs(card, b, s, d, dtype,
                                                  random_carry, s + d)
    counts = lambda: (slstm_scan.launches.count,
                      slstm_scan.bwd_launches.count)
    before = counts()
    hs, last, kept = slstm_scan.slstm_scan_keep(gx, r, carry)
    grads = slstm_scan.slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(counts(), before)) == (1, 1)
    want_hs, want_last, want_kept = slstm_scan.slstm_scan_plain(
        gx, r, carry, keep=True)
    want = slstm_scan.slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs,
                                           dlast)
    fwd = [(hs, want_hs), (kept, want_kept), *zip(last, want_last)]
    bwd = [(grads[0], want[0]), (grads[1], want[1]),
           *zip(grads[2], want[2])]
    for part, pairs in (("fwd", fwd), ("bwd", bwd)):
        for got, ref_ in pairs:
            assert got.dtype == ref_.dtype and got.shape == ref_.shape
            err = (got.float() - ref_.float()).abs() / (
                1 + ref_.float().abs())
            assert float(err.max()) <= tol
            if dtype == torch.float32:
                assert float(err.max()) <= SLSTM_F32_KEEP[part], part


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_kernels_repeat_bit_for_bit(card, dtype):
    """At xlstm-125m's training shape, the forward keeping the carry and
    the backward on its hs and kept carry, run 5 times on one input, give
    hs, the kept carry, the last carry, dgx, dr and the initial carry's
    gradient bit for bit alike (no atomics, one order for every sum)."""
    gx, r, carry, dhs, dlast = _slstm_grad_inputs(card, 2, 2048, 768, dtype,
                                                  False, 11)

    def run():
        hs, last, kept = slstm_scan.slstm_scan_keep(gx, r, carry)
        dgx, dr, dcarry = slstm_scan.slstm_scan_bwd(gx, r, carry, hs, kept,
                                                    dhs, dlast)
        return (hs, kept, *last, dgx, dr, *dcarry)

    first = run()
    for _ in range(4):
        again = run()
        torch.cuda.synchronize()
        for name, u, v in zip(("hs", "kept", "h", "c", "n", "m", "dgx", "dr",
                               "dh0", "dc0", "dn0", "dm0"), again, first):
            assert torch.equal(u, v), name


def test_slstm_kernels_take_an_input_off_16_bytes(card):
    """A contiguous gx (and dhs) that lies off a 16-byte boundary: the
    wrapper copies it first, and both kernels give what they give on an
    aligned copy, bit for bit."""
    b, s, d = 1, 40, 64
    gx, r, carry = _slstm_inputs(card, b, s, d, torch.float32, True, 9)
    base = torch.empty(gx.numel() + 1, device=card)
    off = base[1:].view(gx.shape)
    off.copy_(gx)
    assert off.data_ptr() % 16 and off.is_contiguous()
    n = slstm_scan.launches.count + slstm_scan.bwd_launches.count
    hs, last, kept = slstm_scan.slstm_scan_keep(off, r, carry)
    want_hs, want_last, want_kept = slstm_scan.slstm_scan_keep(gx, r, carry)
    dhs = torch.randn(b, s, d, device=card)
    dlast = tuple(torch.randn(b, d, device=card) for _ in range(4))
    dbase = torch.empty(dhs.numel() + 1, device=card)
    doff = dbase[1:].view(dhs.shape)
    doff.copy_(dhs)
    got = slstm_scan.slstm_scan_bwd(off, r, carry, hs, kept, doff, dlast)
    ref_ = slstm_scan.slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)
    torch.cuda.synchronize()
    assert slstm_scan.launches.count + slstm_scan.bwd_launches.count - n == 4
    assert torch.equal(hs, want_hs) and torch.equal(kept, want_kept)
    assert all(torch.equal(u, v) for u, v in zip(last, want_last))
    for u, v in zip((got[0], got[1], *got[2]), (ref_[0], ref_[1], *ref_[2])):
        assert torch.equal(u, v)


def test_slstm_kernel_refuses_what_it_does_not_take(card):
    gx, r, carry = _slstm_inputs(card, 1, 4, 32, torch.float32, True)
    with pytest.raises(ValueError):
        ops.slstm_scan(gx.half(), r.half(), tuple(t.half() for t in carry))
    with pytest.raises(ValueError):
        ops.slstm_scan(gx[:, :0], r, carry)
    with pytest.raises(ValueError):
        ops.slstm_scan(gx, r.cpu(), carry)


def test_slstm_gradients_flow_through_the_kernels(card):
    """Autograd through ``ops.slstm_scan`` on the card launches the forward
    (keeping the carry) and the backward once each, and gives the plain
    path's gradients on the CPU at 2e-4 x (1 + |g|)."""
    gx, r, carry = _slstm_inputs(card, 2, 50, 64, torch.float32, True)
    ins = [t.detach().requires_grad_() for t in (gx, r, *carry)]
    cpu = [t.detach().cpu().requires_grad_() for t in ins]
    fwd, bwd = slstm_scan.launches.count, slstm_scan.bwd_launches.count
    for xs in (ins, cpu):
        hs, last = ops.slstm_scan(xs[0], xs[1], tuple(xs[2:]))
        (hs.sum() + last[1].sum()).backward()
    assert (slstm_scan.launches.count - fwd,
            slstm_scan.bwd_launches.count - bwd) == (1, 1)
    for got, want in zip(ins, cpu):
        err = (got.grad.cpu() - want.grad).abs()
        assert bool((err <= 2e-4 * (1 + want.grad.abs())).all())


def _bwd_inputs(card, b, hq, hkv, s, t, d, dtype, causal):
    q, k, v = _qkv(card, b, hq, hkv, s, t, d, dtype)
    with torch.no_grad():
        o = flash_attention(q, k, v, causal=causal)
    g = torch.Generator(device=card)
    g.manual_seed(s * 11 + t)
    return q, k, v, o, torch.randn(q.shape, generator=g,
                                   device=card).to(dtype)


@pytest.mark.parametrize("dtype,path,tol", [
    (torch.float32, "tf32x3", 2e-4),    # aligned float32: 3xTF32 mma.sync
    (torch.float32, "fma", 2e-4),       # q off a 16-byte boundary
    (torch.bfloat16, "wgmma", 2e-2),    # aligned bfloat16: TMA + wgmma
    (torch.bfloat16, "fma", 2e-2),      # q off a 16-byte boundary
])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", [
    (2, 32, 8, 256, 256, 128, True),
    (2, 32, 32, 2048, 2048, 64, True),  # musicgen-large's training shape
    (1, 8, 1, 300, 300, 64, True),      # GQA group 8, ragged
    (1, 4, 4, 37, 301, 32, True),       # S < T, end-aligned, group 1
    (1, 8, 2, 130, 70, 128, False),     # S > T
    (2, 4, 2, 40, 40, 64, True),        # S shorter than one tile
    (1, 8, 2, 33, 97, 128, True),       # one past 32-row / 32-key steps
    (1, 4, 1, 17, 17, 32, True),        # one past a 16-row q step
    (1, 32, 32, 300, 300, 80, True),    # stablelm-3b's heads, ragged
    (1, 4, 1, 37, 301, 80, True),       # D = 80, S < T
    (1, 8, 2, 130, 70, 80, False),      # D = 80, S > T
    (1, 4, 4, 17, 17, 80, True),        # D = 80, one past a 16-row step
    (1, 40, 8, 256, 256, 128, True),    # qwen2.5-14b's heads, GQA group 5
    (1, 10, 2, 130, 130, 80, True),     # group 5 at D = 80, ragged
    (1, 10, 2, 100, 356, 80, False),    # group 5 at D = 80, T > S, no mask
    (2, 10, 2, 40, 40, 80, True),       # group 5 at D = 80, S < 64
])
def test_flash_bwd_kernel_matches_plain(card, dtype, path, tol, b, hq, hkv,
                                        s, t, d, causal):
    q, k, v, o, do = _bwd_inputs(card, b, hq, hkv, s, t, d, dtype, causal)
    if path == "fma":
        q = _off16(q)
    assert flash_bwd_path(q, k, v, o, do) == path
    before = {p: c.count for p, c in bwd_path_launches.items()}
    total = bwd_launches.count
    got = flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert bwd_launches.count == total + 1
    assert {p: c.count - before[p] for p, c in bwd_path_launches.items()} == {
        p: int(p == path) for p in bwd_path_launches}
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        err = (g.float() - w.float()).abs()
        assert bool((err <= tol * (1 + w.float().abs())).all()), float(
            err.max())
        if path == "tf32x3":
            assert bool((err <= FLASH_BWD_F32_KEEP * (1 + w.abs())).all()), \
                float((err / (1 + w.abs())).max())
        if path == "wgmma":
            rel = float(torch.linalg.vector_norm(g.float() - w.float())
                        / torch.linalg.vector_norm(w.float()))
            assert rel <= FLASH_BWD_BF16_KEEP, (name, rel)


@pytest.mark.parametrize("part", sorted(D80_PARTS))
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", [
    (1, 8, 8, 300, 300, 80, True),      # ragged S = T
    (1, 10, 2, 130, 300, 80, False),    # group 5, non-causal, T > S
])
def test_flash_bwd_d80_reads_each_part_of_the_tile(card, part, b, hq, hkv,
                                                   s, t, d, causal):
    """dq, dk and dv from inputs live in one part of the D-80 tile only:
    the plain version's, and zero in the other part."""
    q, k, v, o, do = _d80_part(_bwd_inputs(card, b, hq, hkv, s, t, d,
                                           torch.bfloat16, causal), part)
    with torch.no_grad():
        o = flash_attention(q, k, v, causal=causal)
    assert flash_bwd_path(q, k, v, o, do) == "wgmma"
    got = flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    other = [c for c in range(d) if c not in range(80)[D80_PARTS[part]]]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w.float()).abs()
        assert bool((err <= 2e-2 * (1 + w.float().abs())).all()), (
            name, float(err.max()))
        rel = float(torch.linalg.vector_norm(g.float() - w.float())
                    / torch.linalg.vector_norm(w.float()))
        assert rel <= FLASH_BWD_BF16_KEEP, (name, rel)
        assert not bool(g[..., other].any()), name


@pytest.mark.parametrize("dtype,offset,d", [(torch.float32, False, 128),
                                            (torch.float32, True, 128),
                                            (torch.bfloat16, False, 128),
                                            (torch.bfloat16, False, 64),
                                            (torch.bfloat16, True, 128),
                                            (torch.float32, False, 80),
                                            (torch.bfloat16, False, 80),
                                            (torch.bfloat16, True, 80)])
def test_flash_bwd_kernel_repeats_bit_for_bit(card, dtype, offset, d):
    """No atomics: every gradient element is summed by one block in one
    order, so two runs on one input agree bit for bit, on every path."""
    q, k, v, o, do = _bwd_inputs(card, 2, 8, 2, 300, 300, d, dtype, True)
    if offset:
        q = _off16(q)
    first = flash_attention_bwd(q, k, v, o, do)
    second = flash_attention_bwd(q, k, v, o, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_gradients_flow_through_the_kernels(card):
    """Autograd through ``flash_attention`` on the card launches the
    forward and the backward kernel once each and gives the plain
    version's gradients (float32, 2e-4)."""
    q, k, v = _qkv(card, 1, 8, 2, 200, 200, 64, torch.float32)
    do = torch.randn(q.shape, device=card)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = launches.count, bwd_launches.count
    out = flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (launches.count, bwd_launches.count) == (fwd + 1, bwd + 1)
    want = flash_attention_bwd_plain(q, k, v, out.detach(), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def _randn(card, shape, dtype, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(1024, 1024, 1024), (256, 384, 128),
                                   (130, 200, 70), (37, 513, 129), (1, 1, 1),
                                   (64, 0, 32)])
def test_matmul_kernel_matches_plain(card, dtype, tol, m, k, n):
    # inputs N(0, 1) x K^-1/4 keep the partial sums of order one, as the
    # reference's 2e-4 assumes (chip_smoke.check_matmul says why)
    scale = max(k, 1) ** -0.25
    a = (_randn(card, (m, k), torch.float32, 1) * scale).to(dtype)
    b = (_randn(card, (k, n), torch.float32, 2) * scale).to(dtype)
    before = matmul.launches.count
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.launches.count == before + 1
    want = matmul.matmul_plain(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol * (1 + want.float().abs())).all())


def _matmul_case(card, m, k, n, dtype, seed=1):
    scale = max(k, 1) ** -0.25
    a = (_randn(card, (m, k), torch.float32, seed) * scale).to(dtype)
    b = (_randn(card, (k, n), torch.float32, seed + 1) * scale).to(dtype)
    return a, b


def _matmul_on_path(a, b, path, tol):
    before = (matmul.launches.count, matmul.path_launches[path].count)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert (matmul.launches.count,
            matmul.path_launches[path].count) == (before[0] + 1,
                                                  before[1] + 1)
    want = matmul.matmul_plain(a, b)
    assert got.dtype == a.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol * (1 + want.float().abs())).all())


@pytest.mark.parametrize("dtype,tol,path", [
    (torch.float32, 2e-4, "fma_pipelined"), (torch.bfloat16, 2e-2, "wgmma")])
@pytest.mark.parametrize("m,k,n", [
    (4096, 4096, 4096),                 # the node path's product
    (256, 512, 512), (128, 64, 256),    # whole tiles of both fast paths
    (300, 512, 200), (37, 4096, 264),   # TMA fills the edges with zeros
    (129, 72, 264), (1, 8, 8),          # one ragged K step; a single row
])
def test_matmul_fast_paths(card, dtype, tol, path, m, k, n):
    a, b = _matmul_case(card, m, k, n, dtype)
    assert matmul.matmul_path(a, b) == path
    _matmul_on_path(a, b, path, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n,offset", [
    (130, 200, 70, False),              # N is no multiple of 16 bytes
    (64, 34, 128, False),               # K is no multiple of 16 bytes
    (37, 513, 129, False),
    (256, 256, 256, True),              # a starts off a 16-byte boundary
])
def test_matmul_general_path(card, dtype, tol, m, k, n, offset):
    a, b = _matmul_case(card, m, k, n, dtype)
    if offset:
        flat = torch.empty(a.numel() + 1, dtype=dtype, device=card)[1:]
        flat.copy_(a.reshape(-1))
        a = flat.view(m, k)
        assert a.data_ptr() % 16 and a.is_contiguous()
    assert matmul.matmul_path(a, b) == "general"
    _matmul_on_path(a, b, "general", tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("shape", [(8192, 1024), (1000, 77), (12345,), ()])
def test_copy_kernel_is_exact_and_fresh(card, dtype, shape):
    x = (_randn(card, shape, torch.float32, 3) * 100).to(dtype)
    before = copy.launches.count
    got = ops.copy(x)
    torch.cuda.synchronize()
    assert copy.launches.count == before + 1
    assert got.dtype == dtype and torch.equal(got, copy.copy_plain(x))
    assert got.data_ptr() != x.data_ptr()
    keep = x.clone()
    got.zero_()
    assert torch.equal(x, keep)


def test_copy_kernel_from_an_unaligned_view(card):
    base = _randn(card, (4097,), torch.float32, 4)
    x = base[1:]                      # contiguous, 4 bytes off 16
    assert x.data_ptr() % 16
    assert torch.equal(ops.copy(x), x)


@pytest.mark.parametrize("stages,extra,offset", [
    (1, -1, 0),        # one byte under one stage
    (1, 0, 0),         # exactly one stage
    (1, 16, 0),        # one stage and one word
    (5, 7, 0),         # not a multiple of 16 bytes
    (1000, 48, 0),     # ranges that split stages
    (0, 1, 0),         # 1 byte
    (1, 16, 3),        # an unaligned view: bytes
])
def test_copy_kernel_at_the_ring_edges(card, stages, extra, offset):
    """Byte counts at the edges of the bulk copy ring's stages (``stages``
    stages of the kernel's own size, and ``extra`` bytes), exact and into
    a fresh buffer, one launch counted a call."""
    n_bytes = stages * copy.stage_bytes() + extra
    g = torch.Generator(device=card)
    g.manual_seed(n_bytes)
    base = torch.randint(0, 256, (n_bytes + offset,), generator=g,
                         device=card, dtype=torch.uint8)
    x = base[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = copy.launches.count
    got = ops.copy(x)
    torch.cuda.synchronize()
    assert copy.launches.count == before + 1
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    keep = x.clone()
    got.fill_(7)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 2048, 2048), (2, 512, 256),
                                   (2, 100, 70), (1, 33, 65), (3, 1, 1)])
def test_stencil_kernel_matches_plain(card, dtype, tol, shape):
    u = _randn(card, shape, dtype, 5)
    before = stencil.launches.count
    got = ops.stencil(u)
    torch.cuda.synchronize()
    assert stencil.launches.count == before + 1
    assert got.dtype == dtype
    for want in (stencil.stencil_plain(u), ref.stencil_ref(u)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_node_kernels_refuse_what_they_do_not_take(card):
    a = torch.zeros((4, 4), device=card)
    with pytest.raises(ValueError):
        ops.matmul(a.half(), a.half())
    with pytest.raises(ValueError):
        ops.matmul(a, a.cpu())
    with pytest.raises(ValueError):
        ops.stencil(a.half()[None])
    with pytest.raises(ValueError):
        ops.copy(a.T)


def test_node_kernels_refuse_inputs_that_need_a_gradient(card):
    a = torch.ones((8, 8), device=card, requires_grad=True)
    u = torch.ones((1, 8, 8), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        ops.matmul(a, a.detach())
    with pytest.raises(RuntimeError, match="backward"):
        ops.copy(a)
    with pytest.raises(RuntimeError, match="backward"):
        ops.stencil(u)
    with torch.no_grad():                 # no gradient asked: the kernel runs
        assert ops.matmul(a, a).grad_fn is None
        assert ops.copy(a).grad_fn is None
        assert ops.stencil(u).grad_fn is None


@pytest.mark.parametrize("s", [40, 1])      # 40: capacity slots; 1: pairs
def test_moe_block_on_the_card_matches_the_cpu_path(card, s):
    """A reduced MoE block (8 experts, top-2, a shared expert) in float32:
    the card's products against the CPU's, routing and all."""
    gen = torch.Generator().manual_seed(0)
    p = init_moe(64, 8, 128, 96, gen=gen, device="cpu")
    x = torch.randn((2, s, 64), generator=gen)
    want, aux_want = moe_block(p, x, top_k=2)
    got, aux = moe_block(to_torch(p, card), x.to(card), top_k=2)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux.cpu(), aux_want, rtol=1e-5, atol=0)


def test_stacked_bf16_init_holds_one_float32_slice_at_a_time(card):
    """A stacked bfloat16 leaf is drawn straight into bfloat16: the peak
    beside its final size stays within one slice in float32, far from a
    float32 copy of the stack."""
    shape, stack = (16, 512, 256), (8,)
    slice_f32 = 16 * 512 * 256 * 4               # 8 MiB
    final = 8 * 16 * 512 * 256 * 2              # 32 MiB
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    gen = torch.Generator(device=card).manual_seed(0)
    w = init_linear(shape, gen=gen, device=card, dtype=torch.bfloat16,
                    scale=0.5, stack=stack)
    torch.cuda.synchronize()
    assert w.dtype == torch.bfloat16 and w.shape == stack + shape
    assert torch.cuda.max_memory_allocated(card) - base <= final + slice_f32
    assert float(w.float().std()) == pytest.approx(0.5, rel=0.01)


def _train_batch(vocab, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, vocab, (2, 97), generator=g)
    return {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}


def test_grad_step_on_the_card_matches_the_cpu_path(card):
    """Reduced granite-8b's loss and gradients on the card (the flash
    kernels forward and backward) against the CPU path (the plain
    versions): the loss at rel 1e-5, each leaf at 1e-4 x its largest
    magnitude; one forward and one backward launch a layer, the backward
    on ``tf32x3``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import make_grad_step
    cfg = get_config("granite-8b").reduced()
    cpu = init_params(cfg, seed=3, device="cpu")
    gpu = to_torch(cpu, card)
    step = make_grad_step(cfg, remat=False)
    want, met_want = step(cpu, _train_batch(cfg.vocab, "cpu"))
    fwd, bwd = launches.count, bwd_launches.count
    bwd_x3 = bwd_path_launches["tf32x3"].count
    got, met = step(gpu, _train_batch(cfg.vocab, card))
    torch.cuda.synchronize()
    assert (launches.count - fwd, bwd_launches.count - bwd,
            bwd_path_launches["tf32x3"].count - bwd_x3) == (
        cfg.n_layers, cfg.n_layers, cfg.n_layers)
    assert float(met["loss"]) == pytest.approx(float(met_want["loss"]),
                                               rel=1e-5)
    for g, w in zip(leaves(got), leaves(want)):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


def test_train_step_as_dtensors_on_the_card_mesh_is_the_plain_step(card):
    """Reduced granite-8b's grad step and AdamW update as DTensors on the
    card's (1, 1) CUDA mesh (``make_host_mesh``; every leaf replicated,
    the flash and AdamW kernels through their sharding rules) against the
    same step on plain tensors: the loss, every gradient and every updated
    param bit for bit, and the same launches (a flash forward and backward
    a layer, an AdamW update a leaf, the norm's passes)."""
    import contextlib
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import (batch_specs, distribute,
                                      opt_moment_specs, param_specs,
                                      sharding_ctx)
    from repro_torch.train import make_grad_step
    cfg = get_config("granite-8b").reduced()
    counters = (launches, bwd_launches, adamw.launches, adamw.norm_launches)
    runs = []
    mesh = make_host_mesh()
    try:
        for on_mesh in (False, True):
            params = to_torch(init_params(cfg, seed=3, device="cpu"), card)
            opt = init_opt_state(params)
            batch = _train_batch(cfg.vocab, card)
            ctx = contextlib.nullcontext()
            if on_mesh:
                moments = opt_moment_specs(params, mesh)
                params = distribute(params, param_specs(params, mesh), mesh)
                opt = distribute(opt, {"m": moments, "v": moments,
                                       "step": ()}, mesh)
                batch = distribute(batch, batch_specs(batch, mesh), mesh)
                ctx = sharding_ctx(mesh)
            before = [c.count for c in counters]
            with ctx:
                grads, met = make_grad_step(cfg, remat=False)(params, batch)
                apply_updates(params, grads, opt, AdamWConfig())
            torch.cuda.synchronize()
            local = (lambda t: t.to_local()) if on_mesh else (lambda t: t)
            runs.append((local(met["loss"]).clone(),
                         [local(g).clone() for g in leaves(grads)],
                         [local(p).clone() for p in leaves(params)],
                         [c.count - b for c, b in zip(counters, before)]))
    finally:
        dist.destroy_process_group()
    (loss, grads, params, counts), (d_loss, d_grads, d_params, d_counts) = runs
    assert torch.equal(loss, d_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, d_grads))
    assert all(torch.equal(a, b) for a, b in zip(params, d_params))
    assert d_counts == counts
    assert counts[:2] == [cfg.n_layers, cfg.n_layers]
    assert counts[2] == len(params)


@pytest.mark.parametrize("arch,grad_tol", [("zamba2-1.2b", 3e-3),
                                           ("xlstm-125m", 1e-4)])
def test_ssd_model_trains_on_the_card(card, arch, grad_tol):
    """A reduced SSD model's grad step on the card (the SSD kernels forward
    and backward, and zamba2's flash kernels) against the CPU path (the
    plain versions): the loss at rel 1e-5, each leaf at ``grad_tol`` x its
    largest magnitude (``tests/test_torch_train.py``'s tolerances); one
    SSD forward and one backward launch per scan of the layer plan (a
    Mamba-2 layer one, an mLSTM layer two: no backward runs the forward
    again, it reads the kept scratch), one flash forward and backward per
    shared-block application, one sLSTM scan forward and backward per
    sLSTM layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, layer_plan
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import make_grad_step
    cfg = get_config(arch).reduced()
    plan = layer_plan(cfg)
    scans = plan.count("mamba2") + 2 * plan.count("mlstm")
    attn = plan.count("shared_attn")
    sl = plan.count("slstm")
    cpu = init_params(cfg, seed=3, device="cpu")
    gpu = to_torch(cpu, card)
    step = make_grad_step(cfg, remat=False)
    want, met_want = step(cpu, _train_batch(cfg.vocab, "cpu"))
    counters = (ssd_scan.launches, ssd_scan.bwd_launches, launches,
                bwd_launches, slstm_scan.launches, slstm_scan.bwd_launches)
    before = tuple(c.count for c in counters)
    got, met = step(gpu, _train_batch(cfg.vocab, card))
    torch.cuda.synchronize()
    after = tuple(c.count for c in counters)
    assert scans > 0 and (sl > 0) == (arch == "xlstm-125m")
    assert tuple(x - y for x, y in zip(after, before)) == (scans, scans,
                                                            attn, attn,
                                                            sl, sl)
    assert float(met["loss"]) == pytest.approx(float(met_want["loss"]),
                                               rel=1e-5)
    for g, w in zip(leaves(got), leaves(want)):
        assert g.device.type == "cuda"
        assert float((g.cpu() - w).abs().max()) <= grad_tol * float(
            w.abs().max())


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_cuda", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SMOKE = _chip_smoke()
# the reduced bfloat16 models' card-against-CPU limit on the median over
# tokens of each token's rel, where chip_smoke.py grounds it
BF16_REDUCED_TOL = _SMOKE.BF16_REDUCED_TOL
# the float32 error of the SSD backward, x (1 + |g|), per gradient, under
# which its 3xTF32 products are kept, grounded there too
SSD_BWD_F32_KEEP = _SMOKE.SSD_BWD_F32_KEEP
# the bfloat16 SSD kernels' ||g - plain|| / ||plain|| per output, likewise
SSD_BF16_KEEP = _SMOKE.SSD_BF16_KEEP


def _prefixed(cfg, device, seed=5):
    """A batch of 2 x 40 tokens and labels with a frontend prefix of the
    reduced config's 16 positions, N(0, 1), the same values everywhere."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (2, 41), generator=g)
    front = torch.randn((2, cfg.frontend_len, cfg.d_model), generator=g)
    return {"tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device), "frontend": front.to(device)}


@pytest.mark.parametrize("arch,dtype,path", [
    ("internvl2-76b", "bfloat16", "wgmma"),
    ("musicgen-large", "float32", "tf32x3")])
def test_prefixed_model_on_the_card_matches_the_cpu_path(card, arch, dtype,
                                                         path):
    """A reduced vlm / audio model with its frontend prefix on the card
    (the flash kernel, one launch a layer on its dtype's path) against the
    CPU path (the plain version), the same weights and prefix: the forward
    at every text token and prefill + 4 teacher-forced decode steps;
    float32 at rel 5e-3 of the largest logit, bfloat16 on the median over
    tokens of each token's rel at ``BF16_REDUCED_TOL``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.optim.adamw import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    cpu = init_params(cfg, seed=4, device="cpu")
    gpu = tree_map(lambda t: t.to(card), cpu)
    outs = []
    with torch.inference_mode():
        for params, dev in ((cpu, "cpu"), (gpu, card)):
            batch = _prefixed(cfg, dev)
            toks, front = batch["tokens"], batch["frontend"]
            before = (launches.count, path_launches[path].count)
            fwd, _ = forward(params, cfg, toks, front)
            if dev == card:
                torch.cuda.synchronize()
                assert (launches.count - before[0],
                        path_launches[path].count - before[1]) == (
                    cfg.n_layers, cfg.n_layers)
            logits, state = prefill(params, cfg, toks[:, :36], 60, front)
            assert int(state["kv"]["length"][0, 0]) == cfg.frontend_len + 36
            seq = [logits]
            for i in range(36, 40):
                logits, state = decode_step(params, cfg, state, toks[:, i])
                seq.append(logits)
            outs.append(torch.cat([fwd.reshape(-1, cfg.vocab),
                                   torch.cat(seq)]).double().cpu())
    want, got = outs
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        assert float((got - want).abs().max()) <= 5e-3 * float(
            want.abs().max())
    else:
        per_token = (got - want).abs().amax(-1) / want.abs().amax(-1)
        assert float(per_token.median()) < BF16_REDUCED_TOL


@pytest.mark.parametrize("arch", ["internvl2-76b", "musicgen-large"])
def test_prefixed_model_trains_on_the_card(card, arch):
    """A reduced vlm / audio model's grad step on a prefixed batch, in
    float32, on the card (the flash kernels forward and backward, all on
    ``tf32x3``, one each a layer) against the CPU path: the loss at rel
    1e-5, each leaf at 1e-4 x its largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import make_grad_step
    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, seed=3, device="cpu")
    gpu = to_torch(cpu, card)
    step = make_grad_step(cfg, remat=False)
    want, met_want = step(cpu, _prefixed(cfg, "cpu"))
    before = (launches.count, path_launches["tf32x3"].count,
              bwd_launches.count, bwd_path_launches["tf32x3"].count)
    got, met = step(gpu, _prefixed(cfg, card))
    torch.cuda.synchronize()
    after = (launches.count, path_launches["tf32x3"].count,
             bwd_launches.count, bwd_path_launches["tf32x3"].count)
    assert tuple(x - y for x, y in zip(after, before)) == (cfg.n_layers,) * 4
    assert float(met["loss"]) == pytest.approx(float(met_want["loss"]),
                                               rel=1e-5)
    for g, w in zip(leaves(got), leaves(want)):
        assert g.device.type == "cuda"
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


# -- AdamW's update and gradient norm (csrc/adamw.cu) ---------------------------

# (param dtype, gradient dtype): float32 (no master copy), bfloat16 with a
# float32 master copy, bfloat16 params with float32 gradients (the
# dry-run's accumulation step)
ADAMW_KINDS = {"float32": (torch.float32, torch.float32),
               "bfloat16": (torch.bfloat16, torch.bfloat16),
               "bfloat16_f32_grads": (torch.bfloat16, torch.float32)}
ADAMW_SIZES = {"one": 1, "seven": 7, "ragged": 4097, "large": (1 << 24) + 3}
ADAMW_OFF16 = "ragged"      # this leaf's tensors lie off a 16-byte boundary


def _adamw_off16(t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


def _adamw_tree(card, kind, seed=0):
    """Params of ``ADAMW_SIZES``' leaves in ``kind``'s dtype and their AdamW
    state (after ``init_opt_state``, moments drawn as after a few steps),
    the ``ADAMW_OFF16`` leaf's tensors all off 16 bytes."""
    from repro_torch.optim import init_opt_state
    pdt, _ = ADAMW_KINDS[kind]
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    params = {k: torch.randn(n, generator=g, device=card).to(pdt)
              for k, n in ADAMW_SIZES.items()}
    state = init_opt_state(params)
    for k, n in ADAMW_SIZES.items():
        state["m"][k] = torch.randn(n, generator=g, device=card) * 1e-3
        state["v"][k] = torch.rand(n, generator=g, device=card) * 1e-6
    params[ADAMW_OFF16] = _adamw_off16(params[ADAMW_OFF16])
    for key in ("m", "v", "master"):
        if key in state:
            state[key][ADAMW_OFF16] = _adamw_off16(state[key][ADAMW_OFF16])
    return params, state


def _adamw_grads(card, kind, scale, seed):
    _, gdt = ADAMW_KINDS[kind]
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    grads = {k: (torch.randn(n, generator=g, device=card) * scale).to(gdt)
             for k, n in ADAMW_SIZES.items()}
    grads[ADAMW_OFF16] = _adamw_off16(grads[ADAMW_OFF16])
    return grads


def _adamw_clone(tree):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _adamw_bits_equal(a, b) -> bool:
    from repro_torch.optim.adamw import leaves
    return all(x.dtype == y.dtype and torch.equal(
        x.reshape(-1).view(torch.int16 if x.element_size() == 2 else
                           torch.int32),
        y.reshape(-1).view(torch.int16 if y.element_size() == 2 else
                           torch.int32))
        for x, y in zip(leaves(a), leaves(b)))


ADAMW_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)


@pytest.mark.parametrize("kind", list(ADAMW_KINDS))
def test_adamw_kernel_is_the_eager_update_bit_for_bit(card, kind):
    """With the clip not binding (the clip factor exactly 1.0 whatever the
    norm's bits), 3 steps of ``apply_updates`` through the kernels equal
    the eager update (``apply_updates_plain``) bit for bit: moments, master
    copy, params; one update launch a leaf, one norm pass a leaf and one
    finalize a step."""
    from repro_torch.kernels import adamw
    from repro_torch.optim import AdamWConfig, apply_updates
    from repro_torch.optim.adamw import apply_updates_plain
    cfg = AdamWConfig(**ADAMW_OPT)
    params, state = _adamw_tree(card, kind)
    p2, s2 = _adamw_clone(params), _adamw_clone(state)
    if kind == "float32":
        assert "master" not in state
    for step in range(3):
        grads = _adamw_grads(card, kind, 1e-5, 10 + step)
        before = (adamw.launches.count, adamw.norm_launches.count)
        _, _, info = apply_updates(params, grads, state, cfg)
        torch.cuda.synchronize()
        assert (adamw.launches.count - before[0],
                adamw.norm_launches.count - before[1]) == (
            len(ADAMW_SIZES), len(ADAMW_SIZES) + 1)
        assert float(info["grad_norm"]) < cfg.clip_norm
        apply_updates_plain(p2, grads, s2, cfg)
        assert _adamw_bits_equal(params, p2)
        assert _adamw_bits_equal({k: state[k] for k in state if k != "step"},
                                 {k: s2[k] for k in s2 if k != "step"})


@pytest.mark.parametrize("kind", list(ADAMW_KINDS))
def test_adamw_kernel_with_the_clip_binding(card, kind):
    """With the clip binding, the kernel's leaf update and the eager one on
    the same scalars (the kernel's norm, its clip factor), bit for bit."""
    from repro_torch.kernels import adamw
    from repro_torch.optim import AdamWConfig, schedule
    from repro_torch.optim.adamw import leaves
    cfg = AdamWConfig(**ADAMW_OPT)
    params, state = _adamw_tree(card, kind, seed=1)
    p2, s2 = _adamw_clone(params), _adamw_clone(state)
    grads = _adamw_grads(card, kind, 1.0, 20)
    step = state["step"] + 1
    gnorm = adamw.global_norm(list(leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    assert float(scale) < 1.0
    scalars = (schedule(cfg, step), scale,
               1 - cfg.b1 ** step.to(torch.float32),
               1 - cfg.b2 ** step.to(torch.float32))
    consts = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                  weight_decay=cfg.weight_decay)
    for fn, (ps, st) in ((adamw.update, (params, state)),
                         (adamw.update_plain, (p2, s2))):
        masters = st.get("master", ps)
        with torch.no_grad():
            for k in ADAMW_SIZES:
                fn(ps[k], masters[k], grads[k], st["m"][k], st["v"][k],
                   *scalars, **consts)
    torch.cuda.synchronize()
    assert _adamw_bits_equal(params, p2)
    assert _adamw_bits_equal({k: state[k] for k in ("m", "v")},
                             {k: s2[k] for k in ("m", "v")})
    if "master" in state:
        assert _adamw_bits_equal(state["master"], s2["master"])


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_adamw_kernels_repeat_bit_for_bit(card, kind):
    """Two runs of the norm and of 2 steps of the update from one state
    and one set of gradients agree bit for bit."""
    from repro_torch.kernels import adamw
    from repro_torch.optim import AdamWConfig, apply_updates
    from repro_torch.optim.adamw import leaves
    cfg = AdamWConfig(**ADAMW_OPT)
    runs = []
    base = _adamw_tree(card, kind, seed=2)
    for _ in range(2):
        params, state = _adamw_clone(base[0]), _adamw_clone(base[1])
        norms = []
        for step in range(2):
            grads = _adamw_grads(card, kind, 1.0, 30 + step)
            norms.append(adamw.global_norm(list(leaves(grads))))
            apply_updates(params, grads, state, cfg)
        runs.append((params, state, norms))
    (pa, sa, na), (pb, sb, nb) = runs
    assert all(torch.equal(x, y) for x, y in zip(na, nb))
    assert _adamw_bits_equal(pa, pb)
    assert _adamw_bits_equal({k: sa[k] for k in sa if k != "step"},
                             {k: sb[k] for k in sb if k != "step"})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_norm_against_a_float64_sum(card, dtype):
    """The norm kernel over ~10^8 terms within rel 1e-6 of their sum in
    float64; the eager norm's own distance printed beside it (its float32
    sums run in another order, so it is no bit-for-bit yardstick)."""
    from repro_torch.kernels import adamw
    g = torch.Generator(device=card)
    g.manual_seed(5)
    grads = [torch.randn(n, generator=g, device=card).to(dtype)
             for n in ((1 << 26) + 5, 30_000_000, 4097, 1)]
    grads[2] = _adamw_off16(grads[2])
    want = torch.sqrt(sum(torch.sum(torch.square(t.double()))
                          for t in grads))
    got = adamw.global_norm(grads)
    eager = adamw.global_norm_plain(grads)
    rel = float(abs(got.double() - want) / want)
    rel_eager = float(abs(eager.double() - want) / want)
    print(f"adamw norm {dtype}: kernel rel {rel:.3e}, eager rel "
          f"{rel_eager:.3e} of the float64 sum")
    assert got.dtype == torch.float32 and got.dim() == 0
    assert rel <= 1e-6


def test_adamw_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels import adamw
    n = 64
    f32 = lambda: torch.zeros(n, device=card)
    one = torch.ones((), device=card)
    consts = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    p = f32()
    bad = [
        (p, p, torch.zeros(n, device=card, dtype=torch.float16), f32(), f32(),
         one, one, one, one),                              # float16 g
        (p, p, f32(), torch.zeros(2 * n, device=card)[::2], f32(), one, one,
         one, one),                                        # strided m
        (p, p, f32(), f32(), torch.zeros(n + 1, device=card), one, one, one,
         one),                                             # another shape
        (p, p, f32(), f32(), f32(), torch.ones(()), one, one, one),  # CPU lr
        (p, p, f32(), f32(), f32(), one, torch.ones(1, device=card), one,
         one),                                             # 1-d scale
    ]
    with torch.no_grad():
        for args in bad:
            with pytest.raises(ValueError):
                adamw.update(*args, **consts)
    with pytest.raises(ValueError):
        adamw.global_norm([f32(), torch.zeros(n)])         # two devices
    with pytest.raises(ValueError):
        adamw.global_norm([torch.zeros(n, device=card, dtype=torch.float16)])


# -- the decode step as captured CUDA graphs (serve/decode_graph.py) ----------

GRAPH_ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b",
               "xlstm-125m", "internvl2-76b"]
GRAPH_STEPS = 8
GRAPH_MAX_LEN = 64


def _graph_model(card, arch):
    """A reduced model of ``arch`` on the card (the MoE model at capacity
    16, where its prefill drops nothing) and a 20-token prefill's state
    and greedy token."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = init_params(cfg, seed=3, device=card)
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (1, 20), generator=g).to(card)
    with torch.inference_mode():
        logits, state = prefill(params, cfg, toks, GRAPH_MAX_LEN)
    return cfg, params, state, int(torch.argmax(logits[0]))


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def _bits_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _graphed(slot, state, tok, steps=GRAPH_STEPS):
    logits, toks = [], []
    for _ in range(steps):
        tok = slot.step(state, tok)
        logits.append(slot.logits.clone())
        toks.append(tok)
    return logits, toks


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_decode_graph_replay_is_the_eager_step_bit_for_bit(card, arch):
    """Each family's reduced model: ``GRAPH_STEPS`` greedy steps replayed
    from a slot's graph give the eager step's logits and tokens bit for
    bit, the eager step run on the stream the graph was captured on; the
    request's state ends where the eager one does; each replay adds the
    sLSTM launches its graph holds."""
    from repro_torch.models import decode_step, layer_plan
    from repro_torch.serve.decode_graph import DecodeSlot
    cfg, params, state, tok = _graph_model(card, arch)
    slot = DecodeSlot(params, cfg, GRAPH_MAX_LEN, card)
    assert slot.graph is not None and slot.capture_s > 0
    n_slstm = layer_plan(cfg).count("slstm")
    assert [(c, n) for c, n in slot.deltas] == (
        [(slstm_scan.launches, n_slstm)] if n_slstm else [])
    eager_state, graph_state = _tree_clone(state), _tree_clone(state)
    want, want_toks = [], []
    t = tok
    slot.stream.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(slot.stream):
        for _ in range(GRAPH_STEPS):
            logits, _ = decode_step(params, cfg, eager_state,
                                    torch.tensor([t], device=card))
            t = int(torch.argmax(logits[0]))
            want.append(logits.clone())
            want_toks.append(t)
    torch.cuda.current_stream().wait_stream(slot.stream)
    before = slstm_scan.launches.count
    got, got_toks = _graphed(slot, graph_state, tok)
    torch.cuda.synchronize()
    assert slstm_scan.launches.count - before == GRAPH_STEPS * n_slstm
    assert got_toks == want_toks
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    for key, sub in eager_state.items():
        for name, v in sub.items():
            assert _bits_equal(graph_state[key][name].float(), v.float()), (
                key, name)
    assert slot.replays == slot.steps == GRAPH_STEPS
    slot.close()


def test_decode_graphs_replayed_from_four_threads_at_once(card):
    """4 threads replay their own slots at once, each its own request, as
    the engine's 4 places do: each gets what its slot gives it alone."""
    import threading
    from repro_torch.serve.decode_graph import DecodeSlot
    cfg, params, state, tok = _graph_model(card, "xlstm-125m")
    slots = [DecodeSlot(params, cfg, GRAPH_MAX_LEN, card) for _ in range(4)]
    starts = []
    for i, slot in enumerate(slots):     # 4 requests: i steps further on
        st = _tree_clone(state)
        t = tok
        for _ in range(i):
            t = slot.step(st, t)
        starts.append((st, t))
    alone = [_graphed(slot, _tree_clone(st), t)
             for slot, (st, t) in zip(slots, starts)]
    together = [None] * 4
    errors = []

    def worker(i):
        try:
            st, t = starts[i]
            together[i] = _graphed(slots[i], _tree_clone(st), t)
        except Exception as e:          # surfaced below, with its thread
            errors.append((i, e))
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors
    for (g, g_toks), (w, w_toks) in zip(together, alone):
        assert g_toks == w_toks
        assert all(_bits_equal(a, b) for a, b in zip(g, w))
    for slot in slots:
        slot.close()


def test_engine_decode_graph_counters_and_launches(card):
    """Through the engine on the card: one slot a worker, each captured
    once; replays equal the decode steps; the sLSTM launches are the
    prefills' and the replays' (xlstm's reduced model)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tpu_pod_slices
    from repro_torch.models import layer_plan
    from repro_torch.serve import ServingEngine
    cfg = get_config("xlstm-125m").reduced()
    eng = ServingEngine(cfg, tpu_pod_slices(2, 2), scheduler="DAM-C",
                        max_len=48, device=card)
    stats = eng.decode_graph_stats()
    assert stats["slots"] == stats["captures"] == 4
    assert stats["replays"] == 0
    g = torch.Generator().manual_seed(1)
    reqs = [eng.submit(torch.randint(0, cfg.vocab, (16,), generator=g)
                       .numpy(), max_new_tokens=5) for _ in range(6)]
    slstm_scan.launches.reset()
    eng.run(timeout=300)
    n_decode = sum(len(r.out_tokens) - 1 for r in reqs)
    stats = eng.decode_graph_stats()
    assert n_decode == 24
    assert stats["replays"] == stats["steps"] == n_decode
    assert 1 <= stats["slots_in_use_max"] <= 4
    per_layer = layer_plan(cfg).count("slstm")
    assert slstm_scan.launches.count == per_layer * (len(reqs) + n_decode)
    eng.close()


def test_engine_decode_graphs_free_their_memory(card):
    """The slots' graphs, pools and buffers go with the engine: after
    ``close`` and ``empty_cache`` the allocated memory is back within 4 MB
    of what it was before the engine."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import tpu_pod_slices
    from repro_torch.serve import ServingEngine
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(card)
    cfg = get_config("granite-8b").reduced()
    eng = ServingEngine(cfg, tpu_pod_slices(2, 2), max_len=256, device=card)
    during = torch.cuda.memory_allocated(card)
    assert eng.decode_graph_stats()["captures"] == 4
    eng.close()
    del eng
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(card)
    assert during > before
    assert after - before <= 4 << 20, (before, during, after)


# -- the prefill as captured CUDA graphs (serve/prefill_graph.py) -------------

PREFILL_ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b",
                 "xlstm-125m"]
PREFILL_MAX_LEN = 64


def _prefill_model(card, arch):
    """A reduced model of ``arch`` on the card, the MoE model at the served
    capacity factor 1.25 (its prefill drops pairs)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    return cfg, init_params(cfg, seed=3, device=card)


def _prefill_prompt(cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed + n)
    return torch.randint(0, cfg.vocab, (n,), generator=g).numpy()


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_graph_replay_is_the_eager_padded_prefill_bit_for_bit(
        card, arch):
    """Prompts of 20, 32, 1 and 17 tokens through one bucket of 32: each
    replay's logits, token and decode state equal, bit for bit, the eager
    padded prefill's run on the stream the graph was captured on."""
    from repro_torch.models import pad_length, prefill
    from repro_torch.serve.prefill_graph import PrefillBucket
    cfg, params = _prefill_model(card, arch)
    bucket = PrefillBucket(params, cfg, 32, PREFILL_MAX_LEN, card)
    assert bucket.graph is not None and bucket.capture_s > 0
    for n in (20, 32, 1, 17):
        prompt = _prefill_prompt(cfg, n)
        state, tok = bucket.prefill(prompt)
        logits = bucket.logits.clone()
        ids = torch.zeros((1, 32), dtype=torch.int64)
        ids[0, :n] = torch.from_numpy(prompt)
        bucket.stream.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode(), torch.cuda.stream(bucket.stream):
            want, want_state = prefill(params, cfg, ids.to(card),
                                       PREFILL_MAX_LEN,
                                       length=pad_length(cfg, n, card))
        torch.cuda.current_stream().wait_stream(bucket.stream)
        assert tok == int(torch.argmax(want[0]))
        assert _bits_equal(logits, want)
        for key, sub in want_state.items():
            for name, v in sub.items():
                assert _bits_equal(state[key][name].float(), v.float()), (
                    n, key, name)
                if name in ("k", "v"):
                    assert bool((state[key][name][:, :, n:] == 0).all())
    assert bucket.replays == bucket.steps == 4
    bucket.close()


def test_prefill_graph_capture_leaves_the_params_untouched(card):
    """Capturing every bucket (its warm-up run and the capture) changes no
    bit of the params it reads."""
    from repro_torch.serve.engine import _bucket
    from repro_torch.serve.prefill_graph import PrefillGraphs
    for arch in ("qwen3-moe-30b-a3b", "xlstm-125m"):
        cfg, params = _prefill_model(card, arch)
        before = _tree_clone(params)
        graphs = PrefillGraphs(params, cfg, PREFILL_MAX_LEN, card, _bucket)
        torch.cuda.synchronize()
        assert graphs.stats()["captures"] == 3          # 16, 32, 64
        for a, b in zip(_param_leaves(params), _param_leaves(before)):
            assert _bits_equal(a.float(), b.float())
        graphs.close()


def _param_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _param_leaves(v)
    else:
        yield tree


def test_prefill_replays_add_the_launch_counts_their_capture_took_back(
        card):
    """zamba2's and xlstm's reduced models: a capture counts its warm-up's
    launches and takes the captured ones back; each replay adds the
    launches the layer plan gives a prefill (flash, the SSD scan, the
    sLSTM scan), and the engine's prefills are replays, one a prompt."""
    from repro_torch.core import tpu_pod_slices
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layer_plan
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.prefill_graph import WARMUP_RUNS, PrefillBucket
    for arch in ("zamba2-1.2b", "xlstm-125m"):
        cfg, params = _prefill_model(card, arch)
        plan = layer_plan(cfg)
        per = {fa.launches: sum(k in ("attn", "shared_attn") for k in plan),
               ssd_scan.launches: plan.count("mamba2")
               + 2 * plan.count("mlstm"),
               slstm_scan.launches: plan.count("slstm")}
        before = {c: c.count for c in per}
        bucket = PrefillBucket(params, cfg, 16, PREFILL_MAX_LEN, card)
        assert {c: c.count - n for c, n in before.items()} == {
            c: WARMUP_RUNS * n for c, n in per.items()}
        deltas = dict(bucket.deltas)
        assert {c: deltas.get(c, 0) for c in per} == per
        before = {c: c.count for c in per}
        for n in (3, 16, 9):
            bucket.prefill(_prefill_prompt(cfg, n))
        assert {c: c.count - n for c, n in before.items()} == {
            c: 3 * n for c, n in per.items()}
        bucket.close()
        eng = ServingEngine(cfg, tpu_pod_slices(2, 2), scheduler="DAM-C",
                            max_len=PREFILL_MAX_LEN, device=card)
        prompts = [_prefill_prompt(cfg, n, 5) for n in (5, 20, 40, 12, 60)]
        reqs = [eng.submit(p, max_new_tokens=2) for p in prompts]
        before = {c: c.count for c in per}
        eng.run(timeout=300)
        stats = eng.prefill_graph_stats()
        assert stats["captures"] == 3
        assert stats["replays"] == stats["steps"] == len(prompts)
        assert stats["steps_by_bucket"] == {16: 2, 32: 1, 64: 2}
        n_decode = sum(len(r.out_tokens) - 1 for r in reqs)
        assert {c: c.count - n for c, n in before.items()} == {
            c: n * len(prompts) + (n_decode * n if c is slstm_scan.launches
                                   else 0)
            for c, n in per.items()}
        eng.close()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,d,lengths", [
    (1, 1024, 768, (1,)), (1, 1024, 768, (1024,)),
    (3, 300, 768, (300, 1, 137)), (2, 70, 100, (70, 33))])
def test_slstm_kernel_with_lengths_matches_plain(card, dtype, tol, b, s, d,
                                                 lengths):
    """The forward kernel with a padded prefill's lengths against its plain
    version with them, at tol x (1 + |v|); one count a call; each row's
    run to its length is the unbounded kernel's on that row, bit for bit."""
    gx, r, carry = _slstm_inputs(card, b, s, d, dtype, True, seed=b + s)
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = slstm_scan.launches.count
    with torch.no_grad():
        hs, last = slstm_scan.slstm_scan(gx, r, carry, lengths=lens)
    assert slstm_scan.launches.count - before == 1
    want_hs, want_last = slstm_scan.slstm_scan_plain(gx, r, carry,
                                                     lengths=lens)
    for got, want in ((hs, want_hs), *zip(last, want_last)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= tol * (1 + want.float().abs())).all())
    with torch.no_grad():
        for row, n in enumerate(lengths):
            hs_c, last_c = slstm_scan.slstm_scan(
                gx[row:row + 1, :n].contiguous(), r,
                tuple(t[row:row + 1].contiguous() for t in carry))
            assert torch.equal(hs_c[0], hs[row, :n])
            assert all(torch.equal(u[0], v[row])
                       for u, v in zip(last_c, last))


# -- the train step as one captured CUDA graph (train/step_graph.py) ----------

TRAIN_GRAPH_STEPS = 4


def _train_graph_model(card, arch):
    """A reduced model of ``arch`` on the card, its optimizer and a batch
    maker laid out as ``train_batch_specs`` at B 2 x S 128."""
    from repro_torch.configs import InputShape, get_config, train_batch_specs
    from repro_torch.optim import AdamWConfig
    cfg = get_config(arch).reduced()
    specs = train_batch_specs(cfg, InputShape("train", "train", 128, 2))

    def batch(i):
        g = torch.Generator(device=card).manual_seed(50 + i)
        out = {k: torch.randint(0, cfg.vocab, v.shape, generator=g,
                                device=card, dtype=v.dtype)
               for k, v in specs.items() if k != "frontend"}
        if "frontend" in specs:
            out["frontend"] = torch.randn(specs["frontend"].shape,
                                          generator=g, device=card)
        return out
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    return cfg, opt, specs, batch


def _train_state(card, cfg):
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    params = init_params(cfg, seed=4, device=card)
    return params, init_opt_state(params)


def _trees_bit_equal(a, b) -> bool:
    from repro_torch.optim.adamw import leaves
    la, lb = list(leaves(a)), list(leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.detach().reshape(-1).view(torch.uint8),
                        y.detach().reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b", "xlstm-125m",
                                  "musicgen-large"])
def test_train_graph_is_the_eager_step_bit_for_bit(card, arch, remat):
    """``TRAIN_GRAPH_STEPS`` steps of a reduced model through a
    ``TrainStepGraph`` (step 1 its eager warm-up, then replays) against the
    eager ``make_train_step`` from the same init and batches: every metric
    and every leaf of the params and the optimizer state bit for bit after
    each step; each replay adds the launches its capture took."""
    from repro_torch.train import make_train_step
    from repro_torch.train.step_graph import TrainStepGraph
    cfg, opt, specs, batch = _train_graph_model(card, arch)
    params, state = _train_state(card, cfg)
    g_params, g_state = _train_state(card, cfg)
    eager = make_train_step(cfg, opt, remat=remat)
    graph = TrainStepGraph(cfg, opt, g_params, g_state, specs, remat=remat)
    for i in range(TRAIN_GRAPH_STEPS):
        params, state, want = eager(params, state, batch(i))
        got = graph.step(batch(i))
        for key, v in want.items():
            assert torch.equal(got[key], v), (i, key)
        assert _trees_bit_equal(g_params, params), i
        assert _trees_bit_equal(g_state, state), i
    assert graph.replays == TRAIN_GRAPH_STEPS - 1
    assert graph.pool_bytes > 0 and graph.capture_s > 0
    assert graph.deltas            # at least AdamW's kernels
    graph.close()


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b"])
def test_train_graph_capture_leaves_the_state_as_it_was(card, arch):
    """The capture records the step and runs none of it: every leaf of the
    params and the optimizer state, the step count among them, bit for bit
    as the warm-up step left it."""
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step_graph import TrainStepGraph
    cfg, opt, specs, batch = _train_graph_model(card, arch)
    params, state = _train_state(card, cfg)
    graph = TrainStepGraph(cfg, opt, params, state, specs, remat=True)
    graph.load(batch(0))
    graph._warm_up()
    before = tree_map(lambda t: t.detach().clone(),
                      {"params": params, "opt": state})
    graph._capture()
    torch.cuda.synchronize()
    assert graph.graph is not None
    assert _trees_bit_equal({"params": params, "opt": state}, before)
    assert int(state["step"]) == 1
    graph.close()


def test_train_graph_capture_holds_under_deterministic_algorithms(card):
    """The MoE path's backward (its scatter to capacity slots, gathered
    back) under ``torch.use_deterministic_algorithms(True)``, as
    ``chip_smoke.moe_bwd_determinism`` runs it: the captured step is the
    eager step in that mode, bit for bit."""
    from repro_torch.train import make_train_step
    from repro_torch.train.step_graph import TrainStepGraph
    cfg, opt, specs, batch = _train_graph_model(card, "qwen3-moe-30b-a3b")
    params, state = _train_state(card, cfg)
    g_params, g_state = _train_state(card, cfg)
    torch.use_deterministic_algorithms(True)
    try:
        eager = make_train_step(cfg, opt, remat=False)
        graph = TrainStepGraph(cfg, opt, g_params, g_state, specs,
                               remat=False)
        for i in range(3):
            params, state, want = eager(params, state, batch(i))
            got = graph.step(batch(i))
            assert torch.equal(got["loss"], want["loss"]), i
            assert _trees_bit_equal(g_state, state), i
    finally:
        torch.use_deterministic_algorithms(False)
    assert graph.replays == 2
    graph.close()


@pytest.mark.parametrize("first", ["decode", "train"])
def test_decode_slot_and_train_graph_close_in_either_order(card, first):
    """A decode slot and a train graph alive together count each other
    (``repro_torch/graphs.py``): closing the first leaves cuBLAS's
    workspaces, which the other reads, in place, so its replays stay the
    eager steps bit for bit; closing the second clears them."""
    from repro_torch import graphs
    from repro_torch.models import decode_step
    from repro_torch.serve.decode_graph import DecodeSlot
    from repro_torch.train import make_train_step
    from repro_torch.train.step_graph import TrainStepGraph
    live = graphs.live()
    cfg_d, params_d, state_d, tok = _graph_model(card, "granite-8b")
    slot = DecodeSlot(params_d, cfg_d, GRAPH_MAX_LEN, card)
    cfg, opt, specs, batch = _train_graph_model(card, "granite-8b")
    params, state = _train_state(card, cfg)
    g_params, g_state = _train_state(card, cfg)
    eager = make_train_step(cfg, opt, remat=False)
    graph = TrainStepGraph(cfg, opt, g_params, g_state, specs, remat=False)
    for i in range(2):                  # the warm-up, the capture, a replay
        params, state, _ = eager(params, state, batch(i))
        graph.step(batch(i))
    assert graphs.live() == live + 2
    (slot if first == "decode" else graph).close()
    assert graphs.live() == live + 1
    if first == "decode":
        for i in range(2, 4):
            params, state, want = eager(params, state, batch(i))
            got = graph.step(batch(i))
            assert torch.equal(got["loss"], want["loss"]), i
        assert _trees_bit_equal(g_state, state)
        graph.close()
    else:
        eager_state, graph_state = _tree_clone(state_d), _tree_clone(state_d)
        want, t = [], tok
        slot.stream.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode(), torch.cuda.stream(slot.stream):
            for _ in range(4):
                logits, _ = decode_step(params_d, cfg_d, eager_state,
                                        torch.tensor([t], device=card))
                t = int(torch.argmax(logits[0]))
                want.append(logits.clone())
        torch.cuda.current_stream().wait_stream(slot.stream)
        got, _ = _graphed(slot, graph_state, tok, steps=4)
        assert all(_bits_equal(g, w) for g, w in zip(got, want))
        slot.close()
    torch.cuda.synchronize()
    assert graphs.live() == live
