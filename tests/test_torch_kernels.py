"""The port's attention ops and SSD scan against the JAX package's, on the
CPU.

The flash attention wrapper takes its plain version for CPU tensors (the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  The plain version walks
the kernel's tile schedule, so these sweeps check the kernel's algorithm:
the 64x64 tiles, the causal tile skip, the ragged-edge masking and the
online-softmax rescale, against ``flash_attention_pallas(interpret=True)``
and ``attention_ref``.  Likewise ``ssd_scan_plain`` walks the SSD
kernel's schedule (chunk length, chunk-relative cumulative sum, the causal
select before the exponential, the states passed along the chunks, the
zero-padded ragged chunk), held against ``ssd_scan_pallas(interpret=True)``
and ``ssd_ref``; its four passes (the chunks in parallel, as the kernel
runs them) are held against the chunk-by-chunk walk at 1e-5.  Tolerances
are the reference's own (``tests/test_kernels.py``): 2e-4 in float32 and
2e-2 in bfloat16 for attention, 3e-3 for the SSD scan.
"""
import collections
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ops, ref, ssd_scan, work
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_path, launches)

torch.set_num_threads(1)


def _qkv(b, hq, hkv, s, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d), dtype=np.float32),
            rng.standard_normal((b, hkv, t, d), dtype=np.float32),
            rng.standard_normal((b, hkv, t, d), dtype=np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("hq,hkv,s,t,causal", [
    (4, 4, 128, 128, True), (8, 2, 64, 192, True),
    (8, 2, 128, 128, False), (8, 1, 64, 192, False),
    (10, 2, 128, 128, True), (10, 2, 64, 192, False)])   # group 5 (qwen2.5)
def test_flash_attention_matches_pallas_and_ref(hq, hkv, s, t, causal):
    q, k, v = _qkv(1, hq, hkv, s, t, 32)
    got = flash_attention(*_t(q, k, v), causal=causal).numpy()
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, bq=64,
                                    bk=64, interpret=True)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,t,causal", [(100, 100, True), (37, 301, True),
                                        (130, 130, False), (1, 65, True)])
def test_flash_attention_ragged_lengths(s, t, causal):
    """Lengths that are not multiples of the 64-row tiles: the kernel masks
    the ragged edge itself (the Pallas kernel refuses such shapes).  Held
    against the port's dense oracle, which the next test holds against the
    JAX package's."""
    q, k, v = _t(*_qkv(2, 4, 2, s, t, 32, seed=1))
    got = flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_flash_attention_bf16():
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=2)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flash_attention_pallas(qb, kb, vb, bq=64, bk=64,
                                             interpret=True), np.float32)
    qt, kt, vt = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (qb, kb, vb))
    got = flash_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype,offset,path", [
    (torch.bfloat16, None, "wgmma"), (torch.bfloat16, "k", "fma"),
    (torch.float32, None, "tf32x3"), (torch.float32, "k", "fma"),
    (torch.float32, "q", "fma"), (torch.float32, "v", "fma")])
def test_flash_path_choice(dtype, offset, path):
    """q, k and v on 16-byte boundaries go to a tensor-core kernel
    (bfloat16: wgmma, float32: 3xTF32), any of them off one to the FMA
    kernel."""
    qkv = {name: t.to(dtype)
           for name, t in zip("qkv", _t(*_qkv(1, 4, 2, 64, 64, 32)))}
    if offset:
        x = qkv[offset]
        flat = torch.empty(x.numel() + 1, dtype=dtype)[1:]
        flat.copy_(x.reshape(-1))
        qkv[offset] = flat.view(x.shape)
        assert qkv[offset].data_ptr() % 16
    assert flash_path(qkv["q"], qkv["k"], qkv["v"]) == path


@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("s,t,causal", [(64, 64, True), (128, 192, True),
                                        (128, 128, False)])
def test_flash_attention_bf16_tiles_match_pallas(d, s, t, causal):
    """The plain version in bfloat16 at the head sizes of the tensor-core
    path and across its 64-row and 64-key tile edges (one tile, T > S,
    two tiles), against the Pallas kernel in interpret mode."""
    q, k, v = _qkv(1, 4, 2, s, t, d, seed=d)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flash_attention_pallas(qb, kb, vb, causal=causal,
                                             bq=64, bk=64, interpret=True),
                      np.float32)
    qt, kt, vt = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (qb, kb, vb))
    got = flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("s,t,causal", [(64, 64, True), (128, 192, True),
                                        (128, 128, False)])
def test_flash_attention_float32_tiles_match_pallas(d, s, t, causal):
    """The plain version in float32 at the head sizes of the 3xTF32 path
    and across its 64-row and 64-key tile edges (one tile, T > S, two
    tiles), against the Pallas kernel in interpret mode, at the
    reference's 2e-4."""
    q, k, v = _qkv(1, 4, 2, s, t, d, seed=d + 1)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=64, bk=64, interpret=True))
    got = flash_attention_plain(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_torch_attention_ref_matches_jax_ref():
    q, k, v = _qkv(2, 8, 2, 37, 101, 32, seed=3)
    for causal in (True, False):
        got = ref.attention_ref(*_t(q, k, v), causal=causal).numpy()
        want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(4)
    b, hq, hkv, t, d = 3, 8, 2, 40, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kc = rng.standard_normal((b, t, hkv, d), dtype=np.float32)
    vc = rng.standard_normal((b, t, hkv, d), dtype=np.float32)
    lengths = np.array([1, 17, 40], np.int32)
    got = ops.decode_attention(*_t(q, kc, vc, lengths)).numpy()
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(lengths))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_cpu_path_takes_plain_version_and_counts_no_launch():
    q, k, v = _t(*_qkv(1, 4, 2, 70, 70, 32, seed=5))
    before = launches.count
    out = flash_attention(q, k, v)
    assert launches.count == before
    assert torch.equal(out, flash_attention_plain(q, k, v))


@pytest.mark.parametrize("shapes,causal", [
    (((1, 4, 64, 32), (1, 3, 64, 32)), True),     # Hq not a multiple of Hkv
    (((1, 4, 128, 32), (1, 2, 64, 32)), True),    # causal with T < S
    (((1, 4, 64, 32), (1, 2, 64, 16)), False),    # head sizes differ
])
def test_flash_attention_rejects_bad_shapes(shapes, causal):
    qs, ks = shapes
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks),
                        causal=causal)


# -- SSD scan ----------------------------------------------------------------

def _ssd_inputs(b, s, h, d, n, decay, seed=0):
    """x, a, b, c as numpy float32.  ``decay``: "mild" (a = -|z| / 10) or
    "strong" (a uniform down to log 1e-6 a token, mLSTM's floor)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, d), dtype=np.float32) * 0.5
    if decay == "mild":
        a = -np.abs(rng.standard_normal((b, s, h), dtype=np.float32)) * 0.1
    else:
        a = np.log(1e-6) * rng.random((b, s, h), dtype=np.float32)
    bm = rng.standard_normal((b, s, n), dtype=np.float32) * n ** -0.25
    cm = rng.standard_normal((b, s, n), dtype=np.float32) * n ** -0.25
    return x, a.astype(np.float32), bm, cm


@pytest.mark.parametrize("b,s,h,d,n,decay", [
    (2, 128, 4, 32, 16, "mild"),      # two chunks, B > 1
    (2, 40, 2, 16, 16, "mild"),       # S shorter than one chunk
    (1, 64, 1, 384, 384, "strong"),   # mLSTM's head (D = N = 384)
    (3, 192, 1, 1, 8, "strong"),      # the mLSTM normalizer's D = 1
])
def test_ssd_scan_matches_pallas_and_ref(b, s, h, d, n, decay):
    arrays = _ssd_inputs(b, s, h, d, n, decay)
    got = ops.ssd_scan(*_t(*arrays)).numpy()
    jx = [jnp.asarray(v) for v in arrays]
    pallas = ssd_scan_pallas(*jx, chunk=min(ssd_scan.CHUNK, s),
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(got, np.asarray(jref.ssd_ref(*jx)), rtol=3e-3,
                               atol=3e-3)


@pytest.mark.parametrize("b,s,h,d,n,decay", [
    (1, 100, 2, 16, 8, "mild"),       # a ragged last chunk
    (2, 130, 1, 1, 384, "strong"),    # ragged, D = 1, N = 384
    (1, 65, 3, 32, 16, "strong"),     # one token past a chunk
])
def test_ssd_scan_ragged_lengths(b, s, h, d, n, decay):
    """Lengths that are not multiples of the chunk (the Pallas kernel
    refuses them): the plain version pads the last chunk as the kernel
    does, and matches the JAX package's sequential oracle."""
    arrays = _ssd_inputs(b, s, h, d, n, decay, seed=1)
    got = ssd_scan.ssd_scan_plain(*_t(*arrays)).numpy()
    want = jref.ssd_ref(*[jnp.asarray(v) for v in arrays])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-3, atol=3e-3)


def test_torch_ssd_ref_matches_jax_ref():
    arrays = _ssd_inputs(2, 70, 3, 16, 8, "mild", seed=2)
    got = ref.ssd_ref(*_t(*arrays)).numpy()
    want = jref.ssd_ref(*[jnp.asarray(v) for v in arrays])
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-3, atol=3e-3)


def test_ssd_scan_bf16_keeps_dtype():
    arrays = _ssd_inputs(1, 96, 2, 32, 16, "mild", seed=3)
    bf = [jnp.asarray(v, jnp.bfloat16) for v in arrays]
    want = np.asarray(jref.ssd_ref(*bf), np.float32)
    got = ops.ssd_scan(*(torch.from_numpy(np.array(v.astype(jnp.float32)))
                         .to(torch.bfloat16) for v in bf))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_ssd_cpu_path_takes_plain_version_and_counts_no_launch():
    x, a, bm, cm = _t(*_ssd_inputs(1, 70, 2, 16, 8, "mild", seed=4))
    before = ssd_scan.launches.count
    out = ops.ssd_scan(x, a, bm, cm)
    assert ssd_scan.launches.count == before
    assert torch.equal(out, ssd_scan.ssd_scan_plain(x, a, bm, cm))


def test_ssd_plain_version_is_differentiable_on_the_cpu():
    """The CPU path keeps autograd (``SSDScan``: the plain forward and
    the plain backward, as the kernels on the card): the causal select
    comes before the exponential, so no inf * 0 reaches the gradient even
    at mLSTM's strongest decay."""
    x, a, bm, cm = (t.requires_grad_() for t in
                    _t(*_ssd_inputs(1, 80, 1, 8, 8, "strong", seed=5)))
    ops.ssd_scan(x, a, bm, cm).square().sum().backward()
    for t in (x, a, bm, cm):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def _chunk_walk(x, a, b, c):
    """The chunk-by-chunk walk that the SSD kernel made before its chunks
    ran in parallel: one chunk after the other, the float32 state carried
    from each to the next."""
    bsz, s, h, d = x.shape
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    state = torch.zeros((bsz, h, d, b.shape[2]))
    ys = []
    for t0 in range(0, s, ssd_scan.CHUNK):
        t1 = min(t0 + ssd_scan.CHUNK, s)
        xc, bc, cc = xf[:, t0:t1], bf[:, t0:t1], cf[:, t0:t1]
        acum = torch.cumsum(af[:, t0:t1], dim=1)                # [B,L,H]
        a_tot = acum[:, -1]                                     # [B,H]
        live = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool).tril()
        diff = acum[:, :, None, :] - acum[:, None, :, :]        # [B,t,u,H]
        decay = torch.exp(torch.where(live[None, :, :, None], diff,
                                      float("-inf")))
        g = torch.einsum("btn,bun->btu", cc, bc)[..., None] * decay
        y = torch.einsum("btuh,buhd->bthd", g, xc)
        y = y + torch.exp(acum)[..., None] * torch.einsum(
            "btn,bhdn->bthd", cc, state)
        ys.append(y)
        w = torch.exp(a_tot[:, None] - acum)                    # [B,L,H]
        state = torch.exp(a_tot)[..., None, None] * state + torch.einsum(
            "buhd,buh,bun->bhdn", xc, w, bc)
    return torch.cat(ys, dim=1).to(x.dtype)


@pytest.mark.parametrize("b,s,h,d,n,decay", [
    (2, 64, 3, 16, 8, "mild"),        # one chunk
    (1, 128, 2, 32, 16, "mild"),      # exactly two chunks
    (1, 1024, 2, 8, 8, "strong"),     # 16 chunks of state passing
    (2, 192, 1, 1, 384, "strong"),    # the mLSTM normalizer's D = 1, N 384
    (2, 150, 2, 16, 8, "mild"),       # a ragged last chunk
])
def test_ssd_parallel_chunks_match_the_chunk_walk(b, s, h, d, n, decay):
    """The plain version's four passes (all chunks' C . B^T and local
    states at once, then the states passed along, then all outputs at once)
    against the sequential walk over the chunks, in float32."""
    x, a, bm, cm = _t(*_ssd_inputs(b, s, h, d, n, decay, seed=6))
    got = ssd_scan.ssd_scan_plain(x, a, bm, cm)
    want = _chunk_walk(x, a, bm, cm)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ssd_scratch_size_counts_every_pass():
    """C . B^T [B, nc, L, L], Acum [B, nc, H, L] and the states
    [B, nc, H, N, D], nc = ceil(S / L): 16.8 MB of states at zamba2's
    heads and S = 1024."""
    bsz, s, h, d, n = 1, 1024, 32, 128, 64
    nc = 16
    states = bsz * nc * h * n * d
    assert ssd_scan.scratch_floats(bsz, s, h, d, n) == (
        bsz * nc * 64 * 64 + bsz * nc * h * 64 + states)
    assert states * 4 == 16_777_216
    assert ssd_scan.scratch_floats(1, 65, 1, 1, 8) == 2 * (4096 + 64 + 8)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_ssd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b,s,h,d,n,by,dtype", [
    pytest.param(1, 1024, 32, 128, 64, "bytes", torch.float32,
                 id="1-1024-32-128-64-bytes"),         # zamba2's heads
    pytest.param(4, 1024, 1, 384, 384, "operations", torch.float32,
                 id="4-1024-1-384-384-operations"),    # the mLSTM values
    pytest.param(4, 1024, 1, 1, 384, "bytes", torch.float32,
                 id="4-1024-1-1-384-bytes"),           # the mLSTM normalizer
    # bfloat16 at the training shapes: half the bytes, and the products
    # priced by the TF32 products a bfloat16 input needs, so zamba2's heads
    # turn operations-bound
    pytest.param(2, 2048, 32, 128, 64, "operations", torch.bfloat16,
                 id="bfloat16-2-2048-32-128-64-operations"),
    pytest.param(8, 2048, 1, 384, 384, "operations", torch.bfloat16,
                 id="bfloat16-8-2048-1-384-384-operations"),
    pytest.param(8, 2048, 1, 1, 384, "bytes", torch.bfloat16,
                 id="bfloat16-8-2048-1-1-384-bytes"),
])
def test_ssd_bound_prices_each_product_at_its_unit(b, s, h, d, n, by, dtype):
    """The SSD bound ``chip_smoke.py`` prices (``kernels/work.py``): C . B^T
    on the tensor cores at every D, the other products there only at D at
    or above the narrow threshold (16), else with the decays at the
    float32 FMA peak.  A tensor-core product of two float32 operands at
    3xTF32 (a third of TF32's peak); in bfloat16 one of two inputs (C .
    B^T; the backward's M = dy x^T too) at the bfloat16 peak, one of an
    input against a float32 value at 2xTF32 (half of TF32's: a bfloat16
    value is exact in TF32).  The bound is the longest of bytes and each
    kind's operations; in bfloat16 the bytes are the inputs' and output's
    at 2 bytes an element."""
    from repro_torch.kernels.ssd_scan import CHUNK, scratch_floats
    assert ssd_scan.NARROW_D == 16     # what the meta path prices by
    lens = [min(CHUNK, s - t0) for t0 in range(0, s, CHUNK)]
    pairs = sum(ln * (ln + 1) // 2 for ln in lens)
    decay, cb = b * h * pairs, b * 2 * pairs * n
    rest = b * h * (2 * pairs * d + 4 * s * d * n)
    both, one = (("3xtf32", "3xtf32") if dtype == torch.float32
                 else ("bfloat16", "2xtf32"))
    want = collections.Counter({"float32": decay})
    want[both] += cb
    want[one if d >= 16 else "float32"] += rest
    wide, nbytes = work.ssd_work(b, s, h, d, n, dtype, 16)
    narrow, nbytes_narrow = work.ssd_work(b, s, h, d, n, dtype, d + 1)
    assert wide == dict(want) and nbytes == nbytes_narrow
    assert narrow == {"float32": decay + rest, both: cb}
    assert nbytes * 4 == work.ssd_work(b, s, h, d, n, torch.float32,
                                       16)[1] * dtype.itemsize
    ms, bound_by = work.bound(wide, nbytes)
    times = [nbytes / 3.35e12] + [f / work.H100_PEAK_FLOPS[k]
                                  for k, f in wide.items()]
    assert bound_by == by and ms == pytest.approx(max(times) * 1e3)
    # the backward, with the scratch kept: M = dy x^T of two inputs, G^T dy,
    # M B, M^T C and the four l x D x N products of an input and a float32
    # value
    bwd, bwd_bytes = work.ssd_bwd_work(b, s, h, d, n, dtype, True)
    two = b * h * 2 * pairs * d
    mixed = b * h * (2 * pairs * d + 4 * pairs * n + 8 * s * d * n)
    want = collections.Counter({"float32": decay})
    want[both] += two
    want[one] += mixed
    assert bwd == dict(want)
    assert bwd_bytes == (4 * b * s * h * d + 2 * b * s * h + 4 * b * s * n
                         ) * dtype.itemsize + 4 * scratch_floats(b, s, h, d,
                                                                 n)
    assert work.H100_PEAK_FLOPS["3xtf32"] == pytest.approx(495e12 / 3)
    assert work.H100_PEAK_FLOPS["2xtf32"] == pytest.approx(495e12 / 2)
    assert work.H100_PEAK_FLOPS["bfloat16"] == pytest.approx(989e12)


@pytest.mark.parametrize("path,unit,peak", [
    ("tf32x3", "3xtf32", 495e12 / 3),   # float32 on the tensor cores
    ("fma", "float32", 67e12),          # float32 FMAs
    ("wgmma", "bfloat16", 989e12),      # bfloat16 on the tensor cores
])
def test_flash_bound_prices_each_path_at_its_unit(path, unit, peak):
    """``chip_smoke.py``'s flash bound at granite-8b's heads and S = 1024:
    a ``tf32x3`` row's products at a third of TF32's peak (0.052 ms), an
    ``fma`` row's at the float32 FMA peak (0.128 ms), a ``wgmma`` row's at
    the bfloat16 tensor-core peak; bound by operations in each."""
    cs = _chip_smoke()
    dtype = torch.bfloat16 if path == "wgmma" else torch.float32
    flops, nbytes = work.attention_work(1, 32, 8, 1024, 1024, 128, dtype)
    assert flops == 4 * 32 * 128 * (1024 * 1025 // 2)
    assert cs.FLASH_UNIT[path] == unit
    ms, bound_by = work.bound({cs.FLASH_UNIT[path]: flops}, nbytes)
    assert bound_by == "operations"
    assert ms == pytest.approx(flops / peak * 1e3)
    assert ms == pytest.approx({"tf32x3": 0.0521, "fma": 0.1283,
                                "wgmma": 0.00869}[path], rel=2e-3)


@pytest.mark.parametrize("shapes", [
    ((1, 64, 2, 16), (1, 64, 2), (1, 64, 8), (1, 64, 4)),   # b, c differ
    ((1, 64, 2, 16), (1, 64, 3), (1, 64, 8), (1, 64, 8)),   # a misfits x
    ((1, 64, 2, 16), (1, 64, 2), (1, 32, 8), (1, 32, 8)),   # b misfits x
    ((1, 64, 16), (1, 64, 2), (1, 64, 8), (1, 64, 8)),      # x not 4-D
])
def test_ssd_scan_rejects_bad_shapes(shapes):
    with pytest.raises(ValueError):
        ops.ssd_scan(*(torch.zeros(sh) for sh in shapes))
