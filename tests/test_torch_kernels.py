"""The port's attention ops against the JAX package's, on the CPU.

The flash attention wrapper takes its plain version for CPU tensors (the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  The plain version walks
the kernel's tile schedule, so these sweeps check the kernel's algorithm:
the 64x64 tiles, the causal tile skip, the ragged-edge masking and the
online-softmax rescale, against ``flash_attention_pallas(interpret=True)``
and ``attention_ref``.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-4 in float32, 2e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 launches)

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
    (8, 2, 128, 128, False), (8, 1, 64, 192, False)])
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
