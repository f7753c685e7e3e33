"""The CUDA kernels on the card, against their plain versions.

Skipped where there is no CUDA card (the kernels have no CPU mode); on the
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no jax: the machine with the card need not have it.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 launches)

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
    (2, 8, 2, 100, 100, 64, True),
    (1, 4, 1, 37, 301, 32, True),
    (1, 8, 8, 130, 70, 128, False),
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


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float32, 48)])
def test_flash_kernel_refuses_what_it_does_not_take(card, dtype, d):
    q, k, v = _qkv(card, 1, 4, 2, 64, 64, d, dtype)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
