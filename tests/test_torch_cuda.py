"""The CUDA kernels on the card, against their plain versions.

Skipped where there is no CUDA card (the kernels have no CPU mode); on the
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no jax: the machine with the card need not have it.
"""
import pytest
import torch

from repro_torch.kernels import ops, ssd_scan
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
    (1, 32, 32, 300, 300, 64, True),    # zamba2's shared attention, ragged
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,d,n,strong", [
    (1, 256, 32, 128, 64, False),     # zamba2's heads
    (1, 300, 32, 128, 64, False),     # ragged S
    (4, 200, 1, 384, 384, True),      # mLSTM values, strong decay
    (4, 130, 1, 1, 384, True),        # mLSTM normalizer (D = 1)
    (2, 37, 4, 32, 16, False),        # S shorter than one chunk
    (3, 150, 2, 48, 100, False),      # D and N the tiles do not divide
])
def test_ssd_kernel_matches_plain(card, dtype, tol, b, s, h, d, n, strong):
    x, a, bm, cm = _ssd_inputs(card, b, s, h, d, n, dtype, strong)
    before = ssd_scan.launches.count
    got = ops.ssd_scan(x, a, bm, cm)
    torch.cuda.synchronize()
    assert ssd_scan.launches.count == before + 1
    want = ssd_scan.ssd_scan_plain(x, a, bm, cm)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
    big = torch.zeros((1, 64, 4096), device=card)        # state too wide
    with pytest.raises(ValueError):
        ops.ssd_scan(x, a, big, big)


def test_kernels_refuse_inputs_that_need_a_gradient(card):
    """No backward yet: under grad mode an input that requires grad is
    refused, never answered with a result cut off from autograd."""
    q, k, v = _qkv(card, 1, 4, 2, 64, 64, 32, torch.float32)
    x, a, bm, cm = _ssd_inputs(card, 1, 64, 2, 16, 8, torch.float32)
    with pytest.raises(RuntimeError, match="backward"):
        flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="backward"):
        ops.ssd_scan(x, a, bm.requires_grad_(), cm)
    with torch.no_grad():                 # no gradient asked: the kernel runs
        assert flash_attention(q, k, v).grad_fn is None
        assert ops.ssd_scan(x, a, bm, cm).grad_fn is None
