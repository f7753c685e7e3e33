"""Flash attention's backward on the CPU, against the JAX package's
gradient: ``jax.vjp`` of ``repro.kernels.ref.attention_ref`` (the JAX
package has no Pallas backward; its training gradient is autodiff of that
function).  The port's plain backward walks the CUDA kernel's tile
schedule, so these tests hold the kernel's algorithm; the kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: the reference's float32 kernel tolerance, rel 2e-4 of each
gradient's largest magnitude; bfloat16 inputs at 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 bwd_launches,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 launches)

torch.set_num_threads(1)

CASES = [  # (b, hq, hkv, s, t, d, causal)
    (1, 4, 4, 70, 70, 32, True),      # GQA group 1, ragged S = T
    (2, 4, 2, 64, 64, 64, True),      # group 2, one tile exactly
    (1, 8, 2, 130, 130, 32, True),    # group 4, ragged, 3 tiles
    (2, 4, 1, 37, 130, 64, True),     # S < T (end-aligned), S < one tile
    (1, 8, 2, 100, 60, 32, False),    # non-causal, S > T
    (1, 4, 2, 50, 200, 128, False),   # non-causal, S < T, D = 128
]


def _inputs(b, hq, hkv, s, t, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, scale=None):
    out, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(
        q, k, v, causal=causal, scale=scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", CASES)
def test_plain_backward_matches_jax_vjp(b, hq, hkv, s, t, d, causal):
    q, k, v, do = _inputs(b, hq, hkv, s, t, d)
    o, want = _jax_grads(q, k, v, do, causal)
    got = flash_attention_bwd_plain(*map(torch.tensor, (q, k, v, o, do)),
                                    causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), w) < 2e-4, name


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", CASES)
def test_autograd_through_flash_attention_matches_jax(b, hq, hkv, s, t, d,
                                                      causal):
    """``ops.flash_attention`` (what the model calls) carries the gradient:
    autograd through ``FlashAttention``, on the CPU its plain versions."""
    q, k, v, do = _inputs(b, hq, hkv, s, t, d, seed=1)
    o, want = _jax_grads(q, k, v, do, causal, scale=0.3)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, scale=0.3)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert _rel(out.detach().numpy(), o) < 2e-4
    out.backward(torch.from_numpy(do))
    for name, x, w in zip("qkv", leaves, want):
        assert _rel(x.grad.numpy(), w) < 2e-4, name


def test_gradient_through_strided_inputs():
    """The model hands the kernel transposed views ([B, S, H, D] ->
    [B, H, S, D]); the gradient finds its way back to them."""
    q, k, v, do = _inputs(1, 4, 2, 70, 70, 32, seed=2)
    _, want = _jax_grads(q, k, v, do, True)
    leaves = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                               ).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*(x.transpose(1, 2) for x in leaves))
    out.backward(torch.from_numpy(do))
    for x, w in zip(leaves, want):
        assert _rel(x.grad.transpose(1, 2).numpy(), w) < 2e-4


def test_bfloat16_backward_against_jax_float32():
    q, k, v, do = _inputs(1, 8, 2, 100, 100, 64, seed=3)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    # the reference's float32 gradient at the bfloat16-rounded inputs
    _, want = _jax_grads(*(x.float().numpy() for x in bf), True)
    out = flash_attention(*bf[:3])
    got = flash_attention_bwd(*bf[:3], out, bf[3])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), w) < 2e-2
    assert out.dtype == torch.bfloat16


def test_no_grad_runs_the_forward_alone():
    """Under ``no_grad`` or ``inference_mode`` nothing is saved and the
    output carries no ``grad_fn``; on the CPU no kernel counter moves."""
    q, k, v, _ = _inputs(1, 4, 2, 40, 40, 32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    counts = (launches.count, bwd_launches.count)
    with torch.no_grad():
        assert flash_attention(tq, tk, tv).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(tq, tk, tv).grad_fn is None
    assert (launches.count, bwd_launches.count) == counts


def test_backward_refuses_what_the_forward_refuses():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 80, 40, 32))
    with pytest.raises(ValueError, match="T >= S"):
        flash_attention_bwd(q, k, v, q, do, causal=True)
    with pytest.raises(ValueError, match="mixed dtypes"):
        flash_attention_bwd(q, k.double(), v, q, do, causal=False)
    assert issubclass(FlashAttention, torch.autograd.Function)
