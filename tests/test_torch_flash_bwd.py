"""Flash attention's backward on the CPU, against the JAX package's
gradient: ``jax.vjp`` of ``repro.kernels.ref.attention_ref`` (the JAX
package has no Pallas backward; its training gradient is autodiff of that
function).  The port's plain backward walks the tile schedule of any
backward path (``wgmma``, the one bfloat16 training takes, ``tf32x3``, the
one float32 training takes, and ``fma``), so these tests hold the kernels'
algorithm; the kernels themselves are
held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: the reference's float32 kernel tolerance, rel 2e-4 of each
gradient's largest magnitude; bfloat16 inputs at 2e-2.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (BWD_PATHS, FlashAttention,
                                                 bwd_launches,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_bwd_path, launches)

torch.set_num_threads(1)

CASES = [  # (b, hq, hkv, s, t, d, causal)
    (1, 4, 4, 70, 70, 32, True),      # GQA group 1, ragged S = T
    (2, 4, 2, 64, 64, 64, True),      # group 2, one tile exactly
    (1, 8, 2, 130, 130, 32, True),    # group 4, ragged, 3 tiles
    (2, 4, 1, 37, 130, 64, True),     # S < T (end-aligned), S < one tile
    (1, 8, 2, 100, 60, 32, False),    # non-causal, S > T
    (1, 4, 2, 50, 200, 128, False),   # non-causal, S < T, D = 128
    (1, 4, 4, 70, 70, 80, True),      # D = 80 (stablelm-3b's), ragged
    (1, 10, 2, 70, 130, 32, True),    # GQA group 5 (qwen2.5-14b's), S < T
    (1, 10, 2, 100, 60, 80, False),   # group 5 at D = 80, non-causal
]

# the edges of the schedules: tf32x3's 16-row q steps of dK/dV, 32-key
# tiles of the LSE pass and of dQ; every path's 64-row q tiles and 64-key
# blocks
EDGE_CASES = [  # (b, hq, hkv, s, t, d, causal)
    (1, 4, 2, 33, 33, 32, True),      # one past a 32-row step, S = T
    (1, 4, 1, 17, 97, 64, True),      # one past a 16-row step; T one past 3 x 32
    (2, 2, 2, 65, 65, 32, True),      # one past a 64-row tile and key block
    (1, 4, 2, 31, 129, 32, True),     # one short of 32 rows; T one past 128
    (1, 2, 1, 48, 40, 64, False),     # non-causal, S > T, T ragged in 32
    (1, 5, 1, 17, 97, 80, True),      # D = 80, group 5, past a 16-row step
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
    """The plain backward at its default schedule: for aligned float32,
    the ``tf32x3`` kernels'."""
    q, k, v, do = _inputs(b, hq, hkv, s, t, d)
    o, want = _jax_grads(q, k, v, do, causal)
    args = list(map(torch.tensor, (q, k, v, o, do)))
    assert flash_bwd_path(*args) == "tf32x3"
    got = flash_attention_bwd_plain(*args, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), w) < 2e-4, name


@pytest.mark.parametrize("schedule", BWD_PATHS)
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", EDGE_CASES)
def test_plain_backward_at_the_schedules_edges(b, hq, hkv, s, t, d, causal,
                                               schedule):
    q, k, v, do = _inputs(b, hq, hkv, s, t, d, seed=4)
    o, want = _jax_grads(q, k, v, do, causal)
    got = flash_attention_bwd_plain(*map(torch.tensor, (q, k, v, o, do)),
                                    causal=causal, schedule=schedule)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g.numpy(), w) < 2e-4, name


def _off16(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts off a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    flat.copy_(x.reshape(-1))
    return flat.view(x.shape)


def test_backward_path_chooser():
    """Aligned float32 takes ``tf32x3``, aligned bfloat16 ``wgmma``; either
    dtype with any of q, k, v, o or dO off a 16-byte boundary ``fma``."""
    ts = [torch.from_numpy(x) for x in _inputs(1, 4, 2, 40, 40, 32)]
    q, k, v, do = ts
    assert flash_bwd_path(q, k, v, q, do) == "tf32x3"
    bf = [x.to(torch.bfloat16) for x in (q, k, v, q, do)]
    assert flash_bwd_path(*bf) == "wgmma"
    for five in ([q, k, v, q, do], bf):
        for i in range(5):
            off = list(five)
            off[i] = _off16(five[i])
            assert off[i].data_ptr() % 16 and off[i].is_contiguous()
            assert flash_bwd_path(*off) == "fma"


def test_plain_backward_takes_the_schedule_of_the_path():
    """By default the plain version walks the schedule of the path the
    inputs would take on the card; the schedules agree to float32's
    rounding."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(1, 4, 2, 100, 100, 32, seed=5))
    o = flash_attention(q, k, v)
    by_path = {p: flash_attention_bwd_plain(q, k, v, o, do, schedule=p)
               for p in BWD_PATHS}
    default = flash_attention_bwd_plain(q, k, v, o, do)
    off = flash_attention_bwd_plain(_off16(q), k, v, o, do)
    for a, b, c, d, w in zip(default, by_path["tf32x3"], off, by_path["fma"],
                             by_path["wgmma"]):
        assert torch.equal(a, b) and torch.equal(c, d)
        assert _rel(a.numpy(), d.numpy()) < 1e-5
        assert _rel(a.numpy(), w.numpy()) < 1e-5
    bf = [x.to(torch.bfloat16) for x in (q, k, v, o, do)]
    for a, b in zip(flash_attention_bwd_plain(*bf),
                    flash_attention_bwd_plain(*bf, schedule="wgmma")):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", CASES)
def test_plain_wgmma_schedule_on_bfloat16_inputs(b, hq, hkv, s, t, d,
                                                  causal):
    """The ``wgmma`` kernels' schedule, walked by the plain version on
    bfloat16-rounded inputs (the path aligned bfloat16 takes on the card),
    against the reference's float32 gradient at those inputs: bfloat16's
    tolerance, rel 2e-2."""
    q, k, v, do = _inputs(b, hq, hkv, s, t, d, seed=6)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    o, want = _jax_grads(*(x.float().numpy() for x in bf), causal)
    args = (*bf[:3], torch.tensor(o).to(torch.bfloat16), bf[3])
    assert flash_bwd_path(*args) == "wgmma"
    got = flash_attention_bwd_plain(*args, causal=causal, schedule="wgmma")
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g.float().numpy(), w) < 2e-2, name


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


def test_chip_smoke_holds_the_wgmma_gradients_as_a_whole():
    """``chip_smoke._bwd_ok``, the check of every backward run on the card:
    the plain version's own bfloat16 gradients pass; dq off by 1.5% on
    every element stays inside the elementwise 2e-2 x (1 + |g|) but fails
    the ``wgmma`` path's ``FLASH_BWD_BF16_KEEP`` on its norm, and passes
    the ``fma`` path, which is held elementwise alone."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_flash_bwd",
        Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(1, 8, 2, 130, 130, 64, seed=7))
    want = flash_attention_bwd_plain(q, k, v, flash_attention(q, k, v), do)
    assert cs._bwd_ok("wgmma", want, want, cs.bwd_errors(want, want))
    off = ((want[0].float() * 1.015).to(torch.bfloat16), *want[1:])
    errs = cs.bwd_errors(off, want)
    assert errs["dq"]["max_rel_err"] < 2e-2
    assert errs["dq"]["norm_rel_err"] > cs.FLASH_BWD_BF16_KEEP
    assert errs["dk"]["norm_rel_err"] == errs["dv"]["norm_rel_err"] == 0.0
    assert not cs._bwd_ok("wgmma", off, want, errs)
    assert cs._bwd_ok("fma", off, want, errs)


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
