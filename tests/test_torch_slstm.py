"""The sLSTM recurrence on the CPU, against the JAX package: its
``slstm_block`` and ``slstm_decode`` (one ``jax.lax.scan`` of
``_slstm_cell``) and their ``jax.vjp``.

The port runs the recurrence through ``ops.slstm_scan``, whose CPU path
is the plain versions of the CUDA kernels (``csrc/slstm_scan.cu``,
``csrc/slstm_scan_bwd.cu``): ``slstm_scan_plain``, the loop a step at a
time, and, under autograd, ``SLSTMScan`` with ``slstm_scan_bwd_plain``,
the backward kernel's reverse recurrence (in float64).  Beside it,
``slstm_scan_bwd_linear`` computes the backward in its kernel's order
(every step's coefficients, then the linear chain).  So these tests hold
the kernels' algorithms and the wrapper's zero padding; the kernels
themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: the forward at ``tests/test_torch_ssm_models.py``'s 2e-4
(rtol and atol); gradients at 1e-4 of each leaf's largest magnitude
(ROADMAP, Port conventions); ``gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.kernels import ops, slstm_scan, work
from repro_torch.models import init_params, xlstm

torch.set_num_threads(1)

TOL = 2e-4
GRAD_TOL = 1e-4


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _carry(b, d, seed):
    """A random (h, c, n, m), as numpy: a decode's carry."""
    return (_x((b, d), seed) * 0.5, _x((b, d), seed + 1),
            np.abs(_x((b, d), seed + 2)) + 1.0, _x((b, d), seed + 3))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _ref_scan(p_j, x, carry):
    """The reference's recurrence from any carry: its ``slstm_block``'s
    ``lax.scan`` of ``_slstm_cell``, without the block's projections."""
    def step(c, xt):
        new = jxlstm._slstm_cell(p_j, c, xt)
        return new, new[0]
    final, hs = jax.lax.scan(step, tuple(map(jnp.asarray, carry)),
                             jnp.asarray(x).swapaxes(0, 1))
    return hs.swapaxes(0, 1), final


@pytest.mark.parametrize("s", [1, 17, 64])
@pytest.mark.parametrize("d", [32, 48])
def test_block_matches_reference(s, d):
    """``slstm_block`` (a zero carry) against the reference's, output and
    the decode state it returns."""
    p_j = jxlstm.init_slstm(jax.random.PRNGKey(d + s), d, 2)
    x = _x((2, s, d), s)
    got, st = xlstm.slstm_block(to_torch(p_j), torch.from_numpy(x),
                                n_heads=2, return_state=True)
    want, st_j = jxlstm.slstm_block(p_j, jnp.asarray(x), n_heads=2,
                                    return_state=True)
    _close(got, want)
    for name in ("h", "c", "n", "m"):
        _close(st[name], st_j[name])


@pytest.mark.parametrize("s", [1, 17, 64])
@pytest.mark.parametrize("d", [32, 48])
def test_scan_from_a_random_carry_matches_reference(s, d):
    """``ops.slstm_scan`` on the gate inputs from a random carry against
    the reference's ``lax.scan`` of ``_slstm_cell`` from the same carry:
    every step's h and the last carry."""
    p_j = jxlstm.init_slstm(jax.random.PRNGKey(7 * d + s), d, 2)
    x, carry = _x((2, s, d), 100 + s), _carry(2, d, 200 + s)
    p = to_torch(p_j)
    hs, last = ops.slstm_scan(xlstm._gate_inputs(p, torch.from_numpy(x)),
                              p["r_gates"], tuple(map(torch.from_numpy,
                                                      carry)))
    want_hs, want_last = _ref_scan(p_j, x, carry)
    _close(hs, want_hs)
    for got, want in zip(last, want_last):
        _close(got, want)


@pytest.mark.parametrize("d", [32, 48])
@pytest.mark.parametrize("carry_kind", ["zero", "random"])
def test_decode_matches_reference(d, carry_kind):
    """``slstm_decode`` (S = 1 through the scan, the request's carry)
    against the reference's, output and new state."""
    p_j = jxlstm.init_slstm(jax.random.PRNGKey(d), d, 2)
    carry = (_carry(2, d, 30) if carry_kind == "random"
             else tuple(np.zeros((2, d), np.float32) for _ in range(4)))
    st_j = dict(zip("hcnm", map(jnp.asarray, carry)))
    x = _x((2, 1, d), 31)
    got, st = xlstm.slstm_decode(to_torch(p_j), torch.from_numpy(x),
                                 to_torch(st_j), n_heads=2)
    want, want_st = jxlstm.slstm_decode(p_j, jnp.asarray(x), st_j, n_heads=2)
    assert got.shape == (2, 1, d)
    _close(got, want)
    for name in "hcnm":
        _close(st[name], want_st[name])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("s", [1, 17, 64])
@pytest.mark.parametrize("d", [32, 48])
def test_block_gradients_match_jax_vjp(s, d):
    """The gradient of ``slstm_block`` (autograd through ``SLSTMScan``, whose
    CPU backward is ``slstm_scan_bwd_plain``) against ``jax.vjp`` of the
    reference's, for x and every parameter leaf, at 1e-4 of each leaf's
    largest magnitude."""
    _block_gradients_match_jax_vjp(s, d)


@pytest.mark.parametrize("s", [1, 17, 64])
@pytest.mark.parametrize("d", [32, 48])
def test_linear_backward_matches_jax_vjp(s, d, monkeypatch):
    """The same with ``SLSTMScan``'s CPU backward replaced by
    ``slstm_scan_bwd_linear``, the kernel's coefficients, linear
    chain and gate gradients: against ``jax.vjp`` at the same limit."""
    monkeypatch.setattr(slstm_scan, "slstm_scan_bwd_plain",
                        slstm_scan.slstm_scan_bwd_linear)
    _block_gradients_match_jax_vjp(s, d)


def _block_gradients_match_jax_vjp(s, d):
    p_j = jxlstm.init_slstm(jax.random.PRNGKey(3 * d + s), d, 2)
    x, dy = _x((2, s, d), 40 + s), _x((2, s, d), 50 + s)
    y_j, vjp = jax.vjp(lambda p, xx: jxlstm.slstm_block(p, xx, n_heads=2),
                       p_j, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(dy))
    p = {k: v.requires_grad_() for k, v in to_torch(p_j).items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = xlstm.slstm_block(p, xt, n_heads=2)
    y.backward(torch.from_numpy(dy))
    _close(y.detach(), y_j)
    want = dict(_leaves(jax.tree.map(np.asarray, gp_j)))
    want["/x"] = np.asarray(gx_j)
    got = {f"/{k}": v.grad.numpy() for k, v in p.items()}
    got["/x"] = xt.grad.numpy()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert np.abs(got[key] - w).max() <= GRAD_TOL * np.abs(w).max(), key


def _f64_inputs(b, s, d, carry_kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    gx, r = rn(b, s, 4, d), rn(4, d) * 0.3
    if carry_kind == "zero":
        carry = [torch.zeros(b, d, dtype=torch.float64) for _ in range(4)]
    else:
        carry = [rn(b, d) * 0.5, rn(b, d), rn(b, d).abs() + 1.5, rn(b, d)]
    return [t.requires_grad_() for t in (gx, r, *carry)]


@pytest.mark.parametrize("carry_kind", ["zero", "random"])
@pytest.mark.parametrize("b,s,d", [(2, 9, 5), (1, 1, 3), (3, 4, 2)])
def test_gradcheck_in_float64(b, s, d, carry_kind):
    """``SLSTMScan`` against central differences in float64 (the plain
    versions compute float64 inputs in float64), hs and the last carry
    with respect to gx, r and the initial carry.  With a zero carry the
    first step's n' is exactly 1 wherever pre_i >= pre_f: the half each
    side takes at that tie (JAX's rule) is what a central difference
    gives."""
    def fn(*ins):
        hs, last = slstm_scan.slstm_scan(ins[0], ins[1], ins[2:])
        return (hs, *last)
    assert torch.autograd.gradcheck(fn, _f64_inputs(b, s, d, carry_kind))


def test_float64_backward_on_dense_gradients_matches_autograd():
    """The plain backward in float64, on dense random gradients of hs and
    the last carry (gradcheck's are one-hot, exact in any width), against
    autograd through the per-token loop of ``slstm_cell`` from a random
    carry (no ties): equal to 1e-10, so no input is rounded to float32 on
    the way."""
    b, s, d = 2, 7, 5
    ins = _f64_inputs(b, s, d, "random")
    g = torch.Generator().manual_seed(3)
    dhs = torch.randn(b, s, d, generator=g, dtype=torch.float64)
    dlast = [torch.randn(b, d, generator=g, dtype=torch.float64)
             for _ in range(4)]
    hs, last = slstm_scan.slstm_scan(ins[0], ins[1], ins[2:])
    got = torch.autograd.grad((hs, *last), ins, (dhs, *dlast))
    carry, steps = tuple(ins[2:]), []
    for t in range(s):
        carry = slstm_scan.slstm_cell(ins[0][:, t], ins[1], carry)
        steps.append(carry[0])
    want = torch.autograd.grad((torch.stack(steps, 1), *carry), ins,
                               (dhs, *dlast))
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=1e-10, atol=1e-10)


def test_zero_carry_tie_gives_half_to_n():
    """At the first step from a zero carry with pre_i > pre_f, n' = 1: the
    initial carry's dn is the half JAX's rule gives, against the whole
    that ``torch.clamp``'s gradient would pass."""
    gx, r, carry = _tie_inputs()
    carry = [t.requires_grad_() for t in carry]
    hs, _ = slstm_scan.slstm_scan(gx, r, carry)
    hs.sum().backward()
    fg = np.exp(0.0 - 1.0)                         # exp(fm - m'), m' = 1
    c = np.tanh(0.5)
    o = 1 / (1 + np.exp(-0.2))
    # dh'/dn' = -o c / n'^2 = -o c at n' = 1, half of it; dn = dn' * fg
    assert float(carry[2].grad) == pytest.approx(-0.5 * o * c * fg)


def _tie_inputs():
    """``test_zero_carry_tie_gives_half_to_n``'s input: one unit, one step
    from a zero carry with pre_i > pre_f (n' = 1 exactly)."""
    gx = torch.tensor([[[[1.0], [0.0], [0.5], [0.2]]]], dtype=torch.float64)
    return gx, torch.zeros(4, 1, dtype=torch.float64), [
        torch.zeros(1, 1, dtype=torch.float64) for _ in range(4)]


@pytest.mark.parametrize("case", ["tie", "zero-2x9x5", "random-2x9x5",
                                  "zero-1x1x3", "random-3x16x4",
                                  "zero-3x33x2", "random-1x40x6"])
def test_linear_backward_equals_the_sequential_in_float64(case):
    """``slstm_scan_bwd_linear`` (every step's coefficients at once, then
    the linear chain, then the gate gradients: the kernel's order)
    against ``slstm_scan_bwd_plain`` (the reverse recurrence a step at a
    time) in float64 on dense random gradients: dgx step for step, dr and
    the initial carry's gradient equal to 1e-12, the ties included (a zero
    carry's first step, where n' = 1 exactly wherever pre_i >= pre_f)."""
    if case == "tie":
        gx, r, carry = _tie_inputs()
    else:
        kind, shape = case.split("-")
        b, s, d = map(int, shape.split("x"))
        gx, r, *carry = (t.detach() for t in _f64_inputs(b, s, d, kind, 5))
    b, s, _, d = gx.shape
    hs, _, kept = slstm_scan.slstm_scan_keep(gx, r, carry)
    g = torch.Generator().manual_seed(11)
    dhs = torch.randn(b, s, d, generator=g, dtype=torch.float64)
    dlast = [torch.randn(b, d, generator=g, dtype=torch.float64)
             for _ in range(4)]
    want = slstm_scan.slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs,
                                           dlast)
    got = slstm_scan.slstm_scan_bwd_linear(gx, r, carry, hs, kept, dhs,
                                           dlast)
    assert got[0].dtype == got[1].dtype == torch.float64
    for u, v in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        torch.testing.assert_close(u, v, rtol=1e-12, atol=1e-12)


def test_plain_backward_computes_in_float64():
    """``slstm_scan_bwd_plain`` on float32 inputs is its float64 result
    rounded to float32, bit for bit: the reference the float32 kernels
    are held to (the same recurrence run in float32 is itself off by up to
    4e-4 of (1 + |dr|) at S 1024)."""
    b, s, d = 2, 23, 6
    gx, r, *carry = (t.detach().float() for t in _f64_inputs(b, s, d,
                                                             "random", 8))
    hs, _, kept = slstm_scan.slstm_scan_keep(gx, r, carry)
    g = torch.Generator().manual_seed(9)
    dhs = torch.randn(b, s, d, generator=g)
    dlast = [torch.randn(b, d, generator=g) for _ in range(4)]
    got = slstm_scan.slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs, dlast)
    f64 = lambda ts: [t.double() for t in ts]
    want = slstm_scan.slstm_scan_bwd_plain(*f64((gx, r)), f64(carry),
                                           *f64((hs, kept, dhs)), f64(dlast))
    for u, v in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert u.dtype == torch.float32 and torch.equal(u, v.float())


def test_padded_width_is_a_pure_function_of_the_shape():
    """``padded_width`` leaves every main-path width as it is (xlstm-125m's
    d 768 and its reduced d, float32 and bfloat16: a whole number of 16
    bytes, so the kernels run them unpadded) and rounds the others up to
    16 bytes (``chip_smoke.SLSTM_CASES``' d 33 in either dtype and d 100 in
    bfloat16); no kernel for float64.  A contiguous tensor off a 16-byte
    boundary is copied before the kernels' 16-byte loads."""
    import chip_smoke as cs
    width = slstm_scan.padded_width
    full = tconfigs.ARCHS["xlstm-125m"]
    for d in (full.d_model, full.reduced().d_model, cs.SLSTM_PREFILL[2],
              cs.SLSTM_TRAIN[2]):
        for dtype in (torch.float32, torch.bfloat16):
            assert width(d, dtype) == d
    want = {(33, torch.float32): 36, (33, torch.bfloat16): 40,
            (100, torch.bfloat16): 104}
    for _, _, d, _ in cs.SLSTM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            assert width(d, dtype) == want.get((d, dtype), d), (d, dtype)
    with pytest.raises(ValueError):
        width(768, torch.float64)
    off = torch.zeros(20)[1:]
    assert off.data_ptr() % 16 and off.is_contiguous()
    fixed = slstm_scan._aligned(off)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)
    whole = torch.zeros(20)
    assert slstm_scan._aligned(whole) is whole


@pytest.mark.parametrize("d,dtype", [(33, torch.float32),
                                     (33, torch.bfloat16),
                                     (100, torch.bfloat16)])
def test_zero_padded_units_change_no_other(d, dtype):
    """The wrapper's padding for a d off 16 bytes, on the plain versions in
    float64: units of zeros (gx, r, carry, dhs, the last carry's gradient)
    beside d random ones up to ``padded_width`` leave every output of the
    d units as it is without them (hs, the last and kept carry, dgx, dr,
    the initial carry's gradient), stay finite in the pad, and get zero
    gradients there."""
    width = slstm_scan.padded_width(d, dtype)
    b, s = 2, 13
    gx, r, *carry = (t.detach() for t in _f64_inputs(b, s, d, "random", 4))
    g = torch.Generator().manual_seed(12)
    dhs = torch.randn(b, s, d, generator=g, dtype=torch.float64)
    dlast = [torch.randn(b, d, generator=g, dtype=torch.float64)
             for _ in range(4)]
    pad = lambda ts: [slstm_scan._pad(t, width) for t in ts]

    def run(gx, r, carry, dhs, dlast):
        hs, last, kept = slstm_scan.slstm_scan_keep(gx, r, carry)
        return (hs, *last, kept, *_flat_bwd(slstm_scan.slstm_scan_bwd_plain(
            gx, r, carry, hs, kept, dhs, dlast)))

    want = run(gx, r, carry, dhs, dlast)
    got = run(*pad((gx, r)), pad(carry), *pad((dhs,)), pad(dlast))
    for u, v in zip(got, want):
        assert u.shape[-1] == width and bool(torch.isfinite(u).all())
        torch.testing.assert_close(u[..., :d], v, rtol=1e-12, atol=1e-12)
    for u in got[6:]:                                  # the gradients
        assert not bool(u[..., d:].any())


def _flat_bwd(grads):
    """(dgx, dr, dh0, dc0, dn0, dm0) of a backward's result."""
    return (grads[0], grads[1], *grads[2])


def test_autograd_runs_the_plain_backward_once(monkeypatch):
    """Under grad mode the CPU path goes through ``SLSTMScan``: one plain
    forward keeping the carry, one plain backward; without a gradient
    nothing is kept."""
    calls = {"keep": 0, "bwd": 0}
    plain, bwd = slstm_scan._plain, slstm_scan.slstm_scan_bwd_plain

    def count_plain(gx, r, carry, keep):
        calls["keep"] += keep
        return plain(gx, r, carry, keep)

    def count_bwd(*args):
        calls["bwd"] += 1
        return bwd(*args)

    monkeypatch.setattr(slstm_scan, "_plain", count_plain)
    monkeypatch.setattr(slstm_scan, "slstm_scan_bwd_plain", count_bwd)
    p_j = jxlstm.init_slstm(jax.random.PRNGKey(0), 32, 2)
    p = {k: v.requires_grad_() for k, v in to_torch(p_j).items()}
    x = torch.from_numpy(_x((2, 10, 32), 1))
    with torch.no_grad():
        xlstm.slstm_block(p, x, n_heads=2)
    assert calls == {"keep": 0, "bwd": 0}
    xlstm.slstm_block(p, x, n_heads=2).sum().backward()
    assert calls == {"keep": 1, "bwd": 1}
    assert slstm_scan.launches.count == slstm_scan.bwd_launches.count == 0


def test_scan_refuses_what_does_not_fit():
    """Shapes, mixed dtypes, non-contiguous inputs and other devices
    raise."""
    gx = torch.zeros(2, 3, 4, 8)
    r, carry = torch.zeros(4, 8), tuple(torch.zeros(2, 8) for _ in range(4))
    with pytest.raises(ValueError):
        ops.slstm_scan(torch.zeros(2, 3, 5, 8), r, carry)
    with pytest.raises(ValueError):
        ops.slstm_scan(gx, torch.zeros(4, 7), carry)
    with pytest.raises(ValueError):
        ops.slstm_scan(gx, r, carry[:3])
    with pytest.raises(ValueError):
        ops.slstm_scan(gx, r.double(), carry)
    with pytest.raises(ValueError):
        ops.slstm_scan(gx.transpose(0, 1).contiguous().transpose(0, 1), r,
                       carry)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_path_gives_the_plain_shapes(dtype):
    """Forward (with the kept carry ``SLSTMScan`` saves) and backward on the
    meta device: the plain version's shapes and dtypes, and the work
    ``kernels/work.py`` prices, reported in place of a launch."""
    b, s, d = 2, 11, 24
    g = torch.Generator().manual_seed(0)
    cpu = [torch.randn(b, s, 4, d, generator=g), torch.randn(4, d,
                                                             generator=g),
           *(torch.randn(b, d, generator=g) for _ in range(4))]
    cpu = [t.to(dtype).requires_grad_() for t in cpu]
    meta = [t.detach().to("meta").requires_grad_() for t in cpu]
    want = slstm_scan.slstm_scan_keep(cpu[0].detach(), cpu[1].detach(),
                                      [t.detach() for t in cpu[2:]])
    got = slstm_scan.slstm_scan_keep(meta[0].detach(), meta[1].detach(),
                                     [t.detach() for t in meta[2:]])
    shapes = lambda out: [(tuple(t.shape), t.dtype)
                          for t in (out[0], *out[1], out[2])]
    assert shapes(got) == shapes(want)
    hs, last = slstm_scan.slstm_scan(cpu[0], cpu[1], cpu[2:])
    want_g = torch.autograd.grad(hs.float().sum() + last[1].float().sum(),
                                 cpu)
    with work.collect() as calls:
        hs, last = slstm_scan.slstm_scan(meta[0], meta[1], meta[2:])
        got_g = torch.autograd.grad(hs.float().sum()
                                    + last[1].float().sum(), meta)
    assert hs.device.type == "meta"
    assert [(tuple(t.shape), t.dtype) for t in got_g] == [
        (tuple(t.shape), t.dtype) for t in want_g]
    assert calls == [("slstm_scan", *work.slstm_work(b, s, d, dtype, True)),
                     ("slstm_scan_bwd", *work.slstm_bwd_work(
                         b, s, d, dtype, kept=True))]
    assert slstm_scan.launches.count == slstm_scan.bwd_launches.count == 0


def test_work_prices_bytes_at_the_main_paths_shapes():
    """At the 1024-token prefill [1, 1024, 4, 768] float32 the forward
    moves 15.7 MB, bytes-bound at ~4.7 us.  At training's [2, 2048, 4, 768]
    the forward's function moves ~63 MB, and the kernel writes ~38 MB more
    of kept carry; the backward reads gx and dhs and writes dgx, ~113 MB
    (~34 us), or ~164 MB reading hs and the kept carry too: the bound is
    the smaller, the recomputing way's."""
    flops, nbytes = work.slstm_work(1, 1024, 768, torch.float32, False)
    ms, by = work.bound(flops, nbytes)
    assert by == "bytes" and nbytes == pytest.approx(15.7e6, rel=0.01)
    assert ms == pytest.approx(4.7e-3, rel=0.01)
    _, fwd = work.slstm_work(2, 2048, 768, torch.float32, False)
    _, fwd_kept = work.slstm_work(2, 2048, 768, torch.float32, True)
    assert fwd == pytest.approx(62.9e6, rel=0.01)
    assert fwd_kept - fwd == pytest.approx(37.7e6, rel=0.01)
    ways = {kept: work.slstm_bwd_work(2, 2048, 768, torch.float32, kept)
            for kept in (True, False)}
    assert ways[True][0] == ways[False][0]          # the same flops
    assert ways[True][1] == pytest.approx(164e6, rel=0.01)
    assert ways[False][1] == pytest.approx(113e6, rel=0.01)
    ms, by = min(work.bound(*w) for w in ways.values())
    assert by == "bytes" and ms == pytest.approx(0.0338, rel=0.01)


def test_init_params_runs_on_the_card_unless_asked(monkeypatch):
    """``init_params`` without a device means the card: without one it
    raises and names the way to the CPU; ``device="cpu"`` builds the
    tree."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.ARCHS["xlstm-125m"].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    tree = init_params(cfg, device="cpu")
    r = tree["stacks"]["slstm"]["slstm"]["r_gates"]
    assert r.device.type == "cpu" and r.shape[1:] == (4, cfg.d_model)
