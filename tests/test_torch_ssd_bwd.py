"""The SSD scan's backward on the CPU, against the JAX package's gradient:
``jax.vjp`` of ``repro.kernels.ref.ssd_ref`` (the JAX package has no
Pallas backward; its training gradient is autodiff of that sequential
scan).  The port's plain backward walks the backward kernel's passes (it
reads C . B^T, Acum and h_c from the forward's kept scratch, laid out as
the kernel's; the dual's local states and R_c passed backward along the
chunks; M, dx and the da terms; each head's db and dc; the sums over
heads; da's reverse cumulative sum), so these tests hold the kernel's
algorithm; the kernel itself is held to
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: the reference's SSD tolerance (``tests/test_kernels.py``),
3e-3 of each gradient's largest magnitude; against torch autograd through
the plain forward (the port's gradient before the backward existed), the
same.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ssd_scan
from repro_torch.models import forward, init_params, layer_plan

torch.set_num_threads(1)

TOL = 3e-3

CASES = [  # (b, s, h, d, n, decay)
    (2, 130, 4, 32, 16, "mild"),      # zamba2-like heads (narrow), ragged
    (1, 64, 1, 384, 384, "strong"),   # mLSTM's values: D = N = 384
    (1, 128, 1, 96, 96, "mild"),      # D = N wide, two chunks
    (3, 192, 1, 1, 8, "strong"),      # the mLSTM normalizer's D = 1
    (1, 100, 2, 16, 8, "mild"),       # a ragged last chunk
    (2, 40, 2, 16, 16, "mild"),       # S shorter than one chunk
    (3, 150, 2, 48, 100, "strong"),   # B > 1, D and N off the 64-tiles
    (2, 200, 3, 8, 8, "strong"),      # strong decay over four chunks
]


def _inputs(b, s, h, d, n, decay, seed=0):
    """x, a, b, c and dy as numpy float32.  ``decay``: "mild" (a = -|z| /
    10) or "strong" (a uniform down to log 1e-6 a token, mLSTM's floor)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, d), dtype=np.float32) * 0.5
    if decay == "mild":
        a = -np.abs(rng.standard_normal((b, s, h), dtype=np.float32)) * 0.1
    else:
        a = np.log(1e-6) * rng.random((b, s, h), dtype=np.float32)
    bm = rng.standard_normal((b, s, n), dtype=np.float32) * n ** -0.25
    cm = rng.standard_normal((b, s, n), dtype=np.float32) * n ** -0.25
    dy = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return x, a.astype(np.float32), bm, cm, dy


def _jax_grads(x, a, b, c, dy):
    y, vjp = jax.vjp(jref.ssd_ref, *map(jnp.asarray, (x, a, b, c)))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _assert_close(got, want, tol=TOL):
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), name


def _torch(*arrays):
    return [torch.from_numpy(np.array(v, np.float32)) for v in arrays]


@pytest.mark.parametrize("b,s,h,d,n,decay", CASES)
def test_plain_backward_matches_jax_vjp(b, s, h, d, n, decay):
    """dx, da, db and dc of the plain backward, fed the reference's own
    output y, against ``jax.vjp(ssd_ref)``."""
    x, a, bm, cm, dy = _inputs(b, s, h, d, n, decay)
    y, want = _jax_grads(x, a, bm, cm, dy)
    got = ssd_scan.ssd_scan_bwd_plain(*_torch(x, a, bm, cm, y, dy))
    _assert_close([t.numpy() for t in got], want)


def _count_forwards(monkeypatch) -> list:
    """Records each call of the scan's forward (its ``keep`` flag)."""
    kept = []
    fwd = ssd_scan._forward

    def spy(*args):
        kept.append(len(args) > 4 and args[4])
        return fwd(*args)

    monkeypatch.setattr(ssd_scan, "_forward", spy)
    return kept


@pytest.mark.parametrize("b,s,h,d,n,decay", CASES)
def test_autograd_through_the_scan_matches_jax_vjp(b, s, h, d, n, decay,
                                                   monkeypatch):
    """``ops.ssd_scan`` under autograd (``SSDScan``: the plain forward,
    which keeps its scratch, then the plain backward, which reads it)
    against ``jax.vjp(ssd_ref)``, and against torch autograd through the
    plain forward's own operations.  The forward runs once, keeping its
    scratch: the backward runs none of its own."""
    forwards = _count_forwards(monkeypatch)
    x, a, bm, cm, dy = _inputs(b, s, h, d, n, decay, seed=1)
    _, want = _jax_grads(x, a, bm, cm, dy)
    leaves = [t.requires_grad_() for t in _torch(x, a, bm, cm)]
    out = ops.ssd_scan(*leaves)
    assert isinstance(out.grad_fn, ssd_scan.SSDScan._backward_cls)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and saved[5].numel() == ssd_scan.scratch_floats(
        b, s, h, d, n)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    assert forwards == [True]                     # the kept scratch
    _assert_close([t.numpy() for t in got], want)
    twins = [t.detach().clone().requires_grad_() for t in leaves]
    direct = torch.autograd.grad(ssd_scan.ssd_scan_plain(*twins), twins,
                                 torch.from_numpy(dy))
    _assert_close([t.numpy() for t in got], [t.numpy() for t in direct])


def test_plain_backward_keeps_bfloat16():
    """bfloat16 inputs give bfloat16 gradients within 2e-2 of the float32
    reference's on the same (rounded) values."""
    x, a, bm, cm, dy = _inputs(1, 96, 2, 32, 16, "mild", seed=2)
    bf = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, a, bm, cm, dy)]
    rounded = [t.float().numpy() for t in bf]
    y, want = _jax_grads(*rounded)
    got = ssd_scan.ssd_scan_bwd_plain(*bf[:4], torch.from_numpy(y).to(
        torch.bfloat16), bf[4])
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_close([g.float().numpy() for g in got], want, tol=2e-2)


@given(st.integers(min_value=1, max_value=3).map(lambda i: 64 * i - 13),
       st.sampled_from([1, 2, 4]),
       st.sampled_from([8, 16]))
@settings(max_examples=10, deadline=None)
def test_plain_backward_property_random_shapes(s, h, n):
    """Property: the chunked backward == the sequential oracle's gradient
    across random shapes (ragged S, one to three chunks)."""
    x, a, bm, cm, dy = _inputs(1, s, h, 16, n, "mild", seed=s + h + n)
    y, want = _jax_grads(x, a, bm, cm, dy)
    got = ssd_scan.ssd_scan_bwd_plain(*_torch(x, a, bm, cm, y, dy))
    _assert_close([t.numpy() for t in got], want)


def test_no_graph_and_nothing_saved_without_a_gradient(monkeypatch):
    """Under ``no_grad`` or ``inference_mode``, or with no input that
    requires grad, the scan runs outside ``SSDScan``: no ``grad_fn``, no
    saved tensors."""
    def refuse(*_):
        raise AssertionError("SSDScan ran without a gradient asked for")

    monkeypatch.setattr(ssd_scan.SSDScan, "forward", staticmethod(refuse))
    x, a, bm, cm = _torch(*_inputs(1, 70, 2, 8, 8, "mild", seed=3)[:4])
    assert ops.ssd_scan(x, a, bm, cm).grad_fn is None
    x.requires_grad_()
    with torch.no_grad():
        assert ops.ssd_scan(x, a, bm, cm).grad_fn is None
    with torch.inference_mode():
        assert ops.ssd_scan(x, a, bm, cm).grad_fn is None


@pytest.mark.parametrize("b,s,h,d,n,decay", CASES)
def test_kept_scratch_is_laid_out_as_the_kernels(b, s, h, d, n, decay):
    """The forward that keeps its scratch gives ``ssd_scan_plain``'s y,
    and the scratch is what the backward kernel reads: C . B^T ``[B, nc,
    L, L]``, Acum ``[B, nc, H, L]`` and h_c ``[B, nc, H, N, D]`` (the
    state at each chunk's start, here from the sequential recurrence), a
    ragged chunk zero-padded.  The backward given it gives the bits of
    the backward that runs the forward itself."""
    x, a, bm, cm, dy = _torch(*_inputs(b, s, h, d, n, decay, seed=5))
    y, saved = ssd_scan.ssd_scan_keep(x, a, bm, cm)
    assert torch.equal(y, ssd_scan.ssd_scan_plain(x, a, bm, cm))
    assert saved.dtype == torch.float32 and saved.shape == (
        ssd_scan.scratch_floats(b, s, h, d, n),)
    ln = ssd_scan.CHUNK
    nc = -(-s // ln)
    pad = nc * ln - s
    k1, k2 = b * nc * ln * ln, b * nc * (ln * ln + h * ln)
    bp, cp = (F.pad(t, (0, 0, 0, pad)).view(b, nc, ln, n) for t in (bm, cm))
    torch.testing.assert_close(saved[:k1].view(b, nc, ln, ln),
                               torch.einsum("bctn,bcun->bctu", cp, bp),
                               rtol=1e-5, atol=1e-5)
    acum = F.pad(a, (0, 0, 0, pad)).view(b, nc, ln, h).cumsum(2)
    torch.testing.assert_close(saved[k1:k2].view(b, nc, h, ln),
                               acum.transpose(2, 3), rtol=1e-5, atol=1e-5)
    hs = saved[k2:].view(b, nc, h, n, d)
    state = torch.zeros(b, h, n, d)
    for t in range(s):
        if t % ln == 0:
            torch.testing.assert_close(hs[:, t // ln], state, rtol=1e-4,
                                       atol=1e-4)
        state = (torch.exp(a[:, t])[..., None, None] * state
                 + bm[:, t, None, :, None] * x[:, t, :, None, :])
    kept = ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, dy, saved=saved)
    for u, v in zip(kept, ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, dy)):
        assert torch.equal(u, v)


def test_no_grad_forward_keeps_nothing(monkeypatch):
    """A forward with no gradient asked (``no_grad``, ``inference_mode``,
    or no input that requires grad) asks the plain forward for no scratch,
    and its output carries no graph that could hold one."""
    asked = []
    plain = ssd_scan._plain_forward

    def spy(*args):
        asked.append(args[4] if len(args) > 4 else True)
        return plain(*args)

    monkeypatch.setattr(ssd_scan, "_plain_forward", spy)
    x, a, bm, cm = _torch(*_inputs(1, 70, 2, 8, 8, "mild", seed=7)[:4])
    assert ops.ssd_scan(x, a, bm, cm).grad_fn is None
    x.requires_grad_()
    with torch.no_grad():
        assert ops.ssd_scan(x, a, bm, cm).grad_fn is None
    with torch.inference_mode():
        assert ops.ssd_scan(x, a, bm, cm).grad_fn is None
    assert asked == [False, False, False]
    out = ops.ssd_scan(x, a, bm, cm)      # a gradient asked: kept
    assert asked[-1] is True and out.grad_fn is not None


def test_backward_refuses_what_does_not_fit():
    x, a, bm, cm, dy = _torch(*_inputs(1, 70, 2, 8, 8, "mild", seed=4))
    y = ssd_scan.ssd_scan_plain(x, a, bm, cm)
    with pytest.raises(ValueError):                  # dy's shape
        ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, dy[:, :10])
    with pytest.raises(ValueError):                  # y's dtype
        ssd_scan.ssd_scan_bwd(x, a, bm, cm, y.double(), dy)
    with pytest.raises(ValueError):                  # b and c differ
        ssd_scan.ssd_scan_bwd(x, a, bm, cm[..., :4], y, dy)
    _, saved = ssd_scan.ssd_scan_keep(x, a, bm, cm)
    for bad in (saved[:-1], saved.double(), saved.view(1, -1)):
        with pytest.raises(ValueError):              # not the kept scratch
            ssd_scan.ssd_scan_bwd(x, a, bm, cm, y, dy, saved=bad)


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b"])
def test_remat_runs_the_forward_twice_and_the_backward_once(arch,
                                                            monkeypatch):
    """``forward(..., remat=True)`` runs each scan's forward again in the
    backward (``torch.utils.checkpoint``) and its backward once; remat's
    gradients equal the plain step's bit for bit.  Every backward reads
    the kept scratch and runs no forward of its own: under remat the first
    forward runs without grad and keeps nothing, and the forward run again
    keeps its scratch."""
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = ssd_scan._forward, ssd_scan.ssd_scan_bwd_plain

    def count_fwd(*args):
        calls["forward"] += 1
        return fwd(*args)

    def count_bwd(*args):
        calls["backward"] += 1
        return bwd(*args)

    monkeypatch.setattr(ssd_scan, "_forward", count_fwd)
    monkeypatch.setattr(ssd_scan, "ssd_scan_bwd_plain", count_bwd)
    cfg = get_config(arch).reduced()
    plan = layer_plan(cfg)
    scans = plan.count("mamba2") + 2 * plan.count("mlstm")
    params = init_params(cfg, seed=0, device="cpu")
    flat = [p.requires_grad_() for p in _leaves(params)]
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    grads = {}
    for remat in (False, True):
        calls.update(forward=0, backward=0)
        logits, _ = forward(params, cfg, tokens, remat=remat)
        grads[remat] = torch.autograd.grad(logits.square().mean(), flat)
        assert calls == {"forward": scans * (2 if remat else 1),
                         "backward": scans}, (remat, calls)
    for g, w in zip(grads[True], grads[False]):
        assert torch.equal(g, w)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_ssd_bwd",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_chip_smoke_checks_the_backward_at_the_training_shapes(arch,
                                                               monkeypatch):
    """``chip_smoke.py`` holds the backward kernel to its plain version and
    times it at ``SSD_BWD_TRAIN``'s shapes: they must be the (B, S, H, D,
    N) of every scan that phase 8's training step of the full-width model
    calls (xlstm folds its mLSTM heads into the batch).  The model runs on
    the meta device, shapes only, with the kernels' wrappers stubbed."""
    cs = _chip_smoke()
    run = next(r for r in cs.TRAIN_RUNS if r["arch"] == arch)
    seen = set()

    def scan(x, a, b, c):
        seen.add(tuple(x.shape) + (b.shape[-1],))
        return torch.empty_like(x)

    monkeypatch.setattr(ops, "ssd_scan", scan)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: torch.empty_like(q))
    cfg = get_config(arch)
    tokens = torch.zeros(run["batch"], run["seq"], dtype=torch.long,
                         device="meta")
    forward(init_params(cfg, device="meta"), cfg, tokens)
    checked = {case[:5] for case in cs.SSD_BWD_TRAIN.values()}
    assert seen and seen <= checked, (seen, checked)
    assert {case[:5] for case in cs.SSD_BWD_CASES} >= checked
