"""The port's MoE family (qwen3-moe, moonshot) against the JAX package's, on
the CPU.

Weights are initialised by the JAX package and bridged leaf for leaf
(``repro_torch.bridge``); activations and tokens come from numpy seeds.
``moe_block`` is held at 2e-4 in float32 with the same routing; the aux
loss at rel 1e-5; the reduced models' logits at the reference's model
tolerance, rel 5e-3 (``tests/test_models.py``).

bfloat16 has no tolerance of the reference's own.  A routing flip (two
router probabilities within bfloat16's rounding of each other) moves one
token's logits by 0.2-0.9 of their largest, in the reference itself
against its float32 run, so a bound on the largest error over tokens
bounds nothing.  The port's bfloat16 tolerance is on the median over
tokens of each token's rel: ``BF16_MODEL_TOL`` = 0.1, twice the largest
median drift of the reference's bfloat16 run from its float32 run, to one
figure (0.012-0.051 over 16 runs of the reduced models by
``tools/moe_bf16_drift.py``: both archs, capacity 1.25 and 16, 4 seeds,
B = 2, S = 130; the port's median drift from the reference's bfloat16 run
there 0.012-0.026).  The test asserts the grounding on its own inputs
too.  A fault planted in decode fails these limits (the expert and
routing faults in bfloat16; every one in float32).  The drift grows with
depth: ``chip_smoke.py`` holds the 48-layer models' prefill + decode
against their forward at 0.2, the reference's own largest median on that
same comparison at 48 layers, and checks the same path at full width and
6 layers in float32 at rel 5e-3.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models.transformer import layer_plan as jlayer_plan
from repro.models.transformer import prefill as jprefill
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_moe, init_params, layer_plan, moe_block,
                                prefill)
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import route
from _torch_model_checks import (check_forward, check_full_width_tree,
                                 check_init_scales, check_prefill_and_decode,
                                 check_prefill_then_decode_equals_forward,
                                 rel_by_token)

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
BF16_MODEL_TOL = 0.1


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _reference_routing(p, x, top_k, capacity_factor):
    """``expert_idx`` and ``keep`` as the reference's ``moe_block`` forms
    them (``repro/models/moe.py``), for one group."""
    n_experts = p["router"].shape[-1]
    xg = jnp.asarray(x).reshape(1, -1, x.shape[-1])
    probs = jax.nn.softmax(xg @ p["router"], axis=-1)
    _, expert_idx = jax.lax.top_k(probs, top_k)
    sg = xg.shape[1]
    capacity = max(1, int(capacity_factor * sg * top_k / n_experts))
    oh = jax.nn.one_hot(expert_idx, n_experts).reshape(1, sg * top_k, -1)
    pos = jnp.einsum("gne,gne->gn", jnp.cumsum(oh, axis=1) - 1, oh)
    return (np.asarray(expert_idx),
            np.asarray(pos.reshape(1, sg, top_k) < capacity))


def _both(p_j, x, **kw):
    got = moe_block(to_torch(p_j), torch.from_numpy(x), **kw)
    want = jmoe.moe_block(p_j, jnp.asarray(x), **kw)
    return got, want


# -- the block ---------------------------------------------------------------

@pytest.mark.parametrize("s", [40, 1])      # 40: slots; 1: pairs (decode)
@pytest.mark.parametrize("shared_ff", [0, 48])
def test_moe_block_matches_reference(s, shared_ff):
    p_j = jmoe.init_moe(jax.random.PRNGKey(1), 32, 8, 64, shared_ff)
    x = _x((2, s, 32), seed=s)
    (y, aux), (y_j, aux_j) = _both(p_j, x, top_k=2)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=2e-4)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(aux_j), rel=1e-5)
    y_no_aux, no_aux = moe_block(to_torch(p_j), torch.from_numpy(x), top_k=2,
                                 with_aux=False)
    assert no_aux is None and torch.equal(y_no_aux, y)
    idx, _, _, keep, _, _ = route(to_torch(p_j),
                                  torch.from_numpy(x).reshape(1, -1, 32), 2,
                                  1.25)
    want_idx, want_keep = _reference_routing(p_j, x, 2, 1.25)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)


def test_moe_block_groups_tokens_as_the_reference():
    """24 tokens in groups of 8: capacity and queue positions per group."""
    p_j = jmoe.init_moe(jax.random.PRNGKey(2), 32, 8, 64)
    x = _x((3, 8, 32), seed=3)
    (y, aux), (y_j, aux_j) = _both(p_j, x, top_k=2, group_size=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=2e-4)
    assert float(aux) == pytest.approx(float(aux_j), rel=1e-5)


def test_moe_capacity_overflow_drops_tokens_through_the_residual():
    """A router that sends every token to expert 0 first: past its
    capacity, a token's first choice is dropped, and with top-1 its
    output row is 0."""
    p_j = jmoe.init_moe(jax.random.PRNGKey(3), 32, 8, 64)
    p_j["router"] = p_j["router"].at[0, 0].set(100.0)
    x = _x((1, 64, 32), seed=4)
    x[..., 0] = 1.0                     # expert 0's logit 100 higher
    (y, aux), (y_j, aux_j) = _both(p_j, x, top_k=1, capacity_factor=1.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=2e-4)
    assert float(aux) == pytest.approx(float(aux_j), rel=1e-5)
    idx, _, pos, keep, capacity, _ = route(
        to_torch(p_j), torch.from_numpy(x).reshape(1, 64, 32), 1, 1.0)
    assert capacity == 8 and bool((idx == 0).all())
    np.testing.assert_array_equal(pos.reshape(-1).numpy(), np.arange(64))
    assert int(keep.sum()) == 8
    assert bool((y[0, 8:] == 0).all()) and bool((y[0, :8] != 0).any())
    np.testing.assert_array_equal(keep.numpy(),
                                  _reference_routing(p_j, x, 1, 1.0)[1])


def test_uniform_router_aux_loss_is_one_and_ties_pick_the_reference_experts():
    """All router probabilities equal (every top-k choice a tie): the aux
    loss is 1 and the experts are the lowest-numbered, as ``jax.lax.top_k``
    picks them."""
    p_j = jmoe.init_moe(jax.random.PRNGKey(0), 32, 8, 64)
    p_j["router"] = jnp.zeros_like(p_j["router"])
    x = _x((2, 64, 32), seed=5)
    (y, aux), (y_j, aux_j) = _both(p_j, x, top_k=2)
    assert float(aux) == pytest.approx(1.0, rel=1e-6)
    assert float(aux) == pytest.approx(float(aux_j), rel=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=2e-4)
    idx = route(to_torch(p_j), torch.from_numpy(x).reshape(1, 128, 32), 2,
                1.25)[0]
    want_idx, _ = _reference_routing(p_j, x, 2, 1.25)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert set(np.unique(want_idx)) == {0, 1}


def test_init_moe_tree_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = init_moe(64, 16, 96, 48, gen=gen, device="cpu", dtype=torch.bfloat16,
                 stack=(3,))
    want = jax.eval_shape(lambda k: jmoe.init_moe(k, 64, 16, 96, 48),
                          jax.random.PRNGKey(0))
    got = jax.tree_util.tree_leaves_with_path(p)
    want = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, t), (_, s) in zip(got, want):
        assert tuple(t.shape) == (3,) + s.shape, path
        assert t.dtype == torch.bfloat16, path
    std = {"router": 64 ** -0.5, "experts_gate": 64 ** -0.5,
           "experts_up": 64 ** -0.5, "experts_down": 96 ** -0.5}
    for name, want_std in std.items():
        assert float(p[name].float().std()) == pytest.approx(want_std,
                                                             rel=0.05)


# -- the reduced models ------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg_j = jconfigs.ARCHS[request.param].reduced()
    cfg_t = tconfigs.ARCHS[request.param].reduced()
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params_j, to_torch(params_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_plan_and_state_match_reference(arch):
    full_j, full_t = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    assert layer_plan(full_t) == jlayer_plan(full_j) == ["attn_moe"] * 48
    got = init_decode_state(full_t.reduced(), 2, 16, device="meta")
    want = jinit_decode_state(full_j.reduced(), 2, 16)
    assert set(got) == set(want) == {"kv"}
    for name in ("k", "v", "length"):
        assert tuple(got["kv"][name].shape) == want["kv"][name].shape


def test_moe_forward_and_aux_loss_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    check_forward(model, 20)
    tokens = np.random.default_rng(6).integers(0, cfg_j.vocab, (2, 70))
    _, aux = forward(params_t, cfg_t, torch.from_numpy(tokens))
    _, aux_j = jforward(params_j, cfg_j, jnp.asarray(tokens))
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert float(aux) == pytest.approx(float(aux_j), rel=1e-5)


def test_moe_prefill_and_teacher_forced_decode_match_reference(model):
    check_prefill_and_decode(model, prompt_len=24, steps=3)


def test_moe_prefill_then_decode_equals_forward_at_capacity_16(model):
    """At the configured capacity a forward drops what a one-token decode
    never does (the reference's own test raises the capacity likewise,
    ``tests/test_models.py``)."""
    cfg_j, cfg_t, params_j, params_t = model
    check_prefill_then_decode_equals_forward(
        (cfg_j, dataclasses.replace(cfg_t, capacity_factor=16.0), params_j,
         params_t))


def test_moe_init_scales_match_reference(model):
    check_init_scales(model)


def test_moe_bfloat16_drift_is_within_the_reference_own(model):
    """bfloat16 weights (the reference's, rounded) through both packages,
    B = 2, S = 130: the forward at every token and the served outputs
    (prefill's last token, two teacher-forced decode steps).  The port's
    median drift from the reference's bfloat16 run, and from its float32
    run, is held to ``BF16_MODEL_TOL``; so is the reference's own drift
    from float32 on these inputs, which the tolerance rests on."""
    cfg_j, cfg_t, params_j, _ = model
    cfg_b = dataclasses.replace(cfg_j, dtype="bfloat16")
    params_b = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params_j)
    params_f = jax.tree.map(lambda a: a.astype(jnp.float32), params_b)
    cfg_tb = dataclasses.replace(cfg_t, dtype="bfloat16")
    params_tb = to_torch(params_b)
    assert params_tb["embed"].dtype == torch.bfloat16
    tokens = np.random.default_rng(7).integers(0, cfg_j.vocab, (2, 132))

    def served(run_prefill, run_decode, params, cfg, to):
        out, state = run_prefill(params, cfg, to(tokens[:, :130]), 136)
        outs = [np.asarray(out, np.float32)]
        for i in (130, 131):
            out, state = run_decode(params, cfg, state, to(tokens[:, i]))
            outs.append(np.asarray(out, np.float32))
        return np.stack(outs)

    as_j = lambda t: jnp.asarray(t, jnp.int32)
    ref = {"bfloat16": (params_b, cfg_b), "float32": (params_f, cfg_j)}
    fwd = {k: np.asarray(jforward(p, c, jnp.asarray(tokens))[0])
           for k, (p, c) in ref.items()}
    srv = {k: served(lambda p, c, t, n: jprefill(p, c, t, max_len=n),
                     jdecode_step, p, c, as_j) for k, (p, c) in ref.items()}
    with torch.inference_mode():
        got_fwd = forward(params_tb, cfg_tb, torch.from_numpy(tokens))[0]
        got_srv = served(prefill, decode_step, params_tb, cfg_tb,
                         torch.from_numpy)
    assert got_fwd.dtype == torch.float32
    got_fwd = got_fwd.numpy()
    assert np.isfinite(got_fwd).all() and np.isfinite(got_srv).all()
    for got, want in ((got_fwd, fwd), (got_srv, srv)):
        assert np.median(rel_by_token(want["bfloat16"],
                                      want["float32"])) < BF16_MODEL_TOL
        assert np.median(rel_by_token(got, want["bfloat16"])) < BF16_MODEL_TOL
        assert np.median(rel_by_token(got, want["float32"])) < BF16_MODEL_TOL


def _plant(fault, params, cfg, monkeypatch):
    """A fault in the decode path: (params, cfg) for the decode steps."""
    if fault == "no_shared":            # the shared expert skipped
        moe = params["stacks"]["attn_moe"]["moe"]
        assert "shared" in moe
        params = {**params, "stacks": {"attn_moe": {
            **params["stacks"]["attn_moe"],
            "moe": {k: v for k, v in moe.items() if k != "shared"}}}}
    elif fault == "top_k_minus_1":      # one expert fewer per token
        cfg = dataclasses.replace(cfg, top_k=cfg.top_k - 1)
    elif fault == "unnormalised_gates":  # the top-k gates not renormalised
        route_ok = moe_mod.route

        def faulty(params, xg, top_k, capacity_factor, with_aux=True):
            out = route_ok(params, xg, top_k, capacity_factor, with_aux)
            probs = torch.softmax(xg.float() @ params["router"].float(), -1)
            mass = probs.sort(-1, descending=True).values[..., :top_k].sum(-1)
            return (out[0], out[1] * mass[..., None], *out[2:])
        monkeypatch.setattr(moe_mod, "route", faulty)
    elif fault == "stale_kv":           # the token misses its own K/V row
        attend = ops.decode_attention
        monkeypatch.setattr(ops, "decode_attention",
                            lambda q, k, v, n, **kw: attend(q, k, v, n - 1,
                                                            **kw))
    else:
        raise ValueError(fault)
    return params, cfg


@pytest.mark.parametrize("arch,fault", [
    ("qwen3-moe-30b-a3b", "top_k_minus_1"),
    ("qwen3-moe-30b-a3b", "unnormalised_gates"),
    ("qwen3-moe-30b-a3b", "stale_kv"),
    ("moonshot-v1-16b-a3b", "no_shared"),
    ("moonshot-v1-16b-a3b", "unnormalised_gates"),
    ("moonshot-v1-16b-a3b", "stale_kv")])
def test_a_planted_decode_fault_fails_the_model_checks(arch, fault,
                                                       monkeypatch):
    """A fault planted in the reduced model's decode path, prefill and
    forward left whole: prefill's last token and 4 teacher-forced decode
    steps, B = 2, against the sound port's.  In float32 every fault fails
    the model tolerance, rel 5e-3, tenfold at least; in bfloat16 the expert and
    routing faults fail ``BF16_MODEL_TOL`` on the median over tokens.  A
    stale K/V row moves the bfloat16 median less (0.04-0.13 of the
    logits' largest): the float32 checks are the ones that catch it."""
    cfg_j = jconfigs.ARCHS[arch].reduced()
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    tokens = torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg_j.vocab, (2, 134)))
    drift = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(tconfigs.ARCHS[arch].reduced(),
                                  dtype=dtype)
        params = to_torch(jax.tree.map(
            lambda a: a.astype(getattr(jnp, dtype)), params_j))
        outs = []
        with monkeypatch.context() as m, torch.inference_mode():
            for planted in (False, True):
                out, state = prefill(params, cfg, tokens[:, :130], 136)
                p_dec, c_dec = ((_plant(fault, params, cfg, m)) if planted
                                else (params, cfg))
                seq = [out]
                for i in range(130, 134):
                    out, state = decode_step(p_dec, c_dec, state,
                                             tokens[:, i])
                    seq.append(out)
                outs.append(torch.stack(seq).numpy())
        assert np.isfinite(outs[1]).all()
        drift[dtype] = rel_by_token(outs[1], outs[0])
    assert drift["float32"].max() > 10 * 5e-3
    if fault != "stale_kv":
        assert np.median(drift["bfloat16"]) > BF16_MODEL_TOL
    else:
        assert np.median(drift["bfloat16"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_full_width_param_tree_on_meta_device(arch):
    """qwen3-moe-30b-a3b (128 experts) and moonshot-v1-16b-a3b (64 experts
    and a shared expert) at full width: 30.1 B and 28.9 B parameters."""
    check_full_width_tree(arch)


def test_chip_smoke_counts_one_flash_launch_per_moe_block():
    """``chip_smoke.py`` requires 48 flash launches a prefill of either MoE
    model, and prices a decode step by the weights it must read."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_moe", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch in ARCHS:
        cfg = dataclasses.replace(tconfigs.ARCHS[arch], dtype="bfloat16")
        assert cs._launches_per_prefill(cfg) == {"flash_attention": 48,
                                                 "ssd_scan": 0,
                                                 "slstm_scan": 0}
        # attention, router and shared expert whole, top_k of E experts
        tree = init_params(cfg, device="meta")
        moe = tree["stacks"]["attn_moe"]["moe"]
        n = sum(t.numel() for t in jax.tree.leaves(
            tree["stacks"]["attn_moe"]["attn"]))
        n += moe["router"].numel() + sum(
            t.numel() for t in jax.tree.leaves(moe.get("shared", {})))
        n += sum(moe[k].numel() * cfg.top_k // cfg.n_experts
                 for k in ("experts_gate", "experts_up", "experts_down"))
        n += tree["lm_head"].numel()
        assert cs._decode_weight_bytes(cfg, 0) == 2 * n
