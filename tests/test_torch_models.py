"""The port's dense model against the JAX package's, on the CPU (the SSM
families are in ``tests/test_torch_ssm_models.py``, MoE in
``tests/test_torch_moe.py``).

Weights are initialised by the JAX package and bridged leaf for leaf
(``repro_torch.bridge``); token inputs come from a numpy seed.  Logits
are held at the reference's own model tolerance, rel 5e-3
(``tests/test_models.py``); layers at 2e-4 / 1e-5 (float32 elementwise).
The full-width granite-8b tree is compared by shape only, on torch's meta
device and under ``jax.eval_shape``, so nothing full-size is allocated.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.transformer import prefill as jprefill
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.models import decode_step, init_params, layers, prefill
from _torch_model_checks import (check_forward, check_full_width_tree,
                                 check_init_scales, check_prefill_and_decode,
                                 check_prefill_then_decode_equals_forward)
from _torch_model_checks import rel as _rel

torch.set_num_threads(1)

ARCH = "granite-8b"


@pytest.fixture(scope="module")
def granite():
    cfg_j = jconfigs.ARCHS[ARCH].reduced()
    cfg_t = tconfigs.ARCHS[ARCH].reduced()
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params_j, to_torch(params_j)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_configs_match_reference(arch):
    full_j, full_t = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert (dataclasses.asdict(full_t.reduced())
            == dataclasses.asdict(full_j.reduced()))
    assert full_t.n_params == full_j.n_params


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 32), dtype=np.float32)
    w = rng.standard_normal((32,), dtype=np.float32)
    pos = np.arange(12)[None, :] + 5
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e7)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "sq_relu", "gelu",
                                 "relu"])
def test_ffn_matches_reference(act):
    p_j = jlayers.init_ffn(jax.random.PRNGKey(1), 32, 64, act)
    x = np.random.default_rng(1).standard_normal((2, 5, 32), dtype=np.float32)
    got = layers.ffn(to_torch(p_j), torch.from_numpy(x), act)
    want = jlayers.ffn(p_j, jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_forward_matches_reference(granite):
    check_forward(granite, 20)


def test_prefill_and_teacher_forced_decode_match_reference(granite):
    cfg_j, cfg_t, params_j, params_t = granite
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg_j.vocab, (2, 24))
    forced = rng.integers(0, cfg_j.vocab, (4, 2))
    want, state_j = jprefill(params_j, cfg_j, jnp.asarray(prompt), max_len=32)
    got, state_t = prefill(params_t, cfg_t, torch.from_numpy(prompt), 32)
    assert got.shape == (2, cfg_t.vocab) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 5e-3
    for tok in forced:
        want, state_j = jdecode_step(params_j, cfg_j, state_j,
                                     jnp.asarray(tok, jnp.int32))
        got, state_out = decode_step(params_t, cfg_t, state_t,
                                     torch.from_numpy(tok))
        assert state_out is state_t                  # updated in place
        assert _rel(got.numpy(), want) < 5e-3
    np.testing.assert_array_equal(state_t["kv"]["length"].numpy(),
                                  np.asarray(state_j["kv"]["length"]))
    np.testing.assert_allclose(state_t["kv"]["k"].numpy(),
                               np.asarray(state_j["kv"]["k"]), rtol=2e-3,
                               atol=2e-3)


def test_prefill_then_decode_equals_forward_on_the_port(granite):
    check_prefill_then_decode_equals_forward(granite)


def test_init_scales_match_reference(granite):
    check_init_scales(granite)


def test_full_width_param_tree_on_meta_device():
    """Full-width granite-8b (8.3 B parameters)."""
    check_full_width_tree(ARCH)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "nemotron-4-15b",
                                  "stablelm-3b", "musicgen-large",
                                  "internvl2-76b"])
def test_dense_configs_logits_match_reference(arch):
    """The other dense plans' reduced models: qwen2.5 (QKV bias), nemotron
    (squared ReLU), stablelm, musicgen (GELU) and internvl2, here without
    a frontend prefix (``tests/test_torch_frontend.py`` holds the prefix):
    forward, prefill and one decode step."""
    cfg_j = jconfigs.ARCHS[arch].reduced()
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    model = (cfg_j, tconfigs.ARCHS[arch].reduced(), params_j,
             to_torch(params_j))
    check_forward(model, 20)
    check_prefill_and_decode(model, prompt_len=24, steps=1)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "stablelm-3b"])
def test_real_head_layouts_logits_match_reference(arch):
    """The head layouts that ``reduced()`` hides (its 4 heads of 32) and the
    card runs at full width: stablelm-3b's head dim 80 and qwen2.5-14b's
    GQA group of 5 with its QKV bias (``chip_smoke.REAL_HEADS``), built the
    same way in both packages and bridged through numpy: forward, prefill
    and a decode step at rel 5e-3."""
    import chip_smoke as cs
    over = cs.REAL_HEADS[arch]
    cfg_j = dataclasses.replace(jconfigs.ARCHS[arch].reduced(), **over)
    cfg_t = dataclasses.replace(tconfigs.ARCHS[arch].reduced(), **over)
    assert cfg_t == cs.real_heads(tconfigs.ARCHS[arch])
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(params_j)
    assert tuple(params_t["stacks"]["attn"]["attn"]["wq"].shape[1:]) == (
        cfg_t.d_model, cfg_t.n_heads * cfg_t.resolved_head_dim)
    model = (cfg_j, cfg_t, params_j, params_t)
    check_forward(model, 20)
    check_prefill_and_decode(model, prompt_len=24, steps=1)


@pytest.mark.parametrize("arch,dtype,params_b,layout", [
    ("stablelm-3b", "float32", 2.795, (32, 32, 80)),
    ("qwen2.5-14b", "bfloat16", 14.770, (40, 8, 128)),
    ("nemotron-4-15b", "bfloat16", 15.628, (48, 8, 128))])
def test_chip_smoke_serves_the_dense_archs_at_full_width(arch, dtype,
                                                         params_b, layout):
    """``chip_smoke.py`` serves stablelm-3b (float32), qwen2.5-14b and
    nemotron-4-15b (bfloat16) at full width and depth (meta device: the
    parameter counts), one flash launch a layer per prefill on a head
    layout it checks and times in that dtype, and holds a bfloat16 one's
    decode to its own grounded limit."""
    import chip_smoke as cs
    assert dict(cs.SERVED)[arch] == dtype and arch not in cs.SERVED_LAYERS
    cfg = dataclasses.replace(tconfigs.ARCHS[arch], dtype=dtype)
    tree = init_params(cfg, device="meta")
    n = sum(t.numel() for t in _leaves(tree))
    assert abs(n / 1e9 - params_b) < 1e-3
    assert cs._launches_per_prefill(cfg) == {
        "flash_attention": cfg.n_layers, "ssd_scan": 0, "slstm_scan": 0}
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == layout
    assert layout in cs.SERVED_LAYOUTS[dtype]
    if dtype == "bfloat16":
        assert 0 < cs.DENSE_BF16_FULL_TOL[arch] <= cs.BF16_FULL_TOL


@pytest.mark.parametrize("arch,layers,params_b", [
    ("stablelm-3b", None, 2.795), ("qwen2.5-14b", 4, 2.658)])
def test_chip_smoke_trains_the_dense_archs_in_bfloat16(arch, layers,
                                                       params_b):
    """Phase 8 trains stablelm-3b whole and qwen2.5-14b at 4 of its 48
    layers in bfloat16 through the ``Trainer`` (B 2 x S 2048), each flash
    launch on ``wgmma`` both ways, held under the bfloat16 rule, whose
    limits ``tools/bf16_grad_drift.jsonl`` holds for both archs."""
    import chip_smoke as cs
    run = next(r for r in cs.TRAIN_RUNS if r["arch"] == arch)
    assert (run["layers"], run["dtype"], run["batch"], run["seq"]) == (
        layers, "bfloat16", 2, 2048)
    cfg = dataclasses.replace(tconfigs.ARCHS[arch], dtype="bfloat16",
                              **({"n_layers": layers} if layers else {}))
    n = sum(t.numel() for t in _leaves(init_params(cfg, device="meta")))
    assert abs(n / 1e9 - params_b) < 1e-3
    per = cs._step_launches(cfg)
    assert per["wgmma"] == per["bwd_wgmma"] == cfg.n_layers
    assert per["tf32x3"] == per["bwd_tf32x3"] == per["bwd_fma"] == 0
    limits = cs.bf16_grad_limits()[arch]
    assert all(0 < limits[k] < 1 for k in ("loss", "grad", "steps"))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
