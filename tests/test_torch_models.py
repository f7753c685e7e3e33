"""The port's dense model against the JAX package's, on the CPU.

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
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.transformer import prefill as jprefill
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.models import (decode_step, forward, init_params, layers,
                                prefill)

torch.set_num_threads(1)

ARCH = "granite-8b"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


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
    cfg_j, cfg_t, params_j, params_t = granite
    tokens = np.random.default_rng(2).integers(0, cfg_j.vocab, (2, 20))
    got, _ = forward(params_t, cfg_t, torch.from_numpy(tokens))
    want, _ = jforward(params_j, cfg_j, jnp.asarray(tokens))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 5e-3


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
    _, cfg, _, params = granite
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)))
    full, _ = forward(params, cfg, tokens)
    _, state = prefill(params, cfg, tokens[:, :-3], max_len=24)
    for i in range(3, 0, -1):
        step, state = decode_step(params, cfg, state, tokens[:, -i])
        assert _rel(step.numpy(), full[:, -i].numpy()) < 5e-3


def test_init_scales_match_reference(granite):
    """Torch cannot draw jax.random's numbers, but it draws with the same
    scales: each leaf's standard deviation within 10% of the reference's."""
    cfg_j, cfg_t, params_j, _ = granite
    mine = init_params(cfg_t, seed=0, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(params_j)
    my_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), mine))
    assert [p for p, _ in my_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(my_leaves, ref_leaves):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if b.std() == 0:
            np.testing.assert_array_equal(a, b)
        else:
            assert abs(a.std() / b.std() - 1) < 0.1, path


def test_full_width_param_tree_on_meta_device():
    """Full-width granite-8b (8.3 B parameters) built without memory: the
    port's tree on the meta device against ``jax.eval_shape`` of the
    reference's ``init_params``, leaf by leaf."""
    cfg_j, cfg_t = jconfigs.ARCHS[ARCH], tconfigs.ARCHS[ARCH]
    want = jax.eval_shape(lambda k: jinit_params(cfg_j, k),
                          jax.random.PRNGKey(0))
    got = init_params(cfg_t, device="meta")
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, t), (_, s) in zip(got_leaves, want_leaves):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == s.shape, path
        assert str(t.dtype).removeprefix("torch.") == s.dtype.name, path
    n = sum(t.numel() for _, t in got_leaves)
    assert abs(n / cfg_t.n_params - 1) < 0.01


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_unported_block_kinds_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(tconfigs.ARCHS[arch].reduced(), device="meta")
