"""The port's SSM families (hybrid zamba2, ssm xlstm) against the JAX
package's, on the CPU.

Weights are initialised by the JAX package and bridged leaf for leaf
(``repro_torch.bridge``); token and activation inputs come from a numpy
seed.  Blocks are held at 2e-4 (float32 through one SSD scan, whose own
tolerance is 3e-3, and a few products); logits at the reference's model
tolerance, rel 5e-3 (``tests/test_models.py``).  The model-level checks
shared with the dense model come from ``tests/_torch_model_checks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import mamba2 as jmamba2
from repro.models import xlstm as jxlstm
from repro.models.transformer import layer_plan as jlayer_plan
from repro.models.transformer import prefill as jprefill
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.models import (decode_step, layer_plan, mamba2, prefill,
                                xlstm)
from _torch_model_checks import (check_forward, check_full_width_tree,
                                 check_init_scales,
                                 check_prefill_then_decode_equals_forward)
from _torch_model_checks import rel as _rel

torch.set_num_threads(1)

ARCHS = ["zamba2-1.2b", "xlstm-125m"]


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg_j = jconfigs.ARCHS[request.param].reduced()
    cfg_t = tconfigs.ARCHS[request.param].reduced()
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params_j, to_torch(params_j)


# -- blocks ------------------------------------------------------------------

MAMBA = dict(n_heads=2, head_dim=16, ssm_state=8)


@pytest.mark.parametrize("s", [20, 2])     # 2 < the conv's W - 1
def test_mamba2_block_and_state_match_reference(s):
    p_j = jmamba2.init_mamba2(jax.random.PRNGKey(1), 32, **MAMBA)
    x = _x((2, s, 32), seed=s)
    got, st = mamba2.mamba2_block(to_torch(p_j), torch.from_numpy(x),
                                  return_state=True, **MAMBA)
    want, st_j = jmamba2.mamba2_block(p_j, jnp.asarray(x), return_state=True,
                                      **MAMBA)
    _close(got, want)
    _close(st["ssm"], st_j["ssm"])
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(st_j["conv"]))


def test_mamba2_decode_matches_reference():
    p_j = jmamba2.init_mamba2(jax.random.PRNGKey(2), 32, **MAMBA)
    st_j = {"ssm": jnp.asarray(_x((2, 2, 16, 8), 3)),
            "conv": jnp.asarray(_x((2, 3, 32), 4))}
    x = _x((2, 1, 32), 5)
    got, st = mamba2.mamba2_decode(to_torch(p_j), torch.from_numpy(x),
                                   to_torch(st_j), **MAMBA)
    want, want_st = jmamba2.mamba2_decode(p_j, jnp.asarray(x), st_j, **MAMBA)
    _close(got, want)
    _close(st["ssm"], want_st["ssm"])
    _close(st["conv"], want_st["conv"])


def test_mlstm_block_and_state_match_reference():
    p_j = jxlstm.init_mlstm(jax.random.PRNGKey(3), 32, 2)
    x = _x((2, 70, 32), 6)                      # 70: a ragged second chunk
    got, st = xlstm.mlstm_block(to_torch(p_j), torch.from_numpy(x),
                                n_heads=2, return_state=True)
    want, st_j = jxlstm.mlstm_block(p_j, jnp.asarray(x), n_heads=2,
                                    return_state=True)
    _close(got, want)
    _close(st["C"], st_j["C"])
    _close(st["n"], st_j["n"])


def test_mlstm_decode_matches_reference():
    p_j = jxlstm.init_mlstm(jax.random.PRNGKey(4), 32, 2)
    st_j = {"C": jnp.asarray(_x((2, 2, 32, 32), 7)),
            "n": jnp.asarray(_x((2, 2, 32), 8))}
    x = _x((2, 1, 32), 9)
    got, st = xlstm.mlstm_decode(to_torch(p_j), torch.from_numpy(x),
                                 to_torch(st_j), n_heads=2)
    want, want_st = jxlstm.mlstm_decode(p_j, jnp.asarray(x), st_j, n_heads=2)
    _close(got, want)
    _close(st["C"], want_st["C"])
    _close(st["n"], want_st["n"])


def test_slstm_block_and_state_match_reference():
    p_j = jxlstm.init_slstm(jax.random.PRNGKey(5), 32, 2)
    x = _x((2, 17, 32), 10)
    got, st = xlstm.slstm_block(to_torch(p_j), torch.from_numpy(x),
                                n_heads=2, return_state=True)
    want, st_j = jxlstm.slstm_block(p_j, jnp.asarray(x), n_heads=2,
                                    return_state=True)
    _close(got, want)
    for name in ("h", "c", "n", "m"):
        _close(st[name], st_j[name])


def test_slstm_decode_matches_reference():
    p_j = jxlstm.init_slstm(jax.random.PRNGKey(6), 32, 2)
    st_j = {"h": jnp.asarray(_x((2, 32), 11)),
            "c": jnp.asarray(_x((2, 32), 12)),
            "n": jnp.asarray(np.abs(_x((2, 32), 13)) + 1.0),
            "m": jnp.asarray(_x((2, 32), 14))}
    x = _x((2, 1, 32), 15)
    got, st = xlstm.slstm_decode(to_torch(p_j), torch.from_numpy(x),
                                 to_torch(st_j), n_heads=2)
    want, want_st = jxlstm.slstm_decode(p_j, jnp.asarray(x), st_j, n_heads=2)
    _close(got, want)
    for name in ("h", "c", "n", "m"):
        _close(st[name], want_st[name])


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_layer_plan_matches_reference(arch):
    full_j, full_t = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    assert layer_plan(full_t) == jlayer_plan(full_j)
    assert layer_plan(full_t.reduced()) == jlayer_plan(full_j.reduced())


def test_ssm_forward_matches_reference(model):
    check_forward(model, 70)            # 70: a ragged second SSD chunk


def test_ssm_prefill_and_teacher_forced_decode_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg_j.vocab, (2, 24))
    forced = rng.integers(0, cfg_j.vocab, (4, 2))
    want, state_j = jprefill(params_j, cfg_j, jnp.asarray(prompt), max_len=32)
    got, state_t = prefill(params_t, cfg_t, torch.from_numpy(prompt), 32)
    assert got.shape == (2, cfg_t.vocab) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 5e-3
    # the same state tree: per-kind stacks in plan order
    leaves_j = jax.tree_util.tree_leaves_with_path(state_j)
    leaves_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), state_t))
    assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
    for (path, a), (_, b) in zip(leaves_t, leaves_j):
        assert a.shape == np.asarray(b).shape, path
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3, atol=2e-3,
                                   err_msg=str(path))
    for tok in forced:
        want, state_j = jdecode_step(params_j, cfg_j, state_j,
                                     jnp.asarray(tok, jnp.int32))
        got, state_out = decode_step(params_t, cfg_t, state_t,
                                     torch.from_numpy(tok))
        assert state_out is state_t                  # updated in place
        assert _rel(got.numpy(), want) < 5e-3


def test_ssm_prefill_then_decode_equals_forward_on_the_port(model):
    check_prefill_then_decode_equals_forward(model)


def test_ssm_init_scales_match_reference(model):
    check_init_scales(model)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_full_width_param_tree_on_meta_device(arch):
    """Full-width zamba2-1.2b (an unstacked ``shared_attn`` beside the
    ``mamba2`` stack) and xlstm-125m (``mlstm`` and ``slstm`` stacks)."""
    check_full_width_tree(arch)
