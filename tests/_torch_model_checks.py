"""Model-level checks of the port against the JAX package, shared by
``tests/test_torch_models.py`` (the dense model),
``tests/test_torch_ssm_models.py`` (the SSM families) and
``tests/test_torch_moe.py`` (the MoE family).

Each ``check_*`` takes the ``(cfg_j, cfg_t, params_j, params_t)`` of one
reduced model, or an architecture's name.  Logits are held at the
reference's own model tolerance, rel 5e-3 (``tests/test_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models.transformer import prefill as jprefill
from repro_torch import configs as tconfigs
from repro_torch.models import decode_step, forward, init_params, prefill


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def rel_by_token(got, want) -> np.ndarray:
    """``rel`` of each token's logits (the last axis) apart."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


def check_forward(model, seq_len: int) -> None:
    cfg_j, cfg_t, params_j, params_t = model
    tokens = np.random.default_rng(2).integers(0, cfg_j.vocab, (2, seq_len))
    got, _ = forward(params_t, cfg_t, torch.from_numpy(tokens))
    want, _ = jforward(params_j, cfg_j, jnp.asarray(tokens))
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) < 5e-3


def check_prefill_and_decode(model, prompt_len: int, steps: int) -> None:
    """Prefill's last-token logits and ``steps`` teacher-forced decode
    steps against the reference's."""
    cfg_j, cfg_t, params_j, params_t = model
    tokens = np.random.default_rng(3).integers(0, cfg_j.vocab,
                                               (2, prompt_len + steps))
    max_len = prompt_len + steps + 4
    want, state_j = jprefill(params_j, cfg_j,
                             jnp.asarray(tokens[:, :prompt_len]), max_len)
    got, state_t = prefill(params_t, cfg_t,
                           torch.from_numpy(tokens[:, :prompt_len]), max_len)
    assert got.shape == (2, cfg_t.vocab) and got.dtype == torch.float32
    assert rel(got.numpy(), want) < 5e-3
    for i in range(prompt_len, prompt_len + steps):
        want, state_j = jdecode_step(params_j, cfg_j, state_j,
                                     jnp.asarray(tokens[:, i], jnp.int32))
        got, state_t = decode_step(params_t, cfg_t, state_t,
                                   torch.from_numpy(tokens[:, i]))
        assert rel(got.numpy(), want) < 5e-3


def check_prefill_then_decode_equals_forward(model) -> None:
    _, cfg, _, params = model
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)))
    full, _ = forward(params, cfg, tokens)
    _, state = prefill(params, cfg, tokens[:, :-3], max_len=24)
    for i in range(3, 0, -1):
        step, state = decode_step(params, cfg, state, tokens[:, -i])
        assert rel(step.numpy(), full[:, -i].numpy()) < 5e-3


def check_init_scales(model) -> None:
    """Torch cannot draw jax.random's numbers, but it draws with the same
    scales: each leaf's standard deviation within 10% of the reference's."""
    cfg_j, cfg_t, params_j, _ = model
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


def check_full_width_tree(arch: str) -> None:
    """The full-width model built without memory: the port's tree on the
    meta device against ``jax.eval_shape`` of the reference's
    ``init_params``, leaf by leaf, and its size against ``n_params``."""
    cfg_j, cfg_t = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
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
