"""The frontend prefix of the vlm and audio families (internvl2-76b,
musicgen-large) in the port against the JAX package's, on the CPU.

Both families take precomputed frontend embeddings [B, P, d] before the
token embeddings (``repro/models/transformer.py``: ``forward``,
``prefill``, ``loss_and_metrics`` and the steps of ``train/train_step.py``
through ``batch["frontend"]``).  Weights are initialised by the JAX
package and bridged leaf for leaf (``repro_torch.bridge``); tokens and
prefixes come from numpy seeds, a prefix N(0, 1) as in
``tests/test_models.py``.  Tolerances, as the other parity tests':
logits rel 5e-3 (``tests/test_models.py``); the loss rel 1e-5 and each
gradient leaf 1e-4 x its largest magnitude (``tests/test_torch_train.py``);
a train step's loss and gradient norm rel 1e-4.  The input specs are
compared by shape and dtype for every arch and every ``SHAPES`` entry.
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
from repro.models import loss_and_metrics as jloss_and_metrics
from repro.models.transformer import prefill as jprefill
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.train import make_forward_step as jmake_forward_step
from repro.train import make_prefill_step as jmake_prefill_step
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, prefill)
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import leaves
from repro_torch.train import (make_forward_step, make_grad_step,
                               make_prefill_step, make_train_step)
from _torch_model_checks import check_full_width_tree, rel

torch.set_num_threads(1)

PREFIXED = ["internvl2-76b", "musicgen-large"]
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)


@pytest.fixture(scope="module", params=PREFIXED)
def model(request):
    cfg_j = jconfigs.ARCHS[request.param].reduced()
    cfg_t = tconfigs.ARCHS[request.param].reduced()
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params_j, to_torch(params_j)


def _inputs(cfg, b: int = 2, s: int = 24, seed: int = 5, p: int | None = None
            ) -> tuple[np.ndarray, np.ndarray]:
    """(tokens [b, s] int32, frontend [b, P, d] float32 N(0, 1))."""
    rng = np.random.default_rng(seed)
    p = cfg.frontend_len if p is None else p
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    front = rng.standard_normal((b, p, cfg.d_model)).astype(np.float32)
    return toks, front


def _batch(cfg, seed: int = 4, mask: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
           "frontend": rng.standard_normal(
               (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)}
    if mask:
        out["loss_mask"] = (rng.random((2, 32)) > 0.2).astype(np.float32)
    return out


def _t(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_the_prefixed_archs_have_a_frontend():
    for arch in PREFIXED:
        cfg = tconfigs.ARCHS[arch]
        assert cfg.frontend != "none" and cfg.reduced().frontend_len == 16


def test_forward_with_a_prefix_matches_reference(model):
    """Logits for the text positions only, at rel 5e-3."""
    cfg_j, cfg_t, params_j, params_t = model
    toks, front = _inputs(cfg_t)
    got, aux = forward(params_t, cfg_t, torch.from_numpy(toks),
                       frontend=torch.from_numpy(front))
    want, _ = jforward(params_j, cfg_j, jnp.asarray(toks),
                       jnp.asarray(front))
    assert got.shape == (2, 24, cfg_t.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    assert rel(got.numpy(), want) < 5e-3


def test_frontend_is_the_fourth_positional_argument(model):
    """``forward(params, cfg, tokens, frontend)`` as the reference's
    signature; ``remat`` stays a keyword after it."""
    _, cfg_t, _, params_t = model
    toks, front = (torch.from_numpy(a) for a in _inputs(cfg_t))
    by_position, _ = forward(params_t, cfg_t, toks, front)
    by_name, _ = forward(params_t, cfg_t, toks, frontend=front, remat=False)
    torch.testing.assert_close(by_position, by_name, rtol=0, atol=0)
    _, state = prefill(params_t, cfg_t, toks, 48, front)
    assert int(state["kv"]["length"][0, 0]) == 16 + 24


def test_prefill_and_decode_with_a_prefix_match_reference(model):
    """Prefill over prefix + prompt (its cache holds P + S positions, its
    length is P + S) and 3 teacher-forced decode steps after it, against
    the reference's, at rel 5e-3 each."""
    cfg_j, cfg_t, params_j, params_t = model
    toks, front = _inputs(cfg_t, s=27, seed=6)
    p, s = front.shape[1], 24
    max_len = p + 27 + 4
    want, state_j = jprefill(params_j, cfg_j, jnp.asarray(toks[:, :s]),
                             max_len, jnp.asarray(front))
    got, state_t = prefill(params_t, cfg_t, torch.from_numpy(toks[:, :s]),
                           max_len, torch.from_numpy(front))
    assert got.shape == (2, cfg_t.vocab) and got.dtype == torch.float32
    assert rel(got.numpy(), want) < 5e-3
    kv = state_t["kv"]
    assert kv["k"].shape[2] == max_len
    assert (kv["length"] == p + s).all()
    np.testing.assert_array_equal(kv["length"].numpy(),
                                  np.asarray(state_j["kv"]["length"]))
    assert rel(kv["k"][:, :, :p + s].numpy(),
               np.asarray(state_j["kv"]["k"])[:, :, :p + s]) < 5e-3
    for i in range(s, s + 3):
        want, state_j = jdecode_step(params_j, cfg_j, state_j,
                                     jnp.asarray(toks[:, i]))
        got, state_t = decode_step(params_t, cfg_t, state_t,
                                   torch.from_numpy(toks[:, i]))
        assert rel(got.numpy(), want) < 5e-3, i


def test_prefixed_prefill_then_decode_equals_forward(model):
    """The port's own prefixed prefill + decode steps against its prefixed
    forward (what ``chip_smoke.py`` checks at full width)."""
    _, cfg, _, params = model
    toks, front = (torch.from_numpy(a) for a in _inputs(cfg, s=20, seed=7))
    full, _ = forward(params, cfg, toks, front)
    _, state = prefill(params, cfg, toks[:, :-3], 40, front)
    for i in range(3, 0, -1):
        step, state = decode_step(params, cfg, state, toks[:, -i])
        assert rel(step.numpy(), full[:, -i].numpy()) < 5e-3


def test_prefill_and_forward_steps_match_reference(model):
    """``make_prefill_step`` and ``make_forward_step`` on a batch with a
    ``frontend`` against the reference's steps, at rel 5e-3."""
    cfg_j, cfg_t, params_j, params_t = model
    toks, front = _inputs(cfg_t, seed=8)
    batch = {"tokens": toks, "frontend": front}
    want = jmake_forward_step(cfg_j)(params_j, _j(batch))
    got = make_forward_step(cfg_t)(params_t, _t(batch))
    assert got.shape == (2, 24, cfg_t.vocab)
    assert rel(got.numpy(), want) < 5e-3
    want, state_j = jmake_prefill_step(cfg_j, 48)(params_j, _j(batch))
    got, state_t = make_prefill_step(cfg_t, 48)(params_t, _t(batch))
    assert rel(got.numpy(), want) < 5e-3
    np.testing.assert_array_equal(state_t["kv"]["length"].numpy(),
                                  np.asarray(state_j["kv"]["length"]))


def test_prefill_refuses_a_max_len_below_prefix_plus_prompt(model):
    _, cfg, _, params = model
    toks, front = (torch.from_numpy(a) for a in _inputs(cfg, s=10))
    with pytest.raises(ValueError):
        prefill(params, cfg, toks, 16 + 10 - 1, front)
    with pytest.raises(ValueError):
        make_prefill_step(cfg, 25)(params, {"tokens": toks,
                                            "frontend": front})
    logits, state = prefill(params, cfg, toks, 16 + 10, front)
    assert torch.isfinite(logits).all()
    assert (state["kv"]["length"] == 26).all()


def test_a_zero_prefix_changes_the_logits(model):
    """As the reference's ``test_vlm_frontend_changes_logits``: a prefix of
    zeros gives other logits than an N(0, 1) one, of the same shape; the
    zeros' logits match the reference's too."""
    cfg_j, cfg_t, params_j, params_t = model
    toks, front = _inputs(cfg_t, s=32, seed=9)
    zeros = np.zeros_like(front)
    l1, _ = forward(params_t, cfg_t, torch.from_numpy(toks),
                    torch.from_numpy(front))
    l2, _ = forward(params_t, cfg_t, torch.from_numpy(toks),
                    torch.from_numpy(zeros))
    assert l1.shape == l2.shape == (2, 32, cfg_t.vocab)
    assert not torch.allclose(l1, l2)
    want, _ = jforward(params_j, cfg_j, jnp.asarray(toks), jnp.asarray(zeros))
    assert rel(l2.numpy(), want) < 5e-3


def test_loss_and_gradients_with_a_prefix_match_reference(model):
    """``loss_and_metrics`` with ``batch["frontend"]`` and its gradients:
    the loss at rel 1e-5, every leaf at 1e-4 x its largest magnitude."""
    cfg_j, cfg_t, params_j, params_t = model
    batch = _batch(cfg_t)

    def loss_j(p):
        return jloss_and_metrics(p, cfg_j, _j(batch))

    (total_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(params_j)
    grads_t, met_t = make_grad_step(cfg_t, remat=False)(params_t, _t(batch))
    assert rel(float(met_t["total_loss"]), float(total_j)) < 1e-5
    assert rel(float(met_t["loss"]), float(met_j["loss"])) < 1e-5
    assert float(met_t["tokens"]) == float(met_j["tokens"])
    got, want = _flat(to_numpy(grads_t)), _flat(
        jax.tree.map(np.asarray, grads_j))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert np.abs(got[key] - w).max() <= 1e-4 * np.abs(w).max(), key
    # the prefix reaches the gradients: without it they differ
    plain, _ = make_grad_step(cfg_t, remat=False)(
        params_t, {k: v for k, v in _t(batch).items() if k != "frontend"})
    assert any(not torch.equal(a, b)
               for a, b in zip(leaves(plain), leaves(grads_t)))


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def test_train_step_with_a_prefix_matches_reference(model):
    """One AdamW step of ``make_train_step`` on a prefixed batch from a
    bridged init against the reference's (jitted, remat on, as its trainer
    runs it): the loss and gradient norm at rel 1e-4, the updated params at
    the step's scale (lr 1e-2: an element whose gradient is at rounding
    level moves by about lr either way)."""
    cfg_j, cfg_t, params_j, params_t = model
    opt_j, opt_t = JAdamWConfig(**OPT), AdamWConfig(**OPT)
    state_j = jinit_opt_state(params_j)
    state_t = to_torch(state_j)
    batch = _batch(cfg_t, seed=11, mask=False)
    new_j, _, met_j = jax.jit(jmake_train_step(cfg_j, opt_j))(
        params_j, state_j, _j(batch))
    new_t, _, met_t = make_train_step(cfg_t, opt_t)(params_t, state_t,
                                                    _t(batch))
    assert rel(float(met_t["loss"]), float(met_j["loss"])) < 1e-4
    assert rel(float(met_t["grad_norm"]), float(met_j["grad_norm"])) < 1e-4
    got, want = _flat(to_numpy(new_t)), _flat(jax.tree.map(np.asarray, new_j))
    for key, w in want.items():
        assert np.abs(got[key] - w).max() <= 2.5 * OPT["lr"], key


def test_remat_with_a_prefix_gives_the_same_gradients(model):
    """``remat=True`` runs each layer again in the backward: the same loss
    and gradients as without, on a prefixed batch."""
    _, cfg_t, _, params_t = model
    batch = _t(_batch(cfg_t, mask=False))
    plain, met = make_grad_step(cfg_t, remat=False)(params_t, batch)
    remat, met_r = make_grad_step(cfg_t, remat=True)(params_t, batch)
    assert float(met_r["total_loss"]) == float(met["total_loss"])
    for a, b in zip(leaves(plain), leaves(remat)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_a_float32_prefix_is_cast_to_the_model_dtype():
    """A bfloat16 internvl2 given a float32 prefix casts it, as the
    reference does: the same logits as a prefix already in bfloat16, and a
    bfloat16 decode state."""
    cfg = dataclasses.replace(tconfigs.ARCHS["internvl2-76b"].reduced(),
                              dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu")
    toks, front = (torch.from_numpy(a) for a in _inputs(cfg, s=12))
    a, _ = forward(params, cfg, toks, front)
    b, _ = forward(params, cfg, toks, front.to(torch.bfloat16))
    assert a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, state = prefill(params, cfg, toks, 32, front)
    assert state["kv"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_every_layer_plan_takes_a_prefix(arch):
    """The reference's concatenation is plan-agnostic, so is the port's:
    a reduced MoE, hybrid and ssm model given a prefix of 8 positions,
    forward and prefill against the reference's at rel 5e-3."""
    cfg_j = jconfigs.ARCHS[arch].reduced()
    cfg_t = tconfigs.ARCHS[arch].reduced()
    if cfg_j.family == "moe":        # a forward that drops no token
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=16.0)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=16.0)
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(params_j)
    toks, front = _inputs(cfg_t, s=16, seed=12, p=8)
    got, _ = forward(params_t, cfg_t, torch.from_numpy(toks),
                     torch.from_numpy(front))
    want, _ = jforward(params_j, cfg_j, jnp.asarray(toks), jnp.asarray(front))
    assert got.shape == (2, 16, cfg_t.vocab)
    assert rel(got.numpy(), want) < 5e-3
    got, _ = prefill(params_t, cfg_t, torch.from_numpy(toks), 28,
                     torch.from_numpy(front))
    want, _ = jprefill(params_j, cfg_j, jnp.asarray(toks), 28,
                       jnp.asarray(front))
    assert rel(got.numpy(), want) < 5e-3


def _shape_dtype(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape", sorted(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_input_specs_match_reference(arch, shape):
    """``train_batch_specs`` and ``decode_specs``: meta tensors with the
    reference's shapes and dtypes (a prefixed arch's tokens take
    ``seq_len - frontend_len`` positions)."""
    cfg_j, cfg_t = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    shp_j, shp_t = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    for fn_j, fn_t in ((jconfigs.train_batch_specs, tconfigs.train_batch_specs),
                       (jconfigs.decode_specs, tconfigs.decode_specs)):
        want, got = fn_j(cfg_j, shp_j), fn_t(cfg_t, shp_t)
        assert list(got) == list(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta", key
            assert _shape_dtype(got[key]) == (spec.shape, spec.dtype.name), key
    specs = tconfigs.train_batch_specs(cfg_t, shp_t)
    n_front = specs["frontend"].shape[1] if "frontend" in specs else 0
    assert n_front + specs["tokens"].shape[1] == shp_t.seq_len


@pytest.mark.parametrize("arch", PREFIXED)
def test_decode_state_on_the_meta_device_matches_reference(arch):
    """The decode state the specs leave out: ``init_decode_state`` on the
    meta device at full width against ``jax.eval_shape`` of the
    reference's, leaf by leaf."""
    cfg_j, cfg_t = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    want = jax.eval_shape(lambda: jinit_decode_state(cfg_j, 2, 4096))
    got = init_decode_state(cfg_t, 2, 4096, device="meta")
    want_l = jax.tree_util.tree_leaves_with_path(want)
    got_l = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, t), (_, s) in zip(got_l, want_l):
        assert t.device.type == "meta", path
        assert _shape_dtype(t) == (s.shape, s.dtype.name), path


@pytest.mark.parametrize("arch", PREFIXED)
def test_full_width_param_tree_on_meta_device(arch):
    """internvl2-76b (76 B parameters) and musicgen-large (2.42 B) at full
    width: the port's tree on the meta device against ``jax.eval_shape`` of
    the reference's, leaf by leaf; no leaf is new to the bridge."""
    check_full_width_tree(arch)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_front", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_serves_and_trains_the_prefixed_models():
    """``chip_smoke.py`` serves internvl2-76b in bfloat16 cut to 32 layers
    (29.48 B parameters) and musicgen-large in float32 whole, trains
    musicgen-large with its prefix in float32 and in bfloat16, and requires
    one flash launch a layer per prefill (32, 48) and per train step each
    way (48; 96 forwards with remat) on the dtype's paths, and the AdamW
    kernels' update a leaf
    (11) and the norm's pass a leaf and a finalize (12) a step; it prices
    internvl2's decode step by the weights it must read."""
    cs = _chip_smoke()
    served = dict(cs.SERVED)
    assert served["internvl2-76b"] == "bfloat16"
    assert served["musicgen-large"] == "float32"
    cfg = dataclasses.replace(tconfigs.ARCHS["internvl2-76b"],
                              dtype="bfloat16",
                              n_layers=cs.SERVED_LAYERS["internvl2-76b"])
    tree = init_params(cfg, device="meta")
    n = sum(t.numel() for t in leaves(tree))
    assert abs(n / 29.48e9 - 1) < 1e-3 and abs(2 * n / 58.96e9 - 1) < 1e-3
    assert cs._launches_per_prefill(cfg) == {"flash_attention": 32,
                                             "ssd_scan": 0, "slstm_scan": 0}
    assert (64, 8, 128) in cs.SERVED_LAYOUTS["bfloat16"]
    stack = tree["stacks"]["attn"]
    read = sum(t.numel() for t in leaves(stack["attn"]))
    read += sum(t.numel() for t in leaves(stack["ffn"]))
    assert cs._decode_weight_bytes(cfg, 0) == 2 * (
        read + tree["lm_head"].numel())
    music = tconfigs.ARCHS["musicgen-large"]
    assert cs._launches_per_prefill(music)["flash_attention"] == 48
    runs = {run["dtype"]: run for run in cs.TRAIN_PREFIXED}
    assert sorted(runs) == ["bfloat16", "float32"]
    for run in runs.values():
        assert run["arch"] == "musicgen-large" and not run["layers"]
    for dtype, (fwd_path, bwd_path) in (("float32", ("tf32x3", "bwd_tf32x3")),
                                        ("bfloat16", ("wgmma", "bwd_wgmma"))):
        cfg = dataclasses.replace(music, dtype=dtype)
        for remat, fwd in ((False, 48), (True, 96)):
            want = {"flash_attention": fwd, "flash_attention_bwd": 48,
                    "tf32x3": 0, "wgmma": 0, "bwd_tf32x3": 0, "bwd_wgmma": 0,
                    "bwd_fma": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
                    "ssd_bf16_async": 0, "ssd_plain": 0,
                    "ssd_bwd_bf16_async": 0, "ssd_bwd_plain": 0,
                    "slstm_scan": 0, "slstm_scan_bwd": 0,
                    "adamw": 11, "adamw_norm": 12,
                    fwd_path: fwd, bwd_path: 48}
            assert cs._step_launches(cfg, remat) == want


def test_chip_smoke_lays_out_the_prefixed_batch_by_the_specs():
    """Phase 8's prefixed batch: the specs' keys, shapes and dtypes, the
    synthetic stream's tokens and labels, a frontend N(0, 1); musicgen's
    B 2 x (P 64 + 1984 text tokens) by the specs on the meta device."""
    cs = _chip_smoke()
    full = tconfigs.ARCHS["musicgen-large"]
    run = cs.TRAIN_PREFIXED[0]
    assert all((r["batch"], r["seq"]) == (run["batch"], run["seq"])
               for r in cs.TRAIN_PREFIXED)
    shape = tconfigs.InputShape("train", "train", run["seq"], run["batch"])
    specs = tconfigs.train_batch_specs(full, shape)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "frontend": (2, 64, 2048), "tokens": (2, 1984),
        "labels": (2, 1984)}
    cfg = full.reduced()
    shape = tconfigs.InputShape("train", "train", 80, 2)
    batch = cs.prefixed_batch(cfg, shape, 3, "cpu")
    specs = tconfigs.train_batch_specs(cfg, shape)
    assert list(batch) == ["tokens", "labels", "frontend"]
    for key, spec in specs.items():
        assert _shape_dtype(batch[key]) == _shape_dtype(spec), key
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                        global_batch=2, seed=0))
    want = stream.batch_at(3)
    np.testing.assert_array_equal(batch["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(batch["labels"].numpy(), want["labels"])
    assert abs(float(batch["frontend"].std()) - 1) < 0.1
