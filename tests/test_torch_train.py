"""The port's training slice against the JAX package's, on the CPU: the
optimizer, gradient compression, the loss and its gradients for four
families, train steps from a bridged init, checkpoints that each package
restores from the other, the exact resume of the fault-tolerant trainer,
and remat.

The same numpy inputs go to both packages; weights are initialised by the
JAX package and bridged leaf for leaf (``repro_torch.bridge``), the
optimizer state too.  Tolerances, each with its reason:
- AdamW and compression: rel 1e-6, float32 rounding of the same
  arithmetic (the reference's own order of operations);
- the loss: rel 1e-5; each gradient leaf: 1e-4 x its largest magnitude
  (float32 sums in another order through a few layers), and for the
  hybrid 3e-3, the reference's SSD tolerance (``tests/test_kernels.py``):
  on the CPU the reference differentiates its sequential ``ssd_ref`` and
  the port its chunked plain scan, and on reduced zamba2's Mamba-2 leaves
  (gradients up to 220) the two float32 runs drift from a float64 run of
  the reference on the same weights by up to 4.2e-4 (reference) and
  1.7e-3 (port) of the leaf's largest magnitude;
- train-step losses over 3 steps: rel 1e-4 (AdamW's m / sqrt(v) turns
  the gradients' last bits into relative changes of the update);
- checkpoints: bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.models import init_params as jinit_params
from repro.models import loss_and_metrics as jloss_and_metrics
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_updates as japply_updates
from repro.optim import compress_int8 as jcompress_int8
from repro.optim import compress_topk as jcompress_topk
from repro.optim import init_error_feedback as jinit_error_feedback
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import schedule as jschedule
from repro.optim import wire_bytes as jwire_bytes
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.optim import (AdamWConfig, apply_updates, compress_int8,
                               compress_topk, global_norm,
                               init_error_feedback, init_opt_state, schedule,
                               wire_bytes)
from repro_torch.optim.adamw import leaves
from repro_torch.train import make_grad_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(tree_t, tree_j, rel: float) -> None:
    got, want = to_numpy(tree_t), jax.tree.map(
        lambda a: np.asarray(a, np.float32), tree_j)
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            _close(tree_t[k], tree_j[k], rel)
        else:
            assert got[k].shape == want[k].shape, k
            assert _rel(got[k], want[k]) <= rel, k


def _tree(dtype):
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": {"c": rng.standard_normal(5).astype(dtype),
                  "d": rng.standard_normal((2, 2, 3)).astype(dtype)}}


# -- AdamW -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(dtype):
    """5 steps on the same numpy gradients (the third past the clip norm):
    params, both moments, the step and, for bfloat16 params, the float32
    master copy at rel 1e-6 (bfloat16 params: their float32 master rounded,
    so bit for bit the master's rounding)."""
    params_j = jax.tree.map(lambda a: jnp.asarray(a, dtype), _tree(np.float32))
    params_t = to_torch(params_j)
    state_j, state_t = jinit_opt_state(params_j), init_opt_state(params_t)
    assert ("master" in state_j) == ("master" in state_t) == (dtype != "float32")
    cfg_j, cfg_t = JAdamWConfig(**OPT), AdamWConfig(**OPT)
    rng = np.random.default_rng(1)
    for step in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * (30.0 if step == 2 else 0.1)
                                    ).astype(np.float32), _tree(np.float32))
        grads_j = jax.tree.map(lambda a: jnp.asarray(a, dtype), g)
        params_j, state_j, info_j = japply_updates(params_j, grads_j, state_j,
                                                   cfg_j)
        params_t, state_t, info_t = apply_updates(params_t, to_torch(grads_j),
                                                  state_t, cfg_t)
        assert _rel(float(info_t["lr"]), float(info_j["lr"])) < 1e-6
        assert _rel(float(info_t["grad_norm"]),
                    float(info_j["grad_norm"])) < 1e-6
    assert int(state_t["step"]) == int(state_j["step"]) == 5
    for name in ("m", "v") + (("master",) if dtype != "float32" else ()):
        _close(state_t[name], state_j[name], 1e-6)
    _close(params_t, params_j, 1e-6 if dtype == "float32" else 0.0)
    assert all(p.dtype == getattr(torch, dtype) for p in leaves(params_t))


def test_schedule_and_clipping_match_reference():
    cfg_j = JAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    cfg_t = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        want = float(jschedule(cfg_j, jnp.array(step)))
        got = float(schedule(cfg_t, torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), step
    # the reference's own clipping test, on the port
    params = {"w": torch.zeros(4)}
    _, _, info = apply_updates(params, {"w": torch.full((4,), 100.0)},
                               init_opt_state(params),
                               AdamWConfig(lr=0.0, clip_norm=1.0,
                                           warmup_steps=0))
    assert float(info["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm({"a": torch.ones(4), "b": [torch.ones(5)]})
                 ) == pytest.approx(3.0)


def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = AdamWConfig(lr=0.3, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    for _ in range(100):
        params, state, _ = apply_updates(params, {"w": 2 * params["w"]},
                                         state, cfg)
    assert float(params["w"].abs().max()) < 0.1


# -- compression -------------------------------------------------------------

def _grads_with_ties():
    rng = np.random.default_rng(2)
    g = _tree(np.float32)
    g["a"] = rng.standard_normal((3, 4)).astype(np.float32)
    # ties of magnitude across the top-k edge: the lower index must win
    g["b"]["c"] = np.array([0.5, -2.0, 2.0, -0.5, 0.5], np.float32)
    g["b"]["d"] = np.ones((2, 2, 3), np.float32) * np.array(
        [1.0, -1.0, 1.0], np.float32)
    return g


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_with_error_feedback_matches_reference(scheme):
    """3 rounds, each carrying its residual into the next: the wire values
    and the residuals at rel 1e-6, top-k's choice among ties exactly."""
    g = _grads_with_ties()
    gj = jax.tree.map(jnp.asarray, g)
    gt = to_torch(g)
    err_j, err_t = jinit_error_feedback(gj), init_error_feedback(gt)
    for _ in range(3):
        if scheme == "int8":
            out_j, err_j = jcompress_int8(gj, err_j)
            out_t, err_t = compress_int8(gt, err_t)
        else:
            out_j, err_j = jcompress_topk(gj, err_j, frac=0.4)
            out_t, err_t = compress_topk(gt, err_t, frac=0.4)
            for a, b in zip(leaves(to_numpy(out_t)),
                            jax.tree.leaves(out_j)):
                np.testing.assert_array_equal(a != 0, np.asarray(b) != 0)
        _close(out_t, out_j, 1e-6)
        _close(err_t, err_j, 1e-6)
    for s in ("int8", "topk", "none"):
        assert wire_bytes(gt, s, 0.05) == jwire_bytes(gj, s, 0.05)


def test_int8_error_feedback_invariant():
    g = {"w": torch.linspace(-3.0, 3.0, 37)}
    out, err = compress_int8(g, init_error_feedback(g))
    torch.testing.assert_close(out["w"] + err["w"], g["w"], rtol=1e-5,
                               atol=1e-6)


# -- the loss and its gradients ------------------------------------------------

def _model(arch: str, **over):
    cfg_j = dataclasses.replace(jconfigs.get_config(arch).reduced(), **over)
    cfg_t = dataclasses.replace(tconfigs.get_config(arch).reduced(), **over)
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params_j, to_torch(params_j)


def _batch(vocab: int, b: int = 2, s: int = 48, seed: int = 4,
           mask: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) > 0.2).astype(np.float32)
    return out


@pytest.mark.parametrize("arch,grad_tol,heads", [
    ("granite-8b", 1e-4, False), ("qwen3-moe-30b-a3b", 1e-4, False),
    ("zamba2-1.2b", 3e-3, False), ("xlstm-125m", 1e-4, False),
    ("stablelm-3b", 1e-4, True), ("qwen2.5-14b", 1e-4, True),
    ("moonshot-v1-16b-a3b", 1e-4, False), ("nemotron-4-15b", 1e-4, False)])
def test_loss_and_gradients_match_reference(arch, grad_tol, heads):
    """``loss_and_metrics`` and its gradients for the reduced model of each
    trainable layer plan (dense; MoE, with its aux loss, moonshot's with its
    shared expert; the hybrid; the ssm; nemotron's squared ReLU and untied
    embeddings), from the same weights and batch: the loss at rel 1e-5, every
    gradient leaf at ``grad_tol`` x its largest magnitude (the module doc
    says why the hybrid's is the SSD tolerance).  With ``heads``, at the
    arch's own head layout, which ``reduced()`` hides
    (``chip_smoke.REAL_HEADS``: stablelm-3b's head dim 80, qwen2.5-14b's
    GQA group of 5 with the QKV bias's gradients)."""
    over = {}
    if heads:
        import chip_smoke as cs
        over = cs.REAL_HEADS[arch]
    cfg_j, cfg_t, params_j, params_t = _model(arch, **over)
    batch = _batch(cfg_j.vocab)

    def loss_j(p):
        return jloss_and_metrics(p, cfg_j, jax.tree.map(jnp.asarray, batch))

    (total_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(params_j)
    grads_t, met_t = make_grad_step(cfg_t, remat=False)(
        params_t, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert _rel(float(met_t["total_loss"]), float(total_j)) < 1e-5
    assert _rel(float(met_t["loss"]), float(met_j["loss"])) < 1e-5
    assert float(met_t["tokens"]) == float(met_j["tokens"])
    if cfg_t.family == "moe":
        assert float(met_j["aux_loss"]) > 0
        assert _rel(float(met_t["aux_loss"]), float(met_j["aux_loss"])) < 1e-5
    got = dict(_flat(to_numpy(grads_t)))
    want = dict(_flat(jax.tree.map(np.asarray, grads_j)))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert np.abs(got[key] - w).max() <= grad_tol * np.abs(w).max(), key


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_remat_gives_the_same_gradients():
    """``forward(..., remat=True)`` runs each layer again in the backward;
    the loss and every gradient leaf are the same (float32, the same
    operations in the same order)."""
    _, cfg_t, _, params_t = _model("granite-8b")
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg_t.vocab, mask=False).items()}
    plain, met = make_grad_step(cfg_t, remat=False)(params_t, batch)
    remat, met_r = make_grad_step(cfg_t, remat=True)(params_t, batch)
    assert float(met_r["total_loss"]) == float(met["total_loss"])
    for a, b in zip(leaves(plain), leaves(remat)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_steps_match_reference():
    """3 AdamW steps of reduced granite-8b from a bridged init (the
    reference's ``make_train_step``, jitted, remat on, as its trainer runs
    it): every step's loss and gradient norm at rel 1e-4."""
    cfg_j, cfg_t, params_j, params_t = _model("granite-8b")
    opt_j, opt_t = JAdamWConfig(**OPT), AdamWConfig(**OPT)
    state_j = jinit_opt_state(params_j)
    state_t = to_torch(state_j)
    step_j = jax.jit(jmake_train_step(cfg_j, opt_j))
    step_t = make_train_step(cfg_t, opt_t)
    for i in range(3):
        batch = _batch(cfg_j.vocab, seed=10 + i, mask=False)
        params_j, state_j, met_j = step_j(params_j, state_j,
                                          jax.tree.map(jnp.asarray, batch))
        params_t, state_t, met_t = step_t(
            params_t, state_t, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        assert _rel(float(met_t["loss"]), float(met_j["loss"])) < 1e-4, i
        assert _rel(float(met_t["grad_norm"]),
                    float(met_j["grad_norm"])) < 1e-4, i
    # (not the params themselves: AdamW moves an element whose gradient is
    # at rounding level by about lr either way, m / sqrt(v) being +-1 at
    # the first step whatever the gradient's size)


# -- checkpoints ---------------------------------------------------------------

def _state(cfg_j):
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(3))
    state_j = jinit_opt_state(params_j)
    grads = jax.tree.map(jnp.ones_like, params_j)
    params_j, state_j, _ = japply_updates(params_j, grads, state_j,
                                          JAdamWConfig(**OPT))
    return {"params": params_j, "opt": state_j}


def _assert_same(tree_t, tree_j) -> None:
    got = dict(_flat(to_numpy(tree_t)))
    want = dict(_flat(jax.tree.map(np.asarray, tree_j)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_port_restores_reference_checkpoint(tmp_path):
    cfg_j = jconfigs.get_config("granite-8b").reduced()
    tree_j = _state(cfg_j)
    ck_j = JCheckpointer(str(tmp_path))
    ck_j.save(7, tree_j, extra={"data": {"step": 7}})
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    template = to_torch(jax.tree.map(jnp.zeros_like, tree_j))
    tree_t, manifest = ck.restore(template)
    assert manifest["step"] == 7 and manifest["extra"]["data"]["step"] == 7
    _assert_same(tree_t, tree_j)
    assert tree_t["opt"]["step"].dtype == torch.int32


def test_reference_restores_port_checkpoint(tmp_path):
    cfg_j = jconfigs.get_config("qwen3-moe-30b-a3b").reduced()
    tree_j = _state(cfg_j)
    ck = Checkpointer(str(tmp_path))
    ck.save(12, to_torch(tree_j), extra={"data": {"step": 12}})
    assert (tmp_path / "LATEST").read_text() == "step_00000012"
    with np.load(tmp_path / "step_00000012" / "arrays.npz") as z:
        keys = sorted(z.files)
    assert "opt/step" in keys and "params/stacks/attn_moe/moe/router" in keys
    ck_j = JCheckpointer(str(tmp_path))
    assert ck_j.latest_step() == 12
    restored, manifest = ck_j.restore(jax.tree.map(jnp.zeros_like, tree_j))
    assert manifest["step"] == 12 and manifest["n_leaves"] == len(keys)
    _assert_same(to_torch(restored), tree_j)
    # the same keys as the reference writes for the same tree
    JCheckpointer(str(tmp_path / "ref")).save(12, tree_j)
    with np.load(tmp_path / "ref" / "step_00000012" / "arrays.npz") as z:
        assert sorted(z.files) == keys


def test_port_restores_reference_bfloat16_checkpoint(tmp_path):
    """A bfloat16 leaf is stored as the reference stores it, its raw
    16-bit words; the port reads them back bit for bit."""
    tree = {"w": jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4),
                             jnp.bfloat16), "n": jnp.arange(3)}
    JCheckpointer(str(tmp_path / "j")).save(1, tree)
    template = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
                "n": torch.zeros(3, dtype=torch.int32)}
    got, _ = Checkpointer(str(tmp_path / "j")).restore(template)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(tree["w"], np.float32))
    Checkpointer(str(tmp_path / "t")).save(1, got)
    for d in ("j", "t"):
        with np.load(tmp_path / d / "step_00000001" / "arrays.npz") as z:
            assert z["w"].dtype == np.dtype("V2")
            raw = z["w"].tobytes()
        if d == "j":
            want = raw
    assert raw == want


def test_checkpoint_latest_gc_async_and_atomicity(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    for s in (1, 2, 3):
        ck.save(s, tree)
    ck.save_async(4, tree, extra={"data": {"step": 4}})
    tree["params"]["w"].add_(100.0)     # the snapshot was taken before
    ck.wait()
    assert ck.latest_step() == 4
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_00000003",
                                                "step_00000004"]
    got, manifest = ck.restore(tree)
    assert torch.equal(got["params"]["w"], torch.arange(6.0).reshape(2, 3))
    assert manifest["extra"]["data"]["step"] == 4
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ck.latest_step() == 4
    with pytest.raises(ValueError):
        ck.restore({"params": {"w": torch.zeros(3, 3)},
                    "opt": {"step": torch.tensor(0)}})


# -- the trainer ---------------------------------------------------------------

def _mk_trainer(tmp_path, steps, seed=0, horizon=8):
    """As ``tests/test_elastic_ft.py``'s: ``steps`` is where this trainer
    stops; ``horizon`` is the schedule's total_steps, the same across
    crash and resume."""
    cfg = tconfigs.ARCHS["xlstm-125m"].reduced()
    return Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=horizon),
                   DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                              seed=11),
                   TrainerConfig(total_steps=steps, checkpoint_every=4,
                                 log_every=100, seed=seed),
                   str(tmp_path), device="cpu")


def test_restart_resumes_exactly(tmp_path):
    """The port's counterpart of ``test_elastic_ft.py``'s: a run killed
    after its step-4 checkpoint and resumed gives steps 5-8 the losses of
    the uninterrupted run."""
    full = _mk_trainer(tmp_path / "a", steps=8).run()
    _mk_trainer(tmp_path / "b", steps=4).run()
    t_resume = _mk_trainer(tmp_path / "b", steps=8)
    assert t_resume.try_restore()
    assert t_resume.step == 4
    assert t_resume.stream.step == 4
    resumed = t_resume.run()
    want = [r["loss"] for r in full if r["step"] > 4]
    got = [r["loss"] for r in resumed]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert [r["step"] for r in resumed] == [5, 6, 7, 8]


def test_trainer_detects_injected_straggler(tmp_path):
    t = _mk_trainer(tmp_path, steps=14)
    t.pod_time_fn = lambda step, pod: 3.0 if (pod == 1 and step > 5) else 1.0
    t.run()
    assert "rescale" in [e.kind for e in t.supervisor.events]


def test_trainer_stream_matches_reference_data():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=7)
    s = SyntheticStream(cfg)
    batches = [next(s) for _ in range(3)]
    s.skip_to(1)
    np.testing.assert_array_equal(next(s)["tokens"], batches[1]["tokens"])


def test_train_launcher_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--steps", "4", "--batch", "2", "--seq", "32",
         "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    assert "[train] done: 4 steps" in out.stdout
