"""bfloat16 training of the port against the JAX package's, on the CPU:
the loss and its gradients of every trainable layer plan, AdamW steps, the
MoE backward's dropped rows, and the exact resume of a bfloat16 trainer.

The same numpy inputs go to both packages; the weights are drawn by the JAX
package in bfloat16 and bridged leaf for leaf (``repro_torch.bridge``).
The yardstick is the exact function, the reference's float32 run on the
same weights cast up, and the rule (``chip_smoke.bf16_grad_limits``, read
from ``tools/bf16_grad_drift.jsonl``): a bfloat16 loss, its worst gradient
leaf (largest error over the leaf's largest magnitude) and 3 AdamW steps'
losses within twice the reference's own largest bfloat16-vs-float32 drift
over seeds 0-7.  zamba2-1.2b is held on its loss and step losses only: its
reduced bfloat16 gradients carry no signal in either package (the
reference's own worst leaf strays by several times the leaf's largest).
"""
import dataclasses
import importlib.util
import json
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.models import loss_and_metrics as jloss_and_metrics
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig
from repro_torch.models import init_params, moe
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import leaves
from repro_torch.train import make_grad_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_bf16", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
LIMITS = CS.bf16_grad_limits()
ARCHS = ("granite-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "xlstm-125m",
         "musicgen-large", "stablelm-3b", "qwen2.5-14b", "moonshot-v1-16b-a3b",
         "nemotron-4-15b")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def _worst_leaf(grads, want) -> float:
    got, want = dict(_flat(grads)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
               for k, w in want.items())


def _models(arch: str, seed: int = 0):
    """(reference config in float32, its bfloat16 twin, the port's bfloat16
    config, bfloat16 reference params, the same cast up to float32)."""
    cfg_f = jconfigs.get_config(arch).reduced()
    cfg_b = dataclasses.replace(cfg_f, dtype="bfloat16")
    cfg_t = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                                dtype="bfloat16")
    params_b = jinit_params(cfg_b, jax.random.PRNGKey(seed))
    params_f = jax.tree.map(lambda a: a.astype(jnp.float32), params_b)
    return cfg_f, cfg_b, cfg_t, params_b, params_f


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_the_rule_is_grounded_on_eight_seeds_of_every_arch():
    """``tools/bf16_grad_drift.jsonl`` holds seeds 0-7 of each of the nine
    reduced archs; its last line is the limits ``bf16_grad_limits`` reads
    from the rows (zamba2-1.2b without a gradient limit), and in every row
    the port's bfloat16 run is within them."""
    lines = [json.loads(x) for x in
             CS.BF16_GRAD_DRIFT.read_text().splitlines() if x.strip()]
    rows, last = lines[:-1], lines[-1]
    assert {(r["arch"], r["seed"]) for r in rows} == {
        (a, s) for a in ARCHS for s in range(8)}
    assert all(r["tokens"] == [2, 48] for r in rows)
    assert last["limits"] == LIMITS == CS.bf16_grad_limits(rows)
    assert LIMITS["zamba2-1.2b"]["grad"] is None
    for r in rows:
        lim, port = LIMITS[r["arch"]], r["port_bf16_vs_ref_f32"]
        assert port["loss"] <= lim["loss"], r
        assert lim["grad"] is None or port["grad"] <= lim["grad"], r
        assert r["steps"]["port_bf16_vs_ref_f32"] <= lim["steps"], r


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_under_the_rule(arch):
    """``loss_and_metrics`` and its gradients in bfloat16 (the MoE's with
    its aux loss, musicgen's with its prefix of 16) on the port, against
    the reference's float32 run of the same weights and batch: the loss
    and the worst gradient leaf within the arch's limits (zamba2-1.2b on
    its loss only, its gradients finite); every gradient in bfloat16."""
    cfg_f, _, cfg_t, params_b, params_f = _models(arch)
    batch = CS.bf16_drift_batch(cfg_f, 4)
    (total_f, _), grads_f = jax.jit(jax.value_and_grad(
        lambda p: jloss_and_metrics(p, cfg_f, _j(batch)), has_aux=True))(
            params_f)
    grads_t, met_t = make_grad_step(cfg_t, remat=False)(to_torch(params_b),
                                                        _t(batch))
    assert all(g.dtype == torch.bfloat16 for g in leaves(grads_t))
    lim = LIMITS[arch]
    loss_rel = abs(float(met_t["total_loss"]) - float(total_f)) / abs(
        float(total_f))
    assert loss_rel <= lim["loss"], (loss_rel, lim)
    if cfg_t.family == "moe":
        assert float(met_t["aux_loss"]) > 0
    if lim["grad"] is None:
        assert all(bool(torch.isfinite(g).all()) for g in leaves(grads_t))
    else:
        worst = _worst_leaf(to_numpy(grads_t), grads_f)
        assert worst <= lim["grad"], (worst, lim)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_steps_under_the_rule(arch):
    """3 AdamW steps from the bridged bfloat16 weights (the reference's
    ``make_train_step``, jitted, remat on; the port's with a float32 master
    copy and moments): each step's loss within the step limit of the
    reference's float32 steps from the same weights cast up, and within
    twice it of the reference's bfloat16 steps (each within the limit of
    the float32 run); the port's params stay bfloat16 and its master copy
    rounds to them."""
    cfg_f, cfg_b, cfg_t, params_b, params_f = _models(arch)
    opt_j, opt_t = (JAdamWConfig(**CS.BF16_STEP_OPT),
                    AdamWConfig(**CS.BF16_STEP_OPT))
    runs = {}
    for name, cfg, params in (("f32", cfg_f, params_f),
                              ("bf16", cfg_b, params_b)):
        step, state, losses = (jax.jit(jmake_train_step(cfg, opt_j)),
                               jinit_opt_state(params), [])
        for seed in CS.BF16_STEP_SEEDS:
            params, state, met = step(params, state, _j(CS.bf16_drift_batch(
                cfg_f, seed, mask=False)))
            losses.append(float(met["loss"]))
        runs[name] = losses
    params_t = to_torch(params_b)
    state_t = init_opt_state(params_t)
    step_t, losses_t = make_train_step(cfg_t, opt_t), []
    for seed in CS.BF16_STEP_SEEDS:
        params_t, state_t, met = step_t(params_t, state_t, _t(
            CS.bf16_drift_batch(cfg_f, seed, mask=False)))
        losses_t.append(float(met["loss"]))
    lim = LIMITS[arch]["steps"]
    for i, got in enumerate(losses_t):
        assert abs(got - runs["f32"][i]) / abs(runs["f32"][i]) <= lim, i
        assert abs(got - runs["bf16"][i]) / abs(runs["bf16"][i]) <= 2 * lim, i
    assert sorted(state_t) == ["m", "master", "step", "v"]
    for p, p32 in zip(leaves(params_t), leaves(state_t["master"])):
        assert p.dtype == torch.bfloat16 and p32.dtype == torch.float32
        assert torch.equal(p, p32.to(torch.bfloat16))


def test_moe_dropped_pairs_add_only_zeros_to_slot_zero(monkeypatch):
    """The gather back from the capacity slots (``moe._experts_by_slot``)
    reads slot 0 for every dropped (token, k) pair, so its backward, an
    atomic ``scatter_add`` on CUDA, sums their rows into slot 0's gradient.
    That sum is exact in any order only if those rows' gradients are
    exactly zero: they are (their combine weight is 0), in bfloat16 and
    float32, at a capacity that drops pairs."""
    seen = []
    real = moe._experts_by_slot

    def spy(params, xg, expert_idx, pos, keep, capacity):
        out = real(params, xg, expert_idx, pos, keep, capacity)
        out.register_hook(lambda g: seen.append(
            (g.detach().clone(), keep.reshape(g.shape[:2]).clone())))
        return out

    monkeypatch.setattr(moe, "_experts_by_slot", spy)
    cfg = tconfigs.get_config("qwen3-moe-30b-a3b").reduced()
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(3)
        params = moe.init_moe(cfg.d_model, cfg.n_experts, cfg.d_ff,
                              gen=gen, device="cpu", dtype=dtype)
        x = torch.randn((2, 48, cfg.d_model), generator=gen).to(dtype)
        for t in [x, *leaves(params)]:
            t.requires_grad_(True)
        y, aux = moe.moe_block(params, x, top_k=cfg.top_k,
                               capacity_factor=0.5)
        dy = torch.randn(y.shape, generator=gen)
        torch.autograd.grad((y.float() * dy).sum() + aux,
                            [x, *leaves(params)])
        grad, keep = seen.pop()
        assert int((~keep).sum()) > 0 and bool(keep.any())
        assert bool((grad[~keep] == 0).all())
        assert bool((grad[keep] != 0).any())


def test_restore_writes_into_the_template(tmp_path):
    """``Checkpointer.restore`` (the ``Trainer``'s resume, so that the card
    holds one copy of the state) writes each leaf into the template's own
    tensor, bfloat16, float32 and int32 bit for bit; a file it writes
    leaf by leaf is ``np.savez``'s, and numpy reads it."""
    tree = {"params": {"w": torch.linspace(-3, 3, 12).reshape(3, 4).to(
                torch.bfloat16)},
            "opt": {"master": {"w": torch.linspace(-3, 3, 12).reshape(3, 4)},
                    "step": torch.tensor(5, dtype=torch.int32)}}
    ck = Checkpointer(str(tmp_path))
    ck.save(5, tree)
    template = {"params": {"w": torch.zeros((3, 4), dtype=torch.bfloat16)},
                "opt": {"master": {"w": torch.zeros(3, 4)},
                        "step": torch.tensor(0, dtype=torch.int32)}}
    got, manifest = ck.restore(template)
    assert manifest["step"] == 5
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as z:
        assert sorted(z.files) == ["opt/master/w", "opt/step", "params/w"]
        np.testing.assert_array_equal(z["opt/master/w"],
                                      tree["opt"]["master"]["w"].numpy())
        assert z["params/w"].dtype == np.dtype("V2")
    for (_, g), (_, t), (_, s) in zip(_flat_torch(got),
                                      _flat_torch(template),
                                      _flat_torch(tree)):
        assert g is t and g.dtype == s.dtype
        assert torch.equal(g.reshape(-1).view(torch.uint8),
                           s.reshape(-1).view(torch.uint8))


def test_restore_refuses_a_corrupt_checkpoint(tmp_path):
    """A byte changed in a leaf's data fails its member's CRC-32, and the
    restore raises; the same file as written restores."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(1000, dtype=torch.float32)}
    ck.save(1, tree)
    npz = tmp_path / "step_00000001" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    at = raw.index(np.float32(500.0).tobytes())
    raw[at] ^= 1
    npz.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile):
        ck.restore({"w": torch.zeros(1000)})
    raw[at] ^= 1
    npz.write_bytes(bytes(raw))
    got, _ = ck.restore({"w": torch.zeros(1000)})
    assert torch.equal(got["w"], tree["w"])


def _trainer(arch: str, path, steps: int):
    cfg = dataclasses.replace(tconfigs.ARCHS[arch].reduced(),
                              dtype="bfloat16")
    return Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                   DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                              seed=11),
                   TrainerConfig(total_steps=steps, checkpoint_every=4,
                                 log_every=100, seed=0),
                   str(path), device="cpu")


def _state(t: Trainer) -> dict:
    return {k: v.detach().clone() for k, v in _flat_torch(t._state_tree())}


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_torch(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-125m"])
def test_bf16_trainer_resumes_bit_for_bit(arch, tmp_path):
    """A reduced bfloat16 ``Trainer`` checkpoints at step 4; a fresh one
    restores it (its own bfloat16 leaves, the float32 master copy and
    moments) and takes steps 5-8: the restored state equals the straight
    run's at step 4, and the later losses, params, master copy and moments
    equal the straight run's, bit for bit."""
    full = _trainer(arch, tmp_path / "a", 4)
    full.run()
    at_ckpt = _state(full)
    full.tcfg = dataclasses.replace(full.tcfg, total_steps=8,
                                    checkpoint_every=100)
    full.run()
    at_end = _state(full)
    assert {k.split("/")[2] for k in at_end if k.startswith("/opt/")} >= {
        "master", "m", "v"}
    resumed = _trainer(arch, tmp_path / "a", 8)
    assert resumed.try_restore() and resumed.step == 4
    for state, want in ((_state(resumed), at_ckpt), (None, at_end)):
        if state is None:
            resumed.run()
            state = _state(resumed)
        assert sorted(state) == sorted(want)
        for k, w in want.items():
            assert state[k].dtype == w.dtype, k
            assert torch.equal(state[k].reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), k
    assert [r["loss"] for r in resumed.history] == [
        r["loss"] for r in full.history if r["step"] > 4]
    assert all(v.dtype == torch.bfloat16
               for k, v in at_end.items() if k.startswith("/params/"))


def test_chip_smoke_trains_the_bfloat16_runs_at_full_width():
    """Phase 8's bfloat16 runs: qwen3-moe-30b-a3b cut 48 -> 1 layer at
    full width (1.24 B parameters, ~20 GB at 16 bytes each), granite-8b x
    1, zamba2-1.2b x 6, xlstm-125m whole, stablelm-3b whole and
    qwen2.5-14b x 4 (``tests/test_torch_models.py`` holds those two), all
    B 2 x S 2048, beside the
    float32 runs; a bfloat16 step's flash launches are on ``wgmma``
    forward and backward (remat runs the forward again), and its AdamW
    kernels' are one update a leaf (13) and the norm's pass a leaf and a
    finalize (14)."""
    runs = {(r["arch"], r["dtype"]): r for r in CS.TRAIN_RUNS}
    assert {a for a, d in runs if d == "bfloat16"} == {
        "qwen3-moe-30b-a3b", "granite-8b", "zamba2-1.2b", "xlstm-125m",
        "stablelm-3b", "qwen2.5-14b"}
    assert {a for a, d in runs if d == "float32"} == {
        "granite-8b", "zamba2-1.2b", "xlstm-125m"}
    assert all((r["batch"], r["seq"]) == (2, 2048) for r in runs.values())
    moe_run = runs["qwen3-moe-30b-a3b", "bfloat16"]
    cfg = dataclasses.replace(tconfigs.get_config("qwen3-moe-30b-a3b"),
                              n_layers=moe_run["layers"], dtype="bfloat16")
    n = sum(t.numel() for t in leaves(init_params(cfg, device="meta")))
    assert moe_run["layers"] == 1 and abs(n / 1.236e9 - 1) < 5e-3
    assert 19e9 < 16 * n < 20e9
    for remat, fwd in ((False, 1), (True, 2)):
        assert CS._step_launches(cfg, remat) == {
            "flash_attention": fwd, "flash_attention_bwd": 1, "tf32x3": 0,
            "wgmma": fwd, "bwd_tf32x3": 0, "bwd_wgmma": 1, "bwd_fma": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "ssd_bf16_async": 0,
            "ssd_plain": 0, "ssd_bwd_bf16_async": 0, "ssd_bwd_plain": 0,
            "slstm_scan": 0, "slstm_scan_bwd": 0, "adamw": 13,
            "adamw_norm": 14}
    granite = dataclasses.replace(tconfigs.get_config("granite-8b"),
                                  n_layers=8)
    assert CS._step_launches(granite)["tf32x3"] == 8
    assert CS._step_launches(dataclasses.replace(
        granite, dtype="bfloat16"))["bwd_wgmma"] == 8
