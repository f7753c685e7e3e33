"""The AdamW slice on the CPU: ``apply_updates``, whose gradient norm and
leaf updates go to ``repro_torch.kernels.adamw`` (its plain versions on the
CPU, its kernels on the card), against the JAX package's over several
steps; the meta path's report of the kernels' work; the op count of a
reduced train step.

The same numpy values go to both packages.  Tolerances, each with its
reason: the norm, lr, moments, master copy and float32 params at rel 1e-6
(float32 rounding of the same arithmetic in the reference's order, as
``tests/test_torch_train.py``); a bfloat16 param is its own master copy
rounded to nearest even, bit for bit.  The card's kernels are held to
these plain versions bit for bit in ``tests/test_torch_cuda.py``.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_updates as japply_updates
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import InputShape, get_config, train_batch_specs
from repro_torch.kernels import adamw, work
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
from repro_torch.optim.adamw import apply_updates_plain, leaves
from repro_torch.train import make_grad_step, make_train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
# leaves of one element, less than the kernel's chunk of 8, a ragged
# length and a 2-d one
SHAPES = {"one": (1,), "seven": (7,), "ragged": (4097,), "mat": (33, 65)}
# (param dtype, gradient dtype): float32, bfloat16 with a float32 master
# copy, bfloat16 params with float32 gradients (the dry-run's accumulation)
KINDS = {"float32": ("float32", "float32"),
         "bfloat16": ("bfloat16", "bfloat16"),
         "bfloat16_f32_grads": ("bfloat16", "float32")}
# the gradients' scale: their norm far under the clip (1.0) or far over it
CLIP = {"not_binding": 1e-3, "binding": 30.0}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _params(dtype):
    rng = np.random.default_rng(0)
    return {k: jnp.asarray(rng.standard_normal(s).astype(np.float32), dtype)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", list(CLIP))
@pytest.mark.parametrize("kind", list(KINDS))
def test_apply_updates_match_the_reference(kind, clip):
    """4 steps on the same numpy gradients: the gradient norm and lr each
    step, then the moments, the master copy and the params."""
    pdt, gdt = KINDS[kind]
    params_j = _params(pdt)
    params_t = to_torch(params_j)
    state_j, state_t = jinit_opt_state(params_j), init_opt_state(params_t)
    assert ("master" in state_t) == (pdt != "float32")
    cfg_j, cfg_t = JAdamWConfig(**OPT), AdamWConfig(**OPT)
    rng = np.random.default_rng(1)
    for _ in range(4):
        g = {k: jnp.asarray((rng.standard_normal(s) * CLIP[clip]).astype(
            np.float32), gdt) for k, s in SHAPES.items()}
        params_j, state_j, info_j = japply_updates(params_j, g, state_j,
                                                   cfg_j)
        params_t, state_t, info_t = apply_updates(params_t, to_torch(g),
                                                  state_t, cfg_t)
        assert _rel(float(info_t["grad_norm"]),
                    float(info_j["grad_norm"])) < 1e-6
        assert (float(info_t["grad_norm"]) < cfg_t.clip_norm) == (
            clip == "not_binding")
        assert _rel(float(info_t["lr"]), float(info_j["lr"])) < 1e-6
    names = ("m", "v") + (("master",) if "master" in state_t else ())
    for name in names:
        got = to_numpy(state_t[name])
        for k in SHAPES:
            assert _rel(got[k], np.asarray(state_j[name][k])) <= 1e-6, (name,
                                                                          k)
    for k in SHAPES:
        p = params_t[k]
        assert p.dtype == getattr(torch, pdt)
        if pdt == "float32":
            assert _rel(p.numpy(), np.asarray(params_j[k])) <= 1e-6, k
        else:
            assert torch.equal(p, state_t["master"][k].to(p.dtype)), k


@pytest.mark.parametrize("kind", list(KINDS))
def test_cpu_path_is_the_plain_update(kind):
    """On the CPU ``apply_updates`` and ``apply_updates_plain`` (the eager
    update as it ran before the kernels) agree bit for bit, and no kernel
    is launched."""
    pdt, gdt = KINDS[kind]
    runs = []
    for fn in (apply_updates, apply_updates_plain):
        params = to_torch(_params(pdt))
        state = init_opt_state(params)
        rng = np.random.default_rng(2)
        before = (adamw.launches.count, adamw.norm_launches.count)
        for _ in range(3):
            g = {k: torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)).to(getattr(torch, gdt)) for k, s in SHAPES.items()}
            _, _, info = fn(params, g, state, AdamWConfig(**OPT))
        assert (adamw.launches.count, adamw.norm_launches.count) == before
        runs.append((params, state, float(info["grad_norm"])))
    (pa, sa, na), (pb, sb, nb) = runs
    assert na == nb
    for a, b in zip(leaves([pa, sa]), leaves([pb, sb])):
        assert torch.equal(a, b)


def _meta_tree(kind):
    pdt, gdt = KINDS[kind]
    params = {k: torch.empty(s, dtype=getattr(torch, pdt), device="meta")
              for k, s in SHAPES.items()}
    grads = {k: torch.empty(s, dtype=getattr(torch, gdt), device="meta")
             for k, s in SHAPES.items()}
    return params, grads


@pytest.mark.parametrize("kind", list(KINDS))
def test_meta_path_reports_the_update_and_the_norm(kind):
    """On the meta device ``apply_updates`` computes nothing and reports
    one ``adamw`` call a leaf with ``work.adamw_work``'s bytes and one
    ``adamw_norm`` call with ``work.adamw_norm_work``'s, and no flops."""
    params, grads = _meta_tree(kind)
    state = init_opt_state(params)
    master = "master" in state
    res = analyze(apply_updates, params, grads, state, AdamWConfig(**OPT))
    upd, norm = res["kernels"]["adamw"], res["kernels"]["adamw_norm"]
    assert upd["calls"] == len(SHAPES) and norm["calls"] == 1
    assert upd["bytes"] == sum(
        work.adamw_work(p.numel(), p.dtype, g.dtype, master)[1]
        for p, g in zip(leaves(params), leaves(grads)))
    assert norm["bytes"] == work.adamw_norm_work(
        [(g.numel(), g.dtype) for g in leaves(grads)])[1]
    assert upd["flops"] == norm["flops"] == res["flops"] == 0
    assert all(t.device.type == "meta" for t in leaves([params, state]))


def test_adamw_work_is_bytes_alone():
    """The update's bytes: g read, m, v and the float32 weight read and
    written, a param with a master copy written; no flops; its bound
    priced by bytes alone."""
    flops, nbytes = work.adamw_work(1000, torch.bfloat16, torch.bfloat16,
                                    True)
    assert flops == {} and nbytes == 1000 * 28
    assert work.adamw_work(1000, torch.float32, torch.float32, False)[1] == (
        1000 * 28)
    assert work.adamw_work(1000, torch.bfloat16, torch.float32, True)[1] == (
        1000 * 30)
    assert work.adamw_norm_work([(10, torch.bfloat16),
                                 (3, torch.float32)]) == ({}, 20 + 12 + 4)
    ms, by = work.bound({}, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-1.2b"])
def test_analyze_of_a_reduced_train_step_lists_the_update(arch):
    """A reduced train step on the meta device: its op count lists the
    update (one ``adamw`` call a leaf) and the norm (one call), and the
    step counts the flops of its gradient alone (the update adds bytes,
    no flops)."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, device="meta")
    state = init_opt_state(params)
    batch = train_batch_specs(cfg, InputShape("t", "train", 64, 2))
    step = make_train_step(cfg, AdamWConfig(**OPT), remat=False)
    res = analyze(step, params, state, batch)
    n = sum(1 for _ in leaves(params))
    assert res["kernels"]["adamw"]["calls"] == n
    assert res["kernels"]["adamw_norm"]["calls"] == 1
    grad_only = analyze(make_grad_step(cfg, remat=False), params, batch)
    assert res["flops"] == grad_only["flops"]
    assert res["bytes"] > grad_only["bytes"]


def test_wrappers_refuse_mixed_devices_and_no_gradients():
    n = 8
    cpu = lambda: torch.zeros(n)
    meta = torch.empty(n, device="meta")
    one = torch.ones(())
    p = cpu()
    with pytest.raises(ValueError):
        adamw.update(p, p, meta, cpu(), cpu(), one, one, one, one, b1=0.9,
                     b2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError):
        adamw.global_norm([cpu(), meta])
    with pytest.raises(ValueError):
        adamw.global_norm([])


def test_adamw_kernel_module_imports_no_jax():
    code = ("import sys; import repro_torch.kernels.adamw, "
            "repro_torch.optim.adamw; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.stdout.strip() == "[]"



def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke_adamw",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_splits_a_traced_step_at_the_update():
    """``chip_smoke._card_ms_by_range`` on a trace of made-up events: the
    kernels before the update's device-side span are the gradient's (the
    backward's among them, outside the gradient's own device-side span),
    those in it the update's, those after it outside; host events and the
    annotations themselves count nothing."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval
    cs = _chip_smoke()
    grad, upd = cs.STEP_RANGES

    def ev(name, start, end, device=DeviceType.CUDA, note=False):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=Interval(start, end),
                               is_user_annotation=note)

    events = [ev(grad, 0, 5000, DeviceType.CPU, True),
              ev(upd, 5000, 6000, DeviceType.CPU, True),
              ev(grad, 100, 300, note=True),          # the host thread's only
              ev(upd, 9000, 9500, note=True),
              ev("gemm_fwd", 100, 300), ev("elementwise_bwd", 400, 8000),
              ev("adamw_norm_partials", 9000, 9100),
              ev("adamw_update", 9100, 9500),
              ev("Memcpy DtoH", 9600, 9601),
              ev("aten::add", 5100, 5200, DeviceType.CPU)]
    out = cs._card_ms_by_range(SimpleNamespace(events=lambda: events))
    assert out[grad]["card_ms"] == pytest.approx(0.2 + 7.6)
    assert out[grad]["by_class"] == pytest.approx({"gemm": 0.2,
                                                   "elementwise": 7.6})
    assert out[upd]["by_class"] == pytest.approx({"adamw": 0.5})
    assert out["outside"]["by_class"] == pytest.approx({"copy": 0.001})
    assert cs._card_ms_by_range(SimpleNamespace(events=lambda: events[4:]
                                                )) == {}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b"])
def test_chip_smoke_counts_the_update_launches_a_step(arch):
    """Phase 8's launches a train step: one update a leaf, the norm's pass
    a leaf and one finalize; a gradient alone none."""
    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    n = sum(1 for _ in leaves(init_params(cfg, device="meta")))
    step = cs._step_launches(cfg)
    assert (step["adamw"], step["adamw_norm"]) == (n, n + 1)
    grad = cs._step_launches(cfg, update=False)
    assert (grad["adamw"], grad["adamw_norm"]) == (0, 0)
    assert {k: v for k, v in grad.items() if not k.startswith("adamw")} == {
        k: v for k, v in step.items() if not k.startswith("adamw")}
