"""The port's step on DTensors (``parallel/sharding.py``'s kernel sharding
rules, ``launch/op_analysis.py``'s per-device count, ``launch/dryrun.py``):

- on one device, a (1, 1) CPU mesh, the step as DTensors counts what the
  plain step counts, exactly: flops, bytes and peak of a reduced train,
  prefill and decode cell of four families;
- on real shards, a (2, 2) and a (1, 4) mesh of 4 CPU processes on gloo,
  the train step's loss and gradients as DTensors equal the plain
  single-process step's: the loss at rel 1e-5 and each gradient leaf at
  1e-4 x its largest magnitude (the port's float32 rule, ROADMAP's Port
  conventions).  The kernels (flash attention, the SSD scan, the sLSTM
  scan) run their plain versions on each process's shards, so this holds
  their sharding rules to the function: granite-8b's GQA (4 query heads
  on 2 K/V heads) with both sharded on (2, 2), and with the K/V heads
  whole and each shard reading the one its query head maps to on (1, 4);
  xlstm-125m's sLSTM units and mLSTM heads; qwen3-moe-30b-a3b's experts
  over "model" with a group's tokens over "data"; zamba2-1.2b's Mamba-2
  heads.  Then a prefill and decode steps on those shards: the K/V caches
  sequence-sharded (SP decode), each row written by the shard that holds
  its position, the softmax over them reduced across the shards.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fake_group():
    """The fake-backend default group the meshes are cut from, torn down
    after the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _shape(cfg, kind: str) -> InputShape:
    prefix = cfg.frontend_len if cfg.frontend != "none" else 0
    if kind == "decode":
        return InputShape("decode_t64", "decode", 64, 2)
    return InputShape(f"{kind}_s32", kind, 32 + prefix, 2)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b", "xlstm-125m"])
def test_one_device_counts_equal_the_plain_step(arch, kind, fake_group):
    """A reduced float32 cell on the (1, 1) CPU mesh: every leaf is
    replicated, nothing is redistributed, and the step as DTensors runs the
    plain step's ops on its (whole) shards: its flops, bytes and peak equal
    the plain run's, and it issues no collective."""
    mesh = make_host_mesh("cpu")
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
    shape = _shape(cfg, kind)
    cell = dryrun.build_cell(cfg, shape, mesh, n_micro=1)
    got = dryrun.analyze_cell(cell, shape, mesh)
    want = dryrun.analyze_cell(cell, shape)
    for key in ("flops", "bytes", "peak_bytes"):
        assert got[key] == want[key] > 0, (key, got[key], want[key])
    assert got["collectives"]["bytes"] == {"total": 0}


# -- on real shards: 4 processes on gloo ---------------------------------

WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import (batch_specs, distribute, param_specs,
                                      sharding_ctx)
    from repro_torch.train import make_grad_step

    torch.set_num_threads(1)
    rank, init, out, shape = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              tuple(int(n) for n in sys.argv[4].split("x")))
    archs = sys.argv[5].split(",")
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=("data", "model"))
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def on_mesh(t):
        return distribute(t, batch_specs(t, mesh), mesh)

    res = {}
    for arch in archs:
        cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab, (4, 32)).astype(np.int32))
            for k in ("tokens", "labels")}
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 4)).astype(
            np.int32))
        step = make_grad_step(cfg, remat=True)
        params = init_params(cfg, seed=0, device="cpu")
        want_g, want_m = step(params, batch)
        want = [g.detach() for g in leaves(want_g)]
        with torch.no_grad():       # a prefill (T 40) and 3 decode steps
            logits, state = prefill(params, cfg, batch["tokens"], 40)
            want_s = [logits] + [decode_step(params, cfg, state, t)[0]
                                 for t in nxt]
        params = init_params(cfg, seed=0, device="cpu")
        with sharding_ctx(mesh):
            dparams = distribute(params, param_specs(params, mesh), mesh)
            got_g, got_m = step(dparams, {k: on_mesh(v)
                                          for k, v in batch.items()})
            loss = got_m["total_loss"].full_tensor().item()
            got = [g.full_tensor() for g in leaves(got_g)]
            with torch.no_grad():
                logits, state = prefill(dparams, cfg,
                                        on_mesh(batch["tokens"]), 40)
                got_s = [logits.full_tensor()] + [
                    decode_step(dparams, cfg, state, on_mesh(t))[0]
                    .full_tensor() for t in nxt]
        res[arch] = {
            "loss": loss, "want_loss": want_m["total_loss"].item(),
            "leaf_errs": [rel(a, b) for a, b in zip(got, want)],
            "serve_errs": [rel(a, b) for a, b in zip(got_s, want_s)]}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
""")

# the hybrid's gradients at the SSD tolerance, the port's rule for them
# (ROADMAP, Port conventions: its Mamba-2 leaves run to ~220, and two
# float32 orders of summation drift apart by up to 1.7e-3 of the largest)
GRAD_TOL = {"zamba2-1.2b": 3e-3}
GLOO_RUNS = {"2x2": ["granite-8b", "xlstm-125m", "qwen3-moe-30b-a3b",
                     "zamba2-1.2b"],
             "1x4": ["granite-8b", "qwen3-moe-30b-a3b"]}


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Each mesh of ``GLOO_RUNS`` once: 4 processes, a gloo group through a
    file under a fresh temporary directory (this process's default group
    is the fake one), rank 0's results."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    results = {}
    for shape, archs in GLOO_RUNS.items():
        tmp = tmp_path_factory.mktemp(f"gloo{shape}")
        out = tmp / "out.json"
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank),
             f"file://{tmp / 'init'}", str(out), shape, ",".join(archs)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(4)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=600)
                errs.append(err)
        finally:
            for p in procs:
                p.kill()
        assert all(p.returncode == 0 for p in procs), errs[0][-3000:]
        results[shape] = json.loads(out.read_text())
    return results


@pytest.mark.parametrize("shape,arch", [(s, a) for s, archs in
                                        GLOO_RUNS.items() for a in archs])
def test_sharded_steps_equal_the_plain_steps(shape, arch, gloo_runs):
    """A reduced float32 grad step (B 4 x S 32, remat) as DTensors on a
    mesh of 4 gloo processes, the kernels' plain versions on the shards:
    its loss at rel 1e-5 of the plain single-process step's, and each
    gradient leaf, gathered whole, within 1e-4 of that leaf's largest
    magnitude (the hybrid's 3e-3, ``GRAD_TOL``; measured 1.1e-4).  Then a prefill into a state of T 40 (its K/V caches
    sequence-sharded over "model") and 3 decode steps: their logits at the
    model tolerance, rel 5e-3 of the largest (measured: at most 2.1e-5,
    zamba2's prefill; the attention models' 1.7e-6)."""
    got = gloo_runs[shape][arch]
    assert got["loss"] == pytest.approx(got["want_loss"], rel=1e-5)
    assert max(got["leaf_errs"]) <= GRAD_TOL.get(arch, 1e-4), got[
        "leaf_errs"]
    assert len(got["serve_errs"]) == 4
    assert max(got["serve_errs"]) <= 5e-3, got["serve_errs"]
