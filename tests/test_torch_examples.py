"""The twins of ``examples/`` (``repro_torch/examples``) against their
originals, on the CPU: the simulator twins print the originals' lines; the
quickstart from the reference's weights, bridged, prints its losses and
generates its tokens; the serving twin completes every request; the
training twin resumes where the original does and reports its events.

Each original runs in a subprocess as its docstring says; each twin runs
here through its ``main``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models as rmodels
from repro.models.transformer import prefill as rprefill
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.examples import (dvfs_sim, heat_distributed,
                                  interference_sim, kmeans, quickstart,
                                  serve_lm, train_lm)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _original(name: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          *args], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("twin", [dvfs_sim, heat_distributed,
                                  interference_sim, kmeans],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_simulator_twin_prints_the_originals_lines(twin, capsys):
    name = twin.__name__.rsplit(".", 1)[-1]
    twin.main()
    got = capsys.readouterr().out
    assert got.splitlines() == _original(f"{name}.py").splitlines()


def _step_losses(text: str) -> dict[int, str]:
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^step\s+(\d+)\s+loss (\S+)", text, re.M)}


def _generated(text: str) -> list[int]:
    line = re.search(r"^generated token ids: (\[.*\])$", text, re.M)
    return [int(x) for x in line.group(1).strip("[]").split(",")]


def test_quickstart_twin_from_the_reference_weights(capsys):
    """The original's weights (``init_params(cfg, PRNGKey(0))``) bridged
    into the twin: every printed loss within 1 of the original's in its
    4th decimal, and the same generated token ids.  The generation's
    logits, finite and not constant, against the reference's prefill and
    teacher-forced decode steps on the twin's trained weights, bridged
    back, at rel 5e-3 (the float32 model tolerance): the ids alone would
    pass any decode whose argmax falls to the stream's most frequent
    token."""
    want = _original("quickstart.py")
    cfg = rcfg.get_config("qwen2.5-14b").reduced()
    params = to_torch(rmodels.init_params(cfg, jax.random.PRNGKey(0)))
    out = quickstart.main(["--device", "cpu"], params=params)
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]      # the model line
    lw, lg = _step_losses(want), _step_losses(got)
    assert sorted(lg) == sorted(lw) == [5, 10, 15, 20]
    for step, loss in lw.items():
        assert abs(float(lg[step]) - float(loss)) <= 1e-4 + 1e-9, step
    assert _generated(got) == _generated(want) == out["generated"]
    assert np.isfinite(out["losses"]).all()

    trained = jax.tree.map(jnp.asarray, to_numpy(out["params"]))
    logits, state = rprefill(trained, cfg, jnp.asarray(out["prompt"].numpy()),
                             max_len=32)
    ref = [logits]
    for tok in out["generated"][:-1]:
        logits, state = rmodels.decode_step(
            trained, cfg, state, jnp.asarray([tok], jnp.int32))
        ref.append(logits)
    assert len(ref) == len(out["logits"]) == 9
    for step, (g, r) in enumerate(zip(out["logits"], ref)):
        g, r = g.double().numpy(), np.asarray(r, np.float64)
        assert np.isfinite(g).all() and g.max() > g.min(), step
        rel = np.abs(g - r).max() / np.abs(r).max()
        assert rel < 5e-3, (step, rel)


def test_serve_lm_twin_completes_every_request():
    out = serve_lm.main(["--device", "cpu"])
    assert set(out) == {"RWS", "DAM-P"}
    for res in out.values():
        assert res["stats"]["completed"] == serve_lm.REQUESTS == 10
        assert res["prefills"] == 10


def test_train_lm_twin_resumes_and_reports_the_originals_events(tmp_path):
    """``--small --steps 8``: the twin resumes at the original's step and
    its supervisor reports the original's events; every loss is finite."""
    want = _original("train_lm.py", "--small", "--steps", "8")
    resumed = int(re.search(r"^-- resumed at step (\d+)", want,
                            re.M).group(1))
    events = want.split("supervisor events:\n", 1)[1].splitlines()
    out = train_lm.main(["--small", "--steps", "8", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    assert out["resumed_at"] == resumed == 4
    assert [f"  step {s}: {k} — {d}" for s, k, d in out["events"]] == events
    assert events
    losses = [h["loss"] for h in out["first"] + out["resumed"]]
    assert len(losses) == 8 and np.isfinite(losses).all()
