"""The torch placement score (``repro_torch/core/placement_torch.py``)
against the JAX package's backends, through the port's copies of the
discrete-event simulator and ``make_scheduler``.

On the CPU, where these run, ``make_scheduler(placement_backend="torch")``
builds the hook on the CPU (``make_score_fn`` patched to ``device="cpu"``;
its default is the card, which ``test_torch_backend_needs_a_card`` holds)."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.placement_jax import make_score_fn as jax_score_fn
from repro_torch.core import placement_torch

torch.set_num_threads(1)


@pytest.fixture
def torch_backend_on_cpu(monkeypatch):
    monkeypatch.setattr(placement_torch, "make_score_fn", functools.partial(
        placement_torch.make_score_fn, device="cpu"))


def _records_fingerprint(core, sched_name, backend, *, queue_penalty=0.0,
                         seed=7):
    """``tests/test_schedulers.py::_records_fingerprint`` over the package
    ``core`` (the reference's or the port's)."""
    topo = core.tx2()
    sched = core.make_scheduler(sched_name, topo, seed=seed,
                                queue_penalty=queue_penalty,
                                track_load=queue_penalty > 0.0,
                                placement_backend=backend)
    tt = core.matmul_type(64)
    dag = core.synthetic_dag(tt, parallelism=4, total_tasks=600)
    m = core.simulate(dag, sched, background=[core.corun_chain(tt, core=0)])
    return (m.makespan, [(r.type_name, r.leader, r.width, r.t_start, r.t_end)
                         for r in m.records])


@pytest.mark.parametrize("sched_name", ["DAM-C", "RWSM-C"])
def test_torch_backend_bit_identical_without_queue_penalty(
        sched_name, torch_backend_on_cpu):
    """With queue-aware placement off the score is the identity map: the
    port's simulator with the torch backend reproduces the reference's
    numpy schedule exactly, as the reference's jax backend does."""
    want = _records_fingerprint(ref_core, sched_name, "numpy")
    assert _records_fingerprint(port_core, sched_name, "numpy") == want
    assert _records_fingerprint(port_core, sched_name, "torch") == want


def test_torch_backend_queue_penalty_commits_every_task(
        torch_backend_on_cpu):
    """With a live penalty the score is float32, so bit-identity is not
    promised; every one of the 600 tasks commits."""
    mk, recs = _records_fingerprint(port_core, "DAM-C", "torch",
                                    queue_penalty=0.05)
    assert mk > 0 and len(recs) == 600


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps of two float32 arrays of one sign."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_score_matches_the_jax_backend_within_one_ulp():
    """The hook's float32 scores on seeded draws of PTT values and loads as
    the searches pass them (float64, non-negative): within 1 ulp of
    ``placement_jax``'s and of numpy's float32 evaluation of the same
    inputs rounded to float32, as both backends take them; within 2 of
    numpy's float64 scores rounded to float32, which no float32 evaluation
    holds to 1 (the three inputs are rounded first: the JAX backend is 2
    ulps off on some draws too)."""
    rng = np.random.default_rng(0)
    ours = placement_torch.make_score_fn(device="cpu")
    theirs = jax_score_fn()
    worst = {"jax": 0, "float32": 0, "float64": 0}
    for _ in range(500):
        n = int(rng.integers(1, 40))
        vals = rng.exponential(1e-3, n)
        load = rng.exponential(5e-3, n)
        penalty = float(rng.uniform(0.0, 1.0))
        got = ours(vals, load, penalty)
        assert got.dtype == np.float32 and got.shape == (n,)
        want = {"jax": np.asarray(theirs(vals, load, penalty),
                                  dtype=np.float32),
                "float32": (vals.astype(np.float32) + np.float32(penalty)
                            * load.astype(np.float32)),
                "float64": (vals + penalty * load).astype(np.float32)}
        for k, w in want.items():
            worst[k] = max(worst[k], int(_ulps(got, w).max()))
    assert worst["jax"] <= 1 and worst["float32"] <= 1, worst
    assert worst["float64"] <= 2, worst
    vals = rng.exponential(1e-3, 8)
    assert ours(vals, None, 0.05) is vals


def test_jax_and_unknown_backends_raise():
    with pytest.raises(ValueError, match="placement_backend='torch'"):
        port_core.make_scheduler("DAM-C", port_core.tx2(),
                                 placement_backend="jax")
    with pytest.raises(ValueError, match="placement_backend"):
        port_core.make_scheduler("DAM-C", port_core.tx2(),
                                 placement_backend="tpu")


def test_torch_backend_needs_a_card(monkeypatch):
    """No fallback: without a card the default hook is refused, and so is
    the backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        placement_torch.make_score_fn()
    with pytest.raises(RuntimeError, match="is_available"):
        port_core.make_scheduler("DAM-C", port_core.tx2(),
                                 placement_backend="torch")


def test_node_dag_under_the_torch_score(torch_backend_on_cpu):
    """``chip_smoke.py`` phase 9's node DAG at small tiles on the CPU: DAM-C
    with a queue penalty, ``track_load`` and the torch score; every task
    commits, and the searches score the loads through the hook."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_place", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sched = port_core.make_scheduler(
        "DAM-C", port_core.tpu_pod_slices(2, 2), seed=0,
        queue_penalty=cs.SCORE_PENALTY, track_load=True,
        placement_backend="torch")
    hook, loaded = sched.score_fn, []

    def counted(vals, load, penalty):
        loaded.append(load is not None)
        return hook(vals, load, penalty)

    sched.score_fn = counted
    metrics, *_ = cs.run_node_dag({"matmul": 64, "copy": 128, "stencil": 64},
                                  "cpu", timeout=120, sched=sched)
    assert metrics.errors == [] and metrics.n_tasks == cs.NODE_TASKS
    assert any(loaded)
