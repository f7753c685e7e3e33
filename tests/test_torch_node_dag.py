"""The node path on the CPU: the paper's node kernels (matmul, copy,
stencil) as the payloads of a ``mixed_dag`` on the port's threaded runtime.

This is ``chip_smoke.py``'s node phase (``run_node_dag``) at small tiles
(matmul 128, copy 256, stencil 128) with ``device="cpu"``: 96 tasks, 4 a
layer, ``tpu_pod_slices(2, 2)`` under DAM-C with place 0 slowed 4x.  On the
CPU every payload takes its kernel's plain version, so no launch is
counted; each type's output is held against the JAX package's ``ops`` on
the same numpy inputs (matmul 2e-4, stencil after 4 sweeps 1e-5, copy
exact).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import copy, matmul, stencil

torch.set_num_threads(1)

TILES = {"matmul": 128, "copy": 256, "stencil": 128}


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_node", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run():
    cs = _chip_smoke()
    counters = (matmul.launches, copy.launches, stencil.launches)
    before = [c.count for c in counters]
    metrics, sched, outputs, inputs, kind_of = cs.run_node_dag(
        TILES, "cpu", timeout=120)
    return {"cs": cs, "metrics": metrics, "sched": sched, "outputs": outputs,
            "inputs": inputs, "kind_of": kind_of,
            "launched": [c.count - b for c, b in zip(counters, before)]}


def test_every_task_commits(run):
    m, cs = run["metrics"], run["cs"]
    assert m.errors == []
    assert m.n_tasks == cs.NODE_TASKS == 96
    assert {k: len(v) for k, v in run["outputs"].items()} == {
        "matmul": 32, "copy": 32, "stencil": 32}
    high = [r for r in m.records if r.priority == 1]
    assert len(high) == cs.NODE_TASKS // cs.NODE_PARALLELISM


def test_each_type_has_its_own_ptt(run):
    sched, places = run["sched"], run["sched"].topology.places()
    for name in run["kind_of"]:
        tbl = sched.ptt.for_type(name)
        assert sum(tbl.visited(p) for p in places) > 0
        assert any(tbl.get(p) > 0 for p in places)


def test_cpu_payloads_count_no_launch(run):
    assert run["launched"] == [0, 0, 0]


@pytest.mark.parametrize("kind", ["matmul", "copy", "stencil"])
def test_outputs_match_the_jax_ops(run, kind):
    outs = run["outputs"][kind]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    arrays = [jnp.asarray(t.numpy()) for t in run["inputs"][kind]]
    if kind == "matmul":
        want = jops.matmul(*arrays)
    elif kind == "copy":
        want = jops.copy(*arrays)
    else:
        want = arrays[0]
        for _ in range(run["cs"].STENCIL_SWEEPS):
            want = jops.stencil(want)
    got = outs[0].numpy()
    if kind == "copy":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        tol = 2e-4 if kind == "matmul" else 1e-5
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_inputs_come_from_the_seed(run):
    a = run["cs"].node_inputs(TILES, seed=0)
    b = run["cs"].node_inputs(TILES, seed=0)
    for kind, arrays in a.items():
        for x, y, t in zip(arrays, b[kind], run["inputs"][kind]):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, t.numpy())
