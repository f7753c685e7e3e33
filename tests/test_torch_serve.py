"""The port's serving engine against the JAX package's, on the CPU.

With the reference's weights bridged in, the port's ``ServingEngine``
must emit the reference engine's greedy tokens; the batching and overload
policies (copied modules) must decide alike on the same seeded inputs.
"""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import tpu_pod_slices as jtopo
from repro.core.queues import BatchingConfig as JBatching
from repro.serve import BrownoutConfig as JBrownout
from repro.serve import OverloadController as JController
from repro.serve import ServingEngine as JEngine
from repro.serve import form_batches as jform
from repro.serve.batching import BatchSlot as JSlot
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.core import BatchingConfig as TBatching
from repro_torch.core import tpu_pod_slices as ttopo
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import BrownoutConfig as TBrownout
from repro_torch.serve import OverloadController as TController
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.serve import form_batches as tform
from repro_torch.serve import resolve_device
from repro_torch.serve.batching import BatchSlot as TSlot

torch.set_num_threads(1)


def test_engine_greedy_tokens_match_reference():
    cfg_j = jconfigs.ARCHS["granite-8b"].reduced()
    cfg_t = tconfigs.ARCHS["granite-8b"].reduced()
    ref = JEngine(cfg_j, jtopo(2, 2), scheduler="DAM-C", max_len=32)
    port = TEngine(cfg_t, ttopo(2, 2), scheduler="DAM-C", max_len=32,
                   device="cpu")
    port.params = to_torch(ref.params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab, 16) for _ in range(4)]
    want = [ref.submit(p, max_new_tokens=4) for p in prompts]
    ref.run(timeout=300)
    got = [port.submit(p, max_new_tokens=4) for p in prompts]
    port.run(timeout=300)
    assert port.latency_stats()["completed"] == 4
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 4 for r in got)


def _slots(slot_cls, rng_seed):
    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(int(rng.integers(1, 24))):
        req = type("R", (), {
            "tier": "high" if rng.random() < 0.1 else "low",
            "deadline_s": float(rng.choice([0.0, 0.05, 0.2])),
            "t_submit": float(rng.random() * 0.01)})()
        out.append(slot_cls(req, {}, float(rng.random() * 0.01)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_form_batches_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    kw = dict(max_batch=int(rng.integers(2, 9)),
              delay_s=float(rng.choice([1e-3, 5e-3])),
              flush_slack_s=float(rng.choice([0.0, 5e-3])))
    now = float(rng.random() * 0.02)
    ref_slots, port_slots = _slots(JSlot, seed), _slots(TSlot, seed)
    jg, jrest = jform(ref_slots, now=now, cfg=JBatching(**kw))
    tg, trest = tform(port_slots, now=now, cfg=TBatching(**kw))
    idx_j = {id(s): i for i, s in enumerate(ref_slots)}
    idx_t = {id(s): i for i, s in enumerate(port_slots)}
    assert ([[idx_t[id(s)] for s in g] for g in tg]
            == [[idx_j[id(s)] for s in g] for g in jg])
    assert [idx_t[id(s)] for s in trest] == [idx_j[id(s)] for s in jrest]


def test_overload_controller_matches_reference():
    rng = np.random.default_rng(7)
    signal = np.abs(rng.standard_normal(400)) * 0.4
    signal[100:200] += rng.random(100) * 5.0      # a saturation episode
    kw = dict(enter=(0.5, 1.5, 4.0), exit=(0.25, 0.75, 2.0), min_tokens=2)
    ref, port = JController(JBrownout(**kw)), TController(TBrownout(**kw))
    rungs = [(ref.update(float(x), i * 5e-3), port.update(float(x), i * 5e-3))
             for i, x in enumerate(signal)]
    assert [a for a, _ in rungs] == [b for _, b in rungs]
    assert max(a for a, _ in rungs) > 0
    assert port.transitions == ref.transitions
    assert port.summary() == ref.summary()


def test_launcher_serves_reduced_model_on_cpu():
    out = tlaunch.main(["--reduced", "--device", "cpu", "--requests", "2",
                        "--prompt-len", "12", "--new-tokens", "2"])
    assert out["stats"]["completed"] == 2


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(tconfigs.ARCHS["granite-8b"].reduced(), ttopo(1, 1))
    assert resolve_device("cpu") == torch.device("cpu")
