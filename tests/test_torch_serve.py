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


def _greedy_tokens_match(arch: str) -> None:
    cfg_j = jconfigs.ARCHS[arch].reduced()
    cfg_t = tconfigs.ARCHS[arch].reduced()
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


def test_engine_greedy_tokens_match_reference():
    _greedy_tokens_match("granite-8b")


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b"])
def test_engine_greedy_tokens_match_reference_ssm(arch):
    """The SSM families through both engines: the port's prefill runs the
    SSD scan's plain version, its decode the recurrent states."""
    _greedy_tokens_match(arch)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_engine_greedy_tokens_match_reference_moe(arch):
    """The MoE family through both engines: prefill routes by capacity
    slots, each one-token decode by (token, expert) pairs."""
    _greedy_tokens_match(arch)


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


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b"])
def test_launcher_serves_reduced_ssm_model_on_cpu(arch):
    out = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "12",
                        "--new-tokens", "2"])
    assert out["stats"]["completed"] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launcher_serves_reduced_moe_model_on_cpu(dtype):
    out = tlaunch.main(["--arch", "moonshot-v1-16b-a3b", "--reduced",
                        "--device", "cpu", "--dtype", dtype, "--requests",
                        "2", "--prompt-len", "12", "--new-tokens", "2"])
    assert out["stats"]["completed"] == 2
    assert out["dtype"] == dtype


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(tconfigs.ARCHS["granite-8b"].reduced(), ttopo(1, 1))
    assert resolve_device("cpu") == torch.device("cpu")


# -- the reference's serving scenarios (tests/test_serve.py), on the port ------

@pytest.fixture(scope="module")
def engine_cfg():
    return tconfigs.ARCHS["xlstm-125m"].reduced()


def test_deadline_admission_rejects_hopeless_requests(engine_cfg):
    """``tests/test_serve.py``'s test of the same name on the port's engine:
    a deadline below even the PTT-best-case estimate is refused at
    admission, finalizes at once with ``rejected``, runs nothing, and
    leaves the admitted request alone."""
    eng = TEngine(engine_cfg, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                  device="cpu")
    rng = np.random.default_rng(2)
    ok = eng.submit(rng.integers(0, engine_cfg.vocab, 16), max_new_tokens=2)
    doomed = [eng.submit(rng.integers(0, engine_cfg.vocab, 16),
                         max_new_tokens=4, deadline_s=1e-5)
              for _ in range(3)]
    for r in doomed:
        assert r.rejected and r.t_done == r.t_submit
        assert not r.out_tokens
    eng.run(timeout=300)
    stats = eng.latency_stats()
    assert stats["completed"] == 1 and stats["rejected"] == 3
    assert stats["deadline_miss"] == 3
    assert len(ok.out_tokens) == 2


def test_deadline_shedding_truncates_decode_chain(engine_cfg):
    """``tests/test_serve.py``'s test of the same name on the port's engine:
    requests admitted under a 20 ms deadline that passes mid-chain shed
    their queued decode work and finalize truncated, not empty."""
    eng = TEngine(engine_cfg, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                  device="cpu")
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, engine_cfg.vocab, 16),
                       max_new_tokens=6, deadline_s=0.02) for _ in range(3)]
    eng.run(timeout=300)
    stats = eng.latency_stats()
    assert stats["rejected"] == 0
    assert stats["shed"] == 3
    for r in reqs:
        assert r.shed and r.t_done > 0
        assert 1 <= len(r.out_tokens) < 6


def test_forced_overload_backpressure_and_brownout():
    """``tests/test_serve.py``'s test of the same name on the port's engine
    (synthetic payloads, ~4x past the fleet's capacity): the bounded queue
    rejects with ``backpressure``, the brownout ladder reaches its shed
    rung, every intervention lands in its cause's counter, and the
    transition log is a contiguous walk from rung 0."""
    eng = TEngine(None, ttopo(2, 2), scheduler="DAM-C", max_pending=24,
                  brownout=TBrownout(enter=(0.02, 0.05, 0.10),
                                     exit=(0.01, 0.02, 0.05)),
                  prefill_s=20e-3, decode_s=5e-3)
    prompts = [np.zeros(8, np.int32)] * 80
    m = eng.run_open_loop(prompts, rate_rps=400.0, max_new_tokens=5,
                          timeout=120)
    assert not m.errors
    s = eng.latency_stats()
    assert s["completed"] + s["rejected"] == 80
    assert s["rejected_backpressure"] > 0
    assert s["rejected"] == s["rejected_backpressure"]
    assert s["rejected_deadline"] == 0
    assert s["shed_deadline"] == 0
    assert s["brownout_max_rung"] >= 2
    assert s["shed_brownout"] + s["tokens_clamped"] > 0
    assert s["shed"] == s["shed_brownout"]
    prev = 0
    for _t, frm, to in m.brownout_transitions:
        assert frm == prev and to != frm
        prev = to
    assert s["brownout_transitions"] == len(m.brownout_transitions) > 0


def test_warm_start_priming_is_engine_level():
    """``tests/test_serve.py``'s test of the same name on the port's engine:
    ``warm_start`` primes every place's PTT entry for a request's prefill
    type before it is placed; an explicit ``prime`` then primes nothing."""
    from repro_torch.core import TaskType
    topo = ttopo(2, 2)
    eng = TEngine(None, topo, scheduler="DAM-C")
    eng.submit(np.zeros(8, np.int32), max_new_tokens=2)
    tbl = eng.sched.ptt.for_type("prefill_16")
    assert all(tbl.get(p) > 0.0 for p in topo.places())
    kinds = {p.kind for p in topo.partitions}
    assert eng.prime(TaskType("prefill_16",
                              serial_time={k: 1e-3 for k in kinds})) == 0
    eng.run(timeout=60)


def test_open_loop_poisson_arrival(engine_cfg):
    """``tests/test_serve.py``'s test of the same name on the port's engine:
    seeded Poisson arrivals while the runtime runs; the per-request
    latency percentiles in ``RunMetrics`` and the engine's stats."""
    eng = TEngine(engine_cfg, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                  device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, engine_cfg.vocab, 12) for _ in range(3)]
    m = eng.run_open_loop(prompts, rate_rps=20.0, max_new_tokens=2,
                          timeout=300)
    assert m.n_tasks >= 3
    stats = m.request_latency_stats()
    assert stats["completed"] == 3
    for key in ("ttft_ms", "e2e_ms"):
        for p in ("mean", "p50", "p95", "p99"):
            assert stats[key][p] > 0
        assert stats[key]["p50"] <= stats[key]["p99"]
    es = eng.latency_stats()
    assert es["completed"] == 3
    assert es["ttft_ms_p50"] <= es["ttft_ms_p99"]
