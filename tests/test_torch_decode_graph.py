"""The serving engine's decode slots (``repro_torch/serve/decode_graph.py``)
on the CPU, where a slot runs the decode step's plain version on its static
buffers (on the card it replays a captured graph: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold that route bit for bit against the eager step).

For a reduced model of each family (granite-8b; qwen3-moe-30b-a3b at
capacity 16; zamba2-1.2b; xlstm-125m; internvl2-76b on its text path),
with the reference's weights bridged in:

- the slot's steps are the eager ``decode_step``'s, bit for bit, over
  ``NEW_TOKENS`` greedy steps from one prefill's state;
- they agree with the reference's jitted ``decode_step`` at its model
  tolerance, rel 5e-3, with the same greedy tokens;
- two requests interleaved through one slot get what each gets alone;
- the engine's batched path through its slots gives the reference engine's
  tokens.

And: a shed request takes no slot, DTensor params and state are refused,
a replay adds the launches its graph holds (with a stand-in for the graph
object), a closed engine refuses to decode, and an engine does not close
while its run is live.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import tpu_pod_slices as jtopo
from repro.core.queues import BatchingConfig as JBatching
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models.transformer import prefill as jprefill
from repro.serve import ServingEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.core import BatchingConfig as TBatching
from repro_torch.core import tpu_pod_slices as ttopo
from repro_torch.kernels import flash_attention, slstm_scan
from repro_torch.launch import serve as tlaunch
from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.serve.decode_graph import DecodeSlot, decode_counters
from repro_torch.serve.engine import Request

torch.set_num_threads(1)

ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "xlstm-125m",
         "internvl2-76b"]
MOE_CAPACITY = 16.0
NEW_TOKENS = 6
PROMPT_LEN = 12
MAX_LEN = 32


def _cfgs(arch):
    cfg_j, cfg_t = jconfigs.ARCHS[arch].reduced(), tconfigs.ARCHS[arch].reduced()
    if cfg_t.family == "moe":
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=MOE_CAPACITY)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=MOE_CAPACITY)
    return cfg_j, cfg_t


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg_j, cfg_t = _cfgs(request.param)
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params_j, to_torch(params_j)


def _prompt(cfg, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, PROMPT_LEN)


def _prefill(params, cfg, prompt):
    """The prefill's state and its greedy token."""
    with torch.inference_mode():
        logits, state = prefill(params, cfg, torch.from_numpy(prompt)[None],
                                MAX_LEN)
    return state, int(torch.argmax(logits[0]))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _eager(params, cfg, state, tok: int, steps: int):
    """``steps`` greedy eager steps: each step's logits and token."""
    logits_seq, toks = [], []
    with torch.inference_mode():
        for _ in range(steps):
            logits, state = decode_step(params, cfg, state,
                                        torch.tensor([tok]))
            tok = int(torch.argmax(logits[0]))
            logits_seq.append(logits.clone())
            toks.append(tok)
    return logits_seq, toks


def _through(slot, state, tok: int, steps: int):
    logits_seq, toks = [], []
    for _ in range(steps):
        tok = slot.step(state, tok)
        logits_seq.append(slot.logits.clone())
        toks.append(tok)
    return logits_seq, toks


def test_slot_steps_are_the_eager_steps_bit_for_bit(model):
    _, cfg, _, params = model
    state, tok = _prefill(params, cfg, _prompt(cfg))
    eager_state, slot_state = _clone(state), _clone(state)
    want, want_toks = _eager(params, cfg, eager_state, tok, NEW_TOKENS)
    slot = DecodeSlot(params, cfg, MAX_LEN, "cpu")
    got, got_toks = _through(slot, slot_state, tok, NEW_TOKENS)
    assert got_toks == want_toks
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (1, cfg.vocab)
        assert torch.equal(_bits(g), _bits(w))
    # the request's own state carries the steps, as the eager one does
    for key, sub in eager_state.items():
        for name, t in sub.items():
            assert torch.equal(slot_state[key][name], t), (key, name)
    assert slot.steps == NEW_TOKENS and slot.replays == 0
    assert slot.graph is None


def test_slot_steps_match_the_reference_jitted_decode(model):
    cfg_j, cfg, params_j, params = model
    prompt = _prompt(cfg)
    state, tok = _prefill(params, cfg, prompt)
    got, got_toks = _through(DecodeSlot(params, cfg, MAX_LEN, "cpu"),
                             state, tok, NEW_TOKENS)
    jdecode = jax.jit(lambda p, s, t: jdecode_step(p, cfg_j, s, t))
    logits, state_j = jprefill(params_j, cfg_j, jnp.asarray(prompt)[None],
                               MAX_LEN)
    tok_j = int(jnp.argmax(logits[0]))
    assert tok_j == tok
    want, want_toks = [], []
    for _ in range(NEW_TOKENS):
        logits, state_j = jdecode(params_j, state_j,
                                  jnp.asarray([tok_j], jnp.int32))
        tok_j = int(jnp.argmax(logits[0]))
        want.append(np.asarray(logits))
        want_toks.append(tok_j)
    assert got_toks == want_toks
    for g, w in zip(got, want):
        g = g.numpy().astype(np.float64)
        w = w.astype(np.float64)
        assert np.abs(g - w).max() / np.abs(w).max() < 5e-3


def test_two_requests_interleaved_through_one_slot(model):
    _, cfg, _, params = model
    starts = [_prefill(params, cfg, _prompt(cfg, seed)) for seed in (1, 2)]
    alone = [_through(DecodeSlot(params, cfg, MAX_LEN, "cpu"), _clone(st),
                      tok, NEW_TOKENS) for st, tok in starts]
    slot = DecodeSlot(params, cfg, MAX_LEN, "cpu")
    states = [_clone(st) for st, _ in starts]
    toks = [tok for _, tok in starts]
    got = [([], []), ([], [])]
    for _ in range(NEW_TOKENS):
        for i in (0, 1):
            toks[i] = slot.step(states[i], toks[i])
            got[i][0].append(slot.logits.clone())
            got[i][1].append(toks[i])
    for (g_logits, g_toks), (w_logits, w_toks) in zip(got, alone):
        assert g_toks == w_toks
        for g, w in zip(g_logits, w_logits):
            assert torch.equal(_bits(g), _bits(w))
    assert slot.steps == 2 * NEW_TOKENS


def test_batched_engine_through_the_slots_matches_reference(model):
    cfg_j, cfg, _, _ = model
    kw = dict(max_batch=4, delay_s=5e-3)
    ref = JEngine(cfg_j, jtopo(2, 2), scheduler="DAM-C", max_len=MAX_LEN,
                  batching=JBatching(**kw))
    port = TEngine(cfg, ttopo(2, 2), scheduler="DAM-C", max_len=MAX_LEN,
                   batching=TBatching(**kw), device="cpu")
    port.params = to_torch(ref.params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN) for _ in range(4)]
    want = [ref.submit(p, max_new_tokens=4) for p in prompts]
    ref.run(timeout=300)
    got = [port.submit(p, max_new_tokens=4) for p in prompts]
    port.run(timeout=300)
    assert port.latency_stats()["completed"] == 4
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    stats = port.decode_graph_stats()
    assert stats["slots"] == 4 and stats["captures"] == 0
    assert stats["steps"] == sum(len(r.out_tokens) - 1 for r in got) == 12
    assert 1 <= stats["slots_in_use_max"] <= 4
    port.close()
    assert port.decode_graph_stats()["slots"] == 0


@pytest.fixture(scope="module")
def xlstm():
    return tconfigs.ARCHS["xlstm-125m"].reduced()


def test_engine_takes_a_slot_only_for_a_step(xlstm):
    """Requests under a deadline that passes mid-chain shed their queued
    decode work: a shed dispatch takes no slot, so every slot taken makes
    one step."""
    eng = TEngine(xlstm, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                  device="cpu")
    taken = []
    take = eng._decode_slot

    def counted():
        taken.append(1)
        return take()
    eng._decode_slot = counted
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, xlstm.vocab, 16), max_new_tokens=6,
                       deadline_s=0.02) for _ in range(3)]
    eng.run(timeout=300)
    assert eng.latency_stats()["shed"] == 3
    steps = sum(len(r.out_tokens) - 1 for r in reqs)
    assert len(taken) == steps == eng.decode_graph_stats()["steps"]
    # a shed request's dispatch, directly: nothing taken, nothing stepped
    req = Request(99, np.zeros(4, np.int32), 4)
    req.shed = True
    eng._decode_payload(1, req, {"state": None, "tok": 0, "step": 0})
    assert len(taken) == steps and not req.out_tokens


def test_decode_after_close_raises(xlstm):
    """A closed engine has no slots, and a decode dispatch then fails
    loudly: there is no eager route to fall back to."""
    eng = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu")
    eng.close()
    assert eng.decode_graph_stats()["slots"] == 0
    req = Request(7, np.zeros(4, np.int32), 4)
    with pytest.raises(RuntimeError, match="after close"):
        eng._decode_payload(1, req, {"state": None, "tok": 0, "step": 0})
    assert not req.out_tokens


def test_close_is_refused_while_the_run_is_live(xlstm):
    """The last slot's close clears cuBLAS's workspaces for the process,
    so an engine closes only when no worker of its run can replay."""
    eng = TEngine(xlstm, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                  device="cpu")
    eng.close()                     # before a run: allowed
    eng = TEngine(xlstm, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                  device="cpu")
    eng.runtime.start()
    with pytest.raises(RuntimeError, match="while the run is live"):
        eng.close()
    assert eng.decode_graph_stats()["slots"] == 4
    eng.runtime.drain(timeout=30)
    eng.close()
    assert eng.decode_graph_stats()["slots"] == 0


def test_params_set_again_capture_new_slots_before_the_run_only(xlstm):
    eng = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu")
    first = eng.decode_slots
    eng.params = eng.params                 # a new set of slots
    assert eng.decode_slots != first and len(eng.decode_slots) == 1
    assert all(s.state is None for s in first)      # the old ones closed
    eng.run(timeout=60)                     # nothing submitted: it starts
    with pytest.raises(RuntimeError, match="after the run started"):
        eng.params = eng.params


def test_slot_refuses_a_state_it_does_not_hold(xlstm):
    params = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu").params
    slot = DecodeSlot(params, xlstm, MAX_LEN, "cpu")
    state = init_decode_state(xlstm, 2, MAX_LEN, device="cpu")   # batch 2
    with pytest.raises(ValueError, match="slot's is"):
        slot.step(state, 0)
    assert slot.steps == 0


@pytest.fixture
def host_mesh():
    """A (1, 1) mesh on the fake-backend default group, torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    yield make_host_mesh("cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_slot_refuses_dtensor_params_and_state(xlstm, host_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    params = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu").params

    def on_mesh(tree):
        if isinstance(tree, dict):
            return {k: on_mesh(v) for k, v in tree.items()}
        return distribute_tensor(tree, host_mesh, [Replicate(), Replicate()])
    with pytest.raises(ValueError, match="DTensor params"):
        DecodeSlot(on_mesh(params), xlstm, MAX_LEN, "cpu")
    slot = DecodeSlot(params, xlstm, MAX_LEN, "cpu")
    state, tok = _prefill(params, xlstm, _prompt(xlstm))
    with pytest.raises(ValueError, match="DTensor state"):
        slot.step(on_mesh(state), tok)
    assert slot.steps == 0


class _StandInGraph:
    """A captured graph's stand-in: its replay runs the slot's step on the
    slot's static buffers, as the graph's kernels would."""

    def __init__(self, slot):
        self.slot = slot
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.slot.logits, self.slot.argmax = self.slot._run()

    def reset(self):
        pass


def _counts():
    return [c.count for c in decode_counters()]


@pytest.fixture
def kept_counts():
    """The stand-in replays add launches no kernel made: put every decode
    counter back as it was, for the tests that hold a count absolute."""
    counters = decode_counters()
    before = [c.count for c in counters]
    yield
    for c, n in zip(counters, before):
        c.reset()
        c.add(n)


def test_replay_adds_the_launches_its_graph_holds(xlstm, kept_counts):
    params = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu").params
    slot = DecodeSlot(params, xlstm, MAX_LEN, "cpu")
    graph = slot.graph = _StandInGraph(slot)
    slot.deltas = [(slstm_scan.launches, 3), (flash_attention.launches, 2)]
    state, tok = _prefill(params, xlstm, _prompt(xlstm))
    want_logits, want_toks = _eager(params, xlstm, _clone(state), tok, 4)
    sl0, fl0 = slstm_scan.launches.count, flash_attention.launches.count
    others = _counts()
    got_logits, got_toks = _through(slot, state, tok, 4)
    assert got_toks == want_toks
    assert all(torch.equal(_bits(g), _bits(w))
               for g, w in zip(got_logits, want_logits))
    assert graph.replays == slot.replays == slot.steps == 4
    assert slstm_scan.launches.count == sl0 + 4 * 3
    assert flash_attention.launches.count == fl0 + 4 * 2
    moved = [a - b for a, b in zip(_counts(), others)]
    assert sum(moved) == 4 * 5          # and no other counter moved


def test_engine_replays_hold_the_launch_equation(xlstm, kept_counts):
    """The engine's accounting with stand-in graphs, as ``chip_smoke.py``
    holds it on the card: replays equal the decode steps, and each adds
    its graph's launches."""
    eng = TEngine(xlstm, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                  device="cpu")
    for slot in eng.decode_slots:
        slot.graph = _StandInGraph(slot)
        slot.deltas = [(slstm_scan.launches, 3)]
    rng = np.random.default_rng(6)
    reqs = [eng.submit(rng.integers(0, xlstm.vocab, 16), max_new_tokens=5)
            for _ in range(4)]
    slstm_scan.launches.reset()
    eng.run(timeout=300)
    n_decode = sum(len(r.out_tokens) - 1 for r in reqs)
    stats = eng.decode_graph_stats()
    assert n_decode == 16
    assert stats["replays"] == stats["steps"] == n_decode
    assert stats["captures"] == stats["slots"] == 4
    assert slstm_scan.launches.count == 3 * n_decode   # CPU prefills: none


def test_launcher_prints_which_decode_ran():
    args = ["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "12", "--new-tokens", "3"]
    out = tlaunch.main(args)
    assert out["decode"] == "slots, plain route"
    assert out["decode_graphs"]["steps"] == 4
    assert out["decode_graphs"]["slots"] == 4
    assert out["decode_graphs"]["replays"] == 0
    assert out["stats"]["completed"] == 2
