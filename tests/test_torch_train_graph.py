"""The captured train step (``repro_torch/train/step_graph.py``) on the CPU,
where it runs the train step's plain version on its static buffers (on the
card it replays a captured graph: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold that route bit for bit against the eager step).

- Its steps are ``make_train_step``'s, bit for bit, over 4 steps (every
  metric and every leaf of the params and the optimizer state) for a
  reduced model of each trainable family (dense granite-8b; MoE
  qwen3-moe-30b-a3b; the hybrid zamba2-1.2b; the ssm xlstm-125m;
  musicgen-large with its frontend prefix), with and without remat.
- The step count is updated in its own tensor.
- The ``Trainer``'s restore writes into the tensors the step reads, and
  its resumed steps are a straight run's.
- A batch of other keys, shapes or dtypes, and DTensor params or state,
  are refused.
- With a stand-in for the graph object, a replay adds the launches its
  capture took, and cuBLAS's workspaces are cleared only when the last
  graph of either kind (a decode slot, a train step) closes.
- The quickstart twin, whose step this is, trains as the reference's
  jitted quickstart does (rel 1e-4, the train-step convention) and as the
  eager step does (bit for bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import graphs
from repro_torch.bridge import to_torch
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.examples import quickstart
from repro_torch.kernels import adamw, flash_attention
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import leaves
from repro_torch.serve.decode_graph import DecodeSlot
from repro_torch.train import make_train_step
from repro_torch.train.step_graph import TrainStepGraph, train_counters
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "xlstm-125m",
         "musicgen-large"]
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
STEPS = 4
BATCH, SEQ = 2, 48


def _specs(cfg) -> dict:
    return tconfigs.train_batch_specs(
        cfg, tconfigs.InputShape("train", "train", SEQ, BATCH))


def _batch(cfg, i: int) -> dict:
    """Batch ``i`` laid out as ``train_batch_specs``: tokens and labels of
    the synthetic stream, a frontend N(0, 1) for a prefixed model."""
    specs = _specs(cfg)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab,
                                        seq_len=specs["tokens"].shape[1],
                                        global_batch=BATCH, seed=1))
    batch = {k: torch.as_tensor(v) for k, v in stream.batch_at(i).items()}
    if "frontend" in specs:
        g = torch.Generator().manual_seed(100 + i)
        batch["frontend"] = torch.randn(specs["frontend"].shape, generator=g)
    return batch


def _state(cfg):
    params = init_params(cfg, seed=3, device="cpu")
    return params, init_opt_state(params)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[t.element_size()])


def _same(a, b) -> bool:
    la, lb = list(leaves(a)), list(leaves(b))
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_are_the_eager_steps_bit_for_bit(arch, remat):
    cfg = tconfigs.get_config(arch).reduced()
    params, state = _state(cfg)
    eager = make_train_step(cfg, AdamWConfig(**OPT), remat=remat)
    g_params, g_state = _state(cfg)
    graph = TrainStepGraph(cfg, AdamWConfig(**OPT), g_params, g_state,
                           _specs(cfg), remat=remat)
    for i in range(STEPS):
        params, state, want = eager(params, state, _batch(cfg, i))
        got = graph.step(_batch(cfg, i))
        assert sorted(got) == sorted(want)
        for key, v in want.items():
            assert torch.equal(_bits(got[key]), _bits(v)), (i, key)
        assert _same(graph.params, params), i
        assert _same(graph.opt_state, state), i
    assert graph.params is g_params and graph.opt_state is g_state
    assert graph.steps == STEPS and graph.replays == 0 and graph.graph is None


def test_the_step_count_keeps_its_tensor():
    cfg = tconfigs.get_config("granite-8b").reduced()
    params, state = _state(cfg)
    count = state["step"]
    ptr = count.data_ptr()
    graph = TrainStepGraph(cfg, AdamWConfig(**OPT), params, state,
                           _specs(cfg))
    for i in range(3):
        graph.step(_batch(cfg, i))
        assert state["step"] is count and count.data_ptr() == ptr
        assert count.dtype == torch.int32 and int(count) == i + 1


def _trainer(tmp_path, total: int, every: int) -> Trainer:
    cfg = tconfigs.get_config("xlstm-125m").reduced()
    return Trainer(cfg, AdamWConfig(**OPT),
                   DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
                   TrainerConfig(total_steps=total, checkpoint_every=every,
                                 log_every=100),
                   str(tmp_path), device="cpu")


def _ptrs(tree) -> list[int]:
    return [t.data_ptr() for t in leaves(tree)]


def test_restore_writes_into_the_tensors_the_step_reads(tmp_path):
    straight = _trainer(tmp_path / "straight", 6, 100)
    want = [r["loss"] for r in straight.run()]
    first = _trainer(tmp_path / "ckpt", 3, 3)
    first.run()
    first.close()
    resumed = _trainer(tmp_path / "ckpt", 6, 100)
    tree = resumed._state_tree()
    ptrs = _ptrs(tree)
    step_graph = resumed.step_fn
    assert resumed.try_restore() and resumed.step == 3
    assert _ptrs(resumed._state_tree()) == ptrs
    assert step_graph.params is resumed.params is tree["params"]
    assert step_graph.opt_state is resumed.opt_state is tree["opt"]
    got = [r["loss"] for r in resumed.run()]
    assert got == want[3:]
    assert _same(resumed._state_tree(), straight._state_tree())
    assert _ptrs(resumed._state_tree()) == ptrs
    resumed.close()
    with pytest.raises(RuntimeError, match="closed"):
        resumed.step_fn.step(straight.stream.batch_at(0))


def test_a_batch_unlike_the_buffers_is_refused():
    cfg = tconfigs.get_config("musicgen-large").reduced()
    params, state = _state(cfg)
    graph = TrainStepGraph(cfg, AdamWConfig(**OPT), params, state,
                           _specs(cfg))
    batch = _batch(cfg, 0)
    longer = dict(batch, tokens=torch.zeros((BATCH, SEQ), dtype=torch.int32))
    with pytest.raises(ValueError, match="buffer's is"):
        graph.step(longer)
    wide = dict(batch, labels=batch["labels"].long())
    with pytest.raises(ValueError, match="buffer's is"):
        graph.step(wide)
    text_only = {k: v for k, v in batch.items() if k != "frontend"}
    with pytest.raises(ValueError, match="batch keys"):
        graph.step(text_only)
    assert graph.steps == 0 and int(state["step"]) == 0
    graph.step(batch)
    assert graph.steps == 1


@pytest.fixture
def host_mesh():
    """A (1, 1) mesh on the fake-backend default group, torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    yield make_host_mesh("cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dtensor_params_and_state_are_refused(host_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.optim.adamw import tree_map
    cfg = tconfigs.get_config("granite-8b").reduced()
    params, state = _state(cfg)

    def on_mesh(tree):
        return tree_map(lambda t: distribute_tensor(
            t, host_mesh, [Replicate(), Replicate()]), tree)
    with pytest.raises(ValueError, match="DTensor params"):
        TrainStepGraph(cfg, AdamWConfig(**OPT), on_mesh(params), state,
                       _specs(cfg))
    with pytest.raises(ValueError, match="DTensor optimizer state"):
        TrainStepGraph(cfg, AdamWConfig(**OPT), params, on_mesh(state),
                       _specs(cfg))


class _StandInGraph:
    """A captured graph's stand-in: its replay runs the step on the owner's
    static buffers, as the graph's kernels would."""

    def __init__(self, owner, run):
        self.owner, self.run = owner, run
        self.replays = 0
        self.resets = 0

    def replay(self):
        self.replays += 1
        self.run()

    def reset(self):
        self.resets += 1


@pytest.fixture
def kept_counts():
    """The stand-in replays add launches no kernel made: put every train
    counter back as it was."""
    counters = train_counters()
    before = [c.count for c in counters]
    yield
    for c, n in zip(counters, before):
        c.reset()
        c.add(n)


def test_replay_adds_the_launches_its_capture_took(kept_counts):
    cfg = tconfigs.get_config("granite-8b").reduced()
    params, state = _state(cfg)
    want_params, want_state = _state(cfg)
    eager = make_train_step(cfg, AdamWConfig(**OPT))
    graph = TrainStepGraph(cfg, AdamWConfig(**OPT), params, state,
                           _specs(cfg))

    def run():
        graph.metrics = graph._run()
    graph.graph = stand_in = _StandInGraph(graph, run)
    graph.deltas = [(flash_attention.launches, 4), (adamw.launches, 13)]
    counters = train_counters()
    before = [c.count for c in counters]
    for i in range(3):
        want_params, want_state, want = eager(want_params, want_state,
                                              _batch(cfg, i))
        got = graph.step(_batch(cfg, i))
        assert got is graph.metrics
        assert torch.equal(got["loss"], want["loss"])
    assert _same(params, want_params) and _same(state, want_state)
    assert stand_in.replays == graph.replays == graph.steps == 3
    moved = {id(c): c.count - n for c, n in zip(counters, before)}
    assert moved[id(flash_attention.launches)] == 3 * 4
    assert moved[id(adamw.launches)] == 3 * 13
    assert sum(moved.values()) == 3 * 17      # and no other counter moved


def test_capture_takes_back_the_launches_it_counted(kept_counts):
    """``graphs.capture`` records the counters' deltas over the capture and
    takes them back (a capture launches nothing), here with a stand-in for
    ``torch.cuda.graph`` that runs its body once."""
    import contextlib

    class _Graph:
        pass
    calls = []

    @contextlib.contextmanager
    def fake_graph(graph, stream=None):
        calls.append(stream)
        yield

    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "CUDAGraph", _Graph)
    mp.setattr(torch.cuda, "graph", fake_graph)
    try:
        before = flash_attention.launches.count, adamw.launches.count

        def body():
            flash_attention.launches.add(2)
            adamw.launches.add(5)
            return "out"
        graph, out, deltas = graphs.capture(body, "stream", train_counters())
    finally:
        mp.undo()
    assert isinstance(graph, _Graph) and out == "out" and calls == ["stream"]
    assert deltas == [(flash_attention.launches, 2), (adamw.launches, 5)]
    assert (flash_attention.launches.count, adamw.launches.count) == before


@pytest.mark.parametrize("first", ["decode", "train"])
def test_workspaces_clear_when_the_last_graph_of_either_kind_closes(
        first, monkeypatch):
    cleared = []
    monkeypatch.setattr(graphs, "clear_workspaces",
                        lambda device: cleared.append(device))
    cfg = tconfigs.get_config("xlstm-125m").reduced()
    params, state = _state(cfg)
    slot = DecodeSlot(params, cfg, 32, "cpu")
    step = TrainStepGraph(cfg, AdamWConfig(**OPT), params, state,
                          _specs(cfg))
    owners = {"decode": slot, "train": step}
    live = graphs.live()
    for owner in owners.values():
        owner.graph = _StandInGraph(owner, lambda: None)
        graphs.hold(owner)
    assert graphs.live() == live + 2
    standins = {k: o.graph for k, o in owners.items()}
    second = "train" if first == "decode" else "decode"
    owners[first].close()
    assert cleared == [] and graphs.live() == live + 1
    assert standins[first].resets == 1 and owners[first].graph is None
    owners[second].close()
    assert standins[second].resets == 1
    assert graphs.live() == live
    assert cleared == ([torch.device("cpu")] if live == 0 else [])


def test_quickstart_twin_trains_as_the_jitted_reference_and_the_eager_step():
    cfg_j = jconfigs.get_config("qwen2.5-14b").reduced()
    cfg_t = tconfigs.get_config("qwen2.5-14b").reduced()
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    out = quickstart.main(["--device", "cpu"], params=to_torch(params_j))
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=quickstart.STEPS)
    stream = SyntheticStream(DataConfig(vocab=cfg_t.vocab, seq_len=64,
                                        global_batch=4))
    step_j = jax.jit(jmake_train_step(cfg_j, JAdamWConfig(**opt)))
    state_j = jinit_opt_state(params_j)
    params_t = to_torch(params_j)
    state_t = init_opt_state(params_t)
    step_t = make_train_step(cfg_t, AdamWConfig(**opt))
    for i, got in enumerate(out["losses"]):
        batch = stream.batch_at(i)
        params_j, state_j, met_j = step_j(params_j, state_j, jax.tree.map(
            jnp.asarray, batch))
        params_t, state_t, met_t = step_t(
            params_t, state_t, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        assert got == float(met_t["loss"]), i
        assert abs(got - float(met_j["loss"])) <= 1e-4 * abs(
            float(met_j["loss"])), i
    assert _same(out["params"], params_t)
