"""The serving engine's prefill by length bucket
(``repro_torch/serve/prefill_graph.py``) on the CPU, where a bucket runs
the padded prefill's plain version on its static buffers (on the card it
replays a captured graph: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold that route bit for bit against the eager padded
prefill).

For a reduced model of each family (granite-8b; qwen3-moe-30b-a3b at
capacity factor 1.25, where the reference drops (token, k) pairs;
zamba2-1.2b; xlstm-125m), with the reference's weights bridged in, the
port's prefill of a prompt padded to its bucket against the reference's
``prefill`` of the prompt alone: logits and the caches' rows before S at
rel 5e-3 (``tests/test_models.py``), the recurrent states at 3e-3
(``tests/test_kernels.py``), the rows from S on exactly zero and the
caches' ``length`` S.

And: the MoE's padded routing over routing groups of a real length past
the first group, the sLSTM plain scan with lengths bit for bit the
unpadded one, the engine through its buckets against the reference's
engine, the bucket statistics, a stand-in graph's replay accounting, and
the refusals (DTensor params, a frontend prefix, params set once the run
started, a prefill after close).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import tpu_pod_slices as jtopo
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models.transformer import prefill as jprefill
from repro.serve import ServingEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import to_torch
from repro_torch.core import tpu_pod_slices as ttopo
from repro_torch.kernels import flash_attention, slstm_scan
from repro_torch.kernels.slstm_scan import slstm_scan_plain
from repro_torch.models import PadLength, moe, pad_length, prefill
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.serve.decode_graph import decode_counters
from repro_torch.serve.engine import Request, _bucket
from repro_torch.serve.prefill_graph import (PrefillBucket, PrefillGraphs,
                                             prefill_buckets)

torch.set_num_threads(1)

ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "xlstm-125m"]
MAX_LEN = 600
# 1, 2 and 15 into bucket 16, 16 its edge, 17 into 32, 300 into 512, and
# 560 into the last bucket, max_len
LENGTHS = [1, 2, 15, 16, 17, 300, 560]


def _bucket_len(n: int) -> int:
    return min(_bucket(n), MAX_LEN)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg_j = jconfigs.ARCHS[request.param].reduced()
    cfg_t = tconfigs.ARCHS[request.param].reduced()
    if cfg_t.family == "moe":       # the served factor: the reference drops
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=1.25)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=1.25)
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params_j, to_torch(params_j)


def _prompt(cfg, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + n).integers(0, cfg.vocab, n)


def _padded(prompt: np.ndarray, b: int) -> torch.Tensor:
    ids = np.zeros((1, b), np.int64)
    ids[0, :len(prompt)] = prompt
    return torch.from_numpy(ids)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", LENGTHS)
def test_padded_prefill_matches_the_reference_unpadded(model, n,
                                                       monkeypatch):
    cfg_j, cfg, params_j, params = model
    prompt = _prompt(cfg, n)
    b = _bucket_len(n)
    kept = []                   # the unpadded MoE routing's keep, a block
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a, **k: (
        lambda out: (kept.append(out[3]), out)[1])(route(*a, **k)))
    with torch.inference_mode():
        logits, state = prefill(params, cfg, _padded(prompt, b), MAX_LEN,
                                length=pad_length(cfg, n, "cpu"))
    want, state_j = jprefill(params_j, cfg_j, jnp.asarray(prompt)[None],
                             MAX_LEN)
    assert logits.dtype == torch.float32 and logits.shape == (1, cfg.vocab)
    assert _rel(logits, want) < 5e-3
    assert sorted(state) == sorted(state_j)
    for key, sub in state.items():
        assert sorted(sub) == sorted(state_j[key])
        for name, t in sub.items():
            w = np.asarray(state_j[key][name])
            assert tuple(t.shape) == w.shape, (key, name)
            if name == "length":
                assert bool((t == n).all()) and (w == n).all(), (key, t)
            elif name in ("k", "v"):
                assert _rel(t[:, :, :n], w[:, :, :n]) < 5e-3, (key, name)
                assert bool((t[:, :, n:] == 0).all()), (key, name)
            else:
                np.testing.assert_allclose(t.numpy(), w, rtol=3e-3,
                                           atol=3e-3, err_msg=f"{key}/{name}")
    if cfg.family == "moe":
        # the padded prefill routes through route_padded, not route
        assert not kept
        if n == 300:            # the reference drops pairs on this prompt
            with torch.inference_mode():
                prefill(params, cfg, torch.from_numpy(prompt)[None], MAX_LEN)
            assert kept and not all(bool(k.all()) for k in kept)


@pytest.mark.parametrize("n,group", [(24, 8), (20, 8), (13, 8), (16, 16)])
def test_padded_moe_routes_the_real_length_groups(n, group):
    """Routing groups past the first: 24 tokens in groups of 8 (the real
    length a multiple of the group: three groups), 20 (one group of 20)
    and 13 (one), padded to 32, at capacity factor 1.25 with drops, give
    the unpadded block's and the reference's rows."""
    p_j = jmoe.init_moe(jax.random.PRNGKey(4), 32, 8, 64, 48)
    x = np.random.default_rng(n).standard_normal((1, n, 32),
                                                 dtype=np.float32)
    xp = np.zeros((1, 32, 32), np.float32)
    xp[:, :n] = x
    xp[:, n:] = 7.0                     # the pads' rows are no input
    p = to_torch(p_j)
    sg, cap = moe.real_routing(n, 2, 8, 1.25, group_size=group)
    pad = PadLength(torch.tensor([n], dtype=torch.int32), torch.tensor(sg),
                    torch.tensor(cap))
    got, aux = moe.moe_block(p, torch.from_numpy(xp), top_k=2,
                             with_aux=False, pad=pad)
    want, _ = moe.moe_block(p, torch.from_numpy(x), top_k=2,
                            group_size=group, with_aux=False)
    ref, _ = jmoe.moe_block(p_j, jnp.asarray(x), top_k=2, group_size=group)
    assert aux is None
    np.testing.assert_allclose(got[:, :n].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    idx, _, _, keep, _, _ = moe.route(p, torch.from_numpy(x).reshape(
        -1, sg, 32), 2, 1.25)
    _, gates, _, pkeep = moe.route_padded(p, torch.from_numpy(xp), 2, pad)
    assert torch.equal(pkeep[0, :n].reshape(-1), keep.reshape(-1))
    assert not bool(pkeep[0, n:].any()) and not bool(gates[0, n:].any())
    if (n, group) == (24, 8):
        assert sg == 8 and not bool(keep.all())     # drops in some group


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[5, 1, 13], [13], [1]])
def test_slstm_plain_scan_with_lengths_is_the_unpadded_run(lengths, dtype):
    """Each row's run to its length is the unpadded plain run's, bit for
    bit: hs before the length and the last carry; from the length on hs
    holds the last h."""
    b, s, d = len(lengths), 13, 24
    g = torch.Generator().manual_seed(len(lengths))
    gx = torch.randn((b, s, 4, d), generator=g).to(dtype)
    r = (torch.randn((4, d), generator=g) * 0.1).to(dtype)
    carry = tuple((torch.randn((b, d), generator=g) * 0.5).to(dtype)
                  for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32)
    hs, last = slstm_scan_plain(gx, r, carry, lengths=lens)
    with torch.no_grad():
        same = slstm_scan.slstm_scan(gx, r, carry, lengths=lens)
    assert torch.equal(same[0], hs)
    for i, n in enumerate(lengths):
        want_hs, want_last = slstm_scan_plain(
            gx[i:i + 1, :n].contiguous(), r,
            tuple(t[i:i + 1].contiguous() for t in carry))
        assert torch.equal(hs[i, :n], want_hs[0])
        assert all(torch.equal(u[i], v[0]) for u, v in zip(last, want_last))
        assert torch.equal(hs[i, n:], last[0][i].expand(s - n, d))


def test_slstm_scan_refuses_lengths_it_cannot_take():
    gx = torch.zeros((2, 3, 4, 8))
    r = torch.zeros((4, 8))
    carry = tuple(torch.zeros((2, 8)) for _ in range(4))
    with pytest.raises(ValueError, match="lengths"):
        slstm_scan.slstm_scan(gx, r, carry,
                              lengths=torch.tensor([1, 2]))     # int64
    with pytest.raises(ValueError, match="lengths"):
        slstm_scan.slstm_scan(gx, r, carry,
                              lengths=torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="no gradient"):
        slstm_scan.slstm_scan(gx.requires_grad_(), r, carry,
                              lengths=torch.tensor([1, 2],
                                                   dtype=torch.int32))


@pytest.mark.parametrize("max_len,want", [
    (1040, [16, 32, 64, 128, 256, 512, 1024, 1040]),
    (64, [16, 32, 64]), (600, [16, 32, 64, 128, 256, 512, 600]),
    (10, [10])])
def test_buckets_are_the_ptt_buckets_cut_at_max_len(max_len, want):
    assert prefill_buckets(max_len, _bucket) == want


@pytest.fixture(scope="module")
def xlstm():
    return tconfigs.ARCHS["xlstm-125m"].reduced()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_through_its_buckets_matches_the_reference_engine(arch):
    """Prompts in three buckets (16, 32, 64) through the port's engine and
    the reference's: the same tokens, each prefill through its bucket."""
    cfg_j = jconfigs.ARCHS[arch].reduced()
    cfg = tconfigs.ARCHS[arch].reduced()
    ref = JEngine(cfg_j, jtopo(2, 2), scheduler="DAM-C", max_len=64)
    port = TEngine(cfg, ttopo(2, 2), scheduler="DAM-C", max_len=64,
                   device="cpu")
    port.params = to_torch(ref.params)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 16, 30, 33, 50)]
    want = [ref.submit(p, max_new_tokens=3) for p in prompts]
    ref.run(timeout=300)
    got = [port.submit(p, max_new_tokens=3) for p in prompts]
    port.run(timeout=300)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    stats = port.prefill_graph_stats()
    assert stats["buckets"] == [16, 32, 64]
    assert stats["steps"] == len(prompts) and stats["replays"] == 0
    assert stats["captures"] == 0
    assert stats["steps_by_bucket"] == {16: 2, 32: 1, 64: 2}
    assert all(b > 0 for b in stats["state_bytes"])
    port.close()
    assert port.prefill_graph_stats() == {}


def test_a_bucket_prefill_is_the_eager_padded_prefill_bit_for_bit(xlstm):
    params = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu").params
    bucket = PrefillBucket(params, xlstm, 32, 48, "cpu")
    for n in (17, 32, 20):
        prompt = _prompt(xlstm, n)
        state, tok = bucket.prefill(prompt)
        with torch.inference_mode():
            logits, want = prefill(params, xlstm, _padded(prompt, 32), 48,
                                   length=pad_length(xlstm, n, "cpu"))
        assert tok == int(torch.argmax(logits[0]))
        assert torch.equal(bucket.logits, logits)
        for key, sub in want.items():
            for name, t in sub.items():
                assert torch.equal(state[key][name], t), (key, name)
                # the request's own tensors, not the bucket's
                assert state[key][name] is not bucket.state[key][name]
    assert bucket.steps == 3 and bucket.replays == 0 and bucket.graph is None
    with pytest.raises(ValueError, match="a prompt of 33"):
        bucket.prefill(_prompt(xlstm, 33))


def test_padded_prefill_refuses_a_frontend_prefix():
    cfg = tconfigs.ARCHS["internvl2-76b"].reduced()
    params = TEngine(cfg, ttopo(1, 1), max_len=64, device="cpu").params
    front = torch.zeros((1, cfg.frontend_len, cfg.d_model))
    with pytest.raises(ValueError, match="frontend"):
        prefill(params, cfg, torch.zeros((1, 16), dtype=torch.int64), 64,
                frontend=front, length=pad_length(cfg, 10, "cpu"))


def test_params_set_again_make_new_buckets_before_the_run_only(xlstm):
    eng = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu")
    first = eng.prefill_graphs
    eng.params = eng.params
    assert eng.prefill_graphs is not first
    assert not first.buckets                    # the old ones closed
    assert list(eng.prefill_graphs.buckets) == [16, 32, 48]
    eng.run(timeout=60)
    with pytest.raises(RuntimeError, match="after the run started"):
        eng.params = eng.params
    assert list(eng.prefill_graphs.buckets) == [16, 32, 48]


def test_launcher_prints_which_prefill_ran():
    from repro_torch.launch import serve as tlaunch
    args = ["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "12", "--new-tokens", "3"]
    out = tlaunch.main(args)
    assert out["prefill"] == "buckets, plain route"
    assert out["prefill_graphs"]["buckets"] == [16, 23]   # max_len 12 + 3 + 8
    assert out["prefill_graphs"]["steps"] == 2
    assert out["prefill_graphs"]["replays"] == 0


def test_prefill_after_close_raises(xlstm):
    eng = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu")
    eng.close()
    req = Request(3, np.zeros(4, np.int32), 4)
    with pytest.raises(RuntimeError, match="prefill after close"):
        eng._prefill_payload(1, req, {"step": 0})
    assert not req.out_tokens


@pytest.fixture
def host_mesh():
    """A (1, 1) mesh on the fake-backend default group, torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    yield make_host_mesh("cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_prefill_graphs_refuse_dtensor_params(xlstm, host_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    params = TEngine(xlstm, ttopo(1, 1), max_len=48, device="cpu").params

    def on_mesh(tree):
        if isinstance(tree, dict):
            return {k: on_mesh(v) for k, v in tree.items()}
        return distribute_tensor(tree, host_mesh, [Replicate(), Replicate()])
    with pytest.raises(ValueError, match="DTensor params"):
        PrefillGraphs(on_mesh(params), xlstm, 48, "cpu", _bucket)


class _StandInGraph:
    """A captured graph's stand-in: its replay runs the bucket's padded
    prefill on the bucket's static buffers, as the graph's kernels would."""

    def __init__(self, bucket):
        self.bucket = bucket
        self.replays = 0

    def replay(self):
        self.replays += 1
        b = self.bucket
        b.logits, b.argmax, b.state = b._run()

    def reset(self):
        pass


@pytest.fixture
def kept_counts():
    """The stand-in replays add launches no kernel made: put every counter
    back as it was, for the tests that hold a count absolute."""
    counters = decode_counters()
    before = [c.count for c in counters]
    yield
    for c, n in zip(counters, before):
        c.reset()
        c.add(n)


def test_engine_prefill_replays_hold_the_launch_equation(xlstm, kept_counts):
    """The engine's accounting with stand-in graphs, as ``chip_smoke.py``
    holds it on the card: replays equal the prefills, and each adds its
    graph's launches; the tokens are the plain route's."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, xlstm.vocab, n) for n in (5, 20, 40, 12)]

    def serve(stand_in: bool):
        eng = TEngine(xlstm, ttopo(2, 2), scheduler="DAM-C", max_len=48,
                      device="cpu")
        if stand_in:
            for b in eng.prefill_graphs.buckets.values():
                b.graph = _StandInGraph(b)
                b.deltas = [(slstm_scan.launches, 2),
                            (flash_attention.launches, 1)]
        reqs = [eng.submit(p, max_new_tokens=2) for p in prompts]
        eng.run(timeout=300)
        return eng, [r.out_tokens for r in reqs]

    _, want = serve(False)
    slstm_scan.launches.reset()
    flash_attention.launches.reset()
    eng, got = serve(True)
    assert got == want
    stats = eng.prefill_graph_stats()
    assert stats["replays"] == stats["steps"] == len(prompts)
    assert stats["steps_by_bucket"] == {16: 2, 32: 1, 48: 1}
    n_decode = sum(len(t) - 1 for t in got)
    assert eng.decode_graph_stats()["steps"] == n_decode
    # CPU decode steps launch nothing; each replay adds its graph's
    assert slstm_scan.launches.count == 2 * len(prompts)
    assert flash_attention.launches.count == len(prompts)
