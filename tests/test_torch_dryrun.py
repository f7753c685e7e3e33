"""The port's dry-run (``repro_torch/launch/dryrun.py``), its op counter
(``launch/op_analysis.py``) and the kernels' meta path, against the
reference's dry-run pieces: its parameter trees, ``analyze_hlo`` of a
compiled step, and the kernels' plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import repro.configs as rcfg
import repro.models as rmodels
from repro.launch.hlo_analysis import analyze_hlo
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, SHAPES, InputShape
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import work
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import leaves
from repro_torch.train import make_train_step

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fake_group():
    """The fake-backend default group the meshes are cut from, torn down
    after the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b", "xlstm-125m",
                                  "internvl2-76b"])
def test_reduced_dryrun_on_16_fake_devices(arch, fake_group, tmp_path):
    """The counterpart of the reference's test of the same name: a train
    step (B 8 x S 32) and a decode step (B 8, T 64) of the reduced config
    in bfloat16, every leaf a DTensor on a fake (4, 4) mesh, counted on the
    meta device, with its collectives and the roofline's three terms."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="bfloat16")
    mesh = make_mesh((4, 4), ("data", "model"))
    shapes = {"train": InputShape("train_s32", "train", 32, 8),
              "decode": InputShape("decode_t64", "decode", 64, 8)}
    if cfg.frontend != "none":      # the prefix takes 16 of the positions
        shapes["train"] = InputShape("train_s48", "train", 48, 8)
    for kind, shape in shapes.items():
        rec = dryrun.run_cell(arch, shape.name, "fake4x4", tmp_path, cfg=cfg,
                              shape=shape, mesh=mesh, n_micro=1)
        assert rec["status"] == "OK", rec.get("traceback")
        assert rec["n_devices"] == 16 and rec["fits_hbm"]
        assert rec["work"]["flops"] > 0 and rec["work"]["peak_bytes"] > 0
        coll = rec["collectives"]
        assert set(coll) >= {"bytes", "counts", "entries"}
        assert coll["bytes"]["total"] == sum(
            v for k, v in coll["bytes"].items() if k != "total") > 0
        roof = rec["roofline"]
        assert roof["collective_s"] == pytest.approx(
            coll["bytes"]["total"] / roof["peaks"]["net_bytes_per_s"])
        assert roof["dominant"] == max(
            ("compute", "memory", "collective"),
            key=lambda k: roof[f"{k}_s"])
        local = sum(rec["argument_bytes_per_device"].values())
        whole = sum(rec["argument_bytes_whole"].values())
        assert whole / 16 <= local < whole
        assert (tmp_path / f"{arch}__{shape.name}__fake4x4.json").exists()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_counted_params_equal_the_reference(arch):
    """The dry-run's counted parameter total at full width (the meta tree
    ``build_cell`` makes) equals the reference's ``eval_shape(init_params)``
    leaf sum exactly."""
    ref_cfg = dataclasses.replace(rcfg.ARCHS[arch], dtype="bfloat16")
    shapes = jax.eval_shape(lambda: rmodels.init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    want = sum(int(x.size) for x in jax.tree.leaves(shapes))
    cfg = dataclasses.replace(ARCHS[arch], dtype="bfloat16")
    cell = dryrun.build_cell(cfg, SHAPES["decode_32k"],
                             _FakeMesh({"data": 16, "model": 16}))
    assert sum(t.numel() for t in leaves(cell.args["params"])) == want


def _chain(a, ws):
    for w in ws:
        a = a @ w
    return a


def test_op_analysis_counts_a_matmul_chain():
    """The counterpart of ``tests/test_serve.py``'s roofline check: three
    [64, 128] x [128, 128] products are 3 x 2 M N K flops; each reads its
    operands and writes its result; at most two results live at once."""
    a = torch.empty(64, 128, device="meta")
    ws = [torch.empty(128, 128, device="meta") for _ in range(3)]
    res = analyze(_chain, a, ws)
    assert res["flops"] == 3 * 2 * 64 * 128 * 128
    assert res["aten_flops"] == {"mm": res["flops"]}
    assert res["bytes"] == 3 * 4 * (64 * 128 + 128 * 128 + 64 * 128)
    assert res["peak_bytes"] == 2 * 4 * 64 * 128
    assert res["kernels"] == {} and res["ops"] == 3


def test_counted_flops_equal_the_reference_hlo_with_dense_attention():
    """A reduced granite-8b train step (float32, B 2 x S 128, remat), the
    reference's ``analyze_hlo`` of its compiled step on one CPU device
    against the port's count on the meta device.  One systematic gap:
    the port prices its attention kernels by ``kernels/work.py``, over the
    causal triangle's live pairs and 5 products in the backward, where the
    reference computes ``attention_ref`` dense (2 products forward, 4
    backward, over all S x S pairs); the port's count is 0.923 of the
    reference's.  Priced dense, the two counts are equal (measured: to the
    flop), so the rest of the step — projections, FFN, head, loss,
    remat's second forward, AdamW — is counted alike."""
    b, s = 2, 128
    rc = dataclasses.replace(rcfg.ARCHS["granite-8b"].reduced(),
                             dtype="float32")
    p = jax.eval_shape(lambda: rmodels.init_params(rc, jax.random.PRNGKey(0)))
    o = jax.eval_shape(ref_init_opt_state, p)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
             for k in ("tokens", "labels")}
    hlo = jax.jit(ref_make_train_step(rc, RefAdamW(), remat=True)).lower(
        p, o, batch).compile().as_text()
    want = analyze_hlo(hlo)["flops"]

    cfg = dataclasses.replace(ARCHS["granite-8b"].reduced(), dtype="float32")
    params = init_params(cfg, device="meta")
    tb = {k: torch.empty(b, s, dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    got = analyze(make_train_step(cfg, AdamWConfig(), remat=True), params,
                  init_opt_state(params), tb)
    kern = got["kernels"]
    assert kern["flash_attention"]["calls"] == 2 * cfg.n_layers   # remat
    assert kern["flash_attention_bwd"]["calls"] == cfg.n_layers
    dense = 4 * b * cfg.n_heads * s * s * cfg.resolved_head_dim
    priced_dense = (got["flops"] - sum(k["flops"] for k in kern.values())
                    + kern["flash_attention"]["calls"] * dense
                    + kern["flash_attention_bwd"]["calls"] * 2 * dense)
    assert priced_dense == pytest.approx(want, rel=1e-9)
    assert got["flops"] / want == pytest.approx(0.923, abs=2e-3)


def _shapes(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_path_gives_the_plain_shapes(dtype):
    """Forward and backward on the meta device: the plain version's output
    and gradient shapes and dtypes, and the work the bound prices."""
    b, hq, hkv, s, d = 1, 4, 2, 80, 32
    g = torch.Generator().manual_seed(0)
    cpu = [torch.randn(shape, generator=g).to(dtype).requires_grad_()
           for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    meta = [t.detach().to("meta").requires_grad_() for t in cpu]
    want_o = fa.flash_attention(*cpu)
    want_g = torch.autograd.grad(want_o.float().sum(), cpu)
    with work.collect() as calls:
        got_o = fa.flash_attention(*meta)
        got_g = torch.autograd.grad(got_o.float().sum(), meta)
    assert got_o.device.type == "meta"
    assert _shapes([got_o, *got_g]) == _shapes([want_o, *want_g])
    fwd = work.attention_work(b, hq, hkv, s, s, d, dtype)
    bwd = work.attention_bwd_work(b, hq, hkv, s, s, d, dtype)
    # the aligned paths' units: tf32x3 both ways; wgmma both ways
    unit = "3xtf32" if dtype == torch.float32 else "bfloat16"
    assert calls == [("flash_attention", {unit: fwd[0]}, fwd[1]),
                     ("flash_attention_bwd", {unit: bwd[0]}, bwd[1])]
    assert fa.launches.count == 0 and fa.bwd_launches.count == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_path_gives_the_plain_shapes(dtype):
    """Forward (with the kept scratch ``SSDScan`` saves) and backward on the
    meta device: the plain version's shapes and dtypes, and the work."""
    bsz, s, h, d, n = 2, 100, 3, 8, 16
    g = torch.Generator().manual_seed(0)
    cpu = [torch.randn(bsz, s, h, d, generator=g),
           -torch.rand(bsz, s, h, generator=g),
           torch.randn(bsz, s, n, generator=g),
           torch.randn(bsz, s, n, generator=g)]
    cpu = [t.to(dtype).requires_grad_() for t in cpu]
    meta = [t.detach().to("meta").requires_grad_() for t in cpu]
    want_y, want_saved = ssd.ssd_scan_keep(*(t.detach() for t in cpu))
    got_y, got_saved = ssd.ssd_scan_keep(*(t.detach() for t in meta))
    assert _shapes([got_y, got_saved]) == _shapes([want_y, want_saved])
    want_g = torch.autograd.grad(ssd.ssd_scan(*cpu).float().sum(), cpu)
    with work.collect() as calls:
        y = ssd.ssd_scan(*meta)
        got_g = torch.autograd.grad(y.float().sum(), meta)
    assert _shapes([y, *got_g]) == _shapes([want_y, *want_g])
    fwd = work.ssd_work(bsz, s, h, d, n, dtype, ssd.NARROW_D)
    bwd = work.ssd_bwd_work(bsz, s, h, d, n, dtype, kept=True)
    assert calls == [("ssd_scan", *fwd), ("ssd_scan_bwd", *bwd)]
    assert ssd.launches.count == 0 and ssd.bwd_launches.count == 0


def test_host_cell_predicts_the_argument_bytes(fake_group, tmp_path):
    """The host mesh on the CPU, (1, 1) when asked for: a reduced float32
    train cell's predicted argument bytes equal those of the params, the
    AdamW state and the batch built for real; without a card and without
    asking, no host mesh."""
    mesh = make_host_mesh("cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    cfg = dataclasses.replace(ARCHS["granite-8b"].reduced(), dtype="float32")
    shape = InputShape("train_s64", "train", 64, 2)
    rec = dryrun.run_cell("granite-8b", shape.name, "host", tmp_path,
                          cfg=cfg, shape=shape, mesh=mesh, n_micro=1)
    assert rec["status"] == "OK", rec.get("traceback")
    params = init_params(cfg, device="cpu")
    real = {"params": params, "opt_state": init_opt_state(params),
            "batch": {k: torch.zeros(2, 64, dtype=torch.int32)
                      for k in ("tokens", "labels")}}
    assert rec["argument_bytes_per_device"] == {
        k: sum(t.nbytes for t in leaves(v)) for k, v in real.items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
