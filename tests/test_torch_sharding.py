"""The port's sharding rules (``repro_torch/parallel/sharding.py``) against
the reference's ``PartitionSpec``s, leaf for leaf, and their DTensor
placements on a fake-backend ``DeviceMesh``."""
import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import repro.configs as rcfg
import repro.models as rmodels
import repro.parallel.sharding as rsh
import repro_torch.configs as tcfg
import repro_torch.models as tmodels
import repro_torch.parallel.sharding as tsh
from repro_torch.launch.mesh import make_mesh, make_production_mesh

torch.set_num_threads(1)

ARCHS = sorted(tcfg.ARCHS)
MESHES = [{"data": 4, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]


class _FakeMesh:
    """The reference test's mesh stand-in: ``shape`` and ``axis_names``."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.fixture(scope="module")
def fake_group():
    """The fake-backend default group the meshes are cut from, torn down
    after the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _ref_flat(tree) -> dict:
    """{path of keys: spec as a tuple} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(k.key for k in path): tuple(spec) for path, spec in flat}


def _port_flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + (k,)))
        return out
    return {path: tree}


def _cfgs(arch: str, size: str):
    ref, port = rcfg.ARCHS[arch], tcfg.ARCHS[arch]
    if size == "reduced":
        ref, port = ref.reduced(), port.reduced()
    return (dataclasses.replace(ref, dtype="bfloat16"),
            dataclasses.replace(port, dtype="bfloat16"))


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference_leaf_for_leaf(arch, size):
    """Params (with and without FSDP), optimizer moments, a train batch and
    the decode state at ``decode_32k`` (``long_500k`` for the
    sub-quadratic archs), reference ``eval_shape`` trees against the
    port's meta-device trees, on (4, 4), (16, 16) and (2, 16, 16)."""
    rc, tc = _cfgs(arch, size)
    rp = jax.eval_shape(lambda: rmodels.init_params(rc,
                                                    jax.random.PRNGKey(0)))
    tp = tmodels.init_params(tc, device="meta")
    shape = rcfg.SHAPES["train_4k"]
    rb, tb = rcfg.train_batch_specs(rc, shape), tcfg.train_batch_specs(
        tc, shape)
    dshape = rcfg.SHAPES["long_500k" if rc.sub_quadratic else "decode_32k"]
    if size == "reduced":
        dshape = dataclasses.replace(dshape, seq_len=64, global_batch=8)
    rs = jax.eval_shape(lambda: rmodels.init_decode_state(
        rc, dshape.global_batch, dshape.seq_len))
    ts = tmodels.init_decode_state(tc, dshape.global_batch, dshape.seq_len,
                                   device="meta")
    for sizes in MESHES:
        mesh = _FakeMesh(sizes)
        pairs = {
            "params": (rsh.param_specs(rp, mesh), tsh.param_specs(tp, mesh)),
            "params_fsdp": (rsh.param_specs(rp, mesh, fsdp=True),
                            tsh.param_specs(tp, mesh, fsdp=True)),
            "moments": (rsh.opt_moment_specs(rp, mesh),
                        tsh.opt_moment_specs(tp, mesh)),
            "batch": (rsh.batch_specs(rb, mesh), tsh.batch_specs(tb, mesh)),
            "state": (rsh.decode_state_specs(rs, mesh),
                      tsh.decode_state_specs(ts, mesh)),
        }
        for what, (ref, port) in pairs.items():
            want, got = _ref_flat(ref), _port_flat(port)
            assert got == want, (arch, size, sizes, what)
    assert tsh.dp_axes(_FakeMesh(MESHES[2])) == rsh.dp_axes(
        _FakeMesh(MESHES[2]))


def test_sanitize_drops_nondivisible():
    mesh = _FakeMesh({"data": 4, "model": 8})
    assert tsh.sanitize(("model", None), (16, 3), mesh) == ("model", None)
    assert tsh.sanitize(("model", None), (12, 3), mesh) == (None, None)
    assert tsh.sanitize((("data", "model"), None), (32, 3), mesh) == \
        (("data", "model"), None)
    assert tsh.sanitize((("data", "model"), None), (16, 3), mesh) == \
        (None, None)


def test_sanitize_pads_rank():
    mesh = _FakeMesh({"data": 2, "model": 2})
    assert tsh.sanitize(("model",), (4, 6, 8), mesh) == ("model", None, None)


def _sharded_shape(shape, spec, sizes) -> tuple:
    out = []
    for dim, axis in zip(shape, spec):
        for name in (axis if isinstance(axis, tuple) else (axis,)):
            if name is not None:
                dim //= sizes[name]
        out.append(dim)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_distribute_gives_the_local_shards(arch, fake_group):
    """Each reduced arch's params (FSDP too) as DTensors on a fake (4, 4)
    mesh: every local shape is the global one divided by its spec's axes."""
    cfg = tcfg.ARCHS[arch].reduced()
    params = tmodels.init_params(cfg, device="meta")
    mesh = make_mesh((4, 4), ("data", "model"))
    sizes = tsh.axis_sizes(mesh)
    assert sizes == {"data": 4, "model": 4}
    for fsdp in (False, True):
        specs = tsh.param_specs(params, mesh, fsdp=fsdp)
        dt = tsh.distribute(params, specs, mesh)
        flat_p, flat_s, flat_d = (_port_flat(t) for t in (params, specs, dt))
        assert flat_p.keys() == flat_d.keys()
        for path, leaf in flat_p.items():
            local = flat_d[path].to_local()
            assert local.device.type == "meta"
            assert tuple(local.shape) == _sharded_shape(
                tuple(leaf.shape), flat_s[path], sizes), (path, fsdp)


def test_tuple_axis_shards_one_dim_over_two_mesh_dims(fake_group):
    """("pod", "data") on one tensor dim: Shard on both mesh dims, the pod
    the major; the local shard is 1/32 of the dim."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    spec = tsh.batch_specs(torch.empty(256, 4096, device="meta"), mesh)
    assert spec == (("pod", "data"), None)
    assert tsh.to_placements(spec, mesh) == (Shard(0), Shard(0), Replicate())
    dt = tsh.distribute({"tokens": torch.empty(256, 4096, device="meta")},
                        {"tokens": spec}, mesh)["tokens"]
    assert tuple(dt.to_local().shape) == (8, 4096)
    assert tuple(dt.shape) == (256, 4096)


def test_constrain_and_pin_outside_a_mesh_are_the_identity(fake_group):
    x = torch.randn(8, 4)
    assert tsh.constrain(x, ("dp", None)) is x
    tree = {"w": x}
    assert tsh.pin_stack_cotangent(tree) is tree
    mesh = make_mesh((4, 4), ("data", "model"), device_type="cpu")
    with tsh.sharding_ctx(mesh):
        assert tsh.constrain(x, ("dp", None)) is x      # a plain tensor
        dt = tsh.distribute({"x": x}, {"x": (None, None)}, mesh)["x"]
        moved = tsh.constrain(dt, ("dp", "model"))
    assert tsh.to_placements(("data", "model"), mesh) == moved.placements
    assert tuple(moved.to_local().shape) == (2, 1)
