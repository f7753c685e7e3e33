"""Production and host meshes (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  A process holds one default group, so the production
meshes share one: the ``"fake"`` backend of PyTorch's testing tools, at
the larger world (512 ranks), from which the single-pod mesh takes the
first 256.  This process is rank 0; a collective on a fake group moves
nothing and returns a tensor of its result's shape (the dry-run's step on
DTensors issues them on meta shards).  The meshes are CPU meshes by
default: DTensor's sharding propagation prices its choices with the
device module of the mesh's type, which the meta device has not.  The
reference's ``jax.make_mesh`` gives Explicit axes on recent JAX, under
which its ``constrain`` raises; a ``DeviceMesh`` has no such mode.
"""
from __future__ import annotations

import torch

WORLD = 512     # ranks of the default group: the multi-pod mesh's devices


def _default_group() -> None:
    """Start this process's default group on the fake backend as rank 0 of
    ``WORLD``, unless one is up with at least that many ranks."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < WORLD:
            raise RuntimeError(f"the default process group has "
                               f"{dist.get_world_size()} ranks; a mesh "
                               f"needs {WORLD}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    # DTensor caches its sharding decisions by the meshes' values: a mesh of
    # an earlier group (torn down in this process) equals a new one and
    # would bring back that group's process groups
    from torch.distributed.tensor import debug
    clear = getattr(debug, "_clear_sharding_prop_cache", None)
    if clear is not None:
        clear()


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with the dim ``names`` over the first
    ranks of the default group (started if need be)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    _default_group()
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
    data=16, model=16) = 512 devices — the pod axis is the slow links
    between pods; gradients reduce inside each pod first.  On the
    ``device_type`` "cpu" (a dry-run's, the default) or "meta", where
    DTensor runs an all-to-all as one but propagates no sharding."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return make_mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh(device_type: str | None = None):
    """What this host has: (n, 1) ("data", "model") over its n CUDA
    devices, or with ``device_type="cpu"`` (1, 1) on the CPU.  Without a
    card and without that, raises: a dry-run of the host never stands in
    for one."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device; pass "
                               "device_type='cpu' for a (1, 1) CPU mesh")
        device_type = "cuda"
    n = torch.cuda.device_count() if device_type == "cuda" else 1
    return make_mesh((n, 1), ("data", "model"), device_type)
