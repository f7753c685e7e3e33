"""Sharding rules: leaf-name-driven specs for params, optimizer state,
batches and decode state, and their DTensor placements on a ``DeviceMesh``
(port of ``repro/parallel/sharding.py``).

Mesh axes:
  single-pod:  ("data", "model") = (16, 16)          — 256 devices
  multi-pod:   ("pod", "data", "model") = (2, 16, 16) — 512 devices

Parallelism mapping (the reference's rules, ``_RULES`` copied as they are):
  DP  — batch over ("pod", "data");
  TP  — Megatron column/row sharding over "model": wq/wk/wv/w_gate/w_up
        column-sharded, wo/w_down row-sharded; vocab-sharded embedding and
        lm_head;
  EP  — expert stacks [E, ...] sharded over "model";
  SP  — long-context decode KV caches sharded over "model" on the
        *sequence* dim;
  ZeRO-1 — optimizer moments additionally sharded over "data" on the
        first replicated dim that divides.

A spec is a tuple with one entry a tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (that dim sharded over their product,
the first the major), as ``tuple(PartitionSpec)`` is in the reference.
The spec functions return trees of such tuples over the port's nested-dict
trees, leaf for leaf; :func:`to_placements` turns a spec into DTensor
placements and :func:`distribute` a tree into DTensors.  Every spec is
*sanitized* against real dim sizes: an axis that does not divide the dim is
dropped (replicated), so the same rules serve the full configs, the reduced
ones and any mesh.

A mesh here is a ``DeviceMesh`` with dim names, or any object with
``shape`` (a mapping from axis name to size) and ``axis_names``, as the
reference's tests pass.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch

PyTree = Any

# base spec per leaf name, for the *unstacked* (per-layer) shape
_RULES: dict[str, tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "final_norm": (None,),
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "wo": ("model", None),
    # FFN
    "w_gate": (None, "model"), "w_up": (None, "model"),
    "w_down": ("model", None),
    # MoE (leading E axis = expert parallelism)
    "router": (None, None),
    "experts_gate": ("model", None, None),
    "experts_up": ("model", None, None),
    "experts_down": ("model", None, None),
    # Mamba-2
    "wx": (None, "model"), "wz": (None, "model"),
    "wb": (None, None), "wc": (None, None), "wdt": (None, "model"),
    "conv_w": (None, "model"), "dt_bias": ("model",), "a_log": ("model",),
    "norm_z": ("model",), "w_out": ("model", None),
    # mLSTM
    "w_x": (None, "model"), "w_gate_proj": (None, "model"),
    "w_if": (None, None), "norm_h": ("model",),
    # sLSTM
    "w_i": (None, "model"), "w_f": (None, "model"),
    "w_z": (None, "model"), "w_o": (None, "model"),
    "r_gates": (None, "model"),
    "w_up_a": (None, "model"), "w_up_b": (None, "model"),
    # norms
    "ln1": (None,), "ln2": (None,),
}


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(sizes: dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def sanitize(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop axes that don't divide their dim; trim/pad rank.  A tuple of
    one axis is that axis, as ``PartitionSpec`` has it."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec)[:len(shape)] + (None,) * (len(shape) - len(spec))
    spec = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)
    return tuple(axis if axis is not None
                 and dim % _axis_size(sizes, axis) == 0 else None
                 for dim, axis in zip(shape, spec))


def _map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                   path: tuple = ()) -> PyTree:
    """``fn(path, leaf, *matching leaves of rest)`` over a tree of dicts
    (anything else, a spec's tuple too, is a leaf); ``path`` is the tuple
    of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def _leaf_name(path: tuple) -> str:
    return str(path[-1]) if path else ""


def _fold_data(spec: tuple, shape: tuple[int, ...], sizes: dict) -> tuple:
    """``spec`` with "data" on the first still-replicated dim (> 1) that it
    divides."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, ax) in enumerate(zip(shape, axes)):
        if ax is None and dim > 1 and dim % _axis_size(sizes, "data") == 0:
            axes[i] = "data"
            break
    return tuple(axes)


def param_specs(params_shape: PyTree, mesh, *, fsdp: bool = False) -> PyTree:
    """Spec tree for a params(-shaped) tree.  Stacked leaves (under
    "stacks") get a leading None for the layer axis.

    ``fsdp``: additionally shard each leaf over "data" on its first free
    dim (ZeRO-3 / FSDP) — what the reference takes where bf16 params under
    TP alone don't fit a device (the 70B VLM backbone, the 30B MoEs); never
    over "pod"."""
    sizes = axis_sizes(mesh)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        base = _RULES.get(_leaf_name(path))
        if base is None:
            base = (None,) * len(shape)
        elif "stacks" in path:
            base = (None,) + tuple(base)
        spec = sanitize(base, shape, mesh)
        if fsdp:
            spec = _fold_data(spec, shape, sizes)
        return sanitize(spec, shape, mesh)

    return _map_with_path(spec_for, params_shape)


def opt_moment_specs(params_shape: PyTree, mesh) -> PyTree:
    """ZeRO-1: like param specs but with "data" folded into the first
    still-replicated dim that divides — optimizer memory scales 1/DP."""
    sizes = axis_sizes(mesh)
    return _map_with_path(
        lambda path, leaf, spec: sanitize(
            _fold_data(spec, tuple(leaf.shape), sizes), tuple(leaf.shape),
            mesh),
        params_shape, param_specs(params_shape, mesh))


def dp_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def batch_specs(batch_shape: PyTree, mesh) -> PyTree:
    """Token batches: batch dim over DP axes, rest replicated.  A lone
    tensor gives a lone spec."""
    dp = dp_axes(mesh)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        return sanitize((dp,) + (None,) * (len(shape) - 1), shape, mesh)

    return _map_with_path(spec_for, batch_shape)


def decode_state_specs(state_shape: PyTree, mesh) -> PyTree:
    """Decode caches/states.  Leaves live under stacked layer groups with a
    leading L axis: [L, B, ...].  KV caches [L, B, T, Hkv, D] shard B over
    DP and T (sequence) over "model" (SP for long context); recurrent
    states [L, B, H, ...] shard B over DP and H over "model"."""
    dp = dp_axes(mesh)

    def spec_for(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if name in ("k", "v") and len(shape) == 5:      # [L,B,T,Hkv,D]
            return sanitize((None, dp, "model", None, None), shape, mesh)
        if name == "length":
            return sanitize((None, dp), shape, mesh)
        if name in ("ssm", "C") and len(shape) == 5:    # [L,B,H,D,N]
            return sanitize((None, dp, "model", None, None), shape, mesh)
        if name == "conv" and len(shape) == 4:          # [L,B,W-1,Di]
            return sanitize((None, dp, None, "model"), shape, mesh)
        if name == "n" and len(shape) == 4:             # [L,B,H,N]
            return sanitize((None, dp, "model", None), shape, mesh)
        if len(shape) == 3:                             # slstm [L,B,d]
            return sanitize((None, dp, "model"), shape, mesh)
        return sanitize((None, dp) + (None,) * (len(shape) - 2), shape, mesh)

    return _map_with_path(spec_for, state_shape)


def to_placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on each mesh dim whose name the spec gives tensor dim d
    (alone or in a tuple, which shards d over each of its axes, the first
    the major), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, axis in enumerate(spec):
        for name in (axis if isinstance(axis, tuple) else (axis,)):
            if name is not None:
                dim_of[name] = d
    return tuple(Shard(dim_of[name]) if name in dim_of else Replicate()
                 for name in mesh.mesh_dim_names)


def distribute(tree: PyTree, spec_tree: PyTree, mesh) -> PyTree:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements, cut from the leaf where it lies (no collective: every rank
    holds the whole leaf, as on the meta device; ``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor
    return _map_with_path(
        lambda _, spec, leaf: distribute_tensor(
            leaf, mesh, to_placements(spec, mesh), src_data_rank=None),
        spec_tree, tree)


# ---------------------------------------------------------------------------
# In-model sharding constraints.
#
# ``sharding_ctx(mesh)`` marks the mesh a launcher runs a step on;
# ``constrain(x, axes)`` then moves a DTensor ``x`` to the sanitized
# placements of ``axes`` and is the identity outside the context and for a
# plain tensor (CPU tests, one device).  The sentinel "dp" expands to the
# mesh's data-parallel axes.
# ---------------------------------------------------------------------------

_ACTIVE_MESH: list = []


@contextlib.contextmanager
def sharding_ctx(mesh):
    _ACTIVE_MESH.append(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.pop()


def constrain(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not _ACTIVE_MESH or not isinstance(x, DTensor):
        return x
    mesh = _ACTIVE_MESH[-1]
    resolved = tuple(dp_axes(mesh) if a == "dp" else a for a in axes)
    spec = sanitize(resolved, tuple(x.shape), mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))


def pin_stack_cotangent(tree: PyTree, *, stacked: bool = True) -> PyTree:
    """The identity.

    The reference wraps its scanned stack in a ``custom_vjp`` that pins the
    stacked weights' cotangent to the ZeRO sharding inside the scan body:
    ``lax.scan``'s backward accumulates its xs-cotangent in one loop buffer
    at the sharding of the gathered per-layer weights, which GSPMD would
    otherwise hold at full size.  Eager autograd has neither the loop
    buffer nor the partitioner: each layer's weight gradient is its own
    tensor, placed by the ops that make it, so there is nothing to pin."""
    return tree
