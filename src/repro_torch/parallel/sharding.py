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
    the major), ``Replicate()`` on the others and on a mesh dim of size 1
    (where a shard is the whole dim: on a (1, 1) mesh every leaf is
    replicated, so a step redistributes nothing)."""
    dim_of = {}
    for d, axis in enumerate(spec):
        for name in (axis if isinstance(axis, tuple) else (axis,)):
            if name is not None:
                dim_of[name] = d
    return placements(mesh, dim_of)


def placements(mesh, dim_of: dict) -> tuple:
    """``Shard(dim_of[name])`` on each mesh dim of more than one device that
    ``dim_of`` maps to a tensor dim (not None), ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    return tuple(Shard(dim_of[name]) if dim_of.get(name) is not None
                 and sizes[name] > 1 else Replicate()
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
# mesh's data-parallel axes.  The models call it where the reference does:
# the decode K/V cache and output (``models/attention.py``), the decode
# logits (``kernels/ref.py``) and, under ``cfg.seq_parallel``, Megatron
# sequence parallelism's gather and sequence-sharded residual
# (``models/transformer.py``); and where DTensor needs a layout that the
# reference's partitioner picks itself: a block's normed input whole over
# "model" and its output's partial sum reduced (Megatron's tensor
# parallelism), the MoE groups and the mLSTM gates.  On plain tensors the
# helpers below do what one device does (a reshape, a pad, nothing).  The
# dry-run runs its step on DTensors inside the context
# (``launch/dryrun.py``); everything else runs plain tensors.
# ---------------------------------------------------------------------------

_ACTIVE_MESH: list = []


@contextlib.contextmanager
def sharding_ctx(mesh):
    """Within the block ``constrain`` moves DTensors on ``mesh``, and a
    plain tensor that meets a DTensor (positions, masks, a step's scalars:
    the same on every device) counts as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    _ACTIVE_MESH.append(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE_MESH.pop()


def constrain(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    if not _ACTIVE_MESH or not is_distributed(x):
        return x
    mesh = _ACTIVE_MESH[-1]
    resolved = tuple(dp_axes(mesh) if a == "dp" else a for a in axes)
    spec = sanitize(resolved, tuple(x.shape), mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))


def is_distributed(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor (a step run on a mesh)."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tensors)


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int
                ) -> torch.Tensor:
    """``x [..., n_heads * head_dim]`` as ``[..., n_heads, head_dim]``.  A
    DTensor whose last dim is sharded over a mesh dim that does not divide
    ``n_heads`` (GQA's K/V heads on a wider "model" axis) is first gathered
    there: a shard would cut a head, which the reference's partitioner
    gathers as well."""
    if is_distributed(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.ndim - 1
        sizes = x.device_mesh.shape
        pl = tuple(Replicate() if isinstance(p, Shard)
                   and p.dim in (-1, last) and n_heads % sizes[i] else p
                   for i, p in enumerate(x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def pad(x: torch.Tensor, widths: tuple) -> torch.Tensor:
    """``F.pad(x, widths)`` with zeros.  A DTensor is padded on its shards
    (its padded dims whole first where a mesh dim shards them): padding a
    dim that no mesh dim shards commutes with the sharding."""
    import torch.nn.functional as F
    if not is_distributed(x):
        return F.pad(x, widths)
    from torch.distributed.tensor import Replicate
    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    pl = tuple(Replicate() if p.is_shard() and p.dim % x.ndim in padded
               else p for p in x.placements)
    return on_shards(lambda t: F.pad(t, widths), x.device_mesh, (x,),
                     (pl,), pl)


def keep_layout(x: torch.Tensor) -> torch.Tensor:
    """``x``; a DTensor through an autograd boundary at its own placements:
    whatever layout the ops after it give its gradient (a product's,
    sharded where a view before it cannot split or merge that dim), the
    gradient is moved back to ``x``'s layout (a partial sum's to whole)
    before it reaches the ops that made ``x``."""
    if is_distributed(x):
        x = x.redistribute(x.device_mesh, x.placements)
    return x


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n_heads, head_dim]`` as ``[..., n_heads * head_dim]``, its
    gradient at the merged tensor's layout (``keep_layout``): the next
    product may give it sharded where ``split_heads`` could not shard
    (heads that the mesh dim does not divide)."""
    return keep_layout(x.reshape(*x.shape[:-2], -1))


def gather_data(tree: PyTree) -> PyTree:
    """FSDP's gather: each DTensor leaf of ``tree`` made whole over the
    data-parallel axes (its shards over "model" kept), its gradient
    reduce-scattered back in the backward.  The models call it on their
    params, so that a product meets whole weights where the reference's
    partitioner gathers an FSDP leaf; a tree of plain tensors comes back
    as it is."""
    first = next(iter(_leaves(tree)), None)
    if first is None or not is_distributed(first):
        return tree
    from torch.distributed.tensor import Replicate

    def whole(_, t):
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if n in ("pod", "data") else p
                   for n, p in zip(names, t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)

    return _map_with_path(whole, tree)


def _leaves(tree: PyTree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def batch_axes(mesh, n: int) -> tuple[str, ...]:
    """The mesh's data-parallel axes (of more than one device) if their
    product divides a batch of ``n``, else none."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in dp_axes(mesh) if sizes.get(a, 1) > 1)
    total = 1
    for a in axes:
        total *= sizes[a]
    return axes if n % total == 0 else ()


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def model_coordinate(mesh) -> int:
    """This rank's index along the mesh's "model" axis (0 without one)."""
    if "model" not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank("model")


def zeros_distributed(shapes: PyTree, spec_tree: PyTree, mesh,
                      device) -> PyTree:
    """A tree of zeros like ``shapes`` (tensors that give shapes and dtypes
    only, such as fake ones), each leaf a DTensor on ``mesh`` at its spec's
    placements, made from its local shard alone (on ``device``): the whole
    leaf is never made.  The specs are sanitized, so every shard is the
    dim over the mesh dims' product."""
    from torch.distributed.tensor import DTensor

    def leaf(_, spec, t):
        pl = to_placements(spec, mesh)
        shape = list(t.shape)
        for p, size in zip(pl, mesh.shape):
            if p.is_shard():
                shape[p.dim] //= size
        local = torch.zeros(shape, dtype=t.dtype, device=device)
        stride, n = [], 1
        for size in reversed(t.shape):
            stride.insert(0, n)
            n *= size
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=tuple(stride))

    return _map_with_path(leaf, spec_tree, shapes)


def on_shards(fn: Callable, mesh, args: tuple, in_placements: tuple,
              out_placements, grad_placements: tuple | None = None):
    """``fn`` run on the local shards of the DTensors ``args``, moved first
    to ``in_placements`` (one tuple a tensor argument, None for any other),
    its outputs wrapped as DTensors with ``out_placements`` (one tuple, or
    a tuple of them for several outputs); the gradient
    of each input comes back with ``grad_placements`` (default: its input
    placements; ``Partial`` where each shard's gradient is a part of a sum,
    as for an input that every shard reads but each only in part).  The
    kernels' sharding rules (``torch.distributed.tensor.experimental.
    local_map``): a kernel runs as on one device, on its shard."""
    from torch.distributed.tensor import DTensor, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = (out_placements,)      # one output
    whole = tuple(Replicate() for _ in mesh.mesh_dim_names)
    args = tuple(DTensor.from_local(a, mesh, whole, run_check=False)
                 if isinstance(a, torch.Tensor)
                 and not isinstance(a, DTensor) else a for a in args)
    return local_map(fn, out_placements, in_placements, grad_placements,
                     mesh, redistribute_inputs=True)(*args)


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
