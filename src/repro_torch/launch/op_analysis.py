"""The work of a step counted on its op stream: the port's counterpart of
``repro/launch/hlo_analysis.py``.

The JAX package compiles a step and parses the optimized HLO for the flops
of every dot, the bytes every top-level op reads and writes, and the
collectives.  Eager PyTorch has no compiled module to parse, so this counts
the same terms on the stream of aten ops a run of the step dispatches,
through a ``TorchDispatchMode``, typically over a run on the meta device,
where nothing is computed or allocated:

  flops       2*M*N*K of every op of the matmul family, by the formulas of
              ``torch.utils.flop_counter`` (mm, bmm, addmm, baddbmm, the
              convolutions), plus the work that the hand-written kernels'
              meta path reports (``kernels/work.py``: flash attention and
              the SSD scan, forward and backward; a kernel is no aten op);
  bytes       the bytes every op reads and writes, each op on its own (an
              eager step fuses nothing): its tensor operands and results;
              a view and an ``empty`` move none; as in the reference, an
              indexing op (gather, index, embedding) reads what it gives
              (2x its result), a scatter or an indexed write moves 3x what
              it writes, a copy 2x; plus the kernels' reported bytes;
  peak_bytes  the most bytes of storage the run holds at once beyond what
              existed when it began (the step's temporaries: activations,
              what autograd saves, gradients, the kernels' scratch),
              counted by each new storage's size until it is freed;
  collectives the functional collectives the run issues (a step on
              DTensors redistributes through them), in the reference's
              record: result bytes by kind, an all-reduce 2x, and call
              counts.

A step on DTensors (``torch.distributed.tensor``, as the dry-run runs it on
a mesh) is counted per device, for this process's rank, which is rank 0:
the mode lets each DTensor op through to DTensor's dispatch (it returns
``NotImplemented``, as ``CommDebugMode`` does) and counts what that runs
on the local shards: the redistributions' collectives and copies, then the
op on the shards it reads.  So an op's flops are its local share (its
global count over the mesh dims on which its output is ``Shard`` or
``Partial``, whole on a ``Replicate`` dim, where every device does it),
its bytes those of the local shards it reads and writes, and the peak
that of the local storages.  Where a dim splits unevenly, rank 0 holds
the largest shard, so its counts are the most any device does.  The
kernels run on their shards (``parallel.sharding.on_shards``) and report
the local work.  DTensor's own sharding propagation runs ops on fake
tensors; those are not counted.  A run on plain tensors counts what it
did before (and issues no collective).
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import work

aten = torch.ops.aten

# ops that allocate and move nothing
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided}
# ops that read about what they give: 2x the result (hlo_analysis._io_bytes)
_RESULT_SIZED = {aten.index, aten.index_select, aten.gather, aten.embedding}
# ops that write into a region: 3x the update (read region and update,
# write region), by the update's position among the arguments
_SCATTER = {aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
            aten.scatter_add_: 3, aten.index_put: 2, aten.index_put_: 2}
# the functional collectives, by the reference's kind
_COLLECTIVE = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}
# ops around a collective that hand its result on: no bytes, no storage
_PASS = {"wait_tensor", "_wrap_tensor_autograd"}


def _in_cpu_alltoall() -> bool:
    """Whether an all-gather is DTensor's stand-in for an all-to-all: on a
    CPU mesh ``shard_dim_alltoall`` all-gathers and keeps its chunk (gloo
    has no all-to-all); a device that has one runs the all-to-all."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def _tensors(obj) -> list[torch.Tensor]:
    """The tensors among an op's arguments or results (one list deep)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for t in obj if isinstance(t, torch.Tensor)]
    return []


class _OpCounter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.flops_by_op: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.collectives: list[tuple[str, int, str]] = []
        self._storages: dict[int, tuple[int, weakref.ref]] = {}

    def _free(self, key: int) -> None:
        nbytes, _ = self._storages.pop(key)
        self.live -= nbytes

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages or key in inputs:
            return
        nbytes = st.nbytes()
        self._storages[key] = (nbytes, weakref.ref(
            st, lambda _, key=key: self._free(key)))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _collective(self, name: str, args, out):
        """A collective: its kind and result bytes in ``collectives``; as
        an op, its operand and result bytes.  DTensor's stand-in for an
        all-to-all on a CPU mesh is counted as the all-to-all: its result
        is the chunk it keeps, and its whole gather is no storage."""
        ins = [t for a in args for t in _tensors(a)]
        res = _tensors(out)
        nbytes = sum(t.nbytes for t in res)
        kind = _COLLECTIVE[name]
        if kind == "all-gather" and _in_cpu_alltoall():
            kind, nbytes = "all-to-all", sum(t.nbytes for t in ins)
            self.bytes += 2 * nbytes
        else:
            self.bytes += sum(t.nbytes for t in ins) + nbytes
            in_storages = {id(t.untyped_storage()) for t in ins}
            for t in res:
                self._track(t, in_storages)
        self.ops += 1
        group = [a for a in args if isinstance(a, str)]
        self.collectives.append((kind, nbytes, group[-1] if group else ""))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # counted on the shards it runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in (*_tensors(out), *(
                t for a in args for t in _tensors(a)))):
            return out                  # DTensor's sharding propagation
        packet = func.overloadpacket
        name = packet.__name__
        if name in _PASS:
            return out
        if name in _COLLECTIVE:
            return self._collective(name, args, out)
        if packet in self._flop_formulas:
            f = int(self._flop_formulas[packet](*args, out_val=out, **kwargs))
            self.flops += f
            self.flops_by_op[packet.__name__] += f
        if packet in _NO_BYTES:
            for t in _tensors(out):
                self._track(t, set())
            return out
        if func.is_view:
            return out
        self.ops += 1
        ins = [t for a in (*args, *kwargs.values()) for t in _tensors(a)]
        outs = _tensors(out)
        if packet in _RESULT_SIZED:
            self.bytes += 2 * sum(t.nbytes for t in outs)
        elif packet in _SCATTER:
            self.bytes += 3 * sum(t.nbytes
                                  for t in _tensors(args[_SCATTER[packet]]))
        elif packet is aten.copy_:
            self.bytes += 2 * args[1].nbytes
        else:
            self.bytes += (sum(t.nbytes for t in ins)
                           + sum(t.nbytes for t in outs))
        in_storages = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            self._track(t, in_storages)
        return out


def analyze(fn: Callable[..., Any], *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under the op counter and return the
    work of the run (one device's where its tensors are DTensors):
    ``flops`` (the matmul family's and the kernels'), ``bytes``,
    ``peak_bytes``, and their parts: ``aten_flops`` by op, the kernels'
    calls, flops and bytes by kernel, ``ops`` (the aten ops that move
    bytes); ``collectives``, the record of those it issued (``{"bytes":
    {kind: ..., "total": ...}, "counts": {kind: calls}, "entries": [...]}``,
    an entry's ``axis`` the name of its process group).  Nothing in the
    run is computed where its tensors lie on the meta device."""
    counter = _OpCounter()
    with work.collect() as calls, counter:
        fn(*args, **kwargs)
    from .collectives import Entry, summarize
    tally: Counter = Counter(counter.collectives)
    coll = summarize([Entry(kind, nbytes, n, group, "run", "step")
                      for (kind, nbytes, group), n in tally.items()])
    kernels: dict[str, dict] = {}
    for name, flops, nbytes in calls:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += sum(flops.values())
        k["bytes"] += nbytes
    kernel_flops = sum(k["flops"] for k in kernels.values())
    kernel_bytes = sum(k["bytes"] for k in kernels.values())
    return {
        "flops": counter.flops + kernel_flops,
        "bytes": counter.bytes + kernel_bytes,
        "peak_bytes": counter.peak,
        "aten_flops": dict(counter.flops_by_op),
        "kernels": kernels,
        "ops": counter.ops,
        "collectives": coll,
    }
