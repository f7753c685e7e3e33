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
              counted by each new storage's size until it is freed.

:func:`analyze` gives these for one run of a function, whole: a caller
that runs a step on sharded inputs divides them per device.  The
collective terms of ``analyze_hlo`` stay out (no collective runs in an
eager step on one process).
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Callable

import torch
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
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
    work of the run, whole: ``flops`` (the matmul family's and the
    kernels'), ``bytes``, ``peak_bytes``, and their parts: ``aten_flops``
    by op, the kernels' calls, flops and bytes by kernel, ``ops`` (the aten
    ops that move bytes).  Nothing in the run is computed where its tensors
    lie on the meta device."""
    counter = _OpCounter()
    with work.collect() as calls, counter:
        fn(*args, **kwargs)
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
    }
