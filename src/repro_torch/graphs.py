"""What the port's captured CUDA graphs share: the launch counts a capture
takes and each replay adds back, and the process-wide count of the graphs
that live, by which the last of them to close clears cuBLAS's workspaces.

Three kinds of graph live in one process, the counterparts of the
reference's three jitted steps: the serving engine's decode slots
(``serve/decode_graph.py``, one a worker thread), its prefill buckets
(``serve/prefill_graph.py``, one a prompt-length bucket) and the captured
train step (``train/step_graph.py``).

Each graph is captured into a memory pool of its own (:func:`capture`
passes no ``pool``): a pool shared by graphs is safe only when they
replay one at a time, in the order of their capture, and the engine's
worker threads replay decode slots and prefill buckets of different
lengths at once.  A graph's outputs live in its pool and its next replay
overwrites them, so a caller copies out what it keeps (a prefill's decode
state) before it lets another replay of the same graph start (each
bucket's lock, each slot's dispatch).

A replay runs none of the kernel wrappers' Python, so the launch counters
do not see it.  :func:`capture` takes each counter's delta over the
capture and takes it back again, since a capture records its kernels and
launches none; :func:`replay` adds the deltas on each replay
(``LaunchCounter.add(n)``).  So a counter counts the kernels that ran,
eagerly or in a replay.

cuBLAS keeps a workspace for each stream it runs on, a capture stream's
too, which the graph captured there reads by address.  PyTorch keeps these
workspaces for the whole process, not for a graph, and frees them only all
at once (``torch._C._cuda_clearCublasWorkspaces``), the default stream's
and every other thread's among them.  So the graphs that live are counted
for the process (``_LIVE``, the module's one piece of state: decode slots,
prefill buckets and train steps count each other), and only the last of
them to close
clears the workspaces, after a ``synchronize``.  That clear is
process-wide: it must not run while another thread launches cuBLAS work,
which ``ServingEngine.close`` keeps by refusing while its run is live.
Without it the capture streams' workspaces stay allocated after the
graphs are gone.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Iterable

import torch

from .kernels.common import LaunchCounter

# the owners of the graphs that live, of any kind, in the whole process
_LIVE: "weakref.WeakSet[Any]" = weakref.WeakSet()

Deltas = list[tuple[LaunchCounter, int]]


def capture(fn: Callable[[], Any], stream: torch.cuda.Stream,
            counters: Iterable[LaunchCounter]
            ) -> tuple[torch.cuda.CUDAGraph, Any, Deltas]:
    """``fn()`` captured into a new graph on ``stream``, in a memory pool of
    the graph's own: (the graph, what ``fn`` returned, the launch counts the
    capture took from ``counters``, taken back from them)."""
    counters = list(counters)
    before = [c.count for c in counters]
    graph = torch.cuda.CUDAGraph()
    # no ``pool``: the graph's memory pool is its own
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    deltas = [(c, c.count - n) for c, n in zip(counters, before)
              if c.count != n]
    for counter, n in deltas:
        counter.add(-n)
    return graph, out, deltas


def replay(graph, deltas: Deltas) -> None:
    """Replay ``graph`` on the current stream and add the launches it
    holds."""
    graph.replay()
    for counter, n in deltas:
        counter.add(n)


def hold(owner) -> None:
    """Count ``owner``'s graph among those that live."""
    _LIVE.add(owner)


def live() -> int:
    """The graphs that live in the process, of any kind."""
    return len(_LIVE)


def release(owner, graph, device: torch.device) -> None:
    """Free ``graph`` and its pool; if ``owner``'s was the last graph of
    the process to live, clear cuBLAS's workspaces (:func:`clear_workspaces`)."""
    graph.reset()
    held = owner in _LIVE
    _LIVE.discard(owner)
    if held and not _LIVE:
        clear_workspaces(device)


def clear_workspaces(device: torch.device) -> None:
    """Wait for the card, then free cuBLAS's workspaces of every stream."""
    torch.cuda.synchronize(device)
    torch._C._cuda_clearCublasWorkspaces()
