"""DAG builders (paper §2, §4.2.2).

* ``synthetic_dag`` — the paper's synthetic benchmark: layers of P
  same-type tasks (P = DAG parallelism); exactly one task per layer is
  HIGH priority and releases the next layer when it commits.
* ``mixed_dag`` — heterogeneous-mix variant: the layers cycle through
  several task *types* (e.g. matmul / copy / stencil), each layer keeping
  its own critical task, so one DAG stresses every per-type PTT at once
  (cf. the mixed-workload motivation of arXiv:1905.00673).
* ``kmeans_dag`` — K-means as a *dynamic* DAG: each iteration spawns map
  tasks + one HIGH-priority reduce task whose commit inserts the next
  iteration's tasks at runtime.
* ``heat_dag`` — distributed 2D Heat: per node per iteration, stencil
  compute tasks (LOW) + ghost-cell exchange tasks (HIGH, paper §4.2.2:
  "Due to the criticality of such communication, these MPI tasks are
  marked as high priority").
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional, Sequence

from .task import (Priority, Task, TaskType, kmeans_map_type,
                   kmeans_reduce_type, mpi_exchange_type, stencil_type)


@dataclasses.dataclass
class DAG:
    """Root tasks + total count (total includes dynamically inserted tasks
    only after they are inserted; ``expected_total`` is for reporting)."""

    roots: list[Task]
    expected_total: int

    def all_tasks(self) -> list[Task]:
        """Breadth-first enumeration of the *static* portion of the DAG,
        deduplicated: a node reachable along several paths (a diamond's
        join) appears exactly once, at its first-discovered depth.  Order
        is deterministic — roots in submission order, then each level in
        parent order, children in ``add_child`` order."""
        seen: dict[int, Task] = {}
        queue = deque(self.roots)
        while queue:
            t = queue.popleft()
            if t.tid in seen:
                continue
            seen[t.tid] = t
            queue.extend(t.children)
        return list(seen.values())


def _layered_dag(type_of_layer: Callable[[int], TaskType], *,
                 parallelism: int, total_tasks: int) -> DAG:
    """Shared layered-DAG skeleton: layer i holds ``parallelism`` tasks of
    ``type_of_layer(i)`` (the final layer holds the remainder when
    ``total_tasks`` is not a multiple — never silently dropped), the first
    task of each layer is the critical HIGH task and releases the next
    layer when it commits."""
    if parallelism < 1 or total_tasks < parallelism:
        raise ValueError("need total_tasks >= parallelism >= 1")
    roots: list[Task] = []
    prev_critical: Optional[Task] = None
    built, layer = 0, 0
    while built < total_tasks:
        width = min(parallelism, total_tasks - built)
        task_type = type_of_layer(layer)
        layer_tasks = [Task(task_type) for _ in range(width)]
        layer_tasks[0].priority = Priority.HIGH      # the critical task
        if prev_critical is None:
            roots.extend(layer_tasks)
        else:
            for t in layer_tasks:
                prev_critical.add_child(t)
        prev_critical = layer_tasks[0]
        built += width
        layer += 1
    return DAG(roots, built)


def synthetic_dag(task_type: TaskType, *, parallelism: int,
                  total_tasks: int) -> DAG:
    """Paper §4.2.2: each layer has P tasks of the same type; one is marked
    critical; its completion releases the next P tasks.  DAG parallelism =
    total/longest-path = P.  A non-divisible ``total_tasks`` emits a final
    partial layer (``expected_total`` always equals ``total_tasks``)."""
    return _layered_dag(lambda _layer: task_type, parallelism=parallelism,
                        total_tasks=total_tasks)


def mixed_dag(task_types: Sequence[TaskType], *, parallelism: int,
              total_tasks: int) -> DAG:
    """Heterogeneous-mix synthetic DAG: layer i holds ``parallelism``
    tasks of ``task_types[i % len(task_types)]`` — interleaved e.g.
    matmul / copy / stencil layers — with the same per-layer criticality
    structure as :func:`synthetic_dag` (first task of every layer is HIGH
    and gates the next layer).  Because each task type owns its own PTT,
    one run exercises several trace tables and the schedulers must keep
    per-type placement models current simultaneously."""
    types = tuple(task_types)
    if not types:
        raise ValueError("mixed_dag needs at least one task type")
    return _layered_dag(lambda layer: types[layer % len(types)],
                        parallelism=parallelism, total_tasks=total_tasks)


def chain_dag(task_type: TaskType, length: int) -> DAG:
    """A single serial chain — the co-running application's shape."""
    head = Task(task_type)
    cur = head
    for _ in range(length - 1):
        cur = cur.add_child(Task(task_type))
    return DAG([head], length)


def decode_pool_dag(prefill_type: TaskType, decode_type: TaskType, *,
                    n_requests: int, steps: int,
                    batch_key: Optional[str] = "decode") -> DAG:
    """Serving-shaped DAG for the queue-level continuous-batching path:
    ``n_requests`` independent chains, each a HIGH prefill releasing
    ``steps`` LOW decode tasks marked with ``batch_key``.  At any instant
    each chain has at most one ready decode step, so the tasks queued
    under the shared key across chains are exactly the coalescible set —
    the same population the serving engine's DecodeBatcher sees.
    ``batch_key=None`` builds the identical DAG with coalescing off (the
    control for degeneracy tests)."""
    if n_requests < 1 or steps < 0:
        raise ValueError("need n_requests >= 1 and steps >= 0")
    roots: list[Task] = []
    for _ in range(n_requests):
        head = Task(prefill_type, priority=Priority.HIGH)
        cur = head
        for _ in range(steps):
            nxt = Task(decode_type, priority=Priority.LOW)
            nxt.batch_key = batch_key
            cur = cur.add_child(nxt)
        roots.append(head)
    return DAG(roots, n_requests * (1 + steps))


def kmeans_dag(*, n_points: int = 200_000, dims: int = 16, k: int = 8,
               n_chunks: int = 32, iterations: int = 80,
               on_iteration: Optional[Callable[[int], None]] = None) -> DAG:
    """K-means as a dynamic DAG (paper §4.2.2 + §5.4): loop partitions
    become dynamically scheduled map tasks; the reduce task carries the
    largest work unit and is HIGH priority; committing it *inserts* the
    next iteration (dynamic DAG growth via ``on_commit``)."""
    map_type = kmeans_map_type(n_points // n_chunks, dims, k)
    red_type = kmeans_reduce_type(k, dims, n_chunks)

    def make_iteration(it: int) -> list[Task]:
        maps = [Task(map_type) for _ in range(n_chunks)]
        reduce_t = Task(red_type, priority=Priority.HIGH)
        for m in maps:
            m.add_child(reduce_t)

        def commit_hook(_task: Task, _it: int = it) -> list[Task]:
            if on_iteration is not None:
                on_iteration(_it)
            if _it + 1 < iterations:
                return make_iteration(_it + 1)
            return []

        reduce_t.on_commit = commit_hook
        return maps                       # maps are the ready roots

    return DAG(make_iteration(0), iterations * (n_chunks + 1))


def heat_dag(*, nodes: int = 4, tiles_per_node: int = 20, tile: int = 1024,
             iterations: int = 60, boundary_kb: float = 256.0) -> DAG:
    """Distributed 2D Heat (paper §4.2.2, Fig. 10): iterative stencil over a
    row-partitioned grid.  Per node and iteration: ``tiles_per_node``
    stencil tasks (LOW) + one boundary-exchange task per neighbor (HIGH).
    The stencil tasks of iteration i+1 on node n are gated by node n's own
    exchanges of iteration i *and* by each neighbor's exchange directed at
    n (explicitly keyed by destination node below — the old list-index
    gating encoded the direction implicitly in creation order); compute
    tasks gate their own node's exchanges."""
    st = stencil_type(tile)
    ex = mpi_exchange_type(boundary_kb)

    roots: list[Task] = []
    # prev iteration's exchange tasks, keyed by destination neighbor:
    # prev_ex[n][m] is node n's ghost-cell send *toward node m*
    prev_ex: list[dict[int, Task]] = [{} for _ in range(nodes)]
    total = 0
    for it in range(iterations):
        cur_compute: list[list[Task]] = []
        for n in range(nodes):
            comp = [Task(st) for _ in range(tiles_per_node)]
            total += len(comp)
            if it == 0:
                roots.extend(comp)
            else:
                # stencil of iter i depends on own exchanges of i-1 plus
                # the neighbors' exchanges directed at this node
                gates = list(prev_ex[n].values())
                if n > 0:
                    gates.append(prev_ex[n - 1][n])
                if n + 1 < nodes:
                    gates.append(prev_ex[n + 1][n])
                for g in gates:
                    for c in comp:
                        g.add_child(c)
            cur_compute.append(comp)
        cur_ex: list[dict[int, Task]] = []
        for n in range(nodes):
            exs = {nb: Task(ex, priority=Priority.HIGH)
                   for nb in (n - 1, n + 1) if 0 <= nb < nodes}
            total += len(exs)
            for c in cur_compute[n]:
                for e in exs.values():
                    c.add_child(e)
            cur_ex.append(exs)
        prev_ex = cur_ex
    return DAG(roots, total)
