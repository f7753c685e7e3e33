"""Engine-agnostic scheduling queues (paper Fig. 3, steps 1-3).

One reusable structure for *both* execution engines — the discrete-event
simulator and the real threaded runtime — so queue semantics exist once:

* per-core split **Work Stealing Queue**: HIGH tasks in FIFO order (the
  oldest HIGH gates the DAG and is served first), LOW tasks as a LIFO
  deque for owner locality whose FIFO end feeds thieves.  Schedulers
  without priority dequeue that steal HIGH tasks (the RWS family) route
  everything through ``low``, i.e. one plain mixed-LIFO deque, which
  preserves their priority-oblivious ordering;
* per-core FIFO **Assembly Queue** holding placed work (engine-specific
  records — the DES enqueues rate-integration records, the threaded
  runtime barrier records; a molded task's record is inserted into *all*
  member AQs and starts when every member reaches it);
* **steal policy**: the victim with the most stealable tasks wins, maxima
  tie-break uniformly at random from the caller's (seeded) RNG stream,
  and the steal pops the oldest stealable task (LOW FIFO end first).

Every method is O(1) or O(cores) and draws randomness only through the
RNG handed in by the caller, so the DES's bit-exact golden schedules and
the threaded runtime's seeded steal stream both ride on the same code.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Optional

import numpy as np

from .task import Priority, Task


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Continuous-batching knobs, shared by the serving engine's
    :class:`~repro.serve.batching.DecodeBatcher` and the engines'
    queue-level coalescing dequeue.

    ``max_batch`` — most members per dispatch (1 disables batching: the
    degeneracy pin — every path must be bit-identical to no batching).
    ``delay_s`` — how long a partial batch may wait for more members
    before it flushes anyway (the batch-delay window).
    ``flush_slack_s`` — a member whose deadline slack falls to this
    flushes the pending batch immediately.
    ``member_cost`` — marginal cost of each member past the first as a
    fraction of the base step time (batched decode is memory-bound; see
    :meth:`~repro.core.task.TaskType.batched`).

    Frozen + plain fields so it pickles across ``multirun`` workers and
    can ride ``RunSpec.sim_kwargs`` verbatim."""

    max_batch: int = 8
    delay_s: float = 2e-3
    flush_slack_s: float = 0.0
    member_cost: float = 0.05

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.delay_s < 0.0 or self.flush_slack_s < 0.0:
            raise ValueError("delay_s / flush_slack_s must be >= 0")
        if not 0.0 <= self.member_cost <= 1.0:
            raise ValueError(
                f"member_cost must be in [0, 1], got {self.member_cost}")

    @property
    def enabled(self) -> bool:
        return self.max_batch > 1


class SplitWSQ:
    """Split work-stealing queue: a HIGH FIFO deque + a LOW LIFO deque
    (whose FIFO end feeds thieves)."""

    __slots__ = ("high", "low")

    def __init__(self):
        self.high: deque[Task] = deque()
        self.low: deque[Task] = deque()

    def __len__(self) -> int:
        return len(self.high) + len(self.low)


class WorkQueues:
    """Per-core split WSQs + assembly queues under one scheduling policy.

    ``priority_dequeue`` — serve the oldest HIGH before any LOW from the
    owner's queue; ``steal_high`` — HIGH tasks are stealable (RWS family).
    HIGH tasks are routed to the split HIGH deque unless the scheduler is
    fully priority-oblivious (no priority dequeue AND HIGH stealable),
    which keeps stealable counts and steal pops consistent with
    ``Scheduler.may_steal`` for *any* flag combination.
    """

    def __init__(self, n_cores: int, *, priority_dequeue: bool,
                 steal_high: bool, track_load: bool = False,
                 groups: Optional[list[int]] = None):
        self.n_cores = n_cores
        self.priority_dequeue = priority_dequeue
        self.steal_high = steal_high
        self.route_high = priority_dequeue or not steal_high
        self.wsq: list[SplitWSQ] = [SplitWSQ() for _ in range(n_cores)]
        self.aq: list[deque] = [deque() for _ in range(n_cores)]
        # Queued-work accounting for queue-aware placement: per-core
        # estimated seconds of ready work sitting in the WSQs, maintained
        # at push/pop/steal/drain from the estimate the kernel stamped on
        # the task (``task.load_est``).  Off by default — zero cost.
        self.track_load = track_load
        self.queued_s = np.zeros(n_cores) if track_load else None
        # HIGH-only backlog (criticality currency): per-core estimated
        # seconds of *HIGH* ready work.  A shard drowning in HIGH backlog
        # delays the critical path even when its total load looks
        # balanced, so the global rebalancer's criticality-pressure
        # trigger reads this vector.  Maintained alongside ``queued_s``
        # (same push/pop/steal/drain sites); None when load tracking is
        # off — zero cost on the default paths.
        self.queued_high_s = np.zeros(n_cores) if track_load else None
        # Steal groups (sharded control plane): ``groups[core]`` is the
        # core's shard id; thieves only victimize their own group, so work
        # crosses shards exclusively through the global rebalancer.  None
        # = one flat group (the victim scan is untouched).
        self.groups = list(groups) if groups is not None else None

    # -- ready-task (WSQ) operations ----------------------------------------
    def push(self, task: Task, core: int) -> None:
        q = self.wsq[core]
        if self.route_high and task.priority == Priority.HIGH:
            q.high.append(task)
        else:
            q.low.append(task)
        if self.track_load:
            self.queued_s[core] += task.load_est
            if task.priority == Priority.HIGH:
                self.queued_high_s[core] += task.load_est

    def pop_local(self, core: int) -> Optional[Task]:
        """Owner pop: oldest HIGH first under priority dequeue; LOW pops
        LIFO for locality; leftover HIGHs (non-priority dequeue) FIFO."""
        q = self.wsq[core]
        if self.priority_dequeue and q.high:
            task = q.high.popleft()
        elif q.low:
            task = q.low.pop()
        elif q.high:
            task = q.high.popleft()
        else:
            return None
        if self.track_load:
            self.queued_s[core] -= task.load_est
            if task.priority == Priority.HIGH:
                self.queued_high_s[core] -= task.load_est
        return task

    def wsq_len(self, core: int) -> int:
        return len(self.wsq[core])

    def stealable(self, task: Task) -> bool:
        return self.steal_high or task.priority != Priority.HIGH

    def stealable_count(self, core: int) -> int:
        q = self.wsq[core]
        return len(q.low) + len(q.high) if self.steal_high else len(q.low)

    def pick_victim(self, thief: int, rng) -> int:
        """The WSQ with the most stealable tasks (paper step 3); maxima
        tie-break uniformly at random from ``rng``.  Returns -1 when no
        core has stealable work.  O(cores) length reads."""
        best_n = 0
        best: list[int] = []
        groups = self.groups
        group = groups[thief] if groups is not None else None
        wsq = self.wsq
        steal_high = self.steal_high
        for v in range(self.n_cores):
            if v == thief:
                continue
            if group is not None and groups[v] != group:
                continue
            q = wsq[v]
            n = len(q.low) + len(q.high) if steal_high else len(q.low)
            if n > best_n:
                best_n = n
                best = [v]
            elif n and n == best_n:
                best.append(v)
        if not best:
            return -1
        return best[0] if len(best) == 1 else best[rng.randrange(len(best))]

    def steal_pop(self, victim: int) -> Task:
        """Pop the oldest stealable task (LOW FIFO end first; HIGHs only
        ever surface here when ``steal_high`` routed them to ``low`` or
        priority dequeue left them exposed)."""
        q = self.wsq[victim]
        task = q.low.popleft() if q.low else q.high.popleft()
        if self.track_load:
            self.queued_s[victim] -= task.load_est
            if task.priority == Priority.HIGH:
                self.queued_high_s[victim] -= task.load_est
        return task

    def coalesce_batch(self, core: int, key: str, limit: int) -> list[Task]:
        """Coalescing LOW dequeue (continuous batching): remove up to
        ``limit`` queued LOW tasks whose ``batch_key`` equals ``key`` from
        ``core``'s queue, oldest first, and return them as batch members.
        Called right after an engine pops a dispatch leader with a batch
        key; the members skip their own place/dequeue rounds and ride the
        leader.  Only the LOW deque is scanned — batchable work is LOW by
        construction (HIGH prefills must never wait on batch fill)."""
        if limit <= 0:
            return []
        q = self.wsq[core].low
        if not q:
            return []
        taken: list[Task] = []
        kept: list[Task] = []
        for t in q:
            if len(taken) < limit and t.batch_key == key:
                taken.append(t)
            else:
                kept.append(t)
        if taken:
            q.clear()
            q.extend(kept)
            if self.track_load:
                self.queued_s[core] -= sum(t.load_est for t in taken)
        return taken

    def migrate_pop(self, core: int) -> Optional[Task]:
        """Pop one task for cross-shard migration, HIGH-first (a parked
        critical task hurts most): oldest HIGH, else the oldest LOW (the
        thief end — the owner's LIFO locality tail is left alone)."""
        q = self.wsq[core]
        if q.high:
            task = q.high.popleft()
        elif q.low:
            task = q.low.popleft()
        else:
            return None
        if self.track_load:
            self.queued_s[core] -= task.load_est
            if task.priority == Priority.HIGH:
                self.queued_high_s[core] -= task.load_est
        return task

    def drain_wsq(self, cores: Iterable[int]) -> list[Task]:
        """Empty the WSQs of ``cores`` (a revoked partition), returning
        tasks in steal order per core: oldest HIGH first, then the LOW
        deque oldest-first."""
        out: list[Task] = []
        for c in cores:
            q = self.wsq[c]
            out.extend(q.high)
            out.extend(q.low)
            q.high.clear()
            q.low.clear()
            if self.track_load:
                self.queued_s[c] = 0.0
                self.queued_high_s[c] = 0.0
        return out
