"""Engine-agnostic task-lifecycle kernel (paper Fig. 3 / Algorithm 1).

The XiTAO task lifetime — **wake** (predecessor commits, binding placement
of HIGH tasks) → **place** → **dequeue or steal-with-re-search** →
**commit** (leader measures, PTT feedback, dependents wake) — used to be
implemented twice: once inside the discrete-event simulator and once
inside the threaded runtime, and the two copies drifted (the threaded
engine lost priority dequeue, seeded steal tie-breaks and revocation
entirely).  This module is the single implementation both engines drive:

* :class:`SchedulingKernel` owns the scheduler, the shared
  :class:`~.queues.WorkQueues`, and a *time source* (simulated clock for
  the DES, ``perf_counter`` deltas for the threaded runtime); every
  decision point of the lifecycle is a method here;
* what remains in each engine is only its execution substrate: event-heap
  rate integration in the simulator, worker threads + barriers in the
  threaded runtime.

All randomness flows through the scheduler's seeded streams, so the DES
stays bit-reproducible and the threaded engine's *decisions* (victim
tie-breaks, placement tie-breaks) come from the same deterministic
streams even though its measurements are wall-clock.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from .places import ExecutionPlace
from .queues import BatchingConfig, WorkQueues
from .schedulers import Scheduler
from .task import Priority, Task, TaskType


def ptt_observe(bank, type_name: str, place: ExecutionPlace,
                observed: float) -> float:
    """The one PTT-feedback path (paper step 8): the leader folds an
    observed execution time into the type's trace table.  Shared by the
    DES commit, the threaded commit, and the fleet-level PodMonitor so
    the 1:4 hysteresis semantics exist exactly once."""
    return bank.for_type(type_name).update(place, observed)


class SchedulingKernel:
    """Scheduler + queues + time source = every lifecycle decision.

    ``now`` is the engine's time source (seconds since run start).  The
    kernel resets per-run scheduler state on construction
    (:meth:`Scheduler.begin_run`) so back-to-back runs on one scheduler
    object are reproducible, and clears any revoked-capacity view at
    :meth:`end_run` so it never leaks into a later run.
    """

    def __init__(self, scheduler: Scheduler, *, now: Callable[[], float],
                 queues: Optional[WorkQueues] = None):
        self.sched = scheduler
        self.now = now
        # Outstanding-work accounting for queue-aware placement: on when
        # the scheduler either penalizes load or asks for observability.
        # Off (the default) every tracking branch below is dead code, so
        # load-oblivious runs stay bit-identical.
        self.track_load = scheduler.queue_penalty > 0.0 or scheduler.track_load
        # ``queues`` lets a sharded control plane hand several kernels one
        # shared WorkQueues (per-core structures are naturally disjoint;
        # steal groups fence the victim scans).
        if queues is not None:
            self.track_load = self.track_load or queues.track_load
            self.queues = queues
        else:
            self.queues = WorkQueues(
                scheduler.topology.n_cores,
                priority_dequeue=scheduler.priority_dequeue,
                steal_high=scheduler.steal_high,
                track_load=self.track_load)
        self._all_cores = tuple(range(scheduler.topology.n_cores))
        if self.track_load:
            # per-core estimated seconds of placed/running work, charged at
            # choose_place and discharged at commit/fail/requeue; keyed by
            # tid so a discharge cancels exactly what was charged even if
            # the PTT moved in between.  The kernel-local lock exists for
            # the threaded engine, whose commit path runs outside the
            # runtime lock; the DES is single-threaded and uncontended.
            self._running_s = np.zeros(scheduler.topology.n_cores)
            self._run_charges: dict[int, tuple[tuple[int, ...], float]] = {}
            self._load_lock = threading.Lock()
            self._place_lw = [(p.leader, p.width)
                              for p in scheduler.topology.places()]
            # (n_places, max_width) member-core gather matrix for the
            # vectorized place_load: row i holds place i's member cores,
            # padded with the leader (already a member, so the padded max
            # is exactly the max over the true members)
            max_w = max(w for _, w in self._place_lw)
            gather = np.empty((len(self._place_lw), max_w), dtype=np.int64)
            for i, (leader, width) in enumerate(self._place_lw):
                gather[i, :width] = np.arange(leader, leader + width)
                gather[i, width:] = leader
            self._place_gather = gather
            scheduler.load_view = self.place_load
        # Continuous batching (see ``form_dispatch``): engines set this to
        # a BatchingConfig with max_batch > 1 to turn the coalescing
        # dequeue on.  None (the default) keeps every dequeue untouched —
        # the max_batch=1 degeneracy pin.
        self.batching: Optional[BatchingConfig] = None
        scheduler.begin_run()

    # -- wake (steps 1-2): binding placement of HIGH tasks -------------------
    def wake(self, task: Task, waker_core: int) -> int:
        """Stamp readiness, run the wake-time placement, and return the
        core whose WSQ receives the task."""
        task.t_ready = self.now()
        target = self.sched.place_on_wake(task, waker_core)
        core = waker_core if target is None else target
        if self.track_load:
            self._stamp_load_est(task, core)
        return core

    def live_cores(self) -> tuple[int, ...]:
        view = self.sched.live
        return self._all_cores if view is None else view.cores

    def requeue_displaced(self, task: Task,
                          waker: Optional[int] = None) -> int:
        """Re-place a task displaced by a revocation: the old binding is
        void (its partition may be down), the wake-time decision is redone
        over the surviving places, and priority-oblivious paths get a
        uniformly random live waker core (one seeded draw per task, so
        the sequence is scheduler-independent).  A sharded control plane
        passes ``waker`` explicitly — it draws the core from the *global*
        live set before routing to the owning shard."""
        task.t_ready = self.now()
        task.bound_place = None
        if waker is None:
            live = self.live_cores()
            rng = self.sched.rng
            waker = (live[rng.randrange(len(live))] if len(live) > 1
                     else live[0])
        target = self.sched.place_on_wake(task, waker)
        core = waker if target is None else target
        if self.track_load:
            # any in-flight charge from the displaced assignment is void
            self.discharge(task)
            self._stamp_load_est(task, core)
        return core

    # -- outstanding-work accounting (queue-aware placement) ------------------
    def estimate_seconds(self, task_type: TaskType, place: ExecutionPlace) \
            -> float:
        """Expected execution seconds of (type, place): the PTT entry, or
        the type's cost-model prior while the entry is unexplored (a cold
        table must still produce a usable backlog signal)."""
        est = self.sched.ptt.for_type(task_type.name).get(place)
        if est > 0.0:
            return est
        st = task_type.serial_time
        if not st:
            return 0.0
        kind = self.sched.topology.partition_of(place.leader).kind
        if kind in st:
            try:
                return task_type.duration(kind, place.width)
            except Exception:
                return st[kind] / place.width
        return min(st.values())

    def _stamp_load_est(self, task: Task, core: int) -> None:
        """Stamp the estimate the WSQ accounting will carry while the task
        sits queued: the bound place's expectation for HIGH tasks, the
        width-1 expectation at the receiving core otherwise."""
        place = task.bound_place
        if place is None:
            try:
                place = self.sched.topology.place_at(core, 1)
            except Exception:
                task.load_est = 0.0
                return
        task.load_est = self.estimate_seconds(task.type, place)

    def discharge(self, task: Task) -> None:
        """Drop the running-work charge of ``task`` if one is held — called
        at commit/fail feedback and by engine paths that abandon a placed
        task without either (hedge losers, suppressed commits, cancelled
        copies).  Idempotent."""
        if not self.track_load:
            return
        with self._load_lock:
            ch = self._run_charges.pop(task.tid, None)
            if ch is not None:
                cores, est = ch
                for c in cores:
                    self._running_s[c] -= est

    def place_load(self) -> np.ndarray:
        """Per-place outstanding estimated seconds (queued + running),
        aligned with ``topology.places()``.  A molded place starts when its
        most-backlogged member drains, so wide places take the max over
        member cores — one gather + row-max over the per-core vector
        (max is exact, so this matches the old per-place loop bit-for-bit)."""
        load = self.queues.queued_s + self._running_s
        out = load[self._place_gather].max(axis=1)
        return np.maximum(out, 0.0)

    def load_per_core(self) -> np.ndarray:
        """Per-core outstanding estimated seconds (queued + running)."""
        return np.maximum(self.queues.queued_s + self._running_s, 0.0)

    def backlog_signal(self) -> float:
        """Mean outstanding estimated seconds per *live* core — the load
        signal the serving brownout ladder thresholds on."""
        live = self.live_cores()
        load = self.queues.queued_s + self._running_s
        return max(float(load[list(live)].sum()), 0.0) / max(len(live), 1)

    def prime_ptt(self, task_type: TaskType, estimate: float = None) -> int:
        """Explicit PTT warmup: seed every unexplored place of ``task_type``
        with a prior (the type's cost model per place, or ``estimate``), so
        a cold table does not herd early arrivals onto one unexplored place
        at a time.  Primed entries are weak priors — the first real
        observation overwrites them directly.  Returns the number of
        entries primed."""
        tbl = self.sched.ptt.for_type(task_type.name)
        n = 0
        for place in self.sched.topology.places():
            val = (self.estimate_seconds(task_type, place)
                   if estimate is None else float(estimate))
            if val > 0.0 and tbl.prime(place, val):
                n += 1
        return n

    # -- dequeue / steal (steps 3-5) -----------------------------------------
    def on_steal(self, task: Task) -> None:
        """A stolen task's binding decision is redone at the thief."""
        task.bound_place = None

    def form_dispatch(self, task: Task, core: int) -> Task:
        """Continuous batching at the dequeue boundary: after an engine
        pops ``task`` from ``core``'s WSQ, coalesce queued tasks sharing
        its ``batch_key`` into it (oldest first, up to ``max_batch``
        total) and re-type the dispatch via :meth:`TaskType.batched`.

        The re-typed dispatch then flows through the *unchanged* single-
        task machinery — one :meth:`choose_place` search, one run charge,
        one DES duration lookup, and one PTT observation, all against the
        batched type — which is exactly the amortization continuous
        batching buys.  Members' own lifecycle resumes at the dispatch's
        commit (:meth:`batch_feedback` + per-member successor walks).
        No-op unless ``self.batching`` is set and the task carries a
        batch key; re-forming a dispatch that already holds members (a
        preempted or retried batch popped again) only tops it up to
        ``max_batch``."""
        cfg = self.batching
        if cfg is None or task.batch_key is None:
            return task
        existing = task.batch_members or []
        room = cfg.max_batch - 1 - len(existing)
        if room <= 0:
            return task
        members = self.queues.coalesce_batch(core, task.batch_key, room)
        if members:
            task.batch_members = existing + members
            base = task.type
            if base.batch_base is not None:
                # already re-typed on a previous pop; rescale from a
                # member's base type so the bucket tracks the new size
                base = members[0].type
            task.type = base.batched(1 + len(task.batch_members),
                                     cfg.member_cost)
        return task

    def batch_feedback(self, task: Task, place: ExecutionPlace,
                       observed: float) -> None:
        """Commit feedback for a batched dispatch: one PTT observation on
        the dispatch's batch-bucketed type (the learner sees batched
        throughput per size class), plus a discharge per member — members
        hold no run charges of their own (their queued charges were
        dropped at coalesce time), but a displaced-then-coalesced member
        may, and discharge is idempotent either way."""
        self.ptt_feedback(task, place, observed)
        if task.batch_members:
            for m in task.batch_members:
                self.discharge(m)

    def choose_place(self, task: Task, worker_core: int) -> ExecutionPlace:
        """Final execution place chosen by the worker that will run it
        (re-runs the local width search after a steal, steps 4-5)."""
        place = self.sched.place_on_dequeue(task, worker_core)
        if self.track_load:
            # the task left the WSQ (pop already dropped its queued charge);
            # charge its expected duration to every member core until the
            # commit/fail/requeue discharge
            self.discharge(task)
            est = self.estimate_seconds(task.type, place)
            cores = tuple(place.cores)
            with self._load_lock:
                self._run_charges[task.tid] = (cores, est)
                for c in cores:
                    self._running_s[c] += est
        return place

    # -- commit (step 8): measurement + PTT feedback + dependents ------------
    def observe_simulated(self, task_type: TaskType, duration: float) -> float:
        """The DES's measurement model: multiplicative noise (clamped to
        [0.5, 2]) plus heavy-tailed OS-jitter spikes on short tasks.  The
        threaded engine has no business here — it measures real wall
        time."""
        rng = self.sched.rng
        noise = rng.gauss(1.0, task_type.noise) if task_type.noise else 1.0
        observed = duration * min(max(noise, 0.5), 2.0)
        if task_type.spike_prob and rng.random() < task_type.spike_prob:
            observed *= task_type.spike_mag
        return observed

    def ptt_feedback(self, task: Task, place: ExecutionPlace,
                     observed: float) -> None:
        self.discharge(task)
        ptt_observe(self.sched.ptt, task.type.name, place, observed)

    # -- fault recovery (see ``repro.core.faults``) ---------------------------
    def expected_duration(self, task: Task, place: ExecutionPlace) -> float:
        """PTT-expected execution time for (type, place); 0.0 means the
        place is unexplored (straggler detection stays silent until the
        table has an expectation to compare against)."""
        return self.sched.ptt.for_type(task.type.name).get(place)

    def fault_feedback(self, task: Task, place: ExecutionPlace,
                       elapsed: float, penalty: float) -> None:
        """Penalize a failing place in the PTT so the retry's re-placement
        avoids it: fold in ``penalty`` x the worse of (time lost on the
        failure, current expectation) — a failure is evidence the place is
        unhealthy, not just slow."""
        self.discharge(task)
        tbl = self.sched.ptt.for_type(task.type.name)
        obs = max(elapsed, tbl.get(place)) * penalty
        if obs > 0.0:
            ptt_observe(self.sched.ptt, task.type.name, place, obs)

    def hedge_place(self, task: Task, exclude_cores, rng) -> \
            Optional[ExecutionPlace]:
        """PTT-best live place for a speculative duplicate that shares no
        core with the straggling original (``exclude_cores``), or None if
        no such place survives.  Tie-breaks draw from the dedicated fault
        ``rng``, never the scheduler's streams."""
        view = self.sched.live
        live = set(self._all_cores if view is None else view.cores)
        tbl = self.sched.ptt.for_type(task.type.name)
        cand = [p for p in self.sched.topology.places()
                if live.issuperset(p.cores)
                and not exclude_cores.intersection(p.cores)]
        if not cand:
            return None
        return tbl.best(cand, cost=False, rng=rng)

    def commit_successors(self, task: Task, lock=None) -> Iterator[Task]:
        """Yield the tasks a commit makes ready, in wake order: dependents
        whose last input this was (in child order), then dynamically
        inserted zero-dep tasks from ``on_commit``.  ``lock`` (threaded
        engine) guards each dependency decrement — parents committing
        concurrently may share a child."""
        for child in task.children:
            if lock is None:
                child.n_deps -= 1
                ready = child.n_deps == 0
            else:
                with lock:
                    child.n_deps -= 1
                    ready = child.n_deps == 0
            if ready:
                yield child
        if task.on_commit is not None:
            for new_task in task.on_commit(task):
                if new_task.n_deps == 0:
                    yield new_task

    def set_availability(self, down_cores: frozenset) -> None:
        """Refresh the scheduler's live view for a revoked core set (the
        engines call this at revoke/restore edges; views are interned on
        the topology).  An empty set clears the mask entirely."""
        self.sched.live = (None if not down_cores else
                           self.sched.topology.live_view_cores(down_cores))

    def end_run(self) -> None:
        """A run that finishes mid-outage must not leak its availability
        mask into later runs reusing the scheduler (PTT state is meant to
        carry across runs; a revoked-capacity view is not)."""
        self.sched.live = None


def split_by_priority(tasks: Iterable[Task]) -> tuple[list[Task], list[Task]]:
    """Partition displaced work for HIGH-first re-placement: the critical
    path re-binds before the bulk work lands on the survivors."""
    high: list[Task] = []
    low: list[Task] = []
    for t in tasks:
        (high if t.priority == Priority.HIGH else low).append(t)
    return high, low
