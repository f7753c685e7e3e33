"""Real threaded executor — the XiTAO analogue running actual payloads.

Unlike the simulator, nothing here uses cost models: workers execute the
task's ``payload(width)`` callable (typically a jitted JAX kernel), measure
wall time, and feed the *measured* time into the PTT.  Scheduling decisions
come from the same :class:`~.lifecycle.SchedulingKernel` (split
HIGH-FIFO/LOW-LIFO work-stealing queues, assembly queues, seeded
steal-victim selection, wake/requeue placement, PTT feedback) that drives
the discrete-event simulator — this module is only the *threaded driver*:
worker threads, barriers, wall-clock time, and payload execution.  Feature
parity with the DES therefore holds by construction: priority-aware
dequeue, seeded tie-break streams (``ptt_tiebreak="seeded"``,
``ptt_revisit``), LiveView-masked placement, and revocation.

Interference can be injected for tests/demos via ``slowdown``: a mapping
core -> factor; a worker on a slowed core sleeps ``duration*(factor-1)``
after the payload, emulating a co-runner stealing cycles.  (On this
container there is a single physical CPU, so *physical* contention cannot
demonstrate asymmetry; injected slowdown exercises the identical code
paths the scheduler would see on real hardware.)

Molded execution: the leader runs the payload; member cores block on the
task barrier for its duration (XiTAO's simplification: "each entry of the
PTT keeps track of the execution time of the task, as observed by the
leader core").

Open-loop serving mode
----------------------
``start()`` launches the workers immediately and keeps them alive while
requests trickle in (continuous submission); ``drain(timeout)`` stops
accepting, waits for the queues to empty, and returns the metrics.  The
batch-mode ``submit(dag); run()`` path is unchanged (it is exactly
``start-without-accepting`` + ``drain``).

Wall-clock preemption
---------------------
An optional :class:`~.preemption.PreemptionModel` attaches revoke/restore
episodes whose times are interpreted as *wall seconds since run start*,
fired by a timer thread.  At a revoke edge (all under the runtime lock):

1. the partition's cores are marked down and the scheduler receives the
   interned :class:`~.places.LiveView`, so every subsequent wake-time
   search is restricted to surviving places;
2. placed-but-unstarted assignments in the partition's AQs are cancelled
   and their tasks displaced; the partition's WSQs drain;
3. displaced work re-places on the survivors **HIGH tasks first** via the
   kernel's requeue path (the critical path recovers before bulk work);
4. *running* payloads cannot be killed (they are Python frames on worker
   threads) — they get a grace window, exactly the 30-second spot-VM
   signature: the assignment's ``revoked`` event is set, and a
   *cooperative* payload may checkpoint by returning the fraction of its
   outstanding work completed (a float in [0, 1)).  Under
   ``preempt="checkpoint"`` that fraction folds into ``task.resume_frac``
   (which the payload honors on its next execution by skipping completed
   work); under ``"restart"`` the partial progress is discarded and
   counted in ``work_lost_s``.  Non-cooperative payloads simply finish
   and commit — work done during the grace window is work kept.

At a restore edge the cores re-enter the worker loop and steal their way
back to work.  With no model attached every preemption code path is
behind a ``None`` check.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .dag import DAG
from .faults import FaultModel, FaultState, RecoveryPolicy
from .lifecycle import split_by_priority
from .metrics import RunMetrics, TaskRecord
from .preemption import PreemptionModel
from .queues import BatchingConfig
from .schedulers import Scheduler
from .shards import ShardingSpec, make_control_plane
from .task import Priority, Task


class _Assigned:
    __slots__ = ("task", "place", "barrier", "started", "done", "cancelled",
                 "revoked", "partial", "fault", "error", "straggle_flagged")

    def __init__(self, task, place):
        self.task = task
        self.place = place
        self.barrier = threading.Barrier(place.width)
        self.started = False            # some member pulled it (uncancellable)
        self.done = threading.Event()
        self.cancelled = False          # displaced by a revoke before start
        self.revoked = threading.Event()   # cooperative-checkpoint signal
        self.partial = None             # fraction done when preempted, else None
        self.fault = None               # armed injected fail-stop, else None
        self.error = None               # real payload exception, else None
        self.straggle_flagged = False   # straggler monitor saw it already


class ThreadedRuntime:
    def __init__(self, scheduler: Scheduler, *,
                 slowdown: Optional[dict[int, float]] = None,
                 idle_sleep: float = 2e-3,
                 preemption: Optional[PreemptionModel] = None,
                 faults: Optional[FaultModel] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 supervisor=None,
                 sharding: Optional[ShardingSpec] = None,
                 batching: Optional[BatchingConfig] = None):
        # idle_sleep is only a fallback poll: every work arrival (wake,
        # assignment, requeue, restore) notifies the condition variable,
        # so idle workers do not need a tight poll — 1e-4 here made eight
        # idle workers busy-poll the lock at 10 kHz and starve the
        # payloads themselves on small containers
        self.sched = scheduler
        self.topo = scheduler.topology
        # the control plane: the flat kernel, or one kernel per shard
        # behind the sharded plane (see core/shards.py).  Decision
        # *latency* here is real wall time — the worker threads pay it
        # inside the runtime lock — so unlike the DES nothing is modeled;
        # the rebalancer runs on its own timer thread.
        self.sharding = sharding
        self.kernel = make_control_plane(scheduler, now=self._now,
                                         sharding=sharding)
        self.queues = self.kernel.queues
        # continuous batching: a max_batch=1 config is the disabled path
        # by definition (the degeneracy pin), so normalize it to None here
        # — every batching branch below then stays dead code
        if batching is not None and not batching.enabled:
            batching = None
        if batching is not None and faults is not None and faults.enabled:
            raise ValueError("continuous batching with fault injection is "
                             "not supported: a batched dispatch has no "
                             "per-member retry semantics")
        self.batching = batching
        self.kernel.batching = batching
        self.aq = self.queues.aq        # per-core deques of _Assigned
        self.slowdown = dict(slowdown or {})
        self.idle_sleep = idle_sleep
        self.preemption = preemption
        n = self.topo.n_cores
        self.lock = threading.Lock()
        self.work_cv = threading.Condition(self.lock)
        self.outstanding = 0
        self.t0: Optional[float] = None
        self.metrics = RunMetrics(n_cores=n)
        self.stop = False
        self._accepting = False         # True between start() and drain()
        self._started = False
        self._threads: list[threading.Thread] = []
        self._timer: Optional[threading.Thread] = None
        self._rebalance_thread: Optional[threading.Thread] = None
        self._core_up = [True] * n
        self._down_cores: set[int] = set()
        self._ckpt = (preemption is not None
                      and preemption.preempt == "checkpoint")
        self.preempt_events = 0
        self.tasks_preempted = 0
        self.work_lost = 0.0

        # fault-injection state (inert without an *enabled* FaultModel; a
        # zero-probability model is normalized away, matching the DES).
        # Running payloads cannot be killed, so a threaded hedge loser runs
        # to completion and is suppressed at commit; hedging therefore
        # requires idempotent payloads (both copies may execute fully).
        if faults is not None and not faults.enabled:
            faults = None
        self.faults = faults
        self._fx = (FaultState(faults, recovery or RecoveryPolicy())
                    if faults is not None else None)
        self._inflight: dict[int, _Assigned] = {}   # tid -> leader-started rec
        self._timers: list[threading.Timer] = []    # pending retry backoffs
        self._straggler: Optional[threading.Thread] = None
        self._dead_workers: list[int] = []
        # duck-typed repro.runtime.ft.Supervisor (kept untyped: importing
        # repro.runtime from repro.core would be circular); workers beat
        # its heartbeat every pull-loop iteration and drain() polls check()
        self.supervisor = supervisor

    def _now(self) -> float:
        return 0.0 if self.t0 is None else time.perf_counter() - self.t0

    # -- submission -----------------------------------------------------------
    def _wake(self, task: Task, waker_core: int) -> None:
        with self.work_cv:
            self._wake_locked(task, waker_core)
            self.work_cv.notify_all()

    def _wake_locked(self, task: Task, waker_core: int) -> None:
        core = self.kernel.wake(task, waker_core)
        if not self._core_up[core]:
            # a leader committing its grace-window payload on a revoked
            # partition wakes dependents — they must land on a live core
            live = self.kernel.live_cores()
            rng = self.sched.rng
            core = live[rng.randrange(len(live))] if len(live) > 1 else live[0]
        self.queues.push(task, core)
        self.outstanding += 1

    def submit(self, dag: DAG) -> None:
        if self.t0 is None:
            self.t0 = time.perf_counter()
        if self._fx is not None:
            # same deterministic BFS numbering as the DES, so both engines
            # inject identical faults on the same DAG (cross-engine parity)
            self._fx.register_dag(dag)
        for root in dag.roots:
            self._wake(root, waker_core=0)

    # -- worker ---------------------------------------------------------------
    def _pull(self, core: int) -> Optional[_Assigned]:
        with self.lock:
            # 1. own AQ head (down cores still finish work already placed
            #    on them — the grace window)
            if self.aq[core]:
                rec = self.aq[core][0]
                rec.started = True
                return rec
            if not self._core_up[core]:
                return None
            while True:
                # 2. own WSQ: oldest HIGH first under priority dequeue,
                #    else newest LOW (plain work-stealing LIFO)
                task = self.queues.pop_local(core)
                stolen = False
                if task is None:
                    # 3. steal: most-loaded victim, seeded tie-break, FIFO
                    #    end, re-run of the place search at the thief
                    victim = self.queues.pick_victim(core, self.sched.rng)
                    if victim < 0:
                        return None
                    task = self.queues.steal_pop(victim)
                    stolen = True
                if (self._fx is not None
                        and (task.hedge_of or task).committed):
                    # the losing copy of a hedged pair, parked in a WSQ
                    # when the winner committed, resolves at pop
                    self.outstanding -= 1
                    self.work_cv.notify_all()
                    continue
                if stolen:
                    self.kernel.on_steal(task)
                if self.batching is not None and task.batch_key is not None:
                    # coalesce same-key queued LOW work from the queue the
                    # leader came out of (members were pushed beside it)
                    self.kernel.form_dispatch(task,
                                              victim if stolen else core)
                return self._assign(task, core)

    def _assign(self, task: Task, core: int) -> _Assigned:
        # caller holds self.lock
        place = self.kernel.choose_place(task, core)
        rec = _Assigned(task, place)
        for c in place.cores:
            self.aq[c].append(rec)
        self.work_cv.notify_all()
        head = self.aq[core][0]
        head.started = True
        return head

    def _execute(self, rec: _Assigned, core: int) -> None:
        is_leader = core == rec.place.leader
        rec.barrier.wait()        # all members rendezvous
        if is_leader:
            t_start = self._now()
            task = rec.task
            task.t_start = t_start
            fault = None
            if self._fx is not None:
                if task.hedge_of is None:
                    # hedge duplicates run clean (they exist to escape a
                    # degraded place); originals draw per-attempt faults
                    fault = self._fx.draw(task, t_start)
                with self.lock:
                    self._inflight[task.tid] = rec
            ret = None
            if task.payload is not None:
                task.revoke_signal = rec.revoked
                try:
                    ret = task.payload(rec.place.width, *task.args)
                except Exception as e:      # a raising payload must never
                    rec.error = e           # kill the leader thread: the
                                            # members would block forever
                finally:
                    task.revoke_signal = None
            if rec.error is None and task.batch_members:
                # queue-coalesced batch members execute inside the leader's
                # dispatch (real wall time; the commit feeds the total into
                # the batched type's PTT entry)
                for m in task.batch_members:
                    if m.payload is None:
                        continue
                    try:
                        m.payload(rec.place.width, *m.args)
                    except Exception as e:
                        rec.error = e
                        break
            factor = max((self.slowdown.get(c, 1.0) for c in rec.place.cores),
                         default=1.0)
            if factor > 1.0:
                dur = self._now() - t_start
                time.sleep(dur * (factor - 1.0))
            if fault is not None and rec.error is None:
                if fault.kind == "slow":
                    # the place silently degrades from frac onward: the
                    # remaining (1-frac) of the work runs factor x slower
                    dur = self._now() - t_start
                    time.sleep(dur * (1.0 - fault.frac)
                               * (fault.factor - 1.0))
                    with self.lock:
                        self.metrics.faults_failslow += 1
                else:
                    rec.fault = fault       # fail-stop: execution failed
            rec.partial = self._partial_fraction(rec, ret)
            rec.done.set()
        else:
            rec.done.wait()
        rec.barrier.wait()
        if is_leader:
            if self._fx is not None:
                with self.lock:
                    self._inflight.pop(rec.task.tid, None)
            if rec.error is not None or rec.fault is not None:
                self._fail(rec)
            elif rec.partial is None:
                self._commit(rec)
            else:
                self._requeue_preempted(rec)

    @staticmethod
    def _partial_fraction(rec: _Assigned, ret) -> Optional[float]:
        """A cooperative payload answering a revocation signal returns the
        fraction of its *outstanding* work it completed (float in [0, 1));
        anything else — including payloads that never look at the signal —
        means the task ran to completion."""
        if (rec.revoked.is_set() and isinstance(ret, float)
                and 0.0 <= ret < 1.0):
            return ret
        return None

    def _requeue_preempted(self, rec: _Assigned) -> None:
        """A checkpointed (or killed-and-restarted) payload: account its
        progress and hand the task back to the scheduler over the live
        view.  ``outstanding`` is untouched — the task is still pending."""
        task = rec.task
        if self._fx is not None and (task.hedge_of or task).committed:
            # a checkpointing hedge loser: the winner already committed
            # the logical task, so the checkpoint is worthless
            self._suppress(rec)
            return
        dur = self._now() - task.t_start
        with self.work_cv:
            for c in rec.place.cores:
                try:
                    self.aq[c].remove(rec)
                except ValueError:
                    pass
            if self._ckpt:
                # completed fraction of this attempt carries over; the
                # payload reads task.resume_frac on its next execution.
                # The resume penalty folds in here as extra outstanding
                # work, mirroring the DES charging full*(resume_frac +
                # penalty) at the next start (a near-zero-progress
                # checkpoint costs slightly more than its remainder, in
                # both engines).
                penalty = (self.preemption.resume_penalty
                           if self.preemption is not None else 0.0)
                task.resume_frac = (task.resume_frac * (1.0 - rec.partial)
                                    + penalty)
            else:
                self.work_lost += dur
            task.preempt_count += 1
            self.tasks_preempted += 1
            self.queues.push(task, self.kernel.requeue_displaced(task))
            self.work_cv.notify_all()

    def _commit(self, rec: _Assigned) -> None:
        task = rec.task
        src = task              # the logical task (successors, sojourn)
        if self._fx is not None:
            with self.lock:
                logical = task.hedge_of or task
                if logical.committed:
                    won = False
                else:
                    # first copy wins; nudge the loser's cooperative
                    # payload via the existing revocation channel (it
                    # cannot be killed — it suppresses at its own commit)
                    logical.committed = True
                    won = True
                    other = (logical if task.hedge_of is not None
                             else task.hedge_dup)
                    if other is not None and task.hedge_of is not None:
                        self.metrics.hedge_wins += 1
                    if other is not None:
                        loser = self._inflight.get(other.tid)
                        if loser is not None:
                            loser.revoked.set()
            if not won:
                self._suppress(rec)
                return
            src = task.hedge_of or task
        task.t_end = self._now()
        task.place = rec.place
        observed = task.t_end - task.t_start
        members = task.batch_members or ()
        with self.lock:
            # feedback rides the runtime lock: an online reshard() swaps
            # the plane's shard routing under this same lock, and the
            # routing read (kernels[shard_of_core[leader]]) must not
            # interleave with the swap
            if members:
                self.kernel.batch_feedback(task, rec.place, observed)
            else:
                self.kernel.ptt_feedback(task, rec.place, observed)
            for c in rec.place.cores:
                # remove this record from each member AQ (it is at/near head)
                try:
                    self.aq[c].remove(rec)
                except ValueError:
                    pass
            self.metrics.record(TaskRecord(
                type_name=task.type.name, priority=int(task.priority),
                leader=rec.place.leader, width=rec.place.width,
                t_ready=src.t_ready, t_start=task.t_start, t_end=task.t_end))
            if members:
                base = task.type.batch_base or task.type.name
                self.metrics.batches.append((task.type.name, tuple(sorted(
                    [base] + [m.type.name for m in members]))))
                for m in members:
                    m.t_start, m.t_end, m.place = (task.t_start, task.t_end,
                                                   rec.place)
        for ready in self.kernel.commit_successors(src, lock=self.lock):
            self._wake(ready, rec.place.leader)
        for m in members:
            for ready in self.kernel.commit_successors(m, lock=self.lock):
                self._wake(ready, rec.place.leader)
        with self.work_cv:
            self.outstanding -= 1 + len(members)
            self.work_cv.notify_all()

    # -- fault recovery (see ``core/faults.py``) ------------------------------
    def _fail(self, rec: _Assigned) -> None:
        """A failed execution — real payload exception or injected
        fail-stop.  Same recovery as the DES: PTT-penalize the failing
        place, retry after a seeded backoff, or fail permanently once the
        attempt budget is spent.  Hedge copies never retry."""
        task = rec.task
        dur = self._now() - task.t_start
        with self.lock:                 # vs reshard(): see _commit
            self.kernel.discharge(task)  # fault_feedback also discharges,
                                         # but a real payload exception with
                                         # no fault model must not leak load
            if self._fx is not None:
                self.kernel.fault_feedback(task, rec.place, dur,
                                           self._fx.policy.fail_penalty)
        with self.work_cv:
            for c in rec.place.cores:
                try:
                    self.aq[c].remove(rec)
                except ValueError:
                    pass
            if rec.fault is not None:
                self.metrics.faults_failstop += 1
                # the strike point was at frac of the work; only that
                # share of the wall time is work actually lost
                self.metrics.work_lost_faults_s += dur * rec.fault.frac
            else:
                # a real payload exception rides the same recovery path
                # but is not an *injected* fault — it is surfaced instead
                self.metrics.work_lost_faults_s += dur
                self.metrics.errors.append(
                    f"task {task.tid} ({task.type.name}) payload raised "
                    f"{type(rec.error).__name__}: {rec.error}")
            task.fault_count += 1
            if task.hedge_of is not None:
                # a speculative duplicate died; the original carries on
                task.hedge_of.hedge_dup = None
                self.outstanding -= 1
                self.work_cv.notify_all()
                return
            if task.hedge_dup is not None and not task.committed:
                # the original died with its duplicate still in flight —
                # leave recovery to the copy on the healthier place
                self.outstanding -= 1
                self.work_cv.notify_all()
                return
            can_retry = (self._fx is not None
                         and task.fault_count <= self._fx.policy.max_retries)
            if not can_retry:
                self.metrics.failed_tasks += 1
                self.metrics.errors.append(
                    f"task {task.tid} ({task.type.name}) failed permanently "
                    f"after {task.fault_count - 1} retries")
                # a batched dispatch (payload exception path; fault
                # injection is excluded up front) resolves its members too
                self.outstanding -= 1 + len(task.batch_members or ())
                self.work_cv.notify_all()
                return
            self.metrics.retries += 1
            timer = threading.Timer(self._fx.backoff(task), self._retry,
                                    args=(task,))
            timer.daemon = True
            self._timers.append(timer)
            timer.start()

    def _retry(self, task: Task) -> None:
        """Backoff expired: hand the failed task back to the scheduler
        over the live view (its failing place now PTT-penalized)."""
        with self.work_cv:
            if task.committed or self.stop:
                # the hedge twin won while we backed off, or the runtime
                # is shutting down — either way this copy resolves here
                self.outstanding -= 1
                self.work_cv.notify_all()
                return
            self.queues.push(task, self.kernel.requeue_displaced(task))
            self.work_cv.notify_all()

    def _suppress(self, rec: _Assigned) -> None:
        """The losing copy of a hedged pair ran to completion (or
        checkpointed) after the winner committed — running payloads
        cannot be killed, so the loser is dropped here and its wall time
        accounted as the hedge premium."""
        with self.lock:                 # vs reshard(): see _commit
            self.kernel.discharge(rec.task)
        dur = self._now() - rec.task.t_start
        with self.work_cv:
            for c in rec.place.cores:
                try:
                    self.aq[c].remove(rec)
                except ValueError:
                    pass
            self.metrics.work_hedged_s += dur
            self.outstanding -= 1
            self.work_cv.notify_all()

    def _straggler_driver(self) -> None:
        """Monitor thread: flag executions past ``k`` x their PTT
        expectation; launch a speculative duplicate for flagged HIGH
        tasks on the PTT-best place disjoint from the straggler's (the
        DES schedules exact straggle events instead of polling)."""
        pol = self._fx.policy
        while True:
            time.sleep(pol.straggler_poll_s)
            with self.lock:
                if self.stop:
                    return
                now = self._now()
                inflight = list(self._inflight.values())
            for rec in inflight:
                task = rec.task
                if (rec.done.is_set() or rec.straggle_flagged
                        or task.hedge_of is not None):
                    continue
                with self.lock:         # vs reshard(): see _commit
                    exp = self.kernel.expected_duration(task, rec.place)
                if exp <= 0.0 or now - task.t_start < pol.straggler_k * exp:
                    continue
                rec.straggle_flagged = True
                with self.lock:
                    self.metrics.stragglers += 1
                if (not pol.hedge or task.priority != Priority.HIGH
                        or task.hedge_launched or task.committed):
                    continue
                with self.lock:         # vs reshard(): see _commit
                    place = self.kernel.hedge_place(task,
                                                    set(rec.place.cores),
                                                    self._fx.hedge_rng)
                if place is None:
                    continue
                with self.work_cv:
                    if task.committed or task.hedge_launched:
                        continue
                    task.hedge_launched = True
                    dup = Task(type=task.type, priority=task.priority,
                               payload=task.payload)
                    dup.hedge_of = task
                    dup.bound_place = place   # honored at dequeue
                    task.hedge_dup = dup
                    dup.t_ready = now
                    self.metrics.hedges_launched += 1
                    self.outstanding += 1
                    self.queues.push(dup, place.leader)
                    self.work_cv.notify_all()

    def _worker(self, core: int) -> None:
        try:
            self._worker_loop(core)
        except BaseException as e:          # surface, never die silently:
            with self.work_cv:              # drain() reports the death
                self._dead_workers.append(core)
                self.metrics.errors.append(
                    f"worker {core} died: {type(e).__name__}: {e}")
                self.work_cv.notify_all()

    def _worker_loop(self, core: int) -> None:
        sup = self.supervisor
        while True:
            if sup is not None:
                sup.heartbeat.beat(core)
            with self.lock:
                if self.stop:
                    return
            rec = self._pull(core)
            if rec is None:
                with self.work_cv:
                    if self.stop or (self.outstanding == 0
                                     and not self._accepting):
                        return
                    self.work_cv.wait(timeout=self.idle_sleep)
                continue
            if not rec.done.is_set() or core == rec.place.leader:
                self._execute(rec, core)

    # -- wall-clock preemption ------------------------------------------------
    def _preemption_driver(self) -> None:
        """Timer thread: fire revoke/restore edges at their wall-clock
        offsets from run start (restores sort before revokes at equal
        times, like the DES event queue)."""
        edges = sorted(
            [(t0, 1, i) for i, (_, t0, _) in enumerate(self.preemption.episodes)]
            + [(t1, 0, i) for i, (_, _, t1) in enumerate(self.preemption.episodes)])
        for t, is_revoke, eidx in edges:
            while not self.stop:
                dt = t - self._now()
                if dt <= 0:
                    break
                time.sleep(min(dt, 0.01))
            if self.stop:
                return
            with self.work_cv:
                if is_revoke:
                    self._revoke_locked(eidx)
                else:
                    self._restore_locked(eidx)
                self.work_cv.notify_all()

    def _revoke_locked(self, eidx: int) -> None:
        cores = self.preemption.cores_of(eidx, self.topo)
        self._down_cores.update(cores)
        self.kernel.set_availability(frozenset(self._down_cores))
        for c in cores:
            self._core_up[c] = False
        self.preempt_events += 1
        displaced: list[Task] = []
        # placed-but-unstarted assignments lose their place (no member has
        # entered the barrier, so cancelling cannot strand anyone); started
        # ones get the cooperative revocation signal and their grace window
        seen: set[int] = set()
        down_set = set(cores)
        for c in cores:
            for rec in self.aq[c]:
                if rec.started:
                    rec.revoked.set()
                elif not rec.cancelled:
                    rec.cancelled = True
                    if rec.task.tid not in seen:
                        seen.add(rec.task.tid)
                        displaced.append(rec.task)
            kept = [r for r in self.aq[c] if not r.cancelled]
            self.aq[c].clear()
            self.aq[c].extend(kept)
        # a sub-pod revocation may leave a cancelled record's copies in
        # *live* siblings' AQs — prune them there too
        if seen:
            for c in set(self.topo.partition_of(cores[0]).cores) - down_set:
                if any(r.cancelled for r in self.aq[c]):
                    kept = [r for r in self.aq[c] if not r.cancelled]
                    self.aq[c].clear()
                    self.aq[c].extend(kept)
        # ready tasks drain in steal order; HIGH tasks re-place first
        displaced.extend(self.queues.drain_wsq(cores))
        high, low = split_by_priority(displaced)
        for task in high:
            self.queues.push(task, self.kernel.requeue_displaced(task))
        for task in low:
            self.queues.push(task, self.kernel.requeue_displaced(task))

    def _restore_locked(self, eidx: int) -> None:
        self._down_cores.difference_update(
            self.preemption.cores_of(eidx, self.topo))
        self.kernel.set_availability(frozenset(self._down_cores))
        for c in self.preemption.cores_of(eidx, self.topo):
            self._core_up[c] = True

    # -- cross-shard rebalancing ----------------------------------------------
    def _rebalance_driver(self) -> None:
        """Timer thread: run one deterministic rebalance round (the same
        :class:`~.shards.GlobalRebalancer` plan the DES executes) every
        ``rebalance_period_s`` wall seconds; migrated tasks land on their
        destination shard immediately — the overhead here is the real
        time the round takes under the lock."""
        period = self.sharding.rebalance_period_s
        t_next = self._now() + period
        while not self.stop:
            dt = t_next - self._now()
            if dt > 0:
                time.sleep(min(dt, 0.02))
                continue
            with self.work_cv:
                if self.stop:
                    return
                if self.outstanding > 0:
                    for task, dst in self.kernel.rebalancer.plan_round():
                        self.queues.push(task,
                                         self.kernel.migrate_in(task, dst))
                    self.work_cv.notify_all()
            t_next = self._now() + period

    def reshard(self, pods_per_shard: int) -> int:
        """Online re-sharding (sharded control plane only): regroup the
        pods into shards of ``pods_per_shard`` mid-run and land the
        rebalancer's catch-up migration round immediately.  Returns the
        number of tasks migrated by that round."""
        if getattr(self.kernel, "n_shards", 1) <= 1:
            raise ValueError("reshard() requires a sharded control plane")
        with self.work_cv:
            moves = self.kernel.reshard(pods_per_shard)
            for task, dst in moves:
                self.queues.push(task, self.kernel.migrate_in(task, dst))
            self.work_cv.notify_all()
        return len(moves)

    # -- run ------------------------------------------------------------------
    def _launch(self) -> None:
        if self._started:
            return
        self._started = True
        if self.t0 is None:
            self.t0 = time.perf_counter()
        self._threads = [
            threading.Thread(target=self._worker, args=(c,), daemon=True)
            for c in range(self.topo.n_cores)]
        for th in self._threads:
            th.start()
        if self.preemption is not None and self.preemption.episodes:
            self._timer = threading.Thread(target=self._preemption_driver,
                                           daemon=True)
            self._timer.start()
        if (getattr(self.kernel, "n_shards", 1) > 1
                and self.sharding.rebalance_period_s > 0.0):
            self._rebalance_thread = threading.Thread(
                target=self._rebalance_driver, daemon=True)
            self._rebalance_thread.start()
        if self._fx is not None:
            self._straggler = threading.Thread(target=self._straggler_driver,
                                               daemon=True)
            self._straggler.start()

    def start(self) -> None:
        """Open-loop mode: launch workers now and keep accepting
        submissions until :meth:`drain`."""
        self._accepting = True
        self._launch()

    def drain(self, timeout: float = 120.0) -> RunMetrics:
        """Stop accepting work, wait for the queues to empty (or the
        deadline), shut the workers down and return the metrics.  A
        worker-thread death or a timeout is *surfaced* in
        ``metrics.errors`` — an empty list is the "this run is
        trustworthy" signal; partial data never returns silently."""
        deadline = time.monotonic() + timeout
        step = 0
        with self.work_cv:
            self._accepting = False
            self.work_cv.notify_all()
            while self.outstanding > 0 and time.monotonic() < deadline:
                if self._dead_workers:
                    # a dead worker strands its barrier partners: no
                    # progress is coming, so bail out now, not at timeout
                    break
                self.work_cv.wait(timeout=0.05)
                if self.supervisor is not None:
                    step += 1
                    self.supervisor.check(step)
            if self.outstanding > 0:
                self.metrics.errors.append(
                    f"drain incomplete: {self.outstanding} tasks still "
                    f"outstanding"
                    + (f", workers {sorted(self._dead_workers)} dead"
                       if self._dead_workers else ""))
            self.stop = True
            self.work_cv.notify_all()
        for t in self._timers:
            t.cancel()              # pending retry backoffs die with the run
        for th in self._threads:
            th.join(timeout=5.0)
        if self._timer is not None:
            # a revoke edge racing the end of the run must land (or bail
            # on stop) *before* end_run clears the availability mask —
            # otherwise it would re-poison sched.live for a later run
            self._timer.join(timeout=5.0)
        if self._straggler is not None:
            self._straggler.join(timeout=5.0)
        if self._rebalance_thread is not None:
            self._rebalance_thread.join(timeout=5.0)
        if self.supervisor is not None:
            self.supervisor.check(step + 1)
            self.metrics.recovery_events.extend(
                f"{e.kind}@{e.step}: {e.detail}"
                for e in self.supervisor.events)
        self.kernel.end_run()
        self.metrics.finish(self._now())
        self.metrics.preempt_events = self.preempt_events
        self.metrics.tasks_preempted = self.tasks_preempted
        self.metrics.work_lost_s = self.work_lost
        if getattr(self.kernel, "n_shards", 1) > 1:
            self.metrics.migrations = self.kernel.migrations
            self.metrics.overflow_migrations = self.kernel.overflow_migrations
            self.metrics.rebalance_rounds = self.kernel.rebalance_rounds
            self.metrics.migrated_load_s = self.kernel.migrated_load_s
            self.metrics.reshard_rounds = self.kernel.reshard_rounds
        return self.metrics

    def run(self, timeout: float = 120.0) -> RunMetrics:
        """Batch mode: run everything already submitted to completion."""
        self._launch()
        return self.drain(timeout=timeout)


def run_threaded(dag: DAG, scheduler: Scheduler, *,
                 slowdown: Optional[dict[int, float]] = None,
                 preemption: Optional[PreemptionModel] = None,
                 faults: Optional[FaultModel] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 supervisor=None,
                 sharding: Optional[ShardingSpec] = None,
                 batching: Optional[BatchingConfig] = None,
                 timeout: float = 120.0) -> RunMetrics:
    rt = ThreadedRuntime(scheduler, slowdown=slowdown, preemption=preemption,
                         faults=faults, recovery=recovery,
                         supervisor=supervisor, sharding=sharding,
                         batching=batching)
    rt.submit(dag)
    return rt.run(timeout=timeout)
