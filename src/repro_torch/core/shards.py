"""Sharded control plane: hierarchical per-pod scheduling kernels under a
global rebalancer.

The flat :class:`~.lifecycle.SchedulingKernel` makes every scheduling
decision through one scheduler over the whole machine.  That is exactly
the paper's XiTAO shape — and it stops scaling when the machine is a
*fleet*: one PTT argmin sweeps every place in the system per HIGH wake,
one steal scan walks every core, and (once scheduler overhead is modeled
at all) every decision serializes through a single logical decision
server.  This module splits the control plane:

* each **shard** — a consecutive group of ``pods_per_shard`` partitions —
  owns a full :class:`~.lifecycle.SchedulingKernel` over a *cloned*
  scheduler (its own PTT bank and decision streams) whose
  :class:`~.places.LiveView` permanently fences it to the shard's cores,
  so wake/dequeue searches sweep only local places and never race other
  shards' decisions;
* all shards share one :class:`~.queues.WorkQueues` whose *steal groups*
  fence the victim scans (a thief only victimizes its own shard), so the
  per-core queue structures the execution engines index stay exactly as
  they were;
* a :class:`GlobalRebalancer` periodically moves *queued* work between
  shards on load imbalance — HIGH tasks first, priced in the same
  PTT-estimated-seconds currency as queue-aware placement — and wake-time
  *overflow* redirects route new work away from a drowning shard
  synchronously.

``ShardedControlPlane`` duck-types the full kernel interface, so both
execution engines (``simulator.py``, ``runtime.py``) drive it through the
methods they already call.  Decision *latency* is an engine concern: the
DES models per-shard single-server decision queues and charges
``ShardingSpec.decision_s`` per local wake (the flat kernel is then one
saturating server, the sharded plane N of them — the crossover
``bench_scale`` sweeps); the threaded runtime's overhead is real wall
time and needs no model.

``make_control_plane`` degenerates to the *plain* kernel whenever the
grouping yields a single shard, so ``sharding=None`` and
one-shard-zero-overhead specs are literally the flat code path —
bit-identical, which the golden pins and the equivalence pin check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from .lifecycle import SchedulingKernel
from .places import ExecutionPlace
from .queues import WorkQueues
from .schedulers import Scheduler
from .task import Task, TaskType

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ShardingSpec:
    """How to shard the control plane and what its decisions cost.

    ``pods_per_shard`` groups consecutive partitions into shards (a value
    >= the partition count means one shard — the flat kernel).  The
    ``*_s`` fields are *modeled* scheduler overheads, applied by the DES
    only: ``decision_s`` per local wake decision (each shard is a
    single-server decision queue), ``rebalance_decision_s`` per rebalance
    round, ``migration_s`` per migrated task (both added to the migrated
    task's re-arrival time).  ``rebalance_period_s`` spaces rebalance
    rounds (0 disables them); ``imbalance_ratio`` is the hottest/coldest
    outstanding-seconds ratio that triggers migration;
    ``overflow_ratio`` (0 disables) redirects a wake away from its shard
    when that shard's backlog exceeds the fleet mean by the ratio;
    ``max_migrations_per_round`` caps one round's moves.

    Two further (default-off) rebalance triggers deepen the policy
    beyond total-load imbalance:

    * ``high_pressure_ratio`` (0 disables; else >= 1) — criticality
      pressure: a shard whose queued *HIGH* seconds exceed the ratio
      times the live-shard mean HIGH backlog sheds HIGH tasks to the
      shard with the least HIGH backlog, even when total load looks
      balanced.  HIGH tasks gate the DAG, so a HIGH pile-up delays the
      critical path invisibly to the total-load trigger.
    * ``ptt_divergence_ratio`` (0 disables; else >= 1) — per-shard PTTs
      are learned independently; when the slowest-learned shard's mean
      best measured estimate (over task types every live shard has
      explored) exceeds the ratio times the fastest-learned shard's,
      queued work shifts toward the faster shard, which will drain it
      sooner regardless of current queue lengths.

    Both triggers share ``max_migrations_per_round`` with the imbalance
    pass and draw no randomness, so ``plan_round`` stays a deterministic
    pure function of queue + PTT state (the cross-engine parity pin).
    """

    pods_per_shard: int = 1
    decision_s: float = 0.0
    rebalance_period_s: float = 0.0
    rebalance_decision_s: float = 0.0
    migration_s: float = 0.0
    imbalance_ratio: float = 2.0
    overflow_ratio: float = 0.0
    max_migrations_per_round: int = 8
    high_pressure_ratio: float = 0.0
    ptt_divergence_ratio: float = 0.0

    def __post_init__(self) -> None:
        if self.pods_per_shard < 1:
            raise ValueError(f"pods_per_shard {self.pods_per_shard} < 1")
        for f in ("decision_s", "rebalance_period_s", "rebalance_decision_s",
                  "migration_s", "overflow_ratio"):
            v = getattr(self, f)
            if not (0.0 <= v and math.isfinite(v)):
                raise ValueError(f"bad {f} {v!r}")
        if not (1.0 <= self.imbalance_ratio and
                math.isfinite(self.imbalance_ratio)):
            raise ValueError(
                f"imbalance_ratio {self.imbalance_ratio!r} must be >= 1")
        for f in ("high_pressure_ratio", "ptt_divergence_ratio"):
            v = getattr(self, f)
            if not (math.isfinite(v) and (v == 0.0 or v >= 1.0)):
                raise ValueError(f"{f} {v!r} must be 0 (off) or >= 1")
        if self.max_migrations_per_round < 1:
            raise ValueError("max_migrations_per_round must be >= 1")


class GlobalRebalancer:
    """Deterministic cross-shard migration planning, shared verbatim by
    both engines (the DES runs it at ``rebalance`` events, the threaded
    runtime on its timer thread) so migration *decisions* are a pure
    function of queue state.

    One round runs up to three deterministic passes under one shared
    move budget (``max_migrations_per_round``):

    1. **load imbalance** — repeatedly move the head of the hottest
       shard's most-backlogged WSQ — HIGH-first via
       :meth:`WorkQueues.migrate_pop` — to the coldest shard, until the
       hottest/coldest outstanding-seconds ratio drops under
       ``imbalance_ratio`` or the hot shard runs out of queued work;
    2. **criticality pressure** (``high_pressure_ratio`` > 0) — move
       queued HIGH tasks off any shard whose HIGH backlog exceeds the
       ratio times the live-shard mean, toward the least-HIGH-loaded
       shard;
    3. **PTT divergence** (``ptt_divergence_ratio`` > 0) — when the
       slowest-learned shard's mean best measured PTT estimate (over
       the task types every live shard has explored) exceeds the ratio
       times the fastest-learned shard's, shift its queued work to the
       faster shard while it remains the more loaded of the two.

    Ties break toward the lowest shard/core index; no randomness is
    drawn, so plans are a pure function of queue + PTT state shared
    verbatim by both engines.
    """

    def __init__(self, plane: "ShardedControlPlane"):
        self.plane = plane

    def _pop_from(self, shard: int, by_core: np.ndarray) -> Optional[Task]:
        """Pop one migratable task from ``shard``'s most-backlogged core
        as measured by ``by_core`` (total or HIGH-only queued seconds);
        None when nothing is queued there."""
        cp = self.plane
        cands = [c for c in cp.shard_cores[shard] if by_core[c] > _EPS]
        if not cands:
            return None
        src = max(cands, key=lambda c: (by_core[c], -c))
        return cp.queues.migrate_pop(src)

    def plan_round(self) -> list[tuple[Task, int]]:
        """Pop the tasks to migrate this round; returns ``(task,
        destination shard)`` pairs.  The popped tasks are in no queue
        until the engine lands them via :meth:`ShardedControlPlane.
        migrate_in` (after its modeled migration latency, if any)."""
        cp = self.plane
        spec = cp.spec
        live = [s for s in range(cp.n_shards) if not cp.shard_dead(s)]
        if len(live) < 2:
            return []
        cp.rebalance_rounds += 1
        loads = cp.shard_loads()
        qs = cp.queues.queued_s
        moves: list[tuple[Task, int]] = []
        budget = spec.max_migrations_per_round

        # pass 1 — total-load imbalance
        while budget > 0:
            hot = max(live, key=lambda s: (loads[s], -s))
            cold = min(live, key=lambda s: (loads[s], s))
            if hot == cold or \
                    loads[hot] <= spec.imbalance_ratio * (loads[cold] + _EPS):
                break
            task = self._pop_from(hot, qs)
            if task is None:
                break               # the hot shard's excess is all running
            moves.append((task, cold))
            loads[hot] -= task.load_est
            loads[cold] += task.load_est
            cp.migrated_load_s += task.load_est
            budget -= 1

        # pass 2 — criticality pressure (HIGH backlog per shard)
        qhs = cp.queues.queued_high_s
        if spec.high_pressure_ratio > 0.0 and budget > 0 and qhs is not None:
            high = np.array([qhs[list(cp.shard_cores[s])].sum()
                             for s in range(cp.n_shards)])
            while budget > 0:
                mean = float(high[live].mean())
                hot = max(live, key=lambda s: (high[s], -s))
                cold = min(live, key=lambda s: (high[s], s))
                if hot == cold or high[hot] <= high[cold] + _EPS or \
                        high[hot] <= spec.high_pressure_ratio * (mean + _EPS):
                    break
                # the source core has queued HIGH work, so migrate_pop
                # (HIGH-first) is guaranteed to pop a HIGH task
                task = self._pop_from(hot, qhs)
                if task is None:
                    break
                moves.append((task, cold))
                est = task.load_est
                high[hot] -= est
                high[cold] += est
                loads[hot] -= est
                loads[cold] += est
                cp.migrated_load_s += est
                budget -= 1

        # pass 3 — PTT divergence (learned-speed asymmetry)
        if spec.ptt_divergence_ratio > 0.0 and budget > 0:
            per_shard = []
            for s in live:
                bank = cp.kernels[s].sched.ptt
                per_shard.append({name: tbl.best_explored()
                                  for name, tbl in bank})
            shared = sorted(set.intersection(*[
                {n for n, v in d.items() if v is not None}
                for d in per_shard]) if per_shard else set())
            if shared:
                score = {s: sum(d[n] for n in shared) / len(shared)
                         for s, d in zip(live, per_shard)}
                src = max(live, key=lambda s: (score[s], -s))
                dst = min(live, key=lambda s: (score[s], s))
                if src != dst and score[src] > \
                        spec.ptt_divergence_ratio * (score[dst] + _EPS):
                    # drain toward the faster-learned shard, but never
                    # past the point where the slow shard is the less
                    # loaded of the two (no flapping)
                    while budget > 0 and loads[src] > loads[dst] + _EPS:
                        task = self._pop_from(src, qs)
                        if task is None:
                            break
                        moves.append((task, dst))
                        loads[src] -= task.load_est
                        loads[dst] += task.load_est
                        cp.migrated_load_s += task.load_est
                        budget -= 1
        return moves


class ShardedControlPlane:
    """N per-shard kernels + shared queues + the rebalancer, presenting
    the single-kernel interface both execution engines drive.

    Construction clones the top scheduler once per shard (own PTT bank,
    own decision streams — seeded from the top RNG so different run seeds
    give different shard streams) and fences each clone with the interned
    live view that excludes every non-shard core.  Revocation composes
    with the fence through the same mechanism: :meth:`set_availability`
    rebuilds each shard's view as ``non-shard cores ∪ down cores``; a
    fully-revoked shard is marked dead and wake/migration routing skips
    it until a restore brings it back.
    """

    track_load = True           # sharding needs the load currency

    # set by the DES when decision latency is modeled: seconds of wake
    # decisions queued at shard ``s``'s decision server.  Control-plane
    # backlog is part of a shard's load — without it the overflow and
    # rebalance logic are blind to the very bottleneck being modeled (the
    # threaded runtime's decision cost is real wall time, so its pending
    # decisions are always zero and this stays None).
    decision_backlog: Optional[Callable[[int], float]] = None

    def __init__(self, scheduler: Scheduler, *, now: Callable[[], float],
                 sharding: ShardingSpec):
        topo = scheduler.topology
        parts = topo.partitions
        pps = sharding.pods_per_shard
        n_shards = (len(parts) + pps - 1) // pps
        if n_shards < 2:
            raise ValueError("single-shard groupings take the flat kernel "
                             "(use make_control_plane)")
        self.spec = sharding
        self.sched = scheduler
        self.now = now
        self._all_cores = tuple(range(topo.n_cores))
        self._all_core_set = frozenset(self._all_cores)
        self._place_lw = [(p.leader, p.width) for p in topo.places()]
        self.shard_of_core = [0] * topo.n_cores

        self.queues = WorkQueues(
            topo.n_cores, priority_dequeue=scheduler.priority_dequeue,
            steal_high=scheduler.steal_high, track_load=True,
            groups=[0] * topo.n_cores)
        # continuous batching (mirrors SchedulingKernel.batching): the
        # engines set this; form_dispatch below reads it
        self.batching = None
        self._reshard_generation = 0
        self._set_grouping(pps)
        scheduler.begin_run()
        self._down_cores: frozenset = frozenset()
        self._dead = [False] * n_shards
        self.rebalancer = GlobalRebalancer(self)

        # migration telemetry (copied into RunMetrics by the engines)
        self.migrations = 0
        self.overflow_migrations = 0
        self.rebalance_rounds = 0
        self.migrated_load_s = 0.0
        self.reshard_rounds = 0

    def _set_grouping(self, pps: int) -> None:
        """(Re)build the shard grouping for ``pods_per_shard=pps``: shard
        membership tables, the shared queues' steal groups (mutated in
        place — the engines hold references), the per-shard kernels over
        freshly cloned schedulers, and their fence views.  Used at
        construction and by :meth:`reshard`."""
        topo = self.sched.topology
        parts = topo.partitions
        n_shards = (len(parts) + pps - 1) // pps
        self.n_shards = n_shards
        self.shard_parts = tuple(
            tuple(range(i * pps, min((i + 1) * pps, len(parts))))
            for i in range(n_shards))
        self.shard_cores = tuple(
            tuple(c for pi in ps for c in parts[pi].cores)
            for ps in self.shard_parts)
        for s, cs in enumerate(self.shard_cores):
            for c in cs:
                self.shard_of_core[c] = s
        self._shard_core_idx = [np.array(cs, dtype=np.int64)
                                for cs in self.shard_cores]
        self.queues.groups[:] = self.shard_of_core
        self._base_view = tuple(
            topo.live_view_cores(self._all_core_set - frozenset(cs))
            for cs in self.shard_cores)
        gen = self._reshard_generation
        tag = f"r{gen}:" if gen else ""
        self.kernels: list[SchedulingKernel] = []
        for s in range(n_shards):
            clone = self.sched.clone(
                f"shard:{tag}{s}:{self.sched.rng.random()}")
            k = SchedulingKernel(clone, now=self.now, queues=self.queues)
            clone.live = self._base_view[s]
            self.kernels.append(k)

    def reshard(self, pods_per_shard: int) -> list[tuple[Task, int]]:
        """Online re-sharding: regroup the fleet's pods into shards of
        ``pods_per_shard`` mid-run (pods joined, or a long-revoked pod is
        being consolidated into a live neighbor's shard) and return the
        rebalancer's catch-up migration round — ``(task, destination
        shard)`` pairs the engine lands via :meth:`migrate_in` — so
        queued work orphaned on the old grouping's cold corners moves
        under the new one.

        Every per-core structure (WSQs, AQs, queued-seconds vectors) is
        untouched; only shard *membership* changes.  New shard kernels
        are cloned deterministically from the top scheduler's stream
        (cold PTTs — the rebalancer's divergence trigger and plain
        exploration re-learn them; an accepted cost, documented in
        DESIGN.md).  In-flight run charges transfer to the new owner of
        each charged core so load accounting stays exact."""
        if pods_per_shard < 1:
            raise ValueError(f"pods_per_shard {pods_per_shard} < 1")
        parts = self.sched.topology.partitions
        if (len(parts) + pods_per_shard - 1) // pods_per_shard < 2:
            raise ValueError("re-sharding to a single shard is not "
                             "supported (the flat kernel cannot be "
                             "swapped in mid-run)")
        old_kernels = self.kernels
        self._reshard_generation += 1
        self.spec = dataclasses.replace(self.spec,
                                        pods_per_shard=pods_per_shard)
        self._set_grouping(pods_per_shard)
        self._dead = [False] * self.n_shards
        # in-flight charges follow their cores to the new owning shard
        for k in old_kernels:
            for tid, (cores, est) in k._run_charges.items():
                nk = self.kernels[self.shard_of_core[cores[0]]]
                nk._run_charges[tid] = (cores, est)
                for c in cores:
                    nk._running_s[c] += est
        for k in self.kernels:
            k.batching = self.batching
        self.set_availability(self._down_cores)
        self.reshard_rounds += 1
        return self.rebalancer.plan_round()

    # -- shard state ---------------------------------------------------------
    def shard_dead(self, s: int) -> bool:
        return self._dead[s]

    def load_per_core(self) -> np.ndarray:
        """Per-core outstanding estimated seconds (queued + running),
        summed across every shard's running charges."""
        load = self.queues.queued_s.copy()
        for k in self.kernels:
            load += k._running_s
        return np.maximum(load, 0.0)

    def shard_loads(self) -> np.ndarray:
        """Per-shard outstanding estimated seconds — the imbalance and
        overflow currency.  Includes the shard's modeled decision-server
        backlog when the DES provides one (see ``decision_backlog``)."""
        load = self.load_per_core()
        out = np.array([load[idx].sum() for idx in self._shard_core_idx])
        if self.decision_backlog is not None:
            out += np.array([self.decision_backlog(s)
                             for s in range(self.n_shards)])
        return out

    def _coldest_live_shard(self, loads: Optional[np.ndarray] = None) -> int:
        if loads is None:
            loads = self.shard_loads()
        live = [s for s in range(self.n_shards) if not self._dead[s]]
        return min(live, key=lambda s: (loads[s], s))

    def _entry_core(self, s: int) -> int:
        """Deterministic representative core for work routed *into* shard
        ``s`` from outside: its least-loaded live core (lowest index on
        ties) — no randomness, so both engines route identically."""
        load = self.load_per_core()
        cands = [c for c in self.shard_cores[s] if c not in self._down_cores]
        return min(cands, key=lambda c: (load[c], c))

    # -- wake / requeue (lifecycle steps 1-2) --------------------------------
    def wake(self, task: Task, waker_core: int) -> int:
        s = self.shard_of_core[waker_core]
        if self._dead[s]:
            s = self._coldest_live_shard()
            waker_core = self._entry_core(s)
        elif self.spec.overflow_ratio > 0.0:
            loads = self.shard_loads()
            live = [i for i in range(self.n_shards) if not self._dead[i]]
            mean = float(loads[live].mean()) if live else 0.0
            if (len(live) > 1
                    and loads[s] > self.spec.overflow_ratio * (mean + _EPS)):
                t = self._coldest_live_shard(loads)
                if t != s and loads[t] < loads[s]:
                    s = t
                    waker_core = self._entry_core(s)
                    self.overflow_migrations += 1
        return self.kernels[s].wake(task, waker_core)

    def requeue_displaced(self, task: Task,
                          waker: Optional[int] = None) -> int:
        """Revocation/fault re-placement: the waker core is drawn from the
        *global* live set with the top scheduler's RNG — one draw per
        task, same as the flat kernel — then the owning shard redoes the
        wake-time decision over its surviving places."""
        if waker is None:
            live = self.live_cores()
            rng = self.sched.rng
            waker = (live[rng.randrange(len(live))] if len(live) > 1
                     else live[0])
        return self.kernels[self.shard_of_core[waker]].requeue_displaced(
            task, waker=waker)

    def migrate_in(self, task: Task, shard: int) -> int:
        """Land a migrated task on ``shard``: the old binding is void (it
        names a source-shard place), the destination shard redoes the
        wake-time decision from its least-loaded live core.  ``t_ready``
        is *not* restamped — migration must not hide queueing delay from
        the sojourn metrics."""
        if self._dead[shard]:
            shard = self._coldest_live_shard()
        task.bound_place = None
        k = self.kernels[shard]
        waker = self._entry_core(shard)
        target = k.sched.place_on_wake(task, waker)
        core = waker if target is None else target
        k._stamp_load_est(task, core)
        self.migrations += 1
        return core

    def live_cores(self) -> tuple[int, ...]:
        view = self.sched.live
        return self._all_cores if view is None else view.cores

    # -- dequeue / steal (steps 3-5) -----------------------------------------
    def on_steal(self, task: Task) -> None:
        task.bound_place = None

    def choose_place(self, task: Task, worker_core: int) -> ExecutionPlace:
        return self.kernels[self.shard_of_core[worker_core]].choose_place(
            task, worker_core)

    def form_dispatch(self, task: Task, core: int) -> Task:
        """Continuous batching at the dequeue boundary (see
        :meth:`SchedulingKernel.form_dispatch`) — queue coalescing is
        per-core, so sharding changes nothing about it."""
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
                base = members[0].type
            task.type = base.batched(1 + len(task.batch_members),
                                     cfg.member_cost)
        return task

    def batch_feedback(self, task: Task, place: ExecutionPlace,
                       observed: float) -> None:
        """One PTT observation on the batch-bucketed type at the owning
        shard, plus idempotent member discharges (see
        :meth:`SchedulingKernel.batch_feedback`)."""
        self.ptt_feedback(task, place, observed)
        if task.batch_members:
            for m in task.batch_members:
                self.discharge(m)

    # -- load accounting ------------------------------------------------------
    def estimate_seconds(self, task_type: TaskType,
                         place: ExecutionPlace) -> float:
        return self.kernels[self.shard_of_core[place.leader]] \
            .estimate_seconds(task_type, place)

    def discharge(self, task: Task) -> None:
        for k in self.kernels:          # each discharge is idempotent O(1)
            k.discharge(task)

    def place_load(self) -> np.ndarray:
        """Fleet-wide per-place outstanding seconds (observability; each
        shard's own searches read its kernel's view)."""
        load = self.load_per_core()
        out = np.empty(len(self._place_lw))
        for i, (leader, width) in enumerate(self._place_lw):
            out[i] = (load[leader] if width == 1
                      else load[leader:leader + width].max())
        return out

    def backlog_signal(self) -> float:
        live = self.live_cores()
        load = self.load_per_core()
        return max(float(load[list(live)].sum()), 0.0) / max(len(live), 1)

    def prime_ptt(self, task_type: TaskType, estimate: float = None) -> int:
        return sum(k.prime_ptt(task_type, estimate) for k in self.kernels)

    # -- commit (step 8) ------------------------------------------------------
    def observe_simulated(self, task_type: TaskType, duration: float) -> float:
        """Measurement noise is a property of the environment, not the
        shard: draws come from the top scheduler's stream (same model as
        :meth:`SchedulingKernel.observe_simulated`)."""
        rng = self.sched.rng
        noise = rng.gauss(1.0, task_type.noise) if task_type.noise else 1.0
        observed = duration * min(max(noise, 0.5), 2.0)
        if task_type.spike_prob and rng.random() < task_type.spike_prob:
            observed *= task_type.spike_mag
        return observed

    def ptt_feedback(self, task: Task, place: ExecutionPlace,
                     observed: float) -> None:
        self.kernels[self.shard_of_core[place.leader]].ptt_feedback(
            task, place, observed)

    def commit_successors(self, task: Task, lock=None):
        return self.kernels[0].commit_successors(task, lock=lock)

    # -- fault recovery -------------------------------------------------------
    def expected_duration(self, task: Task, place: ExecutionPlace) -> float:
        return self.kernels[self.shard_of_core[place.leader]] \
            .expected_duration(task, place)

    def fault_feedback(self, task: Task, place: ExecutionPlace,
                       elapsed: float, penalty: float) -> None:
        self.kernels[self.shard_of_core[place.leader]].fault_feedback(
            task, place, elapsed, penalty)

    def hedge_place(self, task: Task, exclude_cores, rng) -> \
            Optional[ExecutionPlace]:
        """Fleet-wide PTT-best live place disjoint from the straggler's
        cores — each candidate scored by its *owning shard's* table
        (unexplored 0.0 first, ties prefer narrow, residual ties from the
        fault ``rng``), mirroring :meth:`PTT.best` semantics."""
        live = set(self.live_cores())
        best_key, cands = None, []
        for p in self.sched.topology.places():
            if not live.issuperset(p.cores) \
                    or exclude_cores.intersection(p.cores):
                continue
            tbl = self.kernels[self.shard_of_core[p.leader]] \
                .sched.ptt.for_type(task.type.name)
            key = (tbl.get(p), p.width)
            if best_key is None or key < best_key:
                best_key, cands = key, [p]
            elif key == best_key:
                cands.append(p)
        if not cands:
            return None
        if len(cands) > 1 and rng is not None:
            return cands[rng.randrange(len(cands))]
        return cands[0]

    # -- availability ---------------------------------------------------------
    def set_availability(self, down_cores: frozenset) -> None:
        """Compose revocation with the shard fences: the top scheduler
        gets the global view (requeue routing reads it); each live shard
        gets ``non-shard ∪ down``; a fully-down shard is dead until
        restored (its view is left stale — nothing routes to it)."""
        topo = self.sched.topology
        self._down_cores = down_cores
        self.sched.live = (None if not down_cores
                           else topo.live_view_cores(down_cores))
        for s, k in enumerate(self.kernels):
            cs = frozenset(self.shard_cores[s])
            if cs <= down_cores:
                self._dead[s] = True
                continue
            self._dead[s] = False
            fence = self._all_core_set - cs
            k.sched.live = topo.live_view_cores(fence | down_cores)

    def end_run(self) -> None:
        self.sched.live = None
        self._down_cores = frozenset()
        self._dead = [False] * self.n_shards
        for s, k in enumerate(self.kernels):
            k.sched.live = self._base_view[s]


def make_control_plane(scheduler: Scheduler, *, now: Callable[[], float],
                       sharding: Optional[ShardingSpec] = None):
    """The engines' one constructor: the plain flat kernel for
    ``sharding=None`` *and* for any grouping that yields a single shard
    (``pods_per_shard >= partition count``) — that degeneracy is the
    semantics-preservation pin: a one-shard zero-overhead sharded run is
    the flat code path, bit for bit."""
    if sharding is None or \
            sharding.pods_per_shard >= len(scheduler.topology.partitions):
        return SchedulingKernel(scheduler, now=now)
    return ShardedControlPlane(scheduler, now=now, sharding=sharding)
