"""Discrete-event simulator of the XiTAO-style runtime (paper §4.1.2).

Faithfully models the scheduler-visible machinery:

* per-core Work Stealing Queue (WSQ, owner LIFO / thief FIFO) holding ready
  tasks, and a FIFO Assembly Queue (AQ) holding placed tasks; a molded task's
  pointer is inserted into *all* member AQs atomically and starts when every
  member reaches it (paper Fig. 3 steps 1-7);
* binding placement of HIGH tasks at wake time, re-run of the local width
  search after a steal (steps 4-5), PTT update by the leader on commit
  (step 8) with multiplicative measurement noise;
* dynamic asymmetry: per-core piecewise-constant speed profiles (DVFS) and
  co-running background apps that time-share their pinned cores and pressure
  the partition's shared memory bandwidth.

Progress integration uses piecewise-constant rates: every event (task
start/finish, speed breakpoint, background episode edge) re-derives each
*affected* running task's rate

    rate = min_{c in place} speed(c,t)/share(c) * min(1, bw_cap/bw_demand)^s

and re-schedules versioned completion events.  All randomness is seeded.

One scheduling kernel, two engines
----------------------------------
Queue structure and lifecycle decisions live in the engine-agnostic
kernel shared with the threaded runtime: split HIGH-FIFO/LOW-LIFO WSQs,
assembly queues, priority-aware dequeue, O(cores) steal-victim selection
with seeded tie-breaks (``core/queues.py``), and the wake → place →
dequeue/steal-with-re-search → commit → PTT-feedback state machine
(``core/lifecycle.py``, parameterized over this simulator's virtual
clock).  This module is the *discrete-event driver* over that kernel:
everything below is about integrating task progress through
piecewise-constant rates as fast as possible.

Incremental-dispatch architecture (the hot path)
------------------------------------------------
The original engine re-ran a shuffled fixpoint over *all* cores after every
event and re-scanned whole queues per decision; the machinery below keeps
scheduler-visible behavior but does O(changed state) work per event:

* **Split WSQs** — each core's WSQ is a HIGH-FIFO + LOW-LIFO deque pair
  (``queues.SplitWSQ``).  Priority dequeue ("serve the oldest HIGH first,
  newest LOW otherwise") and steal ("oldest stealable first") become O(1)
  pops instead of O(queue) scans.  Priority-oblivious schedulers (RWS
  family) route all tasks through the LOW deque, preserving their plain
  mixed-LIFO order.
* **O(cores) victim selection** — the steal heuristic "victim with the most
  stealable tasks, random tie-break" reads per-queue lengths instead of
  counting matching tasks per victim (the seed engine's dominant cost:
  O(cores x queue length) ``may_steal`` scans per steal attempt).
* **Idle-core worklist** — ``_dispatch`` drains a dirty-set of cores whose
  state changed since the last event (work pushed, task placed, member core
  freed) in shuffled rounds mirroring the old two-phase (local, then steal)
  fixpoint.  Cores that find neither local work nor a steal victim park in
  a *starving* set and are only re-woken when stealable work appears.
* **Dirty-flag rate refresh** — per-core effective speeds (DVFS x
  background time-sharing) are cached and recomputed only at speed/bg
  breakpoints; partition bandwidth demand is maintained incrementally on
  task start/commit.  ``_refresh_rates`` touches only tasks whose inputs
  changed: all of them after a speed/bg event, bandwidth-sensitive tasks in
  dirtied domains after demand shifts, and freshly started tasks otherwise.
* **Vectorized rate refresh** — when a refresh touches many running tasks
  at once (wide topologies such as ``tx2_xl(8+)`` / ``haswell_cluster``
  with hundreds of cores), the per-task Python loop switches to a numpy
  pass over the running-task rate vector: gathered per-leader speeds,
  per-bandwidth-key slowdown factors, and a vectorized changed-rate mask
  so only tasks whose rate actually moved re-enter the event queue.  Both
  paths perform the identical float64 operations, so results are
  bit-for-bit the same whichever one runs (``_VEC_MIN`` sets the
  crossover).
* **Lazy-deletion event-queue compaction** — every rate change makes the
  task's previously scheduled finish event stale (versioned events; stale
  ones are skipped on pop).  On bandwidth-heavy workloads rates change at
  nearly every event, so stale entries can dominate the heap.  The engine
  counts outstanding stale events and, when they exceed
  ``_COMPACT_MIN_STALE`` *and* half the heap, rebuilds the heap keeping
  only live events (O(heap) re-heapify, amortized O(1) per push).  Pop
  order of surviving events is untouched — the (t, seq) key is a total
  order — so compaction is behavior-invisible; ``heap_peak`` records the
  high-water mark for tests and diagnostics.

Preemptible capacity (pod-slice revocation)
-------------------------------------------
An optional :class:`~.preemption.PreemptionModel` attaches seeded
partition-granular revoke/restore episodes.  At a **revoke** edge the
engine (in order):

1. marks the partition's cores down (they leave the dispatch worklist and
   the starving set; the scheduler receives the interned
   :class:`~.places.LiveView` so every wake-time search is restricted to
   surviving places);
2. preempts the partition's *running* tasks — ``preempt="restart"``
   discards their progress, ``"checkpoint"`` folds the completed fraction
   into ``task.resume_frac`` and charges ``resume_penalty`` extra work at
   the next start — releasing their cores, bandwidth demand and finish
   events (which turn stale, feeding the compaction accounting);
3. drains the partition's AQs (placed-but-unstarted tasks lose their
   place but no progress) and WSQs back to the scheduler;
4. re-places every displaced task on the surviving partitions — **HIGH
   tasks first** (running, then AQ, then WSQ order within each class), so
   criticality-aware schedulers immediately re-bind the critical path
   while RWS-family schedulers scatter, which is exactly the behavioral
   difference the preemption benchmarks measure.

At a **restore** edge the cores re-enter the dispatch loop and steal
their way back to work.  With no model attached every preemption code
path is behind a ``None``/flag check and runs are bit-identical to
builds without the subsystem (pinned against the golden schedules).

Decision *distributions* (victim tie-breaks, core processing order) are
unchanged, but the RNG draw sequence differs from the pre-refactor engine,
so seeded runs are statistically — not bit-for-bit — identical to it;
``tests/test_golden_schedule.py`` pins the current behavior.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from typing import Iterable, Optional

import numpy as np

from .dag import DAG
from .faults import FaultModel, FaultState, RecoveryPolicy
from .interference import BackgroundApp, SpeedProfile, SpeedProfileBase
from .lifecycle import split_by_priority
from .metrics import RunMetrics, TaskRecord
from .places import ExecutionPlace
from .preemption import PreemptionModel
from .queues import BatchingConfig
from .schedulers import Scheduler
from .shards import ShardingSpec, make_control_plane
from .task import PARTITION_BW, Priority, Task

_EPS = 1e-12
_NO_DEMAND = (0.0, 0)
# refresh batches at least this large take the numpy path (see module
# docstring); below it the plain Python loop is faster (tx2-class runs
# rarely have more than ~6 running tasks)
_VEC_MIN = 32
# compact the event heap when stale entries exceed this count AND this
# fraction of the heap (hysteresis: small runs never pay the rebuild).
# Both are Simulator kwargs; these module constants are the defaults.
_COMPACT_MIN_STALE = 64
_COMPACT_HEAP_FRAC = 0.5


class _Running:
    __slots__ = ("task", "place", "remaining", "rate", "base", "version",
                 "cores", "domain", "mem_s", "cap", "bw_contrib", "bwkey",
                 "work_assigned", "fault", "slow_mult", "token")

    def __init__(self, task: Task, place: ExecutionPlace, remaining: float,
                 domain: str, cap: float, bwkey: int):
        self.task = task
        self.place = place
        self.remaining = remaining  # work-seconds left at rate 1.0
        self.work_assigned = remaining  # assignment size (for checkpoints)
        self.rate = -1.0            # <0 = not yet scheduled a finish event
        self.base = -1.0            # min core speed over place (pre-bw rate)
        self.version = 0
        self.cores = place.cores
        self.domain = domain
        self.mem_s = task.type.mem_sensitivity
        self.cap = cap
        self.bw_contrib = task.type.bw_demand * place.width
        self.bwkey = bwkey          # interned (domain, cap, mem_s) id; -1 = bw-insensitive
        # fault-injection state (see ``core/faults.py``): the armed fault
        # for this execution (``remaining`` is truncated to its strike
        # point so the strike is an ordinary finish event), the fail-slow
        # rate multiplier in force, and the straggle-event guard token
        self.fault = None
        self.slow_mult = 1.0
        self.token = 0


class Simulator:
    def __init__(self, scheduler: Scheduler, *,
                 speed: Optional[SpeedProfileBase] = None,
                 background: Iterable[BackgroundApp] = (),
                 preemption: Optional[PreemptionModel] = None,
                 faults: Optional[FaultModel] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 sharding: Optional[ShardingSpec] = None,
                 batching: Optional[BatchingConfig] = None,
                 reshard_at: Iterable[tuple[float, int]] = (),
                 horizon: float = 1e6,
                 event_mode: str = "cohort",
                 compact_min_stale: int = _COMPACT_MIN_STALE,
                 compact_heap_frac: float = _COMPACT_HEAP_FRAC):
        if event_mode not in ("cohort", "scalar"):
            raise ValueError(f"unknown event_mode {event_mode!r} "
                             "(expected 'cohort' or 'scalar')")
        if compact_min_stale < 0:
            raise ValueError(f"compact_min_stale {compact_min_stale!r} < 0")
        if not 0.0 < compact_heap_frac <= 1.0:
            raise ValueError(f"compact_heap_frac {compact_heap_frac!r} "
                             "outside (0, 1]")
        self.event_mode = event_mode
        self.sched = scheduler
        self.topo = scheduler.topology
        self.rng = scheduler.rng
        self.speed = speed or SpeedProfile(self.topo.n_cores)
        self.background = list(background)
        self.preemption = preemption
        self.sharding = sharding
        self.horizon = horizon

        n = self.topo.n_cores
        # the control plane: the engine-agnostic scheduling kernel (split
        # WSQs + AQs, steal policy, wake/requeue placement, PTT feedback —
        # shared with the threaded runtime, see core/lifecycle.py), or N
        # of them behind the sharded plane (core/shards.py).  Groupings
        # that yield one shard *are* the flat kernel (the equivalence pin).
        self.kernel = make_control_plane(scheduler, now=lambda: self.now,
                                         sharding=sharding)
        self.queues = self.kernel.queues
        # modeled scheduler overhead: each shard (1 for the flat kernel)
        # is a single-server decision queue — wakes serialize through it
        # at ``decision_s`` apiece.  Zero cost skips the event machinery
        # entirely (the exact pre-overhead path, bit-identical).
        self._n_shards = getattr(self.kernel, "n_shards", 1)
        self._decision_s = sharding.decision_s if sharding is not None else 0.0
        if self._decision_s > 0.0:
            self._shard_of = (self.kernel.shard_of_core
                              if self._n_shards > 1 else [0] * n)
            self._shard_free = [0.0] * self._n_shards
            self._decide_depth = [0] * self._n_shards
            if self._n_shards > 1:
                # expose the decision-server backlog to the plane so the
                # overflow/rebalance logic can see the modeled bottleneck
                self.kernel.decision_backlog = (
                    lambda s: self._decide_depth[s] * self._decision_s)
        # continuous batching: a max_batch=1 config is the disabled path
        # by definition (the degeneracy pin), so normalize it to None —
        # every batching branch below then stays dead code
        if batching is not None and not batching.enabled:
            batching = None
        if batching is not None and faults is not None and faults.enabled:
            raise ValueError("continuous batching with fault injection is "
                             "not supported: a batched dispatch has no "
                             "per-member retry semantics")
        self._batching = batching
        self.kernel.batching = batching
        # online re-sharding events: (t, pods_per_shard), applied in event
        # order (sharded control plane only; see _reshard)
        self._reshard_at = tuple(sorted(reshard_at))
        if self._reshard_at and self._n_shards <= 1:
            raise ValueError("reshard_at requires a sharded control plane")
        self._pend = itertools.count()
        self._pending_decide: dict[int, tuple[Task, int]] = {}
        self._pending_migrate: dict[int, tuple[Task, int]] = {}
        self.aq: list[deque[_Running]] = self.queues.aq
        self.core_busy: list[Optional[_Running]] = [None] * n
        self.running: dict[int, _Running] = {}
        self.now = 0.0
        self._seq = itertools.count()
        self._events: list[tuple] = []   # (t, seq, kind, tid, version)
        self._done = 0
        self._outstanding = 0
        self.metrics = RunMetrics(n_cores=n)

        # incremental-dispatch state: every core starts on the worklist (the
        # first round parks workless cores in the starving set, after which
        # only state changes re-queue them)
        self._dirty: set[int] = set(range(n))
        self._starving: set[int] = set()    # idle cores out of steal targets

        # dirty-flag rate-refresh state
        self._fresh: list[_Running] = []    # started since last refresh
        self._dirty_domains: set[str] = set()
        self._rates_global_dirty = False
        self._demand: dict[str, tuple[float, int]] = {}  # foreground bw
        self._speed_now = [self.speed.speed(c, 0.0) for c in range(n)]
        self._bg_mult = [1.0] * n
        self._bg_demand: dict[str, tuple[float, int]] = {}
        self._core_speed = list(self._speed_now)
        self._core_speed_arr: Optional[np.ndarray] = None  # lazy np mirror
        self._vec_min = _VEC_MIN

        # bandwidth-key interning for the vectorized refresh: one id per
        # distinct (domain, cap, mem_sensitivity) combination seen
        self._bwkey_id: dict[tuple, int] = {}
        self._bwkeys: list[tuple] = []
        # Last *applied* bandwidth factor per interned key (NaN = never
        # applied) + per-domain key registry: a dirty domain only rescans
        # the running set when some key's recomputed factor actually moved
        # (an unchanged factor recomputes a bitwise-equal rate, which the
        # _EPS change test always rejects — so skipping the scan is
        # state-identical).  Every branch that applies factors writes the
        # cache back, keeping the invariant inductive.
        self._key_factor: list[float] = []
        self._dom_bwkeys: dict[str, list[int]] = {}
        # Domains with any applied factor != 1.0.  A demand *decrease* in a
        # cool domain provably keeps every factor at 1.0 (dem shrinks, cap
        # grows as streams drop), so those sites skip the dirty-domain mark
        # entirely; increases always mark.  Conservative: factor appliers
        # add domains eagerly, only the full dirty-domain sweep removes.
        self._hot_doms: set[str] = set()

        # lazy-deletion event-queue state
        self._stale = 0                     # outstanding dead finish events
        self._compact_min_stale = compact_min_stale
        self._compact_heap_frac = compact_heap_frac
        self.heap_peak = 0                  # high-water mark of the heap
        self.compactions = 0

        # preemptible-capacity state (inert without a PreemptionModel);
        # core-granular — a sub-pod episode revokes a subset of its
        # partition's cores and leaves the siblings dispatching
        self._core_up = [True] * n
        self._down_cores: set[int] = set()
        self._ckpt = (preemption is not None
                      and preemption.preempt == "checkpoint")
        self._resume_penalty = (preemption.resume_penalty
                                if preemption is not None else 0.0)
        self.preempt_events = 0             # revoke edges applied
        self.tasks_preempted = 0            # task executions cut short
        self.work_lost = 0.0                # discarded progress (work-s)

        # fault-injection state (inert without an *enabled* FaultModel — a
        # zero-probability model is normalized away here, so attaching one
        # is literally the None path; the golden pins check this)
        if faults is not None and not faults.enabled:
            faults = None
        self.faults = faults
        self._fx = (FaultState(faults, recovery or RecoveryPolicy())
                    if faults is not None else None)
        self._pending_retry: dict[int, Task] = {}   # tid -> task in backoff
        self._notice_token: dict[int, int] = {}     # eidx -> live notice event
        self._tok = itertools.count(1)              # straggle/notice guards

        # load-coupled speed profiles (e.g. a power governor that detunes
        # harder on loaded partitions, ``interference.LoadCoupledGovernor``)
        # are fed per-partition busy-core counts before every rate refresh;
        # a profile without the hook costs one getattr at construction
        self._load_coupled = bool(getattr(self.speed, "load_coupled", False))
        if self._load_coupled:
            self._pidx_of = [0] * n
            for pidx, part in enumerate(self.topo.partitions):
                for c in part.cores:
                    self._pidx_of[c] = pidx

        # hot-path bindings.  With the flat (unsharded) kernel the wake and
        # commit plumbing — timestamp stamping, measurement-noise draws,
        # PTT feedback routing — is inlined into _wake/_commit below; every
        # *decision* (placement searches, tie-breaks, EMA folding) still
        # runs in scheduler/PTT code, and the draws are made in the same
        # order from the same streams, so results are bit-identical to the
        # generic kernel calls the sharded plane keeps using.
        self._flat = self._n_shards == 1
        self._track_load = self.kernel.track_load if self._flat else True
        self._inline_choose = self._flat and not self._track_load
        self._choose_place = (scheduler.place_on_dequeue if self._inline_choose
                              else self.kernel.choose_place)
        self._ptt_bank = scheduler.ptt
        self._ptt_for: dict = {}    # type name -> PTT (same objects as bank)
        self._rec_append = self.metrics.records.append
        # _dispatch's working set, bound once (all are init-only objects
        # mutated in place, never rebound)
        self._disp_binds = (self._dirty, self.core_busy, self.aq,
                            self.queues.wsq, self._core_up, self._starving,
                            self.rng)
        # per-leader (domain, bw cap, partition kind) — one tuple per
        # leader core, resolved lazily at first placement
        self._leader_info: list = [None] * n
        self._recompute_bg()

    # ------------------------------------------------------------------ util
    def _push_event(self, t: float, kind: str, tid: int = -1, version: int = -1):
        events = self._events
        heapq.heappush(events, (t, next(self._seq), kind, tid, version))
        if len(events) > self.heap_peak:
            self.heap_peak = len(events)

    def _maybe_compact(self):
        """Rebuild the heap without stale finish events once they dominate.
        Surviving events keep their (t, seq) keys — a total order — so pop
        order (and therefore every simulation result) is unchanged.  The
        trigger thresholds are the ``compact_min_stale`` /
        ``compact_heap_frac`` constructor kwargs; at the defaults (64,
        0.5) this is the exact historical stale>64-and-half-the-heap
        condition."""
        if (self._stale <= self._compact_min_stale
                or self._stale <= self._compact_heap_frac
                * len(self._events)):
            return
        running = self.running
        live = []
        for ev in self._events:
            if ev[2] == "finish":
                rec = running.get(ev[3])
                if rec is None or rec.version != ev[4]:
                    continue
            live.append(ev)
        heapq.heapify(live)
        # in-place so the run loop's local alias of ``self._events`` stays valid
        self._events[:] = live
        self._stale = 0
        self.compactions += 1

    def _recompute_speed(self):
        """Re-derive cached per-core DVFS speeds (on a speed breakpoint)."""
        self._speed_now = self.speed.speeds_at(self.now)
        self._update_core_speed()
        self._rates_global_dirty = True

    def _recompute_bg(self):
        """Re-derive background co-runner state (on an episode boundary):
        per-core time-share/thrash multipliers and per-domain bandwidth
        demand contributed by active background apps."""
        n = self.topo.n_cores
        n_bg = [0] * n
        thrash = [0.0] * n
        bg_demand: dict[str, tuple[float, int]] = {}
        now = self.now
        for b in self.background:
            if not b.active(now):
                continue
            for c in b.cores:
                n_bg[c] += 1
                if b.thrash > thrash[c]:
                    thrash[c] = b.thrash
            if b.task_type.bw_demand > 0:
                for c in b.cores:
                    dom = self.topo.partition_of(c).domain
                    d, k = bg_demand.get(dom, _NO_DEMAND)
                    bg_demand[dom] = (d + b.task_type.bw_demand, k + 1)
        self._bg_mult = [
            (1.0 - thrash[c]) / (1 + n_bg[c]) if n_bg[c] else 1.0
            for c in range(n)]
        self._bg_demand = bg_demand
        self._update_core_speed()
        self._rates_global_dirty = True

    def _update_core_speed(self):
        self._core_speed = [s * m for s, m in
                            zip(self._speed_now, self._bg_mult)]
        self._core_speed_arr = None          # np mirror rebuilt on demand

    def _bw_factor(self, key: tuple) -> float:
        """Bandwidth-share slowdown for one (domain, cap, sensitivity)
        combination under the current foreground + background demand."""
        dom, cap0, s = key
        dem, streams = self._demand.get(dom, _NO_DEMAND)
        bd = self._bg_demand.get(dom)
        if bd is not None:
            dem += bd[0]
            streams += bd[1]
        if streams > 1:     # same doubles as max(0.6, 1 - .08*max(0, n-1))
            red = 1.0 - 0.08 * (streams - 1)
            cap = cap0 * (red if red > 0.6 else 0.6)
        else:
            cap = cap0
        return (cap / dem) ** s if dem > cap else 1.0

    def _refresh_rates(self):
        """Re-derive rates + reschedule finishes for tasks whose inputs
        changed since the last event (see module docstring)."""
        if self._load_coupled:
            busy = [0] * len(self.topo.partitions)
            pidx_of = self._pidx_of
            for c, rec in enumerate(self.core_busy):
                if rec is not None:
                    busy[pidx_of[c]] += 1
            if self.speed.set_busy(busy):
                # partition occupancy moved -> the governor's detune factor
                # moved -> every cached core speed is stale
                self._recompute_speed()
        dd_dom = None   # last domain swept below; lets the fresh fast
        #                 path reuse the factor just written to _key_factor
        if self._rates_global_dirty:
            recs = list(self.running.values())
        elif self._dirty_domains:
            # Recompute the factor of every key registered under a dirty
            # domain; only keys whose factor *moved* force a rescan (an
            # unchanged factor reproduces each rec's rate bitwise, so the
            # change test below would reject every one of them anyway —
            # the dominant unsaturated-domain case costs one pow per key
            # instead of a scan over the running set).
            dd = self._dirty_domains
            kf = self._key_factor
            dbk = self._dom_bwkeys
            bwkeys = self._bwkeys
            hot = self._hot_doms
            demand = self._demand
            bg_demand = self._bg_demand
            changed = None
            for dom in dd:
                keys = dbk.get(dom)
                if keys is None:
                    continue
                # _bw_factor inlined with the per-domain demand state
                # hoisted out of the per-key loop (same doubles)
                dem, streams = demand.get(dom, _NO_DEMAND)
                bd = bg_demand.get(dom)
                if bd is not None:
                    dem += bd[0]
                    streams += bd[1]
                if streams > 1:
                    red = 1.0 - 0.08 * (streams - 1)
                    if red < 0.6:
                        red = 0.6
                else:
                    red = 1.0
                all_one = True
                for k in keys:
                    key = bwkeys[k]
                    cap = key[1] * red
                    f = (cap / dem) ** key[2] if dem > cap else 1.0
                    if f != 1.0:
                        all_one = False
                    if f != kf[k]:
                        kf[k] = f
                        if changed is None:
                            changed = {k}
                        else:
                            changed.add(k)
                if all_one:
                    hot.discard(dom)
                else:
                    hot.add(dom)
                dd_dom = dom
            dd.clear()
            if changed is not None:
                recs = [r for r in self.running.values()
                        if r.rate < 0.0 or r.bwkey in changed]
            elif self._fresh:
                recs = None     # factors still; only fresh recs need rates
            else:
                return
        elif self._fresh:
            recs = None
        else:
            return
        if recs is None:
            fresh = self._fresh
            if len(fresh) == 1:
                # dominant case — one commit freed one place, dispatch
                # started one task.  Same float ops as the generic path
                # below, minus the batch plumbing.
                rec = fresh[0]
                fresh.clear()
                if self.running.get(rec.task.tid) is not rec:
                    return
                cs = self._core_speed
                cores = rec.cores
                rec.base = cs[cores[0]] if len(cores) == 1 else \
                    min(cs[c] for c in cores)
                rate = rec.base
                k = rec.bwkey
                if k >= 0 and rec.domain == dd_dom:
                    # this rec's domain was swept just above and no factor
                    # moved (changed is None), so _key_factor[k] already
                    # holds the exact double the inline recompute below
                    # would produce — reuse it and skip the pow
                    f = self._key_factor[k]
                    if f != 1.0:
                        rate *= f
                elif k >= 0:
                    # _bw_factor inlined (same doubles)
                    dom = rec.domain
                    dem, streams = self._demand.get(dom, _NO_DEMAND)
                    bd = self._bg_demand.get(dom)
                    if bd is not None:
                        dem += bd[0]
                        streams += bd[1]
                    if streams > 1:
                        red = 1.0 - 0.08 * (streams - 1)
                        cap = rec.cap * (red if red > 0.6 else 0.6)
                    else:
                        cap = rec.cap
                    if dem > cap:
                        f = (cap / dem) ** rec.mem_s
                        self._key_factor[k] = f
                        self._hot_doms.add(dom)
                        if f != 1.0:
                            rate *= f
                    else:
                        self._key_factor[k] = 1.0
                if rec.slow_mult != 1.0:
                    rate *= rec.slow_mult
                if rate < 1e-9:
                    rate = 1e-9
                # a fresh rec always has rate < 0: push unconditionally
                rec.rate = rate
                rec.version += 1
                events = self._events
                heapq.heappush(
                    events, (self.now + rec.remaining / rate,
                             next(self._seq), "finish", rec.task.tid,
                             rec.version))
                if len(events) > self.heap_peak:
                    self.heap_peak = len(events)
                return
            # defensive: a rec that started and was then killed/preempted
            # before this refresh would push a finish event that corrupts
            # the stale accounting.  Both event loops refresh immediately
            # after dispatching each live event, so the identity check
            # always passes today; it guards future refresh deferral.
            running = self.running
            recs = [r for r in fresh if running.get(r.task.tid) is r]
            if not recs:
                self._fresh.clear()
                return
        if len(recs) >= self._vec_min:
            self._refresh_rates_np(recs)
        else:
            self._refresh_rates_py(recs)
        self._fresh.clear()
        self._dirty_domains.clear()
        self._rates_global_dirty = False

    def _refresh_rates_py(self, recs: list[_Running]):
        """Per-task Python path (small refresh batches).  ``rec.bwkey >= 0``
        is exactly ``rec.mem_s > 0`` (the placement interning invariant),
        so the shared-slowdown memo keys on the interned int."""
        cs = self._core_speed
        now = self.now
        factors: dict = {}      # bwkey id -> slowdown
        bwkeys = self._bwkeys
        kf = self._key_factor
        global_dirty = self._rates_global_dirty
        events = self._events
        seq = self._seq
        heappush = heapq.heappush
        eps = _EPS
        for rec in recs:
            # the min-over-member-cores speed only moves on speed/bg events
            # (global dirty) — demand-only refreshes reuse the cached value
            if global_dirty or rec.base < 0.0:
                cores = rec.cores
                rec.base = rate = cs[cores[0]] if len(cores) == 1 else \
                    min(cs[c] for c in cores)
            else:
                rate = rec.base
            k = rec.bwkey
            if k >= 0:
                f = factors.get(k)
                if f is None:
                    f = factors[k] = kf[k] = self._bw_factor(bwkeys[k])
                    if f != 1.0:
                        self._hot_doms.add(rec.domain)
                if f != 1.0:
                    rate *= f
            sm = rec.slow_mult
            if sm != 1.0:
                rate *= sm              # fail-slow degradation in force
            if rate < 1e-9:
                rate = 1e-9
            old = rec.rate
            if old < 0 or abs(rate - old) > eps * (rate if rate > old
                                                   else old):
                if old >= 0:
                    self._stale += 1     # previous finish event is now dead
                rec.rate = rate
                rec.version += 1
                heappush(events, (now + rec.remaining / rate, next(seq),
                                  "finish", rec.task.tid, rec.version))
        # high-water mark: the heap only grows inside the loop, so one
        # post-loop check sees the same maximum as a per-push check
        if len(events) > self.heap_peak:
            self.heap_peak = len(events)

    def _refresh_rates_np(self, recs: list[_Running]):
        """Vectorized path over the running-task rate vector.  Performs the
        same float64 operations as the Python path (gather/min for bases,
        one shared slowdown factor per bandwidth key, identical change
        test), so the two paths are bit-for-bit interchangeable."""
        n = len(recs)
        cs_list = self._core_speed
        cs = self._core_speed_arr
        if cs is None:
            cs = self._core_speed_arr = np.array(cs_list, dtype=np.float64)
        if self._rates_global_dirty:
            leaders = np.fromiter((r.cores[0] for r in recs), np.int64,
                                  count=n)
            base = cs[leaders]
            for i, rec in enumerate(recs):
                cores = rec.cores
                if len(cores) > 1:
                    base[i] = min(cs_list[c] for c in cores)
                rec.base = base[i]
        else:
            base = np.fromiter((r.base for r in recs), np.float64, count=n)
            for i in np.flatnonzero(base < 0.0):
                rec = recs[i]
                cores = rec.cores
                b = cs_list[cores[0]] if len(cores) == 1 else \
                    min(cs_list[c] for c in cores)
                rec.base = b
                base[i] = b
        rate = base                          # reuse; base is not read again
        if self._bwkeys:
            kid = np.fromiter((r.bwkey for r in recs), np.int64, count=n)
            sens = kid >= 0
            if sens.any():
                fmap = np.ones(len(self._bwkeys), dtype=np.float64)
                for u in np.unique(kid[sens]):
                    f = self._bw_factor(self._bwkeys[u])
                    fmap[u] = self._key_factor[u] = f
                    if f != 1.0:
                        self._hot_doms.add(self._bwkeys[u][0])
                # rate * 1.0 is an exact identity for positive floats, so
                # multiplying the insensitive lanes too changes nothing
                rate = rate * np.where(sens, fmap[np.maximum(kid, 0)], 1.0)
        if self._fx is not None:
            # fail-slow multipliers; x1.0 lanes are exact identities, so
            # this stays bit-for-bit interchangeable with the Python path
            rate = rate * np.fromiter((r.slow_mult for r in recs),
                                      np.float64, count=n)
        np.maximum(rate, 1e-9, out=rate)
        old = np.fromiter((r.rate for r in recs), np.float64, count=n)
        changed = (old < 0.0) | (np.abs(rate - old)
                                 > _EPS * np.maximum(rate, old))
        now = self.now
        push = self._push_event
        for i in np.flatnonzero(changed):
            rec = recs[i]
            if rec.rate >= 0:
                self._stale += 1             # previous finish event is now dead
            r = rate[i]
            rec.rate = r
            rec.version += 1
            push(now + rec.remaining / r, "finish", rec.task.tid, rec.version)

    def _advance(self, t: float):
        dt = t - self.now
        if dt <= 0:
            if dt < -1e-9 * max(1.0, abs(self.now)):
                raise RuntimeError(f"time went backwards: {self.now} -> {t}")
            return      # same instant (fp jitter)
        running = self.running
        if len(running) >= self._vec_min:
            # array path for wide topologies: the elementwise
            # ``remaining - (dt * rate)`` is the identical IEEE-754
            # operation pair as the scalar loop, so both paths are
            # bit-for-bit interchangeable (same contract as the
            # vectorized rate refresh)
            recs = list(running.values())
            n = len(recs)
            step = np.fromiter((r.rate for r in recs), np.float64, count=n)
            step *= dt
            rem = np.fromiter((r.remaining for r in recs), np.float64,
                              count=n)
            rem -= step
            for rec, v in zip(recs, rem.tolist()):
                rec.remaining = v
        else:
            for rec in running.values():
                rec.remaining -= dt * rec.rate
        self.now = t

    # ----------------------------------------------------------------- wake
    def _mark(self, core: int):
        self._dirty.add(core)
        self._starving.discard(core)

    def _enqueue(self, task: Task, core: int):
        """Push a ready task onto ``core``'s WSQ (shared by first wakes and
        preemption requeues — the outstanding count moves only on wake).
        ``WorkQueues.push`` is inlined (per-run-constant flags)."""
        queues = self.queues
        q = queues.wsq[core]
        if queues.route_high and task.priority == Priority.HIGH:
            q.high.append(task)
        else:
            q.low.append(task)
        if queues.track_load:
            queues.queued_s[core] += task.load_est
        self._dirty.add(core)
        self._starving.discard(core)
        # new stealable work re-opens the starving cores' steal loop —
        # only the receiving shard's cores when steal groups fence the
        # victim scans (a foreign starving core could never steal it)
        if self._starving and self.queues.stealable(task):
            groups = self.queues.groups
            if groups is None:
                self._dirty |= self._starving
                self._starving.clear()
            else:
                g = groups[core]
                woken = {c for c in self._starving if groups[c] == g}
                self._dirty |= woken
                self._starving -= woken

    def _wake(self, task: Task, waker_core: int):
        self._outstanding += 1
        if self._decision_s == 0.0:
            if self._flat:
                # inlined SchedulingKernel.wake (plumbing only; the
                # placement decision below is the same scheduler call)
                task.t_ready = self.now
                target = self.sched.place_on_wake(task, waker_core)
                core = waker_core if target is None else target
                if self._track_load:
                    self.kernel._stamp_load_est(task, core)
                self._enqueue(task, core)
            else:
                self._enqueue(task, self.kernel.wake(task, waker_core))
            return
        # modeled decision latency: the wake queues at its shard's
        # decision server and lands when the server gets to it
        s = self._shard_of[waker_core]
        t = max(self.now, self._shard_free[s]) + self._decision_s
        self._shard_free[s] = t
        self._decide_depth[s] += 1
        pid = next(self._pend)
        self._pending_decide[pid] = (task, waker_core, s)
        self._push_event(t, "decide", pid)

    def _decide(self, pid: int):
        """A queued wake decision completes: run the placement now (the
        waker may have been revoked inside the decision latency — fall
        back to the first live core; no RNG is drawn)."""
        task, waker, s = self._pending_decide.pop(pid)
        self._decide_depth[s] -= 1
        if not self._core_up[waker]:
            waker = self.kernel.live_cores()[0]
        self._enqueue(task, self.kernel.wake(task, waker))

    def _rebalance(self):
        """One rebalance round: plan + pop the migrating tasks now, land
        each after the round's decision latency + per-task migration
        cost.  Re-arms itself while the run still has outstanding work."""
        spec = self.sharding
        if self._outstanding > 0:
            lat = spec.rebalance_decision_s + spec.migration_s
            for task, dst in self.kernel.rebalancer.plan_round():
                pid = next(self._pend)
                self._pending_migrate[pid] = (task, dst)
                self._push_event(self.now + lat, "migrate", pid)
            self._push_event(self.now + spec.rebalance_period_s, "rebalance")

    def _migrate_land(self, pid: int):
        task, dst = self._pending_migrate.pop(pid)
        self._enqueue(task, self.kernel.migrate_in(task, dst))

    def _reshard(self, idx: int):
        """Apply one online re-sharding event: regroup the pods into new
        shards (:meth:`ShardedControlPlane.reshard`) and land the
        rebalancer's catch-up migration round immediately.  The plane
        mutates ``shard_of_core`` and the steal-group fences in place, so
        the decision-server binding and every queued reference stay
        valid."""
        _, pps = self._reshard_at[idx]
        moves = self.kernel.reshard(pps)
        self._n_shards = self.kernel.n_shards
        if self._decision_s > 0.0 and self._n_shards > len(self._shard_free):
            # grow the decision-server arrays; wakes queued under old
            # shard ids drain against their (still-indexed) old servers
            grow = self._n_shards - len(self._shard_free)
            self._shard_free.extend([0.0] * grow)
            self._decide_depth.extend([0] * grow)
        for task, dst in moves:
            self._enqueue(task, self.kernel.migrate_in(task, dst))

    def _requeue(self, task: Task):
        """Hand a displaced task back to the scheduler (see
        :meth:`SchedulingKernel.requeue_displaced`)."""
        self._enqueue(task, self.kernel.requeue_displaced(task))

    def submit(self, dag: DAG):
        if self._fx is not None:
            # fault sequence numbers follow the DAG's deterministic BFS
            # order, shared with the threaded engine (cross-engine parity)
            self._fx.register_dag(dag)
        for root in dag.roots:
            self._wake(root, waker_core=0)

    # ------------------------------------------------------------ preemption
    def _set_availability(self):
        """Refresh the control plane's live view(s) after a revoke/restore
        edge (views are interned on the topology; the kernel's requeue
        path reads live cores straight off the view; a sharded plane
        composes the down set with each shard's fence)."""
        self.kernel.set_availability(frozenset(self._down_cores))

    def _preempt_running(self, rec: _Running):
        """Cut one running task short: release cores, bandwidth demand and
        the (now stale) finish event; checkpoint or discard its progress."""
        task = rec.task
        if rec.rate >= 0:
            self._stale += 1            # outstanding finish event is dead
        rec.version += 1
        del self.running[task.tid]
        for c in rec.cores:
            self.core_busy[c] = None
        if rec.bw_contrib > 0.0:
            dom = rec.domain
            d, k = self._demand[dom]
            self._demand[dom] = _NO_DEMAND if k <= 1 else \
                (d - rec.bw_contrib, k - 1)
            if dom in self._hot_doms:
                self._dirty_domains.add(dom)
        if rec.fault is not None:
            # an armed fault truncated ``remaining`` to its strike point;
            # restore the true outstanding work before checkpoint /
            # work-lost accounting (the re-execution re-draws the fault)
            rec.remaining += rec.work_assigned * (1.0 - rec.fault.frac)
            rec.fault = None
        if self._ckpt and rec.work_assigned > 0.0:
            # completed fraction of this assignment carries over (penalty
            # work counts as progress too — a resumed-then-preempted task
            # re-pays proportionally, not absolutely)
            task.resume_frac *= rec.remaining / rec.work_assigned
        else:
            self.work_lost += max(rec.work_assigned - rec.remaining, 0.0)
        task.preempt_count += 1
        self.tasks_preempted += 1

    def _revoke(self, eidx: int):
        """Apply one revoke edge: episode ``eidx``'s cores — the whole
        partition, or a sub-pod subset — go down; all work on them
        returns to the scheduler and re-places on survivors, HIGH tasks
        first."""
        cores = self.preemption.cores_of(eidx, self.topo)
        for c in cores:
            if not self._core_up[c]:
                raise RuntimeError(f"core {c} revoked twice")
        self._down_cores.update(cores)
        self.preempt_events += 1
        self._set_availability()
        displaced: list[Task] = []
        seen: set[int] = set()
        notice = self.preemption.notice if self.preemption is not None else 0.0
        if notice > 0.0:
            # 1) notice window: running tasks keep executing and are only
            #    preempted at its expiry (token-guarded — a restore before
            #    the expiry lets them run to completion, and a stale event
            #    from an earlier episode can never fire into a later one)
            token = next(self._tok)
            self._notice_token[eidx] = token
            self._push_event(self.now + notice, "notice", eidx, token)
        else:
            # 1) running tasks: any execution with a member core in the
            #    revoked set dies (a place may straddle the revoked subset
            #    and live siblings; dedup via core scan)
            for c in cores:
                rec = self.core_busy[c]
                if rec is not None and rec.task.tid not in seen:
                    seen.add(rec.task.tid)
                    self._preempt_running(rec)
                    displaced.append(rec.task)
        # 2) placed-but-unstarted tasks in the revoked cores' AQs (their
        #    place dies; no progress to account).  A sub-pod revocation
        #    can leave the record's copies in *live* siblings' AQs — pull
        #    those too, or the task would run twice.
        seen.clear()
        down_set = set(cores)
        doomed: list = []
        for c in cores:
            for rec in self.aq[c]:
                if rec.task.tid not in seen:
                    seen.add(rec.task.tid)
                    displaced.append(rec.task)
                    doomed.append(rec)
            self.aq[c].clear()
        for rec in doomed:
            for mc in rec.cores:
                if mc not in down_set:
                    try:
                        self.aq[mc].remove(rec)
                    except ValueError:
                        pass
                    self._mark(mc)      # a freed AQ head may unblock members
        # 3) ready tasks in the revoked cores' WSQs, in steal order
        displaced.extend(self.queues.drain_wsq(cores))
        high, low = split_by_priority(displaced)
        # down cores leave the dispatch sets until restored
        for c in cores:
            self._core_up[c] = False
            self._dirty.discard(c)
            self._starving.discard(c)
        # 4) re-place on the survivors — HIGH tasks re-bind first, so the
        #    critical path recovers before the bulk work lands
        for task in high:
            self._requeue(task)
        for task in low:
            self._requeue(task)

    def _restore(self, eidx: int):
        """Apply one restore edge: the episode's cores re-enter the
        dispatch loop (empty-handed — they steal their way back)."""
        self._down_cores.difference_update(
            self.preemption.cores_of(eidx, self.topo))
        self._notice_token.pop(eidx, None)   # pending notice expiry is void
        self._set_availability()
        for c in self.preemption.cores_of(eidx, self.topo):
            self._core_up[c] = True
            self._mark(c)

    # -------------------------------------------------------------- dispatch
    def _try_assign_from_wsq(self, core: int) -> bool:
        """Pop own WSQ (priority-aware — ``WorkQueues.pop_local`` inlined,
        the flags are per-run constants) and place the task into AQs.  The
        losing copy of a hedged pair may be parked in a WSQ when the winner
        commits; it is dropped — and resolved — here rather than removed
        eagerly."""
        queues = self.queues
        q = queues.wsq[core]
        track = queues.track_load
        pd = queues.priority_dequeue
        while True:
            if pd and q.high:
                task = q.high.popleft()
            elif q.low:
                task = q.low.pop()
            elif q.high:
                task = q.high.popleft()
            else:
                return False
            if track:
                queues.queued_s[core] -= task.load_est
            if self._fx is not None and (task.hedge_of or task).committed:
                self._outstanding -= 1      # hedge loser resolves at pop
                continue
            if self._batching is not None and task.batch_key is not None:
                self.kernel.form_dispatch(task, core)
            self._place_into_aqs(task, core)
            return True

    def _try_steal(self, thief: int) -> bool:
        """Steal from the WSQ with the most stealable tasks (paper step 3),
        FIFO end; re-run the place search at the thief (steps 4-5).  Victim
        selection reads O(cores) queue lengths; maxima tie-break uniformly
        at random, as the shuffled scan did."""
        while True:
            victim = self.queues.pick_victim(thief, self.rng)
            if victim < 0:
                return False
            t = self.queues.steal_pop(victim)     # oldest stealable
            if self._fx is not None and (t.hedge_of or t).committed:
                self._outstanding -= 1      # hedge loser resolves at pop
                continue
            if self._flat:
                t.bound_place = None    # inlined on_steal: decision redone
            else:
                self.kernel.on_steal(t)
            if self._batching is not None and t.batch_key is not None:
                # same-key members still sit in the victim's queue —
                # coalesce there, then execute at the thief
                self.kernel.form_dispatch(t, victim)
            self._place_into_aqs(t, thief)
            return True

    def _place_into_aqs(self, task: Task, worker_core: int):
        # ``_choose_place`` is ``place_on_dequeue`` directly when the flat
        # kernel tracks no load (its only other job is the load charge), so
        # a bound HIGH task skips the call entirely — same decision either way
        place = task.bound_place
        if place is None or not self._inline_choose:
            place = self._choose_place(task, worker_core)
        info = self._leader_info[place.leader]
        if info is None:
            part = self.topo.partition_of(place.leader)
            info = self._leader_info[place.leader] = (
                part.domain, PARTITION_BW[part.kind], part.kind, {})
        domain, cap, kind, bw_by_mems = info
        mem_s = task.type.mem_sensitivity
        if mem_s > 0.0:
            bwkey = bw_by_mems.get(mem_s)
            if bwkey is None:
                key = (domain, cap, mem_s)
                bwkey = self._bwkey_id.get(key)
                if bwkey is None:
                    bwkey = self._bwkey_id[key] = len(self._bwkeys)
                    self._bwkeys.append(key)
                    self._key_factor.append(math.nan)
                    self._dom_bwkeys.setdefault(domain, []).append(bwkey)
                bw_by_mems[mem_s] = bwkey
        else:
            bwkey = -1
        base = task.type.duration(kind, place.width)
        if task.resume_frac != 1.0:
            # checkpointed resume: outstanding fraction of the new place's
            # full duration, plus the resume penalty (restart kills keep
            # resume_frac at 1.0 and take this place's full duration)
            base = base * (task.resume_frac + self._resume_penalty)
        rec = _Running(task, place, remaining=base,
                       domain=domain, cap=cap, bwkey=bwkey)
        if task.preempt_count:
            # version-epoch per execution: a stale finish event from a
            # preempted run must never collide with this run's versions
            # (they are compared for equality), so each re-placement
            # starts a disjoint version range
            rec.version = task.preempt_count << 32
        aq = self.aq
        dirty = self._dirty
        starving = self._starving
        for c in rec.cores:
            aq[c].append(rec)
            dirty.add(c)
            starving.discard(c)

    def _try_start_aq(self, core: int) -> bool:
        """Start the AQ head if every member core has it at head and is idle."""
        aq = self.aq
        busy = self.core_busy
        if busy[core] is not None:
            return False
        q = aq[core]
        if not q:
            return False
        rec = q[0]
        cores = rec.cores
        if len(cores) == 1:     # width-1: the caller's checks suffice
            q.popleft()
            busy[core] = rec
        else:
            for c in cores:
                if busy[c] is not None or not aq[c] or aq[c][0] is not rec:
                    return False
            for c in cores:
                aq[c].popleft()
                busy[c] = rec
        task = rec.task
        task.place = rec.place
        task.t_start = self.now
        self.running[task.tid] = rec
        self._fresh.append(rec)          # rate + finish set by _refresh_rates
        if rec.bw_contrib > 0.0:
            dom = rec.domain
            d, k = self._demand.get(dom, _NO_DEMAND)
            self._demand[dom] = (d + rec.bw_contrib, k + 1)
            self._dirty_domains.add(dom)
        if self._fx is not None:
            self._on_start_faults(rec)
        return True

    def _dispatch(self):
        """Drain the idle-core worklist.  Each round mirrors one pass of the
        old all-cores fixpoint — phase A: local work (AQ head, then own WSQ);
        phase B: idle cores with no local work attempt one steal — but only
        over cores whose state changed.  Round order is shuffled so ties
        break randomly, not by core id."""
        dirty, busy, aq, wsq, up, starving, rng = self._disp_binds
        while dirty:
            if len(dirty) == 1:
                # the overwhelmingly common worklist is a single core
                # (one commit released one place) — no sort, no shuffle
                # draw (the shuffles below only fire on len > 1 anyway)
                batch = [dirty.pop()]
            else:
                batch = sorted(dirty, reverse=True)
                dirty.clear()
                rng.shuffle(batch)
            # phase A: local work only (AQ head, then own WSQ)
            for c in batch:
                if busy[c] is not None or not up[c]:
                    continue
                if aq[c]:
                    self._try_start_aq(c)
                else:
                    self._try_assign_from_wsq(c)
            # phase B: idle cores with empty AQs and WSQs attempt to steal
            # (re-shuffled, like the pre-refactor fixpoint: steal order must
            # not correlate with local-work order)
            if len(batch) > 1:
                rng.shuffle(batch)
            for c in batch:
                q = wsq[c]
                if busy[c] is not None or not up[c] or aq[c] \
                        or q.high or q.low:
                    continue
                if not self._try_steal(c):
                    starving.add(c)

    # ---------------------------------------------------------------- faults
    def _on_start_faults(self, rec: _Running):
        """Arm this execution's injected fault — ``remaining`` is truncated
        to the strike point, so the strike is an ordinary finish event —
        and schedule the straggler check at ``k`` x the PTT expectation
        (token-guarded: commits and re-placements invalidate it).  Hedge
        duplicates run clean: they exist to escape a degraded place."""
        task = rec.task
        if task.hedge_of is not None:
            return
        fault = self._fx.draw(task, self.now)
        if fault is not None:
            rec.fault = fault
            rec.remaining = rec.work_assigned * fault.frac
        exp = self.kernel.expected_duration(task, rec.place)
        if exp > 0.0:
            rec.token = next(self._tok)
            self._push_event(self.now + self._fx.policy.straggler_k * exp,
                             "straggle", task.tid, rec.token)

    def _kill_running(self, rec: _Running, event_outstanding: bool):
        """Remove an execution without committing (fault death or hedge-
        loser cancel): release its cores — marked, unlike a revocation's,
        they are still up and must re-enter dispatch — its bandwidth
        demand, and its finish event."""
        if event_outstanding and rec.rate >= 0:
            self._stale += 1
        rec.version += 1
        del self.running[rec.task.tid]
        for c in rec.cores:
            self.core_busy[c] = None
            self._mark(c)
        if rec.bw_contrib > 0.0:
            dom = rec.domain
            d, k = self._demand[dom]
            self._demand[dom] = _NO_DEMAND if k <= 1 else \
                (d - rec.bw_contrib, k - 1)
            if dom in self._hot_doms:
                self._dirty_domains.add(dom)

    def _on_fault_trigger(self, rec: _Running):
        """The finish event at an armed fault's strike point fired."""
        fault = rec.fault
        if fault.kind == "slow":
            # the place silently degrades: the rest of the work proceeds
            # at 1/factor of the healthy rate; nothing fails, so only the
            # straggler detector can see it
            rec.fault = None
            self.metrics.faults_failslow += 1
            rec.slow_mult = 1.0 / fault.factor
            rec.remaining = rec.work_assigned * (1.0 - fault.frac)
            rec.rate = -1.0         # re-derived (with slow_mult) on refresh
            rec.version += 1
            self._fresh.append(rec)
            return
        self._fail_running(rec)

    def _fail_running(self, rec: _Running):
        """Fail-stop strike: the execution dies.  Penalize the place in
        the PTT, then retry after a seeded backoff (the task re-enters the
        kernel's ``requeue_displaced`` placement at the retry event) or
        fail permanently once the attempt budget is spent."""
        task = rec.task
        pol = self._fx.policy
        self.metrics.faults_failstop += 1
        executed = rec.work_assigned * rec.fault.frac - rec.remaining
        self.metrics.work_lost_faults_s += max(executed, 0.0)
        elapsed = self.now - task.t_start
        rec.fault = None
        self._kill_running(rec, event_outstanding=False)
        self.kernel.fault_feedback(task, rec.place, elapsed, pol.fail_penalty)
        task.fault_count += 1
        if task.hedge_dup is not None and not task.committed:
            # the original died but its speculative duplicate is still in
            # flight — leave recovery to the copy on the healthier place
            self._outstanding -= 1
            return
        if task.fault_count > pol.max_retries:
            self.metrics.failed_tasks += 1
            self.metrics.errors.append(
                f"task {task.tid} ({task.type.name}) failed permanently "
                f"after {task.fault_count - 1} retries")
            self._outstanding -= 1
            return
        self.metrics.retries += 1
        self._pending_retry[task.tid] = task
        self._push_event(self.now + self._fx.backoff(task), "retry", task.tid)

    def _on_straggler(self, rec: _Running):
        """The execution outlived ``k`` x its PTT expectation.  Flag it;
        if hedging is on and the task is HIGH, launch a speculative
        duplicate on the PTT-best place sharing no core with the
        straggler (first commit wins, the loser is cancelled)."""
        task = rec.task
        self.metrics.stragglers += 1
        pol = self._fx.policy
        if (not pol.hedge or task.priority != Priority.HIGH
                or task.hedge_launched or task.committed):
            return
        place = self.kernel.hedge_place(task, set(rec.cores),
                                        self._fx.hedge_rng)
        if place is None:
            return
        task.hedge_launched = True
        dup = Task(type=task.type, priority=task.priority,
                   payload=task.payload)
        dup.hedge_of = task
        dup.bound_place = place     # honored by place_on_dequeue everywhere
        task.hedge_dup = dup
        dup.t_ready = self.now
        self.metrics.hedges_launched += 1
        self._outstanding += 1
        self._place_into_aqs(dup, place.leader)

    def _cancel_copy(self, task: Task):
        """Reap the losing copy of a hedged pair: kill it if running, drop
        a pending retry or an AQ placement; a WSQ entry is dropped (and
        resolved) lazily at the next pop.  Each copy resolves exactly
        once."""
        self.kernel.discharge(task)     # whatever load it held is void
        rec = self.running.get(task.tid)
        if rec is not None:
            executed = rec.work_assigned - rec.remaining
            if rec.fault is not None:
                executed = rec.work_assigned * rec.fault.frac - rec.remaining
                rec.fault = None
            self.metrics.work_hedged_s += max(executed, 0.0)
            self._kill_running(rec, event_outstanding=True)
            self._outstanding -= 1
            return
        if self._pending_retry.pop(task.tid, None) is not None:
            self._outstanding -= 1
            return
        for dq in self.aq:
            for r in dq:
                if r.task is task:
                    for c in r.cores:
                        try:
                            self.aq[c].remove(r)
                        except ValueError:
                            pass
                        self._mark(c)   # freed AQ heads may unblock members
                    self._outstanding -= 1
                    return

    def _suppress_commit(self, rec: _Running):
        """A losing copy ran to completion after the logical task had
        already committed (normally unreachable — cancellation reaps
        losers first; kept so the invariants hold if one slips through)."""
        self.kernel.discharge(rec.task)
        self.metrics.work_hedged_s += max(rec.work_assigned - rec.remaining,
                                          0.0)
        self._kill_running(rec, event_outstanding=False)
        self._outstanding -= 1

    def _notice_expire(self, eidx: int):
        """The revocation notice window closed with the episode's cores
        still down: preempt whatever is still running there (work
        finished inside the window committed normally — that is the
        point)."""
        del self._notice_token[eidx]
        displaced: list[Task] = []
        seen: set[int] = set()
        for c in self.preemption.cores_of(eidx, self.topo):
            rec = self.core_busy[c]
            if rec is not None and rec.task.tid not in seen:
                seen.add(rec.task.tid)
                self._preempt_running(rec)
                displaced.append(rec.task)
        high, low = split_by_priority(displaced)
        for task in high:
            self._requeue(task)
        for task in low:
            self._requeue(task)

    # --------------------------------------------------------------- commit
    def _commit(self, rec: _Running):
        task = rec.task
        if self._fx is not None:
            logical = task.hedge_of or task
            if logical.committed:
                self._suppress_commit(rec)  # the other copy already won
                return
            logical.committed = True
            if task.hedge_of is not None:
                self.metrics.hedge_wins += 1
                self._cancel_copy(logical)          # the original lost
            elif task.hedge_dup is not None:
                self._cancel_copy(task.hedge_dup)   # the duplicate lost
        task.t_end = self.now
        busy = self.core_busy
        dirty = self._dirty
        starving = self._starving
        for c in rec.cores:
            busy[c] = None
            dirty.add(c)
            starving.discard(c)
        del self.running[task.tid]
        members = task.batch_members or ()
        self._done += 1 + len(members)
        self._outstanding -= 1 + len(members)
        if rec.bw_contrib > 0.0:
            dom = rec.domain
            d, k = self._demand[dom]
            # pin the total back to exactly zero when the domain drains so
            # incremental +/- never accumulates float residue
            self._demand[dom] = _NO_DEMAND if k <= 1 else \
                (d - rec.bw_contrib, k - 1)
            if dom in self._hot_doms:
                self._dirty_domains.add(dom)

        # Leader measures and updates the PTT (with measurement noise +
        # heavy-tailed spikes from OS jitter on short tasks).  Flat-kernel
        # inline of observe_simulated + ptt_feedback: same draws from the
        # same stream in the same order, same EMA fold.
        ttype = task.type
        if self._flat:
            rng = self.rng
            if ttype.noise:
                noise = rng.gauss(1.0, ttype.noise)
                if noise < 0.5:     # same doubles as min(max(n,.5),2.)
                    noise = 0.5
                elif noise > 2.0:
                    noise = 2.0
                observed = (task.t_end - task.t_start) * noise
            else:
                observed = (task.t_end - task.t_start) * 1.0
            if ttype.spike_prob and rng.random() < ttype.spike_prob:
                observed *= ttype.spike_mag
            if self._track_load:
                self.kernel.discharge(task)
            tbl = self._ptt_for.get(ttype.name)
            if tbl is None:
                tbl = self._ptt_for[ttype.name] = \
                    self._ptt_bank.for_type(ttype.name)
            tbl.update_nolock(rec.place, observed)
            if members and self._track_load:
                for m in members:
                    self.kernel.discharge(m)
        else:
            observed = self.kernel.observe_simulated(
                ttype, task.t_end - task.t_start)
            if members:
                self.kernel.batch_feedback(task, rec.place, observed)
            else:
                self.kernel.ptt_feedback(task, rec.place, observed)

        # A winning duplicate commits on behalf of its logical task:
        # successors and the record's sojourn anchor come from it.
        src = task if task.hedge_of is None else task.hedge_of
        leader = rec.place.leader
        self._rec_append(TaskRecord(
            ttype.name, int(task.priority), leader, rec.place.width,
            src.t_ready, task.t_start, task.t_end))
        if members:
            base = ttype.batch_base or ttype.name
            self.metrics.batches.append((ttype.name, tuple(sorted(
                [base] + [m.type.name for m in members]))))
            for m in members:
                m.t_start = task.t_start
                m.t_end = task.t_end

        # Wake dependents; dynamic DAG growth.  Flat-kernel inline of
        # commit_successors (same dependency bookkeeping, no generator):
        # the DES is single-threaded, so the lockless decrement is exact.
        # A batched dispatch walks the leader's successors first, then
        # each member's in coalesce order — same order as the threaded
        # engine's commit.
        if self._flat:
            for child in src.children:
                child.n_deps -= 1
                if child.n_deps == 0:
                    self._wake(child, leader)
            if src.on_commit is not None:
                for new_task in src.on_commit(src):
                    if new_task.n_deps == 0:
                        self._wake(new_task, leader)
            for m in members:
                for child in m.children:
                    child.n_deps -= 1
                    if child.n_deps == 0:
                        self._wake(child, leader)
                if m.on_commit is not None:
                    for new_task in m.on_commit(m):
                        if new_task.n_deps == 0:
                            self._wake(new_task, leader)
        else:
            for ready in self.kernel.commit_successors(src):
                self._wake(ready, leader)
            for m in members:
                for ready in self.kernel.commit_successors(m):
                    self._wake(ready, leader)

    # ------------------------------------------------------------------ run
    def _run_scalar(self):
        """Reference event loop: one event per iteration, bookkeeping
        (dispatch / rate refresh / compaction / termination) after every
        live event.  Retained verbatim as the bit-identity oracle for the
        cohort loop (``tests/test_cohort_parity.py``)."""
        events = self._events
        running = self.running
        while events:
            t, _, kind, tid, version = heapq.heappop(events)
            if t > self.horizon:
                break
            if kind == "finish":
                rec = running.get(tid)
                if rec is None or rec.version != version:
                    self._stale -= 1               # stale (lazy deletion)
                    continue
                self._advance(t)
                if rec.remaining > 1e-9 * max(rec.rate, 1.0):
                    rec.version += 1               # numeric drift: reschedule
                    self._push_event(self.now + rec.remaining / rec.rate,
                                     "finish", tid, rec.version)
                    continue
                if rec.fault is not None:
                    self._on_fault_trigger(rec)    # armed strike point
                else:
                    self._commit(rec)
            elif kind == "straggle":
                rec = running.get(tid)
                if rec is None or rec.token != version:
                    continue       # execution already ended or re-placed
                self._advance(t)
                self._on_straggler(rec)
            elif kind == "retry":
                retry_task = self._pending_retry.pop(tid, None)
                if retry_task is None:
                    continue       # cancelled while in backoff
                self._advance(t)
                self._requeue(retry_task)
            elif kind == "notice":
                if self._notice_token.get(tid) != version:
                    continue       # partition restored (or re-revoked)
                self._advance(t)
                self._notice_expire(tid)
            else:   # speed / bg / revoke / restore / control-plane event
                self._advance(t)
                if kind == "speed":
                    self._recompute_speed()
                    nb = self.speed.next_breakpoint(t)
                    if nb is not None and nb <= self.horizon:
                        self._push_event(nb, "speed")
                elif kind == "bg":
                    self._recompute_bg()
                elif kind == "revoke":
                    self._revoke(tid)
                elif kind == "restore":
                    self._restore(tid)
                elif kind == "decide":
                    self._decide(tid)
                elif kind == "migrate":
                    self._migrate_land(tid)
                elif kind == "rebalance":
                    self._rebalance()
                elif kind == "reshard":
                    self._reshard(tid)
            self._dispatch()
            self._refresh_rates()
            self._maybe_compact()
            if self._outstanding == 0 and not running:
                break

    def _run_cohort(self):
        """Array-native event loop.  Pops the full same-timestamp cohort in
        an inner loop sharing one rate-integration advance per unique
        timestamp (vectorized across the running set past ``_vec_min``) and
        one compaction check per cohort; stale events take a fast path that
        touches nothing but the lazy-deletion counter, and dispatch/refresh
        only run when their dirty state says there is work.  Decision points
        fire in exactly the scalar reference order, so results are
        bit-identical to ``_run_scalar`` (pinned by the parity suite).

        Rate refresh stays per live event rather than deferring to the
        cohort boundary: two refresh-triggering events at one timestamp
        would otherwise fold into a single EMA-free recompute whose rates
        can differ from the eager pair's within the ``_EPS`` change test,
        silently nudging finish times off the scalar path.
        """
        events = self._events
        running = self.running
        heappop = heapq.heappop
        horizon = self.horizon
        dirty = self._dirty
        fresh = self._fresh
        dirty_domains = self._dirty_domains
        load_coupled = self._load_coupled
        pending_retry = self._pending_retry
        notice_token = self._notice_token
        while events:
            ev = heappop(events)
            t = ev[0]
            if t > horizon:
                break
            while True:
                kind = ev[2]
                live = True
                if kind == "finish":
                    rec = running.get(ev[3])
                    if rec is None or rec.version != ev[4]:
                        self._stale -= 1           # stale (lazy deletion)
                        live = False
                    else:
                        if self.now != t:
                            self._advance(t)
                        rate = rec.rate
                        if rec.remaining > 1e-9 * (rate if rate > 1.0
                                                   else 1.0):
                            rec.version += 1       # drift: reschedule
                            self._push_event(t + rec.remaining / rate,
                                             "finish", ev[3], rec.version)
                            live = False
                        elif rec.fault is not None:
                            self._on_fault_trigger(rec)
                        else:
                            self._commit(rec)
                elif kind == "straggle":
                    rec = running.get(ev[3])
                    if rec is None or rec.token != ev[4]:
                        live = False   # execution already ended or re-placed
                    else:
                        if self.now != t:
                            self._advance(t)
                        self._on_straggler(rec)
                elif kind == "retry":
                    retry_task = pending_retry.pop(ev[3], None)
                    if retry_task is None:
                        live = False   # cancelled while in backoff
                    else:
                        if self.now != t:
                            self._advance(t)
                        self._requeue(retry_task)
                elif kind == "notice":
                    if notice_token.get(ev[3]) != ev[4]:
                        live = False   # partition restored (or re-revoked)
                    else:
                        if self.now != t:
                            self._advance(t)
                        self._notice_expire(ev[3])
                else:   # speed / bg / revoke / restore / control-plane
                    if self.now != t:
                        self._advance(t)
                    if kind == "speed":
                        self._recompute_speed()
                        nb = self.speed.next_breakpoint(t)
                        if nb is not None and nb <= horizon:
                            self._push_event(nb, "speed")
                    elif kind == "bg":
                        self._recompute_bg()
                    elif kind == "revoke":
                        self._revoke(ev[3])
                    elif kind == "restore":
                        self._restore(ev[3])
                    elif kind == "decide":
                        self._decide(ev[3])
                    elif kind == "migrate":
                        self._migrate_land(ev[3])
                    elif kind == "rebalance":
                        self._rebalance()
                    elif kind == "reshard":
                        self._reshard(ev[3])
                if live:
                    if dirty:
                        self._dispatch()
                    if (fresh or dirty_domains or self._rates_global_dirty
                            or load_coupled):
                        self._refresh_rates()
                    if self._outstanding == 0 and not running:
                        return
                if not events or events[0][0] != t:
                    break
                ev = heappop(events)
            stale = self._stale
            if (stale > self._compact_min_stale
                    and stale > self._compact_heap_frac * len(events)):
                self._maybe_compact()

    def run(self) -> RunMetrics:
        for b in self.background:
            if b.t_start > 0:
                self._push_event(b.t_start, "bg")
            if b.t_end < self.horizon:
                self._push_event(b.t_end, "bg")
        if self.preemption is not None:
            n_parts = len(self.topo.partitions)
            for eidx, (pidx, t0, t1) in enumerate(self.preemption.episodes):
                if not 0 <= pidx < n_parts:
                    raise ValueError(f"preemption episode for partition "
                                     f"{pidx}; topology has {n_parts}")
                if t0 <= self.horizon:
                    self._push_event(t0, "revoke", eidx)
                    if t1 <= self.horizon:
                        self._push_event(t1, "restore", eidx)
        if (self._n_shards > 1
                and self.sharding.rebalance_period_s > 0.0):
            self._push_event(self.sharding.rebalance_period_s, "rebalance")
        for i, (t, _) in enumerate(self._reshard_at):
            if t <= self.horizon:
                self._push_event(t, "reshard", i)
        # speed breakpoints are *pulled* lazily — one outstanding event at
        # a time, the next asked of the profile only when it fires — so a
        # DVFS wave spanning the 1e6 s horizon contributes O(1) heap
        # entries and closed-form profiles never enumerate anything
        nb = self.speed.next_breakpoint(0.0)
        if nb is not None and nb <= self.horizon:
            self._push_event(nb, "speed")

        self._dispatch()
        self._refresh_rates()
        if self.event_mode == "scalar":
            self._run_scalar()
        else:
            self._run_cohort()
        # a run that finishes mid-outage must not leak its availability
        # mask into later runs reusing the scheduler (PTT state is meant
        # to carry across runs; a revoked-capacity view is not)
        self.kernel.end_run()
        self.metrics.finish(self.now)
        self.metrics.preempt_events = self.preempt_events
        self.metrics.tasks_preempted = self.tasks_preempted
        self.metrics.work_lost_s = self.work_lost
        if self._n_shards > 1:
            self.metrics.migrations = self.kernel.migrations
            self.metrics.overflow_migrations = self.kernel.overflow_migrations
            self.metrics.rebalance_rounds = self.kernel.rebalance_rounds
            self.metrics.migrated_load_s = self.kernel.migrated_load_s
            self.metrics.reshard_rounds = self.kernel.reshard_rounds
        return self.metrics


def simulate(dag: DAG, scheduler: Scheduler, *,
             speed: Optional[SpeedProfileBase] = None,
             background: Iterable[BackgroundApp] = (),
             preemption: Optional[PreemptionModel] = None,
             faults: Optional[FaultModel] = None,
             recovery: Optional[RecoveryPolicy] = None,
             sharding: Optional[ShardingSpec] = None,
             batching: Optional[BatchingConfig] = None,
             reshard_at: Iterable[tuple[float, int]] = (),
             horizon: float = 1e6,
             event_mode: str = "cohort",
             compact_min_stale: int = _COMPACT_MIN_STALE,
             compact_heap_frac: float = _COMPACT_HEAP_FRAC) -> RunMetrics:
    sim = Simulator(scheduler, speed=speed, background=background,
                    preemption=preemption, faults=faults, recovery=recovery,
                    sharding=sharding, batching=batching,
                    reshard_at=reshard_at, horizon=horizon,
                    event_mode=event_mode,
                    compact_min_stale=compact_min_stale,
                    compact_heap_frac=compact_heap_frac)
    sim.submit(dag)
    return sim.run()
