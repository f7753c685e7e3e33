"""Interference scenarios (paper §5): co-running applications and DVFS.

Dynamic asymmetry is injected through two mechanisms, matching the paper:

* **Speed profiles** — per-core piecewise-constant speed multipliers.  The
  abstract interface (:class:`SpeedProfileBase`) is two queries: ``speed
  (core, t)`` and ``next_breakpoint(t)`` — the *lazy pull* contract the
  discrete-event engine schedules from (one outstanding breakpoint event
  at a time; nothing is ever enumerated up front).  Implementations:

  - :class:`SpeedProfile` — explicit sorted segment lists per core.  The
    general-purpose container: windows (§5.4 episodes), constants, and
    materialized square waves compose freely on it.
  - :class:`PeriodicProfile` — a repeating pattern of (duration, speed)
    phases evaluated *in closed form*: ``speed``/``next_breakpoint`` are
    O(pattern) arithmetic, no segments are ever materialized, so a DVFS
    square wave spanning a 1e6 s horizon costs O(1) memory instead of the
    ~200k segments per core the materialized form needs.  When the phase
    boundaries are exact in floating point (e.g. the Denver 5 s + 5 s
    wave), its breakpoints and speeds are bit-identical to the
    materialized equivalent — ``dvfs_denver`` returns one.
  - :class:`TraceProfile` — replayed per-core speed traces (recorded or
    synthesized; :func:`random_walk_trace` builds a seeded synthetic one).

* ``BackgroundApp`` — a co-running application modeled as an endless chain
  of tasks pinned to specific cores, *outside* the scheduler's control.
  It time-shares its cores with foreground tasks (OS CFS ~ 50/50) and, for
  streaming kernels, pressures the partition's shared memory bandwidth.
  This mirrors §5.1's single-chain matmul / copy co-runners on core 0 and
  §5.4's 5-core interferer on one socket.  :func:`burst_episodes` builds
  bursty on/off co-runner episodes from a seeded arrival process.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Mapping, Optional, Sequence

from .task import TaskType


class SpeedProfileBase:
    """Abstract per-core speed multiplier, piecewise constant in t.

    The simulator consumes profiles through exactly two queries:

    * ``speed(core, t)`` — the multiplier in force at time ``t``;
    * ``next_breakpoint(t)`` — the earliest instant strictly after ``t``
      at which *any* core's speed changes, or ``None`` if there is none.

    ``next_breakpoint`` is the lazy pull model: the engine keeps a single
    outstanding speed event and asks for the next one only when it fires,
    so profiles never need to enumerate their breakpoints eagerly.
    """

    n_cores: int

    def speed(self, core: int, t: float) -> float:
        raise NotImplementedError

    def speeds_at(self, t: float) -> list[float]:
        """Every core's multiplier at ``t`` in one call.  The DES pulls
        this on each speed breakpoint (the whole vector is re-derived at
        once at a cohort boundary), so profiles can specialize the bulk
        query; the default — and the contract any override must keep —
        is element-wise identical to looping :meth:`speed`."""
        return [self.speed(c, t) for c in range(self.n_cores)]

    def next_breakpoint(self, t: float) -> Optional[float]:
        raise NotImplementedError

    def breakpoints(self, horizon: float) -> list[float]:
        """All speed-change instants in (0, horizon], eagerly (diagnostic /
        test helper — the engine itself only ever pulls).  ``horizon`` must
        be finite: an unbounded periodic profile has infinitely many."""
        if not math.isfinite(horizon):
            raise ValueError(f"breakpoints() needs a finite horizon, "
                             f"got {horizon!r}")
        out: list[float] = []
        t = 0.0
        while True:
            nb = self.next_breakpoint(t)
            if nb is None or nb > horizon:
                return out
            out.append(nb)
            t = nb


class SpeedProfile(SpeedProfileBase):
    """Explicit segment lists: speed(core, t) via bisect over sorted
    (t_start, speed) pairs with an implicit (0.0, 1.0) head."""

    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        # per core: sorted list of (t_start, speed); implicit (0.0, 1.0) head
        self._segs: list[list[tuple[float, float]]] = [[(0.0, 1.0)] for _ in range(n_cores)]
        self._bps: Optional[list[float]] = None   # merged cache, built lazily

    def set_constant(self, cores: Sequence[int], speed: float) -> "SpeedProfile":
        for c in cores:
            self._segs[c] = [(0.0, speed)]
        self._bps = None
        return self

    def add_square_wave(self, cores: Sequence[int], *, period: float,
                        lo: float, hi: float = 1.0, t_end: float = 1e6,
                        hi_first: bool = True) -> "SpeedProfile":
        """DVFS-style alternation: hi for period/2, lo for period/2, ...
        materialized as explicit segments (the last phase started before
        ``t_end`` persists).  Prefer :meth:`PeriodicProfile.square_wave`
        for long horizons — same semantics, closed form."""
        for c in cores:
            segs = []
            t, phase_hi = 0.0, hi_first
            while t < t_end:
                segs.append((t, hi if phase_hi else lo))
                t += period / 2
                phase_hi = not phase_hi
            self._segs[c] = segs
        self._bps = None
        return self

    def add_window(self, cores: Sequence[int], t0: float, t1: float,
                   speed: float) -> "SpeedProfile":
        """Override speed on [t0, t1) (e.g. an interference episode that
        starts a few iterations in, paper §5.4).  At ``t1`` the profile
        resumes whatever speed was previously in force there — including
        over the final (infinite) segment."""
        if not 0.0 <= t0 < t1:
            raise ValueError(f"bad window [{t0}, {t1})")
        for c in cores:
            old = self._segs[c]
            new = [(ts, sp) for ts, sp in old if ts < t0]
            new.append((t0, speed))
            if t1 != float("inf"):
                i = bisect.bisect_right(old, (t1, float("inf"))) - 1
                new.append((t1, old[max(i, 0)][1]))   # pre-window speed resumes
                new.extend((ts, sp) for ts, sp in old if ts > t1)
            self._segs[c] = new
        self._bps = None
        return self

    def speed(self, core: int, t: float) -> float:
        segs = self._segs[core]
        i = bisect.bisect_right(segs, (t, float("inf"))) - 1
        return segs[max(i, 0)][1]

    def speeds_at(self, t: float) -> list[float]:
        # constant cores (the untouched majority in sparse profiles) skip
        # the bisect; multi-segment cores compute the same double speed()
        # would, keeping the base-class element-wise contract
        key = (t, float("inf"))
        return [segs[0][1] if len(segs) == 1
                else segs[max(bisect.bisect_right(segs, key) - 1, 0)][1]
                for segs in self._segs]

    def _merged_bps(self) -> list[float]:
        if self._bps is None:
            self._bps = sorted({ts for segs in self._segs
                                for ts, _ in segs if ts > 0.0})
        return self._bps

    def next_breakpoint(self, t: float) -> Optional[float]:
        bps = self._merged_bps()
        i = bisect.bisect_right(bps, t)
        return bps[i] if i < len(bps) else None

    def breakpoints(self, horizon: float) -> list[float]:
        bps = self._merged_bps()
        return bps[:bisect.bisect_right(bps, horizon)]


@dataclasses.dataclass(frozen=True)
class _Pattern:
    """One repeating per-core pattern: phase j covers
    [q*period + offsets[j], q*period + offsets[j+1]) at speeds[j].
    ``last_start`` is the start of the final phase generated before
    ``t_end`` (that phase persists forever, mirroring the materialized
    square wave); None means the pattern repeats unbounded."""

    offsets: tuple[float, ...]
    speeds: tuple[float, ...]
    period: float
    t_end: float
    last_start: Optional[float]


class PeriodicProfile(SpeedProfileBase):
    """Closed-form repeating speed pattern — no segment materialization.

    Each core carries an optional :class:`_Pattern`; ``speed`` and
    ``next_breakpoint`` are O(pattern length) arithmetic (floor-divide into
    the current period + bisect over the within-period phase offsets), so
    construction and memory are independent of the horizon.  Breakpoints
    are generated as ``q*period + offset``: when those products are exact
    in floating point (dyadic phase lengths such as the Denver 5 s + 5 s
    wave) the breakpoint/speed sequence is bit-identical to the segment-
    materialized :meth:`SpeedProfile.add_square_wave` equivalent.
    """

    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        self._pat: list[Optional[_Pattern]] = [None] * n_cores
        self._distinct: list[_Pattern] = []   # deduped; kept by set_pattern

    def set_pattern(self, cores: Sequence[int],
                    phases: Sequence[tuple[float, float]], *,
                    t_end: float = 1e6) -> "PeriodicProfile":
        """Repeat ``phases`` — (duration, speed) pairs — from t=0.  New
        phases start only strictly before ``t_end``; the last one started
        persists forever (the semantics of the materialized square wave)."""
        if not phases:
            raise ValueError("empty pattern")
        offsets, speeds, acc = [], [], 0.0
        for dur, sp in phases:
            if dur <= 0.0:
                raise ValueError(f"non-positive phase duration {dur}")
            offsets.append(acc)
            speeds.append(sp)
            acc += dur
        pat = _Pattern(tuple(offsets), tuple(speeds), acc, t_end,
                       self._last_start(tuple(offsets), acc, t_end))
        for c in cores:
            self._pat[c] = pat
        # rebuild the deduped pattern list here (mutations are rare) so
        # next_breakpoint never rescans all cores on the hot path;
        # _Pattern is a frozen dataclass, so value equality collapses
        # per-partition copies of the same wave into one scan entry
        seen: list[_Pattern] = []
        for p in self._pat:
            if p is not None and p not in seen:
                seen.append(p)
        self._distinct = seen
        return self

    @classmethod
    def square_wave(cls, n_cores: int, cores: Sequence[int], *,
                    period: float, lo: float, hi: float = 1.0,
                    t_end: float = 1e6,
                    hi_first: bool = True) -> "PeriodicProfile":
        """Closed-form equivalent of :meth:`SpeedProfile.add_square_wave`."""
        half = period / 2
        first, second = (hi, lo) if hi_first else (lo, hi)
        return cls(n_cores).set_pattern(
            cores, ((half, first), (half, second)), t_end=t_end)

    @staticmethod
    def _last_start(offsets: tuple[float, ...], period: float,
                    t_end: float) -> Optional[float]:
        """Largest phase start strictly below t_end (None = unbounded)."""
        if t_end == float("inf"):
            return None
        q = math.floor(t_end / period)
        for qq in (q, q - 1):
            if qq < 0:
                continue
            base = qq * period
            for off in reversed(offsets):
                p = base + off
                if p < t_end:
                    return p
        return 0.0

    def _phase_at(self, pat: _Pattern, t: float) -> float:
        """Speed of the phase whose start is the largest generated
        breakpoint <= t.  Phase starts are enumerated as the exact float
        values ``qq*period + off`` — the same expressions
        ``next_breakpoint`` emits — so at a pulled breakpoint instant this
        always returns the *post*-flip speed.  (Reconstructing the
        within-period remainder arithmetically instead can round just
        below the offset at non-dyadic periods, silently losing flips.)"""
        q = math.floor(t / pat.period)
        if q * pat.period > t:            # fp guard: floor landed one high
            q -= 1
        for qq in (q + 1, q, q - 1):      # boundary values may round across
            if qq < 0:
                continue
            base = qq * pat.period
            for j in range(len(pat.offsets) - 1, -1, -1):
                if base + pat.offsets[j] <= t:
                    return pat.speeds[j]
        return pat.speeds[0]

    def speed(self, core: int, t: float) -> float:
        pat = self._pat[core]
        if pat is None:
            return 1.0
        if pat.last_start is not None and t > pat.last_start:
            t = pat.last_start            # final generated phase persists
        return self._phase_at(pat, t)

    def next_breakpoint(self, t: float) -> Optional[float]:
        nxt = None
        for pat in self._distinct:
            q = max(math.floor(t / pat.period), 0)
            if q * pat.period > t:
                q -= 1
            p = None
            for qq in (q, q + 1, q + 2):
                base = qq * pat.period
                for off in pat.offsets:
                    cand = base + off
                    if cand > t:
                        p = cand
                        break
                if p is not None:
                    break
            if p is None or p >= pat.t_end:
                continue
            if nxt is None or p < nxt:
                nxt = p
        return nxt


class TraceProfile(SpeedProfile):
    """Per-core speed traces replayed verbatim.

    ``traces`` maps core -> sequence of (t, speed) points with strictly
    increasing times; the core runs at the last point's speed from its
    time onward (and at 1.0 before the first point if it starts after 0).
    Cores without a trace run at 1.0 throughout.
    """

    def __init__(self, n_cores: int,
                 traces: Mapping[int, Sequence[tuple[float, float]]]):
        super().__init__(n_cores)
        for core, pts in traces.items():
            if not 0 <= core < n_cores:
                raise ValueError(f"trace core {core} outside 0..{n_cores - 1}")
            segs: list[tuple[float, float]] = []
            prev = -1.0
            for t, sp in pts:
                if t < 0.0 or t <= prev:
                    raise ValueError(
                        f"trace for core {core}: times must be "
                        f"non-negative and strictly increasing")
                if sp <= 0.0:
                    raise ValueError(f"trace for core {core}: speed {sp} <= 0")
                segs.append((float(t), float(sp)))
                prev = t
            if not segs:
                continue
            if segs[0][0] > 0.0:
                segs.insert(0, (0.0, 1.0))
            self._segs[core] = segs
        self._bps = None


def random_walk_trace(n_cores: int, cores: Sequence[int] = (), *,
                      seed: int, dt: float, t_end: float, lo: float = 0.2,
                      hi: float = 1.0, step: float = 0.15) -> TraceProfile:
    """Synthetic trace: each core's speed does a seeded bounded random walk
    in [lo, hi], one step every ``dt`` seconds until ``t_end``.  Stands in
    for recorded co-tenancy traces in the scenario sweeps; each core gets
    an independent stream derived from (seed, core) so the profile is
    reproducible point-for-point."""
    if not 0.0 < lo <= hi:
        raise ValueError(f"bad speed range [{lo}, {hi}]")
    if dt <= 0.0 or not math.isfinite(t_end):
        raise ValueError("random_walk_trace needs dt > 0 and a finite t_end")
    cores = tuple(cores) if cores else tuple(range(n_cores))
    traces = {}
    for c in cores:
        rng = random.Random(f"trace-walk:{seed}:{c}")
        sp = lo + (hi - lo) * rng.random()
        pts, k, t = [], 0, 0.0
        while t < t_end:
            pts.append((t, sp))
            sp = min(hi, max(lo, sp + rng.uniform(-step, step)))
            k += 1
            t = k * dt
        traces[c] = pts
    return TraceProfile(n_cores, traces)


@dataclasses.dataclass(frozen=True)
class BackgroundApp:
    """An endless chain of ``task_type`` tasks pinned to ``cores``.

    ``t_start``/``t_end`` bound the episode.  Each pinned core runs one
    background stream (the paper's co-runner is a single chain on core 0;
    the Haswell experiment uses 5 cores of one socket).

    A foreground task time-sharing a pinned core runs at
    ``speed/(1+n_bg) * (1-thrash)``: the OS gives it a fair share and the
    co-runner additionally evicts its private-cache working set."""

    task_type: TaskType
    cores: tuple[int, ...]
    t_start: float = 0.0
    t_end: float = float("inf")
    thrash: float = 0.35

    def active(self, t: float) -> bool:
        return self.t_start <= t < self.t_end


# -- canonical paper scenarios ----------------------------------------------

def corun_chain(task_type: TaskType, core: int = 0, *, t_start: float = 0.0,
                t_end: float = float("inf")) -> BackgroundApp:
    """Paper §5.1: a single task chain (matmul or copy kernels) on core 0
    that persists for the whole execution."""
    return BackgroundApp(task_type, (core,), t_start, t_end)


def corun_socket(task_type: TaskType, cores: Sequence[int], *,
                 t_start: float = 0.0, t_end: float = float("inf")) -> BackgroundApp:
    """Paper §5.4: interfering matmul kernels on 5 cores of one socket."""
    return BackgroundApp(task_type, tuple(cores), t_start, t_end)


def renewal_on_off(rng: random.Random, *, t_start: float, t_end: float,
                   mean_on: float, mean_off: float) -> list[tuple[float, float]]:
    """Alternating seeded exponential off/on intervals: the two-state
    renewal process behind :func:`burst_episodes` and the independent
    pod-slice preemption episodes (``repro.core.preemption``).  Returns
    non-overlapping ``(t0, t1)`` busy windows in [t_start, t_end); the
    draw sequence is one ``expovariate`` per gap then one per episode, so
    the output is a pure function of the RNG state and the parameters."""
    if not math.isfinite(t_end):
        raise ValueError("renewal_on_off needs a finite t_end")
    if mean_on <= 0.0 or mean_off <= 0.0:
        raise ValueError("mean_on and mean_off must be positive")
    episodes: list[tuple[float, float]] = []
    t = t_start
    while True:
        t += rng.expovariate(1.0 / mean_off)     # idle gap
        if t >= t_end:
            return episodes
        e1 = min(t + rng.expovariate(1.0 / mean_on), t_end)
        episodes.append((t, e1))
        t = e1


def mmpp_state_timeline(rng: random.Random, *, t_end: float,
                        mean_calm: float,
                        mean_storm: float) -> list[tuple[float, int]]:
    """Modulating chain of an MMPP: seeded exponential sojourns alternating
    between state 0 (calm) and state 1 (storm), starting calm at t=0.
    Returns the (t, state) change points; consumers treat each state as in
    force until the next point (the last persists to ``t_end``)."""
    if not math.isfinite(t_end):
        raise ValueError("mmpp_state_timeline needs a finite t_end")
    if mean_calm <= 0.0 or mean_storm <= 0.0:
        raise ValueError("mean_calm and mean_storm must be positive")
    out = [(0.0, 0)]
    t, s = 0.0, 0
    while True:
        t += rng.expovariate(1.0 / (mean_calm if s == 0 else mean_storm))
        if t >= t_end:
            return out
        s ^= 1
        out.append((t, s))


def mmpp_on_off(rng: random.Random, timeline: Sequence[tuple[float, int]], *,
                t_end: float, mean_on: float, mean_off_calm: float,
                mean_off_storm: float) -> list[tuple[float, float]]:
    """On/off episodes whose *idle-gap* rate is modulated by ``timeline``
    (an MMPP state sequence from :func:`mmpp_state_timeline`): gaps draw
    exponential lengths with mean ``mean_off_calm`` or ``mean_off_storm``
    depending on the state in force, re-drawn (memorylessly) at each state
    change; episode lengths draw from ``mean_on`` regardless of state.
    With a shared timeline across several callers the episodes *cluster in
    time* — the correlated-burst / maintenance-wave signature."""
    if mean_on <= 0.0 or mean_off_calm <= 0.0 or mean_off_storm <= 0.0:
        raise ValueError("episode/gap means must be positive")
    episodes: list[tuple[float, float]] = []
    t, i = 0.0, 0
    while t < t_end:
        # walk modulation segments, drawing a fresh gap in each (the
        # exponential is memoryless, so re-drawing at a boundary is the
        # standard piecewise construction)
        while True:
            while i + 1 < len(timeline) and timeline[i + 1][0] <= t:
                i += 1
            seg_end = timeline[i + 1][0] if i + 1 < len(timeline) else t_end
            mean_off = (mean_off_calm if timeline[i][1] == 0
                        else mean_off_storm)
            gap = rng.expovariate(1.0 / mean_off)
            if t + gap < seg_end:
                t += gap
                break
            t = seg_end
            if t >= t_end:
                return episodes
        e1 = min(t + rng.expovariate(1.0 / mean_on), t_end)
        episodes.append((t, e1))
        t = e1
    return episodes


def burst_episodes(task_type: TaskType, cores: Sequence[int], *, seed: int,
                   t_end: float, mean_on: float, mean_off: float,
                   t_start: float = 0.0,
                   thrash: float = 0.35) -> tuple[BackgroundApp, ...]:
    """Bursty on/off co-runner: a seeded two-state renewal process.

    Idle gaps and busy episodes draw i.i.d. exponential lengths
    (``mean_off`` / ``mean_on`` seconds) via :func:`renewal_on_off`,
    materialized as a tuple of non-overlapping :class:`BackgroundApp`
    episodes over [t_start, t_end).  The episode list depends only on
    ``seed`` and the parameters, never on process state, so multi-run
    cells stay reproducible.  ``t_end`` must be finite (it bounds the
    episode count).
    """
    rng = random.Random(f"burst:{seed}")
    windows = renewal_on_off(rng, t_start=t_start, t_end=t_end,
                             mean_on=mean_on, mean_off=mean_off)
    return tuple(BackgroundApp(task_type, tuple(cores), t0, t1, thrash)
                 for t0, t1 in windows)


def mmpp_burst_episodes(task_type: TaskType, core_groups: Sequence[Sequence[int]],
                        *, seed: int, t_end: float, mean_on: float,
                        mean_calm: float, mean_storm: float,
                        mean_off_calm: float, mean_off_storm: float,
                        thrash: float = 0.35) -> tuple[BackgroundApp, ...]:
    """MMPP-*correlated* co-runner bursts across several core groups.

    One hidden calm/storm modulating chain (seeded from ``seed`` alone,
    :func:`mmpp_state_timeline`) is shared by every group in
    ``core_groups``; each group then draws its own on/off episodes from a
    per-group stream through :func:`mmpp_on_off` — frequent bursts while
    the shared chain is stormy (``mean_off_storm`` idle gaps, typically
    short), rare ones while calm.  Because the chain is shared, bursts
    *cluster in time across groups* — several pods get hammered in the
    same storm, which is the regime a sharded control plane's rebalancer
    has to survive (every shard hot at once looks balanced; one hot shard
    must drain).  Per-group draws come from per-group streams, so adding
    or removing a group never shifts another group's episodes.
    """
    if not math.isfinite(t_end) or t_end <= 0.0:
        raise ValueError("mmpp_burst_episodes needs a finite positive t_end")
    state_rng = random.Random(f"burst-mmpp-state:{seed}")
    timeline = mmpp_state_timeline(state_rng, t_end=t_end,
                                   mean_calm=mean_calm,
                                   mean_storm=mean_storm)
    apps: list[BackgroundApp] = []
    for g, cores in enumerate(core_groups):
        rng = random.Random(f"burst-mmpp:{seed}:{g}")
        for t0, t1 in mmpp_on_off(rng, timeline, t_end=t_end,
                                  mean_on=mean_on,
                                  mean_off_calm=mean_off_calm,
                                  mean_off_storm=mean_off_storm):
            apps.append(BackgroundApp(task_type, tuple(cores), t0, t1,
                                      thrash))
    apps.sort(key=lambda a: (a.t_start, a.cores, a.t_end))
    return tuple(apps)


def dvfs_denver(n_cores: int = 6, *, period: float = 10.0,
                hi_mhz: float = 2035.0, lo_mhz: float = 345.0) -> PeriodicProfile:
    """Paper §5.2: Denver cluster (cores 0-1 on TX2) alternates between the
    highest and lowest frequency, 5 s each.  Closed form: the 5 s phase
    boundaries are exact in floating point, so this is bit-identical to
    the formerly materialized ~200k-segment profile at zero construction
    cost."""
    return PeriodicProfile.square_wave(n_cores, (0, 1), period=period,
                                       lo=lo_mhz / hi_mhz)


class LoadCoupledGovernor(SpeedProfileBase):
    """A governor whose detune depends on partition *load* (scenario
    realism: power/thermal governors clamp harder exactly when a partition
    is busy, so the scheduler's own placement feeds back into the
    asymmetry it must ride out).

    Wraps any base profile; a partition with a fraction ``f`` of its cores
    occupied runs at ``base_speed * (1 - coupling * f)``.  The simulator
    detects the ``load_coupled`` marker and feeds per-partition busy-core
    counts through :meth:`set_busy` before every rate refresh, so the
    effective speed stays piecewise-constant between events (occupancy
    only changes at task start/finish events).  The threaded runtime has
    no cost models to couple into — this is a DES scenario mechanism.
    """

    load_coupled = True

    def __init__(self, base: SpeedProfileBase, topology, *,
                 coupling: float = 0.3):
        if not 0.0 <= coupling < 1.0:
            raise ValueError(f"coupling {coupling!r} outside [0, 1)")
        self.base = base
        self.n_cores = base.n_cores
        self.coupling = coupling
        self._part_size = [p.size for p in topology.partitions]
        self._pidx_of = [0] * topology.n_cores
        for pidx, part in enumerate(topology.partitions):
            for c in part.cores:
                self._pidx_of[c] = pidx
        self._busy_frac = [0.0] * len(self._part_size)

    def set_busy(self, busy_counts: Sequence[int]) -> bool:
        """Update per-partition occupancy; returns True when any fraction
        moved (the caller then refreshes every cached core speed)."""
        changed = False
        for pidx, n in enumerate(busy_counts):
            f = n / self._part_size[pidx]
            if f != self._busy_frac[pidx]:
                self._busy_frac[pidx] = f
                changed = True
        return changed

    def speed(self, core: int, t: float) -> float:
        return (self.base.speed(core, t)
                * (1.0 - self.coupling * self._busy_frac[self._pidx_of[core]]))

    def next_breakpoint(self, t: float) -> Optional[float]:
        # load-driven changes are injected by the engine at its own events;
        # only the base profile contributes *time*-driven breakpoints
        return self.base.next_breakpoint(t)


def governor_profile(topology, *, period: float = 10.0, lo: float = 0.25,
                     hi: float = 1.0, t_end: float = 1e6,
                     period_spread: float = 0.0,
                     kinds: Optional[Sequence[str]] = None,
                     stagger: bool = True) -> PeriodicProfile:
    """Per-partition DVFS governors: every resource partition runs its own
    square-wave governor over all of its cores.

    Neighboring partitions are phase-staggered (``stagger``: partition i
    starts hi/lo for even/odd i) so the machine is never uniformly slow,
    and ``period_spread`` detunes the periods (partition i uses
    ``period * (1 + period_spread * i)``) so governor edges drift apart
    instead of beating in lockstep — the bursty, never-repeating
    asymmetry pattern adaptive schedulers are supposed to ride out.
    ``kinds`` restricts governed partitions (e.g. only "denver" clusters).
    """
    prof = PeriodicProfile(topology.n_cores)
    governed = 0
    for part in topology.partitions:
        if kinds is not None and part.kind not in kinds:
            continue
        # stagger/detune by position among *governed* partitions, so a
        # kinds filter can't put the governed set back in lockstep
        p = period * (1.0 + period_spread * governed)
        half = p / 2
        hi_first = not (stagger and governed % 2)
        first, second = (hi, lo) if hi_first else (lo, hi)
        prof.set_pattern(part.cores, ((half, first), (half, second)),
                         t_end=t_end)
        governed += 1
    if not governed:
        raise ValueError(f"no partition matches kinds={kinds!r}")
    return prof
