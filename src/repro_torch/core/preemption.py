"""Preemptible capacity: seeded revoke/restore episode models.

Cloud accelerator fleets exhibit a harsher form of dynamic asymmetry than
DVFS or co-runners: capacity is *revoked outright*.  A TPU pod slice is
reclaimed by the scheduler above you, a preemptible VM gets its 30-second
notice, a maintenance event takes an ICI domain down — and the work that
was running there has to land somewhere else (cf. Mage, arXiv:1804.06462:
online schedulers must handle resources disappearing mid-run).  This
module generates the *when*; the discrete-event simulator applies the
*what* (see ``simulator.py``):

* at **revoke** time all running tasks on the affected partition are
  killed (``preempt="restart"``: their progress is lost) or checkpointed
  (``preempt="checkpoint"``: progress carries over, minus a
  ``resume_penalty`` fraction of the task's duration paid on resume), the
  partition's WSQs and AQs are drained back to the scheduler, and every
  displaced task is re-placed on the surviving partitions — HIGH tasks
  re-bound first, so criticality-awareness is measurable under
  revocation;
* at **restore** time the partition's cores re-enter the dispatch loop
  (they steal their way back to work).

Episodes are generated at *partition* granularity — a pod slice, an ICI
domain, a socket — matching how real revocations arrive.  Two seeded
generators:

* :func:`pod_slice_preemption` — each partition runs an independent
  renewal process (exponential up/down intervals), the memoryless
  baseline;
* :func:`mmpp_preemption` — MMPP-style *correlated* revocations: one
  hidden calm/storm modulating chain is shared by every partition and
  scales the revocation rate, so revokes cluster in time across
  partitions (the maintenance-wave / spot-reclaim signature) while each
  partition keeps its own draw stream.

Episodes that would take the *last* live partition down are pruned at
generation time, so the simulated machine always retains capacity and
every DAG completes.  Everything is a pure function of ``(seed, params)``
— multi-run cells stay bit-reproducible for any worker count.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from typing import Optional, Sequence

from .interference import mmpp_on_off, mmpp_state_timeline, renewal_on_off
from .places import Topology

PREEMPT_MODES = ("restart", "checkpoint")


@dataclasses.dataclass(frozen=True)
class PreemptionModel:
    """A fixed, seeded schedule of per-partition revoke/restore episodes.

    ``episodes`` holds ``(partition index, t_revoke, t_restore)`` triples
    sorted by revoke time; episodes of one partition never overlap, and no
    instant has every partition revoked (see :func:`prune_full_outages`).
    ``preempt`` selects what happens to running tasks at revoke time;
    ``resume_penalty`` (checkpoint mode only) is the extra work paid on
    resume, as a fraction of the task's full duration at its new place.
    ``notice`` is the revocation *notice window* (seconds): running tasks
    keep executing for that long after the revoke edge and are only
    killed/checkpointed at its expiry — the spot-VM 30-second-notice
    shape, and the DES analogue of the threaded engine's grace window
    (running payloads there cannot be killed at all).  Queued work always
    drains immediately and nothing new starts on a revoked partition;
    ``notice=0`` (the default) preempts instantaneously, bit-identical to
    models without the field.

    ``subsets`` (optional, parallel to ``episodes``) gives each episode a
    *sub-pod* granularity: entry i is either None (the whole partition —
    the classic shape) or a tuple of absolute core ids inside partition
    ``episodes[i][0]`` to revoke, leaving its siblings live (a partial
    :class:`~.places.LiveView`).  An empty ``subsets`` means every episode
    is whole-partition, so all existing 3-tuple consumers are untouched.
    """

    episodes: tuple[tuple[int, float, float], ...]
    preempt: str = "restart"
    resume_penalty: float = 0.05
    notice: float = 0.0
    subsets: tuple[Optional[tuple[int, ...]], ...] = ()

    def __post_init__(self) -> None:
        if self.preempt not in PREEMPT_MODES:
            raise ValueError(f"preempt must be one of {PREEMPT_MODES}, "
                             f"got {self.preempt!r}")
        if not (0.0 <= self.resume_penalty and
                math.isfinite(self.resume_penalty)):
            raise ValueError(f"bad resume_penalty {self.resume_penalty!r}")
        if not (0.0 <= self.notice and math.isfinite(self.notice)):
            raise ValueError(f"bad notice {self.notice!r}")
        if self.subsets and len(self.subsets) != len(self.episodes):
            raise ValueError(
                f"subsets has {len(self.subsets)} entries for "
                f"{len(self.episodes)} episodes")
        prev_t0 = -1.0
        last_end: dict[int, float] = {}
        for pidx, t0, t1 in self.episodes:
            if not (0.0 <= t0 < t1):
                raise ValueError(f"bad episode window [{t0}, {t1})")
            if t0 < prev_t0:
                raise ValueError("episodes must be sorted by revoke time")
            if t0 < last_end.get(pidx, 0.0):
                raise ValueError(
                    f"overlapping episodes for partition {pidx}")
            prev_t0 = t0
            last_end[pidx] = t1

    def episodes_for(self, pidx: int) -> tuple[tuple[float, float], ...]:
        return tuple((t0, t1) for p, t0, t1 in self.episodes if p == pidx)

    def cores_of(self, eidx: int, topology: Topology) -> tuple[int, ...]:
        """The cores episode ``eidx`` revokes: its subset if one was named,
        else every core of its partition."""
        pidx = self.episodes[eidx][0]
        sub = self.subsets[eidx] if self.subsets else None
        if sub is not None:
            part = topology.partitions[pidx]
            for c in sub:
                if not part.start <= c < part.start + part.size:
                    raise ValueError(
                        f"episode {eidx}: core {c} outside partition "
                        f"{part.name} [{part.start}, "
                        f"{part.start + part.size})")
            return tuple(sub)
        return topology.partitions[pidx].cores

    @property
    def n_episodes(self) -> int:
        return len(self.episodes)


def prune_full_outages(episodes: Sequence[tuple[int, float, float]],
                       n_partitions: int) -> tuple[tuple[int, float, float], ...]:
    """Drop every episode whose revoke would leave *zero* live partitions.

    Sweep the revoke edges in time order, tracking how many kept episodes
    are still in force (restores at exactly the revoke instant count as
    restored — outage windows are half-open [t0, t1)).  Because the down
    set only grows at revoke edges, refusing the n-th concurrent outage is
    sufficient to guarantee at least one partition is live at all times.
    """
    if n_partitions < 1:
        raise ValueError("need at least one partition")
    ordered = sorted(episodes, key=lambda e: (e[1], e[0], e[2]))
    out: list[tuple[int, float, float]] = []
    active: list[float] = []        # min-heap of kept episodes' restore times
    for pidx, t0, t1 in ordered:
        while active and active[0] <= t0:
            heapq.heappop(active)
        if len(active) >= n_partitions - 1:
            continue                # would revoke the last live partition
        heapq.heappush(active, t1)
        out.append((pidx, t0, t1))
    return tuple(out)


def _partition_indices(topology: Topology,
                       partitions: Optional[Sequence[int]]) -> tuple[int, ...]:
    n = len(topology.partitions)
    if partitions is None:
        return tuple(range(n))
    idxs = tuple(partitions)
    for i in idxs:
        if not 0 <= i < n:
            raise ValueError(f"partition index {i} outside 0..{n - 1}")
    return idxs


def pod_slice_preemption(topology: Topology, *, seed: int, t_end: float,
                         mean_up: float, mean_down: float,
                         partitions: Optional[Sequence[int]] = None,
                         preempt: str = "restart",
                         resume_penalty: float = 0.05,
                         notice: float = 0.0) -> PreemptionModel:
    """Independent per-partition revoke/restore renewal episodes.

    Each preemptible partition alternates exponential up intervals (mean
    ``mean_up`` seconds between revocations) and outages (mean
    ``mean_down`` seconds), generated until ``t_end`` (must be finite — it
    bounds the episode count).  Each partition draws from its own stream
    derived from ``(seed, partition name)``, so adding or filtering
    partitions never shifts another partition's episodes.  ``partitions``
    restricts which partition indices are preemptible (default: all).
    """
    if not math.isfinite(t_end) or t_end <= 0.0:
        raise ValueError("pod_slice_preemption needs a finite positive t_end")
    episodes: list[tuple[int, float, float]] = []
    for i in _partition_indices(topology, partitions):
        rng = random.Random(f"preempt:{seed}:{topology.partitions[i].name}")
        for t0, t1 in renewal_on_off(rng, t_start=0.0, t_end=t_end,
                                     mean_on=mean_down, mean_off=mean_up):
            episodes.append((i, t0, t1))
    return PreemptionModel(
        prune_full_outages(episodes, len(topology.partitions)),
        preempt=preempt, resume_penalty=resume_penalty, notice=notice)


def sub_slice_preemption(topology: Topology, *, seed: int, t_end: float,
                         mean_up: float, mean_down: float, frac: float = 0.5,
                         partitions: Optional[Sequence[int]] = None,
                         preempt: str = "restart",
                         resume_penalty: float = 0.05,
                         notice: float = 0.0) -> PreemptionModel:
    """Sub-pod revocation episodes: the renewal timing of
    :func:`pod_slice_preemption`, but each episode takes only a seeded
    contiguous run of ``frac`` of its partition's cores (at least one, at
    most all-but-one — the partition always keeps a live core, so no
    full-outage pruning is ever needed).  The live view during such an
    episode is *partial*: siblings keep dispatching while the searches
    mask out every place that touches a revoked core."""
    if not math.isfinite(t_end) or t_end <= 0.0:
        raise ValueError("sub_slice_preemption needs a finite positive t_end")
    if not 0.0 < frac < 1.0:
        raise ValueError(f"frac {frac!r} outside (0, 1) — use "
                         f"pod_slice_preemption for whole partitions")
    rows: list[tuple[tuple[int, float, float], tuple[int, ...]]] = []
    for i in _partition_indices(topology, partitions):
        part = topology.partitions[i]
        if part.size < 2:
            continue                 # nothing strictly-sub-pod to take
        rng = random.Random(f"preempt-sub:{seed}:{part.name}")
        k = max(1, min(part.size - 1, round(frac * part.size)))
        for t0, t1 in renewal_on_off(rng, t_start=0.0, t_end=t_end,
                                     mean_on=mean_down, mean_off=mean_up):
            off = rng.randrange(part.size - k + 1)
            cores = tuple(range(part.start + off, part.start + off + k))
            rows.append(((i, t0, t1), cores))
    rows.sort(key=lambda r: (r[0][1], r[0][0], r[0][2]))
    return PreemptionModel(tuple(r[0] for r in rows), preempt=preempt,
                           resume_penalty=resume_penalty, notice=notice,
                           subsets=tuple(r[1] for r in rows))


def mmpp_preemption(topology: Topology, *, seed: int, t_end: float,
                    mean_calm: float, mean_storm: float,
                    mean_up_calm: float, mean_up_storm: float,
                    mean_down: float,
                    partitions: Optional[Sequence[int]] = None,
                    preempt: str = "restart",
                    resume_penalty: float = 0.05,
                    notice: float = 0.0) -> PreemptionModel:
    """MMPP-style correlated revocations.

    One hidden calm/storm modulating chain (exponential sojourns of mean
    ``mean_calm`` / ``mean_storm`` seconds, seeded from ``seed`` alone) is
    shared by every preemptible partition; while it is calm a partition's
    revocations arrive with mean gap ``mean_up_calm``, during a storm with
    mean gap ``mean_up_storm`` (typically much shorter).  Outage lengths
    draw from ``mean_down`` regardless of state.  Because the chain is
    shared, revocations *cluster across partitions* — several pods go down
    in the same storm — which is the regime where criticality-aware
    re-binding earns its keep.  Per-partition draws still come from
    per-partition streams, so the construction is order-independent.
    """
    if not math.isfinite(t_end) or t_end <= 0.0:
        raise ValueError("mmpp_preemption needs a finite positive t_end")
    state_rng = random.Random(f"preempt-mmpp-state:{seed}")
    timeline = mmpp_state_timeline(state_rng, t_end=t_end,
                                   mean_calm=mean_calm,
                                   mean_storm=mean_storm)
    episodes: list[tuple[int, float, float]] = []
    for i in _partition_indices(topology, partitions):
        rng = random.Random(f"preempt-mmpp:{seed}:{topology.partitions[i].name}")
        for t0, t1 in mmpp_on_off(rng, timeline, t_end=t_end,
                                  mean_on=mean_down,
                                  mean_off_calm=mean_up_calm,
                                  mean_off_storm=mean_up_storm):
            episodes.append((i, t0, t1))
    return PreemptionModel(
        prune_full_outages(episodes, len(topology.partitions)),
        preempt=preempt, resume_penalty=resume_penalty, notice=notice)
