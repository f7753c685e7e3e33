"""The seven scheduler configurations (paper Table 1 + Algorithm 1).

| name   | asymmetry | moldability | priority placement        |
|--------|-----------|-------------|---------------------------|
| RWS    | n/a       | no          | n/a (stealable)           |
| RWSM-C | n/a       | yes (cost)  | resource cost, local      |
| FA     | fixed     | no          | statically fastest cores  |
| FAM-C  | fixed     | yes (cost)  | fastest partition + cost  |
| DA     | dynamic   | no          | global min time, width 1  |
| DAM-C  | dynamic   | yes (cost)  | global min time*width     |
| DAM-P  | dynamic   | yes (cost)  | global min time           |

Two decision points, mirroring XiTAO's task lifetime (paper Fig. 3):

* ``place_on_wake``   — when a predecessor commits and the task becomes
  ready: HIGH tasks get a *binding* decision (and are pushed to the chosen
  leader's queue, un-stealable except under RWS); LOW tasks stay on the
  waker's queue.
* ``place_on_dequeue`` — when a worker (owner or thief) pulls a LOW task:
  the width is (re)chosen by local search (paper steps 4-5 re-visit the
  PTT after a steal).

PTT tie-break modes
-------------------
Equal PTT predictions (ubiquitous early in a run, when every entry is the
"unexplored" 0.0) are broken uniformly at random.  By default
(``ptt_tiebreak="shared"``) those draws come from the scheduler's main RNG
— the same stream that drives measurement noise, spike injection, and
steal-victim shuffles.  That coupling makes runs *globally* sensitive to
any local perturbation: one extra or missing draw (e.g. a measurement
spike that changes whether a tie occurs) shifts every subsequent draw in
the run, which is how RWSM-C/P6-class cells end up bistable — the same
configuration lands in one of two basins of the PTT explore-exploit trap
depending on irrelevant draw-sequence details.  ``ptt_tiebreak="seeded"``
gives placement tie-breaks their own deterministic seeded stream (derived
from the scheduler seed), so tie-break decisions depend only on the
sequence of tie situations and perturbations stay local.  Golden tests pin
trap-prone cells in seeded mode.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np

from .places import ExecutionPlace, LiveView, Topology
from .ptt import PTTBank
from .task import Priority, Task


@dataclasses.dataclass
class Scheduler:
    name: str
    topology: Topology
    ptt: PTTBank
    rng: random.Random

    moldable: bool = False
    dynamic: bool = False            # uses PTT to find *where* (vs static)
    fixed_asym: bool = False         # static notion of fast cores (FA/FAM-C)
    high_target_cost: bool = True    # DAM-C (cost) vs DAM-P (performance)
    steal_high: bool = False         # only RWS-family steals HIGH tasks
    priority_dequeue: bool = True    # serve HIGH first from own WSQ
    # dedicated RNG for PTT-search tie-breaks ("seeded" mode); None = draw
    # from the shared scheduler RNG (see module docstring)
    tiebreak_rng: Optional[random.Random] = None
    # forced-revisit escape hatch for the PTT explore-exploit trap: with
    # probability ``revisit_eps`` a placement search returns the *stalest*
    # candidate (least-recently-updated PTT entry — a poisoned entry's
    # signature) instead of the argmin, so one bad measurement can't shun
    # a place forever.  Draws come from a dedicated seeded stream so the
    # measurement-noise/steal and tie-break streams are untouched; with
    # ``revisit_rng`` None (the default) this path costs nothing and
    # behavior is bit-identical to pre-escape-hatch runs.
    revisit_eps: float = 0.0
    revisit_rng: Optional[random.Random] = None
    # capacity availability under preemption: None = every partition live
    # (the zero-cost default — all search paths are untouched).  The
    # simulator assigns a :class:`~.places.LiveView` at revoke/restore
    # edges; every wake-time search is then restricted to live places, and
    # FA/FAM-C fall back to the statically fastest *live* partition.
    # Dequeue-time local searches only need a mask when the view is
    # *partial* (sub-pod revocation): the dispatching worker is live, but
    # its wider local places may contain down sibling cores.
    live: Optional[LiveView] = None
    # Queue-aware placement: every PTT placement search minimizes
    # ``ptt_estimate + queue_penalty * outstanding(place)`` where
    # ``outstanding`` is the per-place estimated seconds of queued+running
    # work, read through ``load_view`` (a callable installed by the
    # :class:`~.lifecycle.SchedulingKernel` that owns the accounting).
    # ``queue_penalty=0.0`` (the default) never calls ``load_view`` and is
    # bit-identical to load-oblivious placement.  ``track_load`` turns on
    # the kernel's accounting without the penalty (observability only).
    queue_penalty: float = 0.0
    track_load: bool = False
    load_view: Optional[object] = None
    # Placement scoring backend hook (``placement_backend="jax"``): a
    # callable ``(vals, load, penalty) -> score`` handed to every PTT
    # search.  None (the numpy default) leaves all search fast paths
    # byte-for-byte untouched — goldens are pinned on that path.
    score_fn: Optional[object] = None
    _fa_rr: int = dataclasses.field(default=0, init=False)  # FA round-robin
    # per-type PTT handle cache (same objects as the bank's): the wake /
    # dequeue hot paths do one C-level dict get instead of a method call
    _tbl_cache: dict = dataclasses.field(default_factory=dict, init=False)

    @property
    def search_rng(self) -> random.Random:
        return self.tiebreak_rng if self.tiebreak_rng is not None else self.rng

    def _load_penalty(self):
        """(per-place load vector, penalty) for the placement searches —
        ``(None, 0.0)`` unless queue-aware placement is on, which keeps the
        default searches bit-identical to load-oblivious builds."""
        if self.queue_penalty > 0.0 and self.load_view is not None:
            return self.load_view(), self.queue_penalty
        return None, 0.0

    def begin_run(self) -> None:
        """Reset per-run scheduling state.  PTT contents deliberately
        persist across runs (they are the online model); the FA/FAM-C
        round-robin cursor must not — a reused scheduler otherwise starts
        round-robin where the previous run left off, making back-to-back
        runs irreproducible.  ``live`` is left alone here: a mask applied
        *before* the run (PodMonitor.apply_to) must survive engine
        construction; engines clear it at end-of-run instead (see
        ``SchedulingKernel.end_run``)."""
        self._fa_rr = 0

    def _force_revisit(self) -> bool:
        return (self.revisit_rng is not None
                and self.revisit_rng.random() < self.revisit_eps)

    def _local_indices(self, core: int) -> Optional[np.ndarray]:
        """Local-search candidate override for ``core``: None (the exact
        unmasked path) unless the live view is *partial* — a sub-pod
        revocation can leave a live worker whose wider local places
        contain down sibling cores, so those places are filtered out.
        The worker's width-1 place is always live, so never empty."""
        live = self.live
        if live is None or not live.partial:
            return None
        idx = self.topology.local_place_indices(core)
        return idx[np.isin(idx, live.place_idx)]

    def clone(self, stream: str) -> "Scheduler":
        """An independent scheduler with the same policy flags but its own
        PTT bank and decision streams (seeded from ``stream``) — one per
        control-plane shard.  Availability and load views reset; the
        owning kernel re-installs them."""
        return dataclasses.replace(
            self,
            ptt=PTTBank(self.topology, **self.ptt.ptt_kwargs),
            rng=random.Random(stream),
            tiebreak_rng=(random.Random(f"tiebreak:{stream}")
                          if self.tiebreak_rng is not None else None),
            revisit_rng=(random.Random(f"revisit:{stream}")
                         if self.revisit_rng is not None else None),
            live=None, load_view=None)

    # -- wake-time placement -------------------------------------------------
    def place_on_wake(self, task: Task, waker_core: int) -> Optional[int]:
        """Return the core whose WSQ receives the task (None = waker's).
        For HIGH tasks this may also set ``task.bound_place``."""
        if task.priority != Priority.HIGH:
            return None                      # LOW: local queue of the waker
        live = self.live
        if self.fixed_asym:
            # FA/FAM-C: strictly map to the statically fastest partition
            # (the fastest *live* one while capacity is revoked; ties keep
            # topology order, matching fastest_static_partition).
            if live is None:
                part = self.topology.fastest_static_partition()
                core = part.start + self._fa_rr % part.size
            else:
                # fastest *live* partition; round-robin over its live
                # cores only (a sub-pod revocation may leave it partial)
                part = min(live.partitions, key=lambda p: p.static_rank)
                cs = live.cores_of(part)
                core = cs[self._fa_rr % len(cs)]
            self._fa_rr += 1
            if self.moldable:
                # FAM-C: cost-minimizing width inside the fast partition
                # (the local-search candidates of ``core`` are exactly the
                # aligned places of each valid width containing it).
                tbl = self.ptt.for_type(task.type.name)
                lidx = self._local_indices(core)
                if self._force_revisit():
                    task.bound_place = tbl.stalest(
                        self.topology.local_place_indices(core)
                        if lidx is None else lidx,
                        rng=self.revisit_rng)
                else:
                    load, pen = self._load_penalty()
                    task.bound_place = tbl.local_search(
                        core, cost=True, rng=self.search_rng,
                        load=load, penalty=pen, idx=lidx,
                        score_fn=self.score_fn)
            else:
                task.bound_place = self.topology.place_at(core, 1)
            return task.bound_place.leader
        if self.dynamic:
            tname = task.type.name
            tbl = self._tbl_cache.get(tname)
            if tbl is None:
                tbl = self._tbl_cache[tname] = self.ptt.for_type(tname)
            # _force_revisit / _load_penalty inlined: both are
            # None-guarded no-ops in the default configuration, and this
            # is the hottest placement call in the DES
            rr = self.revisit_rng
            if not self.moldable:
                # DA: fastest single core (global search, width locked to 1).
                if rr is not None and rr.random() < self.revisit_eps:
                    task.bound_place = tbl.stalest(
                        self.topology.width1_place_indices if live is None
                        else live.width1_idx,
                        rng=rr)
                else:
                    if self.queue_penalty > 0.0 and self.load_view is not None:
                        load, pen = self.load_view(), self.queue_penalty
                    else:
                        load, pen = None, 0.0
                    sf = self.score_fn
                    if sf is None:
                        task.bound_place = tbl.width1_search(
                            cost=False, rng=self.search_rng,
                            idx=None if live is None else live.width1_idx,
                            load=load, penalty=pen)
                    else:
                        task.bound_place = tbl.width1_search(
                            cost=False, rng=self.search_rng,
                            idx=None if live is None else live.width1_idx,
                            load=load, penalty=pen, score_fn=sf)
            else:
                # Algorithm 1 lines 6-12: global search, cost (DAM-C) or
                # pure performance (DAM-P).
                if rr is not None and rr.random() < self.revisit_eps:
                    task.bound_place = tbl.stalest(
                        None if live is None else live.place_idx,
                        rng=rr)
                else:
                    if self.queue_penalty > 0.0 and self.load_view is not None:
                        load, pen = self.load_view(), self.queue_penalty
                    else:
                        load, pen = None, 0.0
                    sf = self.score_fn
                    if sf is None:
                        task.bound_place = tbl.global_search(
                            cost=self.high_target_cost, rng=self.search_rng,
                            idx=None if live is None else live.place_idx,
                            load=load, penalty=pen)
                    else:
                        task.bound_place = tbl.global_search(
                            cost=self.high_target_cost, rng=self.search_rng,
                            idx=None if live is None else live.place_idx,
                            load=load, penalty=pen, score_fn=sf)
            return task.bound_place.leader
        return None                          # RWS/RWSM-C: no special handling

    # -- dequeue-time placement ----------------------------------------------
    def place_on_dequeue(self, task: Task, worker_core: int) -> ExecutionPlace:
        """Final execution place chosen by the worker that will run it."""
        if task.bound_place is not None:
            return task.bound_place
        if not self.moldable:
            return self.topology.place_at(worker_core, 1)
        # Algorithm 1 lines 3-5: local search minimizing TM(c,w)*width.
        tname = task.type.name
        tbl = self._tbl_cache.get(tname)
        if tbl is None:
            tbl = self._tbl_cache[tname] = self.ptt.for_type(tname)
        live = self.live
        lidx = (None if live is None or not live.partial
                else self._local_indices(worker_core))
        rr = self.revisit_rng
        if rr is not None and rr.random() < self.revisit_eps:
            return tbl.stalest(self.topology.local_place_indices(worker_core)
                               if lidx is None else lidx,
                               rng=rr)
        sf = self.score_fn
        if self.queue_penalty > 0.0 and self.load_view is not None:
            return tbl.local_search(
                worker_core, cost=True, rng=self.search_rng,
                load=self.load_view(), penalty=self.queue_penalty, idx=lidx,
                score_fn=sf)
        if sf is not None:
            return tbl.local_search(worker_core, cost=True,
                                    rng=self.search_rng, idx=lidx,
                                    score_fn=sf)
        if lidx is None:
            return tbl.local_search_cost(worker_core, self.search_rng)
        return tbl.local_search(worker_core, cost=True, rng=self.search_rng,
                                idx=lidx)

    def may_steal(self, task: Task) -> bool:
        return self.steal_high or task.priority != Priority.HIGH


def make_scheduler(name: str, topology: Topology, *, seed: int = 0,
                   ptt_new_weight: float = 1.0, ptt_old_weight: float = 4.0,
                   ptt_tiebreak: str = "shared",
                   ptt_revisit: float = 0.0,
                   queue_penalty: float = 0.0,
                   track_load: bool = False,
                   placement_backend: str = "numpy") -> Scheduler:
    """Factory for the paper's seven configurations (Table 1).

    ``ptt_tiebreak`` selects where PTT-search tie-breaks draw from:
    ``"shared"`` (paper-faithful default) uses the scheduler's main RNG;
    ``"seeded"`` uses a dedicated deterministic stream derived from
    ``seed``, decoupling placement tie-breaks from the measurement-noise
    and steal streams (see module docstring).

    ``ptt_revisit`` (off at 0.0, the paper-faithful default) enables the
    explore-exploit escape hatch: each PTT placement search returns the
    stalest candidate instead of the argmin with this probability, so a
    poisoned entry is eventually re-measured.  Draws use a dedicated
    stream seeded from ``seed``; 0.0 is bit-identical to builds without
    the hatch.

    ``queue_penalty`` (off at 0.0, the paper-faithful default) makes every
    PTT placement search queue-aware: the score becomes ``ptt_estimate +
    queue_penalty * outstanding_seconds(place)``, so bursts of concurrent
    HIGH wakes spread instead of herding onto one argmin place.  0.0 is
    bit-identical to load-oblivious placement.  ``track_load`` enables the
    kernel's outstanding-work accounting without the penalty term.

    ``placement_backend`` selects who computes the placement score
    vector: ``"numpy"`` (default — the exact golden-pinned path) or
    ``"jax"``, which routes it through a jitted kernel (see
    :mod:`.placement_jax` for the bitwise caveats).  The argmin
    tie-break tail is host-side either way, so the RNG draw sequence is
    backend-independent; with ``queue_penalty == 0`` the jax backend is
    bit-identical to numpy.  Requires jax; raises ``ImportError``
    otherwise rather than silently falling back.
    """
    bank = PTTBank(topology, new_weight=ptt_new_weight, old_weight=ptt_old_weight)
    rng = random.Random(seed)
    if ptt_tiebreak == "shared":
        tiebreak_rng = None
    elif ptt_tiebreak == "seeded":
        # string seeding hashes via sha512 — stable across processes and
        # Python versions, unlike hash() of a tuple
        tiebreak_rng = random.Random(f"ptt-tiebreak:{seed}")
    else:
        raise ValueError(f"unknown ptt_tiebreak {ptt_tiebreak!r} "
                         "(expected 'shared' or 'seeded')")
    if not 0.0 <= ptt_revisit < 1.0:
        raise ValueError(f"ptt_revisit {ptt_revisit!r} outside [0, 1)")
    revisit_rng = (random.Random(f"ptt-revisit:{seed}")
                   if ptt_revisit > 0.0 else None)
    if queue_penalty < 0.0:
        raise ValueError(f"queue_penalty {queue_penalty!r} must be >= 0")
    if placement_backend == "numpy":
        score_fn = None
    elif placement_backend == "jax":
        raise ValueError("placement_backend='jax' needs the JAX package; "
                         "its counterpart here is placement_backend='torch'")
    elif placement_backend == "torch":
        from .placement_torch import make_score_fn
        score_fn = make_score_fn()
    else:
        raise ValueError(f"unknown placement_backend {placement_backend!r} "
                         "(expected 'numpy' or 'torch')")
    n = name.upper()
    common = dict(topology=topology, ptt=bank, rng=rng,
                  tiebreak_rng=tiebreak_rng, revisit_eps=ptt_revisit,
                  revisit_rng=revisit_rng, queue_penalty=queue_penalty,
                  track_load=track_load, score_fn=score_fn)
    if n == "RWS":
        # priority-oblivious: plain LIFO dequeue, HIGH stealable
        return Scheduler("RWS", steal_high=True, priority_dequeue=False,
                         **common)
    if n == "RWSM-C":
        # extends RWS: still no priority awareness in queues or stealing
        return Scheduler("RWSM-C", moldable=True, steal_high=True,
                         priority_dequeue=False, **common)
    if n == "FA":
        return Scheduler("FA", fixed_asym=True, **common)
    if n == "FAM-C":
        return Scheduler("FAM-C", fixed_asym=True, moldable=True, **common)
    if n == "DA":
        return Scheduler("DA", dynamic=True, **common)
    if n == "DAM-C":
        return Scheduler("DAM-C", dynamic=True, moldable=True,
                         high_target_cost=True, **common)
    if n == "DAM-P":
        return Scheduler("DAM-P", dynamic=True, moldable=True,
                         high_target_cost=False, **common)
    raise ValueError(f"unknown scheduler {name!r}")


ALL_SCHEDULERS = ("RWS", "RWSM-C", "FA", "FAM-C", "DA", "DAM-C", "DAM-P")
