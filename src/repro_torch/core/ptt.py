"""Performance Trace Table (paper §4.1.1).

One PTT per *task type*.  Entries are indexed by execution place
``(leader core, width)`` and hold a weighted moving average of observed
execution times as seen by the leader core:

    updated = (old_weight * old + new_weight * obs) / (old_weight + new_weight)

with the paper's recommended ratio 1:4 (``new_weight=1, old_weight=4``) so at
least three observations are needed before the entry tracks a new performance
regime.  Entries start at zero, which the schedulers interpret as
"unexplored — try me first", guaranteeing every place is evaluated at least
once early in the run (paper: "The entries are initialized to zero. This
ensures that all possible execution places are evaluated at least once").

The Algorithm-1 searches (``global_search`` / ``local_search`` /
``width1_search``) run as masked argmins over the dense table using the
topology's precomputed place-index arrays: unexplored (0.0) entries win
automatically, ties prefer narrower places, and residual ties break
*randomly* so equal predictions never pile onto the lowest core id.  This
keeps wake-time placement O(1)-ish numpy work instead of a Python loop over
every place per HIGH task.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Iterable, Optional

import numpy as np

from .places import ExecutionPlace, Topology

# Below this many candidates the searches run as plain-Python loops over the
# persistent mirror lists (numpy's fixed per-call overhead dominates tiny
# argmins on embedded-class topologies like tx2); above it they run as numpy
# masked argmins over the same persistent arrays.  Both paths perform the
# identical IEEE-754 float64 operations over the identical candidate order,
# so the crossover is behavior-invisible.
_PY_SEARCH_MAX = 128


class PTT:
    """Trace table for a single task type over a topology's places.

    Stored as a dense ``[n_cores, n_width_slots]`` float array (rows are
    per-core — the paper lays rows out to fit cache lines so each core
    touches its own line; we keep the same row-major layout).  Invalid
    (core, width) combinations hold NaN.
    """

    def __init__(self, topology: Topology, *, new_weight: float = 1.0,
                 old_weight: float = 4.0, first_visit_direct: bool = True):
        self.topology = topology
        self.new_weight = float(new_weight)
        self.old_weight = float(old_weight)
        self.first_visit_direct = first_visit_direct
        widths = sorted({w for p in topology.partitions for w in p.widths})
        self._w_slot = {w: i for i, w in enumerate(widths)}
        self.table = np.full((topology.n_cores, len(widths)), np.nan)
        self.visits = np.zeros_like(self.table, dtype=np.int64)
        # update-order tick per entry (-1 = never updated): staleness metric
        # for the forced-revisit escape hatch (see ``stalest``)
        self.last_update = np.full(self.table.shape, -1, dtype=np.int64)
        self._tick = 0
        for place in topology.places():
            self.table[place.leader, self._w_slot[place.width]] = 0.0
        self._lock = threading.Lock()

        # Vectorized-search metadata: for the i-th valid place, its flat
        # offset into ``table`` and its width (float).  ``_flat`` is a view,
        # so in-place ``update``s are immediately visible to the searches.
        self._places = topology.places()
        n_slots = len(widths)
        slots = np.array([self._w_slot[pl.width] for pl in self._places],
                         dtype=np.int64)
        self._pos = topology.place_leaders * n_slots + slots
        self._wf = topology.place_widths_f
        self._flat = self.table.reshape(-1)
        self._lu_flat = self.last_update.reshape(-1)
        self._visits_flat = self.visits.reshape(-1)

        # Persistent place-aligned score arrays, the search-side invariant:
        # _vals[i] mirrors table[place i], _costs[i] == _vals[i] * width_i,
        # _lu_place[i] mirrors last_update[place i].  They are maintained
        # incrementally by update()/prime() (the only table writers), so the
        # searches never re-gather or re-multiply the dense table per wake.
        # The *_l lists are plain-Python mirrors of the same doubles feeding
        # the small-n fast path.
        n_places = len(self._places)
        self._vals = np.zeros(n_places)
        self._costs = np.zeros(n_places)
        self._lu_place = np.full(n_places, -1, dtype=np.int64)
        self._vals_l = [0.0] * n_places
        self._costs_l = [0.0] * n_places
        self._visits_l = [0] * n_places
        self._lu_l = [-1] * n_places
        self._wf_l = self._wf.tolist()
        self._pos_l = self._pos.tolist()
        self._all_idx_l = list(range(n_places))
        self._pidx = {(pl.leader, pl.width): i
                      for i, pl in enumerate(self._places)}
        # Per-core local candidate lists (lazily materialized) so the hot
        # local_search fast path never re-converts the index array.
        self._local_js: list[Optional[list[int]]] = [None] * topology.n_cores
        # Small-n tables defer the numpy-side stores (dense table + place
        # mirrors) from update()/prime() to a flush the numpy/score_fn
        # search branches and snapshot() trigger: the plain-Python search
        # path reads only the *_l lists, so per-commit numpy scalar stores
        # would be pure overhead.  The flushed values are bit-identical to
        # the write-through ones (same doubles, same cells).
        self._lazy_np = n_places <= _PY_SEARCH_MAX
        self._np_dirty = False

    # -- queries ------------------------------------------------------------
    def get(self, place: ExecutionPlace) -> float:
        """Predicted execution time; 0.0 means unexplored."""
        i = self._pidx.get((place.leader, place.width))
        if i is None:        # invalid combination: NaN, like the dense read
            return float(self.table[place.leader, self._w_slot[place.width]])
        return self._vals_l[i]

    def visited(self, place: ExecutionPlace) -> int:
        i = self._pidx.get((place.leader, place.width))
        if i is None:        # invalid combination: 0, like the dense read
            return int(self.visits[place.leader, self._w_slot[place.width]])
        return self._visits_l[i]

    def best_explored(self) -> Optional[float]:
        """Minimum *measured* time estimate across this table's valid
        places — never-updated entries (whose 0.0 means "unexplored", not
        "instant") are excluded.  None until any place has been visited.
        The per-shard PTT-divergence summary the global rebalancer
        compares (read-only; list mirrors, so lazy-np state is
        irrelevant)."""
        best = None
        vl = self._vals_l
        nv = self._visits_l
        for i in self._all_idx_l:
            if nv[i] and (best is None or vl[i] < best):
                best = vl[i]
        return best

    def _flush_np(self) -> None:
        """Propagate deferred update()/prime() writes into the dense table
        and the numpy place mirrors (lazy small-n mode only)."""
        with self._lock:
            if not self._np_dirty:
                return
            self._vals[:] = self._vals_l
            self._costs[:] = self._costs_l
            self._lu_place[:] = self._lu_l
            self._flat[self._pos] = self._vals
            self._visits_flat[self._pos] = self._visits_l
            self._lu_flat[self._pos] = self._lu_l
            self._np_dirty = False

    # -- updates ------------------------------------------------------------
    def update(self, place: ExecutionPlace, observed: float) -> float:
        """Weighted-average update, performed by the leader on task commit."""
        if observed < 0 or not math.isfinite(observed):
            raise ValueError(f"bad observation {observed!r}")
        i = self._pidx.get((place.leader, place.width))
        if i is None:
            raise KeyError(f"invalid place {place}")
        with self._lock:
            if self._visits_l[i] == 0 and self.first_visit_direct:
                new = float(observed)
            else:
                new = (self.old_weight * self._vals_l[i]
                       + self.new_weight * observed) / (
                    self.old_weight + self.new_weight)
            cost = new * self._wf_l[i]
            tick = self._tick
            self._tick = tick + 1
            if self._lazy_np:
                self._np_dirty = True
            else:
                pos = self._pos_l[i]
                self._flat[pos] = new
                self._visits_flat[pos] += 1
                self._lu_flat[pos] = tick
                self._vals[i] = new
                self._costs[i] = cost
                self._lu_place[i] = tick
            self._vals_l[i] = new
            self._costs_l[i] = cost
            self._visits_l[i] += 1
            self._lu_l[i] = tick
            return new

    def update_nolock(self, place: ExecutionPlace, observed: float) -> float:
        """Single-threaded-caller form of :meth:`update` (the DES commit
        path): identical math and mirror writes, no lock acquisition."""
        if observed < 0 or not math.isfinite(observed):
            raise ValueError(f"bad observation {observed!r}")
        i = self._pidx.get((place.leader, place.width))
        if i is None:
            raise KeyError(f"invalid place {place}")
        if self._visits_l[i] == 0 and self.first_visit_direct:
            new = float(observed)
        else:
            new = (self.old_weight * self._vals_l[i]
                   + self.new_weight * observed) / (
                self.old_weight + self.new_weight)
        cost = new * self._wf_l[i]
        tick = self._tick
        self._tick = tick + 1
        if self._lazy_np:
            self._np_dirty = True
        else:
            pos = self._pos_l[i]
            self._flat[pos] = new
            self._visits_flat[pos] += 1
            self._lu_flat[pos] = tick
            self._vals[i] = new
            self._costs[i] = cost
            self._lu_place[i] = tick
        self._vals_l[i] = new
        self._costs_l[i] = cost
        self._visits_l[i] += 1
        self._lu_l[i] = tick
        return new

    def prime(self, place: ExecutionPlace, value: float) -> bool:
        """Seed an *unexplored* entry with a prior estimate (PTT warmup
        without traffic).  Returns True if the entry was primed, False if
        it already holds a measurement (priming never overrides data).
        A primed entry does not count as visited: the first real
        observation still overwrites it directly (``first_visit_direct``)
        and ``stalest`` still treats it as never-measured — the prior is
        deliberately weak."""
        if value <= 0 or not math.isfinite(value):
            raise ValueError(f"bad prime value {value!r}")
        i = self._pidx.get((place.leader, place.width))
        if i is None:
            raise KeyError(f"invalid place {place}")
        with self._lock:
            if self._visits_l[i] == 0 and self._vals_l[i] == 0.0:
                new = float(value)
                cost = new * self._wf_l[i]
                if self._lazy_np:
                    self._np_dirty = True
                else:
                    self._flat[self._pos_l[i]] = new
                    self._vals[i] = new
                    self._costs[i] = cost
                self._vals_l[i] = new
                self._costs_l[i] = cost
                return True
            return False

    # -- searches (Algorithm 1 primitives) ------------------------------------
    def _score(self, place: ExecutionPlace, *, cost: bool) -> tuple[float, float]:
        """Sort key: unexplored (0.0) places sort first, then by predicted
        time (or parallel cost = time*width).  Ties break toward narrower
        places (use fewer resources when indifferent)."""
        t = self.get(place)
        value = t * place.width if cost else t
        return (value, place.width)

    def best(self, places: Iterable[ExecutionPlace], *, cost: bool,
             rng=None) -> ExecutionPlace:
        """argmin with *random* final tie-break: equal predictions must not
        systematically pile decisions onto the lowest core id.

        Generic (any candidate iterable) Python path — the hot searches
        below use the vectorized ``_best_from_indices`` instead."""
        best_score, cands = None, []
        for pl in places:
            s = self._score(pl, cost=cost)
            if best_score is None or s < best_score:
                best_score, cands = s, [pl]
            elif s == best_score:
                cands.append(pl)
        if len(cands) > 1 and rng is not None:
            return cands[rng.randrange(len(cands))]
        return cands[0]

    def _pick_min(self, score: np.ndarray, w: np.ndarray,
                  idx: Optional[np.ndarray], rng) -> ExecutionPlace:
        """Shared argmin tail of every search: minimal score, ties prefer
        the narrowest width, residual ties break uniformly at random."""
        cands = np.flatnonzero(score == score.min())
        if len(cands) > 1:
            wt = w[cands]
            cands = cands[wt == wt.min()]
        if len(cands) == 1 or rng is None:
            k = cands[0]
        else:
            k = cands[rng.randrange(len(cands))]
        return self._places[int(k) if idx is None else int(idx[int(k)])]

    def _pick_min_py(self, cands: list, rng) -> ExecutionPlace:
        """Python-path argmin tail: ``cands`` already holds the minimal-score
        place indices in candidate order; filter to the narrowest width and
        draw the residual tie exactly like ``_pick_min``."""
        if len(cands) > 1:
            wl = self._wf_l
            wmin = min(wl[j] for j in cands)
            cands = [j for j in cands if wl[j] == wmin]
        if len(cands) == 1 or rng is None:
            return self._places[cands[0]]
        return self._places[cands[rng.randrange(len(cands))]]

    def _best_from_indices(self, idx: Optional[np.ndarray], *, cost: bool,
                           rng=None, load: Optional[np.ndarray] = None,
                           penalty: float = 0.0,
                           score_fn: Optional[Callable] = None
                           ) -> ExecutionPlace:
        """Masked argmin over the persistent score arrays restricted to
        place indices ``idx`` (None = all valid places).  Semantics
        identical to ``best`` over the same candidates in the same order:
        unexplored entries (0.0) sort first, ties prefer the narrowest
        width, residual ties are broken uniformly at random.

        ``load`` (aligned with the full place list) makes the search
        queue-aware: the score becomes ``ptt + penalty * load[place]``, so
        concurrent wakes spread over places instead of herding onto the
        current argmin.  ``load=None`` (the default) is the exact
        pre-load-awareness code path.

        ``score_fn`` (the ``placement_backend="jax"`` hook) computes the
        score vector ``vals + penalty * load`` externally (e.g. as a jitted
        kernel); the tie-break tail stays host-side so the RNG draw
        sequence is backend-independent."""
        use_load = load is not None and penalty > 0.0
        if score_fn is not None:
            if self._np_dirty:
                self._flush_np()
            vals = self._costs if cost else self._vals
            w = self._wf
            if idx is not None:
                vals, w = vals[idx], w[idx]
            lsub = None
            if use_load:
                lsub = load if idx is None else load[idx]
            score = np.asarray(score_fn(vals, lsub, penalty))
            return self._pick_min(score, w, idx, rng)
        n = len(self._all_idx_l) if idx is None else len(idx)
        if n <= _PY_SEARCH_MAX:
            vl = self._costs_l if cost else self._vals_l
            js = self._all_idx_l if idx is None else idx.tolist()
            best = None
            cands = None
            if use_load:
                ll = load.tolist() if isinstance(load, np.ndarray) else load
                for j in js:
                    s = vl[j] + penalty * ll[j]
                    if best is None or s < best:
                        best, cands = s, [j]
                    elif s == best:
                        cands.append(j)
            else:
                for j in js:
                    s = vl[j]
                    if best is None or s < best:
                        best, cands = s, [j]
                    elif s == best:
                        cands.append(j)
            return self._pick_min_py(cands, rng)
        if self._np_dirty:
            self._flush_np()
        vals = self._costs if cost else self._vals
        w = self._wf
        if idx is not None:
            vals, w = vals[idx], w[idx]
        score = vals
        if use_load:
            score = vals + penalty * (load if idx is None else load[idx])
        return self._pick_min(score, w, idx, rng)

    def local_search(self, core: int, *, cost: bool = True, rng=None,
                     load: Optional[np.ndarray] = None,
                     penalty: float = 0.0,
                     idx: Optional[np.ndarray] = None,
                     score_fn: Optional[Callable] = None) -> ExecutionPlace:
        """Paper: keep partition+core fixed, mold only the width.  ``idx``
        overrides the candidate set (a live-masked subset of the core's
        local places under sub-pod revocation); None is the exact
        unmasked path."""
        if idx is None:
            js = self._local_js[core]
            if js is None:
                js = self._local_js[core] = \
                    self.topology.local_place_indices(core).tolist()
            # inlined small-n no-load loop (identical ops/order to the
            # generic _best_from_indices python branch)
            if score_fn is None and len(js) <= _PY_SEARCH_MAX and (
                    load is None or penalty <= 0.0):
                vl = self._costs_l if cost else self._vals_l
                best = None
                cands = None
                for j in js:
                    s = vl[j]
                    if best is None or s < best:
                        best, cands = s, [j]
                    elif s == best:
                        cands.append(j)
                return self._pick_min_py(cands, rng)
            idx = self.topology.local_place_indices(core)
        return self._best_from_indices(idx, cost=cost, rng=rng, load=load,
                                       penalty=penalty, score_fn=score_fn)

    def local_search_cost(self, core: int, rng) -> ExecutionPlace:
        """Positional fast form of ``local_search(core, cost=True,
        rng=rng)`` — the per-dequeue LOW placement call (same ops/order)."""
        js = self._local_js[core]
        if js is None:
            js = self._local_js[core] = \
                self.topology.local_place_indices(core).tolist()
        if len(js) <= _PY_SEARCH_MAX:
            vl = self._costs_l
            best = None
            cands = None
            for j in js:
                s = vl[j]
                if best is None or s < best:
                    best, cands = s, [j]
                elif s == best:
                    cands.append(j)
            return self._pick_min_py(cands, rng)
        return self._best_from_indices(
            self.topology.local_place_indices(core), cost=True, rng=rng)

    def global_search(self, *, cost: bool, rng=None,
                      idx: Optional[np.ndarray] = None,
                      load: Optional[np.ndarray] = None,
                      penalty: float = 0.0,
                      score_fn: Optional[Callable] = None) -> ExecutionPlace:
        """Paper: sweep all execution places in the system.  ``idx``
        restricts the sweep to those place indices (a revoked-capacity
        live view); None sweeps everything, exactly as before."""
        if idx is None and score_fn is None and (
                load is None or penalty <= 0.0):
            js = self._all_idx_l
            if len(js) <= _PY_SEARCH_MAX:
                # inlined small-n no-load loop (identical ops/order to the
                # generic _best_from_indices python branch)
                vl = self._costs_l if cost else self._vals_l
                best = None
                cands = None
                for j in js:
                    s = vl[j]
                    if best is None or s < best:
                        best, cands = s, [j]
                    elif s == best:
                        cands.append(j)
                return self._pick_min_py(cands, rng)
        return self._best_from_indices(idx, cost=cost, rng=rng,
                                       load=load, penalty=penalty,
                                       score_fn=score_fn)

    def width1_search(self, *, cost: bool = False, rng=None,
                      idx: Optional[np.ndarray] = None,
                      load: Optional[np.ndarray] = None,
                      penalty: float = 0.0,
                      score_fn: Optional[Callable] = None) -> ExecutionPlace:
        """Global sweep restricted to width-1 places (the DA scheduler).
        ``idx``, when given, must already be a width-1 subset (e.g. a
        live view's ``width1_idx``); None uses every width-1 place."""
        return self._best_from_indices(
            self.topology.width1_place_indices if idx is None else idx,
            cost=cost, rng=rng, load=load, penalty=penalty,
            score_fn=score_fn)

    def stalest(self, idx: Optional[np.ndarray] = None, *,
                rng=None) -> ExecutionPlace:
        """The least-recently-*updated* candidate (never-updated entries are
        stalest of all) — the forced-revisit pick for the explore-exploit
        escape hatch.  A poisoned entry (one bad measurement, then shunned
        by every argmin forever) is exactly the entry whose update tick
        stops advancing, so it is what this returns.  Ties prefer narrower
        places, then break uniformly at random, like the searches."""
        n = len(self._all_idx_l) if idx is None else len(idx)
        if n <= _PY_SEARCH_MAX:
            vl = self._lu_l
            js = self._all_idx_l if idx is None else idx.tolist()
            best = None
            cands = None
            for j in js:
                s = vl[j]
                if best is None or s < best:
                    best, cands = s, [j]
                elif s == best:
                    cands.append(j)
            return self._pick_min_py(cands, rng)
        if self._np_dirty:
            self._flush_np()
        ages = self._lu_place if idx is None else self._lu_place[idx]
        w = self._wf if idx is None else self._wf[idx]
        return self._pick_min(ages, w, idx, rng)

    def snapshot(self) -> np.ndarray:
        if self._np_dirty:
            self._flush_np()
        return self.table.copy()


class PTTBank:
    """One PTT per task type (paper: 'one table is instantiated for each
    task type')."""

    def __init__(self, topology: Topology, **ptt_kwargs):
        self.topology = topology
        self.ptt_kwargs = ptt_kwargs
        self._tables: dict[str, PTT] = {}
        self._lock = threading.Lock()

    def for_type(self, task_type_name: str) -> PTT:
        tbl = self._tables.get(task_type_name)    # lock-free hot path:
        if tbl is not None:                       # dict reads are atomic
            return tbl
        with self._lock:
            tbl = self._tables.get(task_type_name)
            if tbl is None:
                tbl = self._tables[task_type_name] = PTT(
                    self.topology, **self.ptt_kwargs)
            return tbl

    def __iter__(self):
        return iter(self._tables.items())
