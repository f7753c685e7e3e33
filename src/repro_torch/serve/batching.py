"""Continuous batching for the decode path (Orca-style iteration-level
scheduling, DESIGN.md §"Continuous batching").

The serving engine's decode chain used to dispatch one LOW task per
token per request: every token paid the full wake → place → dequeue →
commit round-trip, and under load the fleet's throughput knee sat at the
per-token dispatch cost.  Batched decode is memory-bound — one fused
dispatch over ``n`` ready requests costs roughly ``base * (1 +
member_cost * (n-1))``, not ``n * base`` — so coalescing ready decode
steps into one moldable dispatch multiplies sustainable throughput
without touching per-request semantics.

:class:`DecodeBatcher` is the engine-level half: a holding pen for
*ready* decode steps (one slot per admitted request between its previous
commit and its next dispatch).  Batch formation is the pure function
:func:`form_batches` — deterministic given (pending, now, config) — with
four triggers, checked oldest-first:

* **quorum** — ``max_batch`` slots are waiting: flush a full batch;
* **criticality** — a ``tier="high"`` request never waits on batch fill:
  its arrival flushes the whole pending set immediately (the HIGH-flush
  latency bound: a critical decode step waits at most one in-flight
  dispatch, never the delay window);
* **deadline** — a member whose deadline slack has fallen to
  ``flush_slack_s`` flushes the pending set (late tokens destroy the
  request's remaining value);
* **age** — the oldest slot has waited ``delay_s``: a partial batch
  dispatches rather than idling the fleet (the batch-delay window).

While slots sit here they are *outside* the work-stealing queues, so
HIGH prefills — which share the fleet — are never queued behind decode
fill: holding back LOW decode work is precisely what yields the cores to
the critical path.  Shed/brownout state is **not** checked at formation:
membership is re-validated inside the dispatch (payload) and at commit,
so rung-2 shedding removes members, never whole dispatches.

The queue-level half (tasks carrying ``Task.batch_key`` coalesced at the
dequeue boundary) lives in :meth:`~repro.core.queues.WorkQueues.
coalesce_batch` / :meth:`~repro.core.lifecycle.SchedulingKernel.
form_dispatch`; both halves share :class:`~repro.core.queues.
BatchingConfig`.
"""
from __future__ import annotations

import dataclasses
import threading

from ..core.queues import BatchingConfig


@dataclasses.dataclass
class BatchSlot:
    """One request's ready decode step, parked until dispatch.

    ``req`` carries tier / deadline / shed state (duck-typed:
    :class:`~.engine.Request` in production, any object with ``tier``,
    ``deadline_s``, ``t_submit`` in tests); ``ctx`` is the request's
    mutable step state (decoder state, last token, step counter) bound to
    the dispatch via ``Task.args``; ``t_enq`` is when this step became
    ready (the age trigger's clock — re-stamped on every re-add)."""

    req: object
    ctx: dict
    t_enq: float


def form_batches(pending: list[BatchSlot], now: float, cfg: BatchingConfig,
                 drain: bool = False) -> tuple[list[list[BatchSlot]],
                                               list[BatchSlot]]:
    """Deterministic batch formation: split ``pending`` (oldest first)
    into flushed groups and the remainder that keeps waiting.  Pure —
    same inputs, same split — which is what makes formation testable and
    the threaded engine's behavior explainable."""
    groups: list[list[BatchSlot]] = []
    rest = list(pending)
    while len(rest) >= cfg.max_batch:               # quorum
        groups.append(rest[:cfg.max_batch])
        rest = rest[cfg.max_batch:]
    if rest:
        flush = drain
        if not flush:
            # criticality: a HIGH-tier member never waits on fill
            flush = any(getattr(s.req, "tier", "low") == "high"
                        for s in rest)
        if not flush:
            # deadline slack collapsed on some member
            flush = any(
                s.req.deadline_s > 0.0
                and (s.req.t_submit + s.req.deadline_s - now)
                <= cfg.flush_slack_s
                for s in rest)
        if not flush:                               # age (delay window)
            flush = now - rest[0].t_enq >= cfg.delay_s
        if flush:
            groups.append(rest)
            rest = []
    return groups, rest


class DecodeBatcher:
    """Thread-safe holding pen over :func:`form_batches`.  ``add`` /
    ``readd`` / ``poll`` each return the list of slot groups that became
    due, for the caller to turn into fused dispatch tasks; slots that did
    not flush keep waiting for the next trigger."""

    def __init__(self, cfg: BatchingConfig):
        if not cfg.enabled:
            raise ValueError("DecodeBatcher requires max_batch > 1 "
                             "(max_batch=1 is the unbatched path)")
        self.cfg = cfg
        self._pending: list[BatchSlot] = []
        self._lock = threading.Lock()
        # telemetry: dispatches formed, members coalesced into them
        self.batches_formed = 0
        self.members_dispatched = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def _form(self, now: float, drain: bool) -> list[list[BatchSlot]]:
        groups, self._pending = form_batches(self._pending, now, self.cfg,
                                             drain)
        self.batches_formed += len(groups)
        self.members_dispatched += sum(len(g) for g in groups)
        return groups

    def add(self, req, ctx: dict, now: float) -> list[list[BatchSlot]]:
        """Park a newly ready decode step; return any groups now due."""
        with self._lock:
            self._pending.append(BatchSlot(req, ctx, now))
            return self._form(now, drain=False)

    def readd(self, slot: BatchSlot, now: float) -> list[list[BatchSlot]]:
        """Re-park a surviving member after its dispatch committed (its
        age clock restarts — the delay window bounds *per-step* wait)."""
        with self._lock:
            slot.t_enq = now
            self._pending.append(slot)
            return self._form(now, drain=False)

    def poll(self, now: float, drain: bool = False) -> list[list[BatchSlot]]:
        """Timer pump: flush whatever the age/deadline triggers make due
        (``drain=True`` flushes everything — end of submission)."""
        with self._lock:
            if not self._pending:
                return []
            return self._form(now, drain)
