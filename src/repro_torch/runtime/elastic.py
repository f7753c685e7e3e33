"""Elastic cluster runtime: the paper's technique applied to the fleet.

A multi-pod training job observes *dynamic performance asymmetry* exactly
like the paper's cores do: a pod slowed by a co-scheduled job, a thermally
throttled host, DCN congestion.  The ``PodMonitor`` is a PTT over the
topology of pods (task type = "train_step" / "eval_step" / ...), fed with
measured per-pod step times, with the paper's 1:4 weighted update — so
detection has the same hysteresis (≈3 observations) the paper validated.

Mitigations, in escalation order (cheapest first):
  1. rebalance — DAM-C-style cost minimization: reassign per-pod grad-accum
     microbatch counts inversely proportional to predicted step time, so the
     all-reduce barrier waits for no straggler (this is "molding" the step:
     the task's width in tokens, not chips).
  2. drain    — if a pod's predicted time exceeds ``drain_ratio`` x median,
     schedule it out (elastic scale-down): emit a RescalePlan that shrinks
     the DP extent; the trainer restarts from checkpoint with the new mesh.
  3. restore  — a recovered pod (ratio back under ``restore_ratio``) is
     scheduled back in at the next checkpoint boundary.

Built on the unified scheduling kernel's primitives (DESIGN.md §3):
measurements flow through the same :func:`~..core.lifecycle.ptt_observe`
feedback path as task commits in either execution engine, and a drained
pod is expressed as the same interned :class:`~..core.places.LiveView`
availability mask a revoked pod-slice produces — ``apply_to(scheduler)``
hands it to a scheduler driving the DES or the threaded runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.lifecycle import ptt_observe
from ..core.places import LiveView, Topology, tpu_pod_slices
from ..core.ptt import PTTBank
from ..core.schedulers import Scheduler


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """What the trainer should do at the next safe point."""
    kind: str                      # "rebalance" | "drain" | "restore" | "none"
    microbatch_share: tuple[float, ...] = ()   # per-pod fraction of tokens
    active_pods: tuple[int, ...] = ()
    reason: str = ""


@dataclasses.dataclass
class PodMonitor:
    n_pods: int
    slices_per_pod: int = 16
    rebalance_ratio: float = 1.15   # act when max/min predicted time exceeds
    drain_ratio: float = 2.5        # drain a pod slower than this x median
    restore_ratio: float = 1.25
    topology: Topology = None       # type: ignore[assignment]
    ptt: PTTBank = None             # type: ignore[assignment]

    def __post_init__(self):
        if self.topology is None:
            self.topology = tpu_pod_slices(self.n_pods, self.slices_per_pod)
        if self.ptt is None:
            # paper's 1:4 weighting -> ~3 steps of hysteresis
            self.ptt = PTTBank(self.topology, new_weight=1.0, old_weight=4.0)
        self._drained: set[int] = set()

    # -- feeding measurements --------------------------------------------------
    def observe(self, pod: int, step_time: float,
                task_type: str = "train_step") -> None:
        part = self.topology.partitions[pod]
        place = part.place_containing(part.start, self.slices_per_pod) \
            if self.slices_per_pod in part.widths else \
            part.place_containing(part.start, max(part.widths))
        # same PTT-feedback path (and therefore the same 1:4 hysteresis
        # semantics) as a task commit in either execution engine
        ptt_observe(self.ptt, task_type, place, step_time)

    def predicted(self, task_type: str = "train_step") -> list[float]:
        tbl = self.ptt.for_type(task_type)
        out = []
        for p in self.topology.partitions:
            w = self.slices_per_pod if self.slices_per_pod in p.widths \
                else max(p.widths)
            out.append(tbl.get(p.place_containing(p.start, w)))
        return out

    # -- kernel bridge ----------------------------------------------------------
    def live_view(self) -> Optional[LiveView]:
        """The interned availability mask of the un-drained fleet — the
        same :class:`LiveView` object the scheduling kernel's engines
        consume for revoked capacity (None = every pod schedulable).
        Draining a pod and revoking a pod-slice are one mechanism."""
        if not self._drained:
            return None
        return self.topology.live_view(frozenset(self._drained))

    def apply_to(self, scheduler: Scheduler) -> None:
        """Point a scheduler driving either engine over this fleet at the
        monitor's availability mask: drained pods leave every wake-time
        placement search until restored.  The mask governs *placement*
        (no HIGH task binds to a drained pod; LOW work may still be
        stolen by its idle cores — taking cores out of execution outright
        is the preemption subsystem's job).  Engines clear the mask when
        their run ends (a revoked-capacity view must never leak into an
        unrelated later run), so re-apply before each run."""
        if scheduler.topology is not self.topology:
            raise ValueError("scheduler does not run over this fleet")
        scheduler.live = self.live_view()

    # -- planning ---------------------------------------------------------------
    def plan(self, task_type: str = "train_step") -> RescalePlan:
        times = self.predicted(task_type)
        active = [i for i in range(self.n_pods) if i not in self._drained]
        known = [(i, times[i]) for i in active if times[i] > 0]
        if len(known) < 2:
            return RescalePlan("none", reason="insufficient observations")
        vals = sorted(t for _, t in known)
        median = vals[len(vals) // 2]

        # 2. drain pathological stragglers
        to_drain = [i for i, t in known if t > self.drain_ratio * median]
        if to_drain:
            remaining = tuple(i for i in active if i not in to_drain)
            if remaining:
                self._drained.update(to_drain)
                return RescalePlan(
                    "drain", active_pods=remaining,
                    reason=f"pods {to_drain} at >{self.drain_ratio}x median "
                           f"({[round(times[i]/median, 2) for i in to_drain]}x)")

        # 3. restore recovered pods
        recovered = [i for i in self._drained
                     if 0 < times[i] <= self.restore_ratio * median]
        if recovered:
            for i in recovered:
                self._drained.discard(i)
            return RescalePlan(
                "restore",
                active_pods=tuple(i for i in range(self.n_pods)
                                  if i not in self._drained),
                reason=f"pods {recovered} recovered")

        # 1. DAM-C-style token rebalance (mold the per-pod microbatch count)
        tmax, tmin = max(t for _, t in known), min(t for _, t in known)
        if tmax / tmin > self.rebalance_ratio:
            inv = [1.0 / t for _, t in known]
            total = sum(inv)
            share = [0.0] * self.n_pods
            for (i, _), w in zip(known, inv):
                share[i] = w / total
            return RescalePlan(
                "rebalance", microbatch_share=tuple(share),
                active_pods=tuple(i for i, _ in known),
                reason=f"straggler ratio {tmax / tmin:.2f} > "
                       f"{self.rebalance_ratio}")
        return RescalePlan("none", active_pods=tuple(active))

    def microbatches_per_pod(self, total_microbatches: int,
                             plan: Optional[RescalePlan] = None) -> list[int]:
        """Integer microbatch counts per pod honoring a rebalance plan
        (largest-remainder rounding; every active pod gets >= 1)."""
        plan = plan or self.plan()
        if plan.kind != "rebalance":
            active = plan.active_pods or tuple(range(self.n_pods))
            base = total_microbatches // len(active)
            rem = total_microbatches - base * len(active)
            out = [0] * self.n_pods
            for j, i in enumerate(active):
                out[i] = base + (1 if j < rem else 0)
            return out
        shares = plan.microbatch_share
        raw = [s * total_microbatches for s in shares]
        out = [max(1, int(r)) if s > 0 else 0 for r, s in zip(raw, shares)]
        while sum(out) > total_microbatches:
            out[out.index(max(out))] -= 1
        while sum(out) < total_microbatches:
            fl = [r - o for r, o in zip(raw, out)]
            out[fl.index(max(fl))] += 1
        return out
