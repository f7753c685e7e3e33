"""Fault tolerance: heartbeats, failure detection, checkpoint-restart.

``HeartbeatMonitor`` tracks liveness per worker (host/pod); a worker is
declared failed after ``timeout`` without a beat.  ``run_with_recovery``
is the generic supervisor loop: it executes a step function, and on
(injected or real) worker failure restores the last checkpoint, skips the
data stream ahead to the restored step (exact, because batches are a pure
function of step), optionally shrinks the active-pod set via the elastic
monitor, and resumes.  Tests inject failures deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from .elastic import PodMonitor, RescalePlan


class HeartbeatMonitor:
    def __init__(self, workers: list[int], timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self._last: dict[int, float] = {w: now for w in workers}
        self._failed: set[int] = set()

    def beat(self, worker: int) -> None:
        self._last[worker] = self.clock()
        self._failed.discard(worker)

    def failed_workers(self) -> set[int]:
        now = self.clock()
        for w, t in self._last.items():
            if now - t > self.timeout:
                self._failed.add(w)
        return set(self._failed)

    def healthy(self) -> bool:
        return not self.failed_workers()


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    kind: str          # "failure" | "straggler" | "rescale"
    detail: str


@dataclasses.dataclass
class Supervisor:
    """Glue object the trainer consults every step."""
    heartbeat: HeartbeatMonitor
    pods: Optional[PodMonitor] = None
    events: list[RecoveryEvent] = dataclasses.field(default_factory=list)

    def check(self, step: int) -> Optional[str]:
        """Returns an action: None | "restart" (failure detected)."""
        failed = self.heartbeat.failed_workers()
        if failed:
            self.events.append(RecoveryEvent(step, "failure",
                                             f"workers {sorted(failed)}"))
            return "restart"
        return None

    def elastic_plan(self, step: int) -> Optional[RescalePlan]:
        if self.pods is None:
            return None
        plan = self.pods.plan()
        if plan.kind != "none":
            self.events.append(RecoveryEvent(step, "rescale",
                                             f"{plan.kind}: {plan.reason}"))
        return plan
