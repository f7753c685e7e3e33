"""Task-level fault injection + criticality-aware recovery policies.

The interference and preemption layers degrade *platforms* (slowdown
profiles, whole-pod revocation); this module degrades *tasks*.  Two fault
classes, both seeded and engine-agnostic:

* **fail-stop** — a task dies at a seeded fraction of its work.  In the
  DES the execution is cut at that fraction of the assigned work; in the
  threaded engine the same decision marks the execution failed after the
  payload runs (a Python frame cannot be killed mid-flight, so the wall
  time is the lost work) and *real* payload exceptions feed the identical
  path.
* **fail-slow** — the task's place silently degrades mid-execution: from
  a seeded work fraction onward the execution proceeds at ``1/factor``
  rate (DES) or is stretched by ``factor`` (threaded).  Nothing fails, so
  retry policies are blind to it — this is the regime straggler hedging
  exists for.

Faults are drawn per *execution attempt* from a dedicated stream
``random.Random(f"fault:{seed}:{fault_seq}:{attempt}")`` — a pure
function of the model seed, the task's deterministic DAG position
(:meth:`FaultState.register_dag`), and how many times it has already
failed.  Both engines therefore inject the *same* faults on the same DAG
(modulo the MMPP timeline, which reads each engine's own clock), which is
what the cross-engine parity test pins.  None of the draws touch the
scheduler's streams, so attaching a zero-probability model (or none) is
bit-identical to a build without the subsystem.

Recovery (driven by the engines, policy here):

* **retry with backoff** — a fail-stop victim re-enters the kernel's
  ``requeue_displaced`` path after a seeded exponential backoff, with the
  failing place PTT-penalized (:meth:`SchedulingKernel.fault_feedback`)
  so the re-placement avoids it; per-task attempt budget
  ``max_retries``, beyond which the failure is permanent and surfaced in
  ``RunMetrics``.
* **straggler hedging** — an execution running past ``straggler_k`` x
  the PTT-expected duration for its (type, place) is flagged; flagged
  HIGH tasks get a speculative duplicate on the PTT-best place that
  shares no core with the original.  First commit wins; the loser is
  cancelled (DES: killed outright; threaded: nudged via the existing
  cooperative ``revoke_signal`` channel) and its work lands in
  ``work_hedged_s``.  LOW tasks are never hedged — criticality knowledge
  is exactly what makes speculation affordable.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Optional

from .dag import DAG
from .interference import mmpp_state_timeline
from .task import Task


@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault decision for one execution attempt."""
    kind: str           # "stop" | "slow"
    frac: float         # fraction of the assigned work at which it strikes
    factor: float = 1.0  # rate divisor from the strike point on (fail-slow)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded per-task fault injection (see module docstring).

    ``p_fail`` / ``p_slow`` are per-execution-attempt probabilities of a
    fail-stop / fail-slow fault; at most one fires per attempt (fail-stop
    is drawn first).  ``fail_window`` / ``slow_window`` bound the uniform
    work fraction at which the fault strikes.  ``max_task_failures``
    bounds the fail-stop *injections* per task, so a retried task
    eventually runs clean and every DAG completes under a sufficient
    retry budget.  ``timeline`` (from :func:`mmpp_faults`) modulates both
    probabilities by ``storm_mult`` during storm segments, the correlated
    fault-burst signature; empty means constant rates.
    """

    seed: int
    p_fail: float = 0.0
    p_slow: float = 0.0
    slow_factor: float = 4.0
    fail_window: tuple[float, float] = (0.2, 0.9)
    slow_window: tuple[float, float] = (0.1, 0.6)
    max_task_failures: int = 2
    timeline: tuple[tuple[float, int], ...] = ()
    storm_mult: float = 1.0

    def __post_init__(self) -> None:
        for name in ("p_fail", "p_slow"):
            p = getattr(self, name)
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"{name}={p!r} outside [0, 1]")
        if not (self.slow_factor >= 1.0 and math.isfinite(self.slow_factor)):
            raise ValueError(f"slow_factor must be >= 1, got {self.slow_factor!r}")
        for name in ("fail_window", "slow_window"):
            lo, hi = getattr(self, name)
            if not (0.0 < lo <= hi < 1.0):
                raise ValueError(f"{name}={(lo, hi)!r} must satisfy 0<lo<=hi<1")
        if self.max_task_failures < 0:
            raise ValueError("max_task_failures must be >= 0")
        if self.storm_mult < 0.0:
            raise ValueError("storm_mult must be >= 0")

    @property
    def enabled(self) -> bool:
        """False for a zero-probability model: engines treat it exactly
        like ``None`` (the bit-identity guarantee the golden pins check)."""
        return self.p_fail > 0.0 or self.p_slow > 0.0

    def mult_at(self, t: float) -> float:
        """Probability multiplier in force at time ``t`` (1.0 when calm
        or with no timeline)."""
        tl = self.timeline
        if not tl:
            return 1.0
        i = bisect.bisect_right(tl, (t, 2)) - 1
        if i < 0:
            return 1.0
        return self.storm_mult if tl[i][1] else 1.0


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What the engines do about injected (and real) task failures.

    ``backoff_base``/``backoff_cap`` are seconds on the engine's own
    clock (virtual for the DES — benchmark sweeps scale them to the
    calibrated makespan).  ``fail_penalty`` multiplies the failing
    place's PTT observation so the retry re-places elsewhere.
    ``straggler_k`` flags executions past ``k`` x the PTT expectation;
    ``hedge`` enables speculative duplicates for flagged HIGH tasks.
    ``straggler_poll_s`` is the threaded engine's monitor period (the DES
    schedules exact straggle events instead).
    """

    max_retries: int = 5
    backoff_base: float = 1e-3
    backoff_cap: float = 0.05
    fail_penalty: float = 3.0
    straggler_k: float = 3.0
    hedge: bool = False
    straggler_poll_s: float = 5e-3

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not (self.backoff_base >= 0.0 and self.backoff_cap >= 0.0):
            raise ValueError("backoff must be >= 0")
        if self.fail_penalty < 1.0:
            raise ValueError("fail_penalty must be >= 1")
        if self.straggler_k <= 1.0:
            raise ValueError("straggler_k must be > 1")
        if self.straggler_poll_s <= 0.0:
            raise ValueError("straggler_poll_s must be > 0")


class FaultState:
    """Per-run mutable companion of a (frozen) :class:`FaultModel`:
    assigns deterministic fault sequence numbers and performs the pure
    per-attempt draws.  Engines own exactly one per run."""

    def __init__(self, model: FaultModel, policy: RecoveryPolicy):
        self.model = model
        self.policy = policy
        self._next_seq = 0
        # hedging decisions (alternative-place tie-breaks) draw from their
        # own stream — never the scheduler's, or attaching a fault model
        # would perturb every placement decision after the first hedge
        self.hedge_rng = random.Random(f"fault-hedge:{model.seed}")

    def register_dag(self, dag: DAG) -> None:
        """Assign fault sequence numbers in the DAG's deterministic BFS
        order (``DAG.all_tasks``), so both engines — whose global task
        ids differ — inject identical faults at identical DAG positions.
        Dynamically created tasks (``on_commit`` children, hedge
        duplicates) get lazy numbers in creation order instead."""
        for task in dag.all_tasks():
            if task.fault_seq is None:
                task.fault_seq = self._next_seq
                self._next_seq += 1

    def seq_for(self, task: Task) -> int:
        if task.fault_seq is None:
            task.fault_seq = self._next_seq
            self._next_seq += 1
        return task.fault_seq

    def draw(self, task: Task, t: float) -> Optional[Fault]:
        """Arm (or not) a fault for this execution attempt — a pure
        function of (model seed, task's fault_seq, task's failure count);
        ``t`` only selects the MMPP modulation segment."""
        m = self.model
        rng = random.Random(f"fault:{m.seed}:{self.seq_for(task)}:"
                            f"{task.fault_count}")
        # fixed draw order regardless of parameters, so enabling fail-slow
        # never shifts which tasks fail-stop under the same seed
        u_stop = rng.random()
        u_slow = rng.random()
        f_stop = rng.uniform(*m.fail_window)
        f_slow = rng.uniform(*m.slow_window)
        mult = m.mult_at(t)
        if (m.p_fail > 0.0 and task.fault_count < m.max_task_failures
                and u_stop < min(1.0, m.p_fail * mult)):
            return Fault("stop", f_stop)
        if m.p_slow > 0.0 and u_slow < min(1.0, m.p_slow * mult):
            return Fault("slow", f_slow, m.slow_factor)
        return None

    def backoff(self, task: Task) -> float:
        """Seeded exponential backoff before retry number
        ``task.fault_count`` (already incremented by the failure):
        ``base * 2^(n-1)``, jittered uniformly in [0.5x, 1.5x], capped."""
        p = self.policy
        n = max(task.fault_count, 1)
        rng = random.Random(f"fault-backoff:{self.model.seed}:"
                            f"{self.seq_for(task)}:{n}")
        d = p.backoff_base * (2.0 ** (n - 1)) * (0.5 + rng.random())
        return min(d, p.backoff_cap)


def task_faults(*, seed: int, p_fail: float = 0.0, p_slow: float = 0.0,
                slow_factor: float = 4.0,
                fail_window: tuple[float, float] = (0.2, 0.9),
                slow_window: tuple[float, float] = (0.1, 0.6),
                max_task_failures: int = 2) -> FaultModel:
    """Independent per-attempt faults at constant rates (the memoryless
    baseline, and the only mode with exact cross-engine draw parity —
    no clock-dependent modulation)."""
    return FaultModel(seed=seed, p_fail=p_fail, p_slow=p_slow,
                      slow_factor=slow_factor, fail_window=fail_window,
                      slow_window=slow_window,
                      max_task_failures=max_task_failures)


def mmpp_faults(*, seed: int, t_end: float, mean_calm: float,
                mean_storm: float, storm_mult: float = 8.0,
                p_fail: float = 0.0, p_slow: float = 0.0,
                slow_factor: float = 4.0,
                fail_window: tuple[float, float] = (0.2, 0.9),
                slow_window: tuple[float, float] = (0.1, 0.6),
                max_task_failures: int = 2) -> FaultModel:
    """MMPP-correlated fault bursts: one hidden calm/storm chain (the
    same construction as ``mmpp_preemption``, seeded from
    ``f"fault-mmpp-state:{seed}"``) multiplies both fault probabilities
    by ``storm_mult`` during storms, so faults cluster in time — the
    correlated-degradation signature.  Probabilities are evaluated at
    each execution's *start* time on the engine's clock."""
    state_rng = random.Random(f"fault-mmpp-state:{seed}")
    timeline = tuple(mmpp_state_timeline(state_rng, t_end=t_end,
                                         mean_calm=mean_calm,
                                         mean_storm=mean_storm))
    return FaultModel(seed=seed, p_fail=p_fail, p_slow=p_slow,
                      slow_factor=slow_factor, fail_window=fail_window,
                      slow_window=slow_window,
                      max_task_failures=max_task_failures,
                      timeline=timeline, storm_mult=storm_mult)
