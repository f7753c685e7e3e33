"""Run metrics: throughput, per-core work time, placement distributions —
the quantities behind the paper's Figures 4-10."""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict


def percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolation percentile over pre-sorted values (stdlib-only;
    matches numpy's default 'linear' method)."""
    if not sorted_vals:
        raise ValueError("percentile of empty list")
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    if frac == 0.0:
        return sorted_vals[lo]
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[lo + 1] * frac


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One serving request's lifecycle timestamps (all on the engine's
    clock): submission, first token out (prefill commit), last token out.
    Graceful-degradation flags: ``rejected`` = refused at admission with
    ``reject_cause`` attributing it — ``"deadline"`` (the deadline could
    not be met even best-case) or ``"backpressure"`` (bounded pending
    queue full, or the brownout ladder's reject rung); ``shed`` = admitted
    but its queued LOW decode work was dropped — ``shed_cause`` is
    ``"deadline"`` (deadline passed mid-chain) or ``"brownout"`` (the
    ladder's shed rung) — truncated output, request still finalized."""
    rid: int
    t_submit: float
    t_first_token: float
    t_done: float
    deadline_s: float = 0.0         # 0 = no deadline
    rejected: bool = False
    shed: bool = False
    reject_cause: str = ""
    shed_cause: str = ""

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_submit

    @property
    def e2e(self) -> float:
        return self.t_done - self.t_submit

    @property
    def deadline_miss(self) -> bool:
        """A deadlined request that was rejected, shed, or finished late."""
        return self.deadline_s > 0.0 and (
            self.rejected or self.shed or self.e2e > self.deadline_s)


# not frozen: a frozen dataclass __init__ pays object.__setattr__ per
# field, and one TaskRecord is built per committed task on the DES hot
# path; slots keep it compact and equality-by-value is unchanged
@dataclasses.dataclass(slots=True)
class TaskRecord:
    type_name: str
    priority: int
    leader: int
    width: int
    t_ready: float
    t_start: float
    t_end: float

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def place(self) -> str:
        return f"(C{self.leader},{self.width})"


@dataclasses.dataclass
class RunMetrics:
    n_cores: int
    records: list[TaskRecord] = dataclasses.field(default_factory=list)
    makespan: float = 0.0
    # preemption accounting (zero when no PreemptionModel is attached):
    # revoke episodes applied, task executions preempted, and work-seconds
    # of discarded progress (restart kills; checkpointed progress is kept)
    preempt_events: int = 0
    tasks_preempted: int = 0
    work_lost_s: float = 0.0
    # sharded-control-plane accounting (all zero on the flat kernel):
    # rebalancer migrations landed, wake-time overflow redirects,
    # rebalance rounds run, and the estimated seconds of work migrated
    migrations: int = 0
    overflow_migrations: int = 0
    rebalance_rounds: int = 0
    migrated_load_s: float = 0.0
    # online re-sharding rounds applied mid-run (zero without reshard
    # events; see ShardedControlPlane.reshard)
    reshard_rounds: int = 0
    # continuous-batching accounting (empty without a BatchingConfig):
    # one entry per multi-member dispatch — (dispatch type name, sorted
    # tuple of member base-type names, leader included).  The cross-engine
    # parity tests compare these as multisets.
    batches: list[tuple] = dataclasses.field(default_factory=list)
    # fault-injection / recovery accounting (all zero without a FaultModel
    # attached — see ``repro.core.faults``): injected fault counts, retry /
    # permanent-failure counts, straggler flags and speculative duplicates,
    # and the work-seconds burned by failures and by losing hedge copies
    faults_failstop: int = 0
    faults_failslow: int = 0
    retries: int = 0
    failed_tasks: int = 0           # retry budget exhausted (permanent)
    stragglers: int = 0
    hedges_launched: int = 0
    hedge_wins: int = 0             # duplicate committed before the original
    work_lost_faults_s: float = 0.0
    work_hedged_s: float = 0.0      # losing-copy work (the hedge premium)
    # error surface: worker-thread death, permanently failed tasks, drain
    # timeouts.  An empty list is the "run is trustworthy" signal — the
    # threaded engine used to silently return partial data on any of these
    errors: list[str] = dataclasses.field(default_factory=list)
    # supervisor/heartbeat recovery events ("failure@step: workers [..]")
    recovery_events: list[str] = dataclasses.field(default_factory=list)
    # serving-path accounting: one record per completed request (open-loop
    # or batch), feeding the TTFT / end-to-end latency percentiles
    request_records: list[RequestRecord] = dataclasses.field(
        default_factory=list)
    # brownout-ladder transitions (t, from_rung, to_rung) copied from the
    # serving engine's OverloadController at finalize; empty without one
    brownout_transitions: list[tuple] = dataclasses.field(
        default_factory=list)

    def record(self, rec: TaskRecord) -> None:
        self.records.append(rec)

    def record_request(self, rec: RequestRecord) -> None:
        self.request_records.append(rec)

    def finish(self, t_end: float) -> None:
        self.makespan = t_end

    # -- aggregates -----------------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return len(self.records)

    @property
    def throughput(self) -> float:
        """tasks / second (paper §5.1: total tasks / total execution time)."""
        return self.n_tasks / self.makespan if self.makespan > 0 else 0.0

    def per_core_worktime(self) -> list[float]:
        """Cumulative kernel work time per core (paper Fig. 6)."""
        out = [0.0] * self.n_cores
        for r in self.records:
            for c in range(r.leader, r.leader + r.width):
                out[c] += r.duration
        return out

    def priority_placement(self) -> dict[str, float]:
        """Fraction of HIGH tasks per execution place (paper Fig. 5)."""
        high = [r for r in self.records if r.priority == 1]
        if not high:
            return {}
        counts = Counter(r.place for r in high)
        return {p: c / len(high) for p, c in sorted(counts.items())}

    def placement_counts(self, priority: int | None = None) -> dict[str, int]:
        recs = self.records if priority is None else [
            r for r in self.records if r.priority == priority]
        return dict(Counter(r.place for r in recs))

    def per_type_mean_duration(self) -> dict[str, float]:
        sums: dict[str, list[float]] = defaultdict(list)
        for r in self.records:
            sums[r.type_name].append(r.duration)
        return {k: sum(v) / len(v) for k, v in sums.items()}

    def windowed_throughput(self, window: float) -> list[tuple[float, float]]:
        """(t, tasks/s) series — used for the DVFS / iteration-time plots."""
        if not self.records:
            return []
        buckets: dict[int, int] = defaultdict(int)
        for r in self.records:
            buckets[int(r.t_end / window)] += 1
        return [(i * window, n / window) for i, n in sorted(buckets.items())]

    def iteration_times(self, marker_type: str) -> list[float]:
        """Completion-time deltas of a per-iteration marker task type
        (e.g. the K-means reduce) — paper Fig. 9(a)."""
        ends = sorted(r.t_end for r in self.records if r.type_name == marker_type)
        return [b - a for a, b in zip(ends, ends[1:])]

    def request_latency_stats(self) -> dict:
        """Per-request latency percentiles (milliseconds): time-to-first-
        token and end-to-end, p50/p95/p99 + mean, over completed (i.e.
        non-rejected) requests, plus graceful-degradation counters."""
        recs = self.request_records
        if not recs:
            return {}
        done = [r for r in recs if not r.rejected]
        out: dict = {
            "completed": len(done),
            "rejected": sum(1 for r in recs if r.rejected),
            "rejected_deadline": sum(1 for r in recs if r.rejected
                                     and r.reject_cause == "deadline"),
            "rejected_backpressure": sum(1 for r in recs if r.rejected
                                         and r.reject_cause == "backpressure"),
            "shed": sum(1 for r in recs if r.shed),
            "shed_deadline": sum(1 for r in recs if r.shed
                                 and r.shed_cause == "deadline"),
            "shed_brownout": sum(1 for r in recs if r.shed
                                 and r.shed_cause == "brownout"),
            "deadline_miss": sum(1 for r in recs if r.deadline_miss),
        }
        if self.brownout_transitions:
            trans = self.brownout_transitions
            out["brownout"] = {
                "transitions": len(trans),
                "max_rung": max(to for _, _, to in trans),
                "rung_enters": {
                    str(r): sum(1 for _, frm, to in trans
                                if frm < r <= to)
                    for r in (1, 2, 3)},
            }
        if not done:
            return out
        for key, vals in (("ttft_ms", sorted(r.ttft for r in done)),
                          ("e2e_ms", sorted(r.e2e for r in done))):
            out[key] = {
                "mean": sum(vals) / len(vals) * 1e3,
                "p50": percentile(vals, 50) * 1e3,
                "p95": percentile(vals, 95) * 1e3,
                "p99": percentile(vals, 99) * 1e3,
            }
        return out

    def fault_summary(self) -> dict:
        """Compact fault/recovery accounting (the ``faults`` collector)."""
        return {
            "failstop": self.faults_failstop,
            "failslow": self.faults_failslow,
            "retries": self.retries,
            "failed_tasks": self.failed_tasks,
            "stragglers": self.stragglers,
            "hedges": self.hedges_launched,
            "hedge_wins": self.hedge_wins,
            "work_lost_faults_s": round(self.work_lost_faults_s, 9),
            "work_hedged_s": round(self.work_hedged_s, 9),
        }

    def task_sojourn_stats(self) -> dict:
        """Ready-to-commit sojourn percentiles (seconds) over committed
        tasks — the per-task tail the straggler-hedging benchmark reads."""
        if not self.records:
            return {}
        vals = sorted(r.t_end - r.t_ready for r in self.records)
        return {
            "mean_s": sum(vals) / len(vals),
            "p50_s": percentile(vals, 50),
            "p99_s": percentile(vals, 99),
        }

    def summary(self) -> dict[str, float]:
        return {
            "tasks": self.n_tasks,
            "makespan_s": round(self.makespan, 6),
            "throughput_tps": round(self.throughput, 2),
        }
