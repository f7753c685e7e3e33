"""Tasks, task types and the moldable cost model (paper §2, §4.2.2).

A *task type* names a kernel (matmul / copy / stencil / kmeans_map / ...)
and carries a cost model used by the discrete-event simulator:

  * ``serial_time[kind]`` — seconds at width=1 on an unperturbed core of a
    partition *kind* (denver, a57, haswell, pod, ...).
  * ``efficiency(width)`` — parallel efficiency; molded duration is
    ``serial / (width * efficiency)``.  May exceed 1.0 slightly for
    cache-pooling effects (a width-4 stencil gets the whole shared L2).
  * ``bw_demand`` / ``mem_sensitivity`` — streaming kernels pressure the
    partition's shared memory bandwidth and are slowed when the sum of
    co-running demands exceeds it.  This is how co-running *copy* chains
    interfere with whole partitions in the paper's experiments.

The real threaded runtime ignores the cost model and *measures* payload
wall time — cost models never influence scheduling there; only the PTT does.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, Optional

from .places import ExecutionPlace


class Priority(enum.IntEnum):
    LOW = 0
    HIGH = 1


# Shared-bandwidth capacity per partition kind (bytes/s) for the contention
# model; roughly: TX2 LPDDR4 split per cluster, Haswell per-socket DDR4,
# TPU per-slice HBM.
# Effective shared-bandwidth capacity of a bw *domain*, keyed by the kind of
# the partitions in it (TX2: both clusters share the LPDDR4 pipe; Haswell:
# one domain per socket; TPU: per-pod aggregate HBM).
PARTITION_BW = {
    "denver": 18.0e9,
    "a57": 18.0e9,
    "haswell": 45.0e9,
    "pod": 8.19e11 * 16,        # current-gen pod (v5p-class HBM)
    "pod_v4": 3.7e11 * 16,      # previous-gen pod (v4-class HBM2)
}


@dataclasses.dataclass(frozen=True)
class TaskType:
    name: str
    serial_time: dict[str, float]
    efficiency: Callable[[int], float] = lambda w: 1.0
    bw_demand: float = 0.0          # bytes/s demanded at width 1
    mem_sensitivity: float = 0.0    # in [0,1]: exponent on the bw-share slowdown
    noise: float = 0.0              # stddev of multiplicative measurement noise
    # heavy-tailed measurement spikes (OS interrupts / timer quantization —
    # dominant for ~10 us tasks; this is what makes the PTT weight ratio
    # matter in the paper's Fig. 8)
    spike_prob: float = 0.0
    spike_mag: float = 1.0
    # Batched-dispatch lineage (continuous batching, serve path): the base
    # type's name when this type was derived via ``batched()``, else None.
    # Lets metrics/tests recover the per-member type behind a ``@bN`` name.
    batch_base: Optional[str] = dataclasses.field(default=None, compare=False)
    # (kind, width) -> molded duration; cost models are pure so the value is
    # computed (and validated) once.  Excluded from eq/repr; mutating a dict
    # inside a frozen dataclass is fine.
    _dur_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)
    # (n, member_cost) -> derived batched type (see ``batched()``)
    _batch_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                           repr=False, compare=False)

    def duration(self, kind: str, width: int) -> float:
        """Unperturbed molded duration (the DES divides this by the
        time-varying rate)."""
        d = self._dur_cache.get((kind, width))
        if d is None:
            if kind not in self.serial_time:
                raise KeyError(f"{self.name}: no cost for partition kind {kind!r}")
            eff = self.efficiency(width)
            if not 0.0 < eff <= 1.5:
                raise ValueError(f"{self.name}: efficiency({width})={eff} out of (0,1.5]")
            d = self.serial_time[kind] / (width * eff)
            self._dur_cache[(kind, width)] = d
        return d

    def batched(self, n: int, member_cost: float) -> "TaskType":
        """The cost model of ``n`` of these tasks fused into one dispatch
        (continuous batching): batched decode is memory-bound, so each
        member past the first adds only a ``member_cost`` fraction of the
        base time rather than a full serial repeat.  ``n == 1`` returns
        this type unchanged (the ``max_batch=1`` degeneracy pin); ``n > 1``
        names the derived type ``{name}@b{bucket}`` with a power-of-two
        bucket so the PTT learns batched-dispatch throughput per size
        class, not per-token time.  Cached per (n, member_cost)."""
        if n <= 1:
            return self
        key = (n, member_cost)
        bt = self._batch_cache.get(key)
        if bt is None:
            scale = 1.0 + member_cost * (n - 1)
            bt = TaskType(
                f"{self.name}@b{batch_bucket(n)}",
                {k: v * scale for k, v in self.serial_time.items()},
                efficiency=self.efficiency, bw_demand=self.bw_demand,
                mem_sensitivity=self.mem_sensitivity, noise=self.noise,
                spike_prob=self.spike_prob, spike_mag=self.spike_mag,
                batch_base=self.name)
            self._batch_cache[key] = bt
        return bt


def batch_bucket(n: int) -> int:
    """Smallest power of two >= n — the PTT size class of an n-member
    batched dispatch (``decode@b8`` covers sizes 5-8, etc.)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    return 1 << (n - 1).bit_length()


_task_ids = itertools.count()


@dataclasses.dataclass
class Task:
    """One DAG node.  ``payload`` is only used by the real runtime: a
    callable ``payload(width) -> None`` that does the actual work."""

    type: TaskType
    priority: Priority = Priority.LOW
    payload: Optional[Callable[[int], None]] = None
    tid: int = dataclasses.field(default_factory=lambda: next(_task_ids))
    # Extra positional arguments appended to the payload call —
    # ``payload(width, *args)`` — so hot-path task factories can share one
    # bound method instead of allocating a closure per task.
    args: tuple = ()

    # Continuous-batching state (see core/queues.py BatchingConfig and
    # SchedulingKernel.form_dispatch).  ``batch_key`` marks a LOW task as
    # coalescible: when an engine dequeues it with batching enabled, queued
    # tasks with the same key join it as ``batch_members`` and the dispatch
    # is re-typed via ``TaskType.batched``.  Members never execute alone —
    # they ride the dispatch through place/commit and get their successors
    # walked at the dispatch's commit.
    batch_key: Optional[str] = None
    batch_members: Optional[list["Task"]] = None

    # DAG linkage
    children: list["Task"] = dataclasses.field(default_factory=list)
    n_deps: int = 0               # unsatisfied input dependencies
    # Dynamic-DAG hook: called on commit; may create & return new tasks
    # (paper §2: tasks may conditionally insert new tasks at runtime).
    on_commit: Optional[Callable[["Task"], list["Task"]]] = None

    # Scheduling state (filled in by the engines)
    bound_place: Optional[ExecutionPlace] = None   # binding decision (high prio)
    place: Optional[ExecutionPlace] = None         # final execution place
    t_ready: float = -1.0
    t_start: float = -1.0
    t_end: float = -1.0

    # Load-accounting state (see ``core/lifecycle.py``): the estimated
    # execution seconds this task contributes to its queue's outstanding
    # work while it sits in a WSQ.  Stamped by the kernel at wake/requeue
    # when load tracking is on; 0.0 (the default) contributes nothing, so
    # untracked runs never touch it.
    load_est: float = 0.0

    # Preemption state (see ``repro.core.preemption``): fraction of the
    # place-normalized work still outstanding (checkpointed progress keeps
    # it < 1.0 across re-placements; "restart" kills leave it at 1.0), and
    # how many times this task has been preempted.
    resume_frac: float = 1.0
    preempt_count: int = 0
    # Threaded-engine revocation signal: while the task executes, this is
    # the current execution's ``threading.Event``; it is set when the
    # task's partition is revoked mid-run.  A *cooperative* payload may
    # poll it and checkpoint by returning the fraction of its outstanding
    # work completed (see core/runtime.py); payloads that ignore it run
    # to completion in the grace window.  None outside execution (and
    # always None in the DES, which preempts running tasks directly).
    revoke_signal: Optional[object] = None

    # Fault-injection / recovery state (see ``repro.core.faults``; all
    # inert without a FaultModel attached).  ``fault_seq`` is the task's
    # deterministic position in the fault draw stream (assigned by
    # ``FaultState.register_dag``); ``fault_count`` counts failed
    # executions (injected fail-stops and real payload exceptions alike)
    # and doubles as the retry-attempt index.  A hedged HIGH task and its
    # speculative duplicate point at each other via ``hedge_dup`` /
    # ``hedge_of``; ``committed`` marks the logical task's first commit
    # (first copy wins, the other is suppressed).
    fault_seq: Optional[int] = None
    fault_count: int = 0
    hedge_of: Optional["Task"] = None      # set on the duplicate only
    hedge_dup: Optional["Task"] = None     # set on the original only
    hedge_launched: bool = False
    committed: bool = False

    def add_child(self, child: "Task") -> "Task":
        self.children.append(child)
        child.n_deps += 1
        return child

    def __hash__(self) -> int:
        return self.tid

    def __repr__(self) -> str:
        p = "H" if self.priority == Priority.HIGH else "L"
        return f"Task<{self.tid}:{self.type.name}:{p}>"


# ---------------------------------------------------------------------------
# The paper's three synthetic node kernels (§4.2.2).
#
# Calibration notes (TX2): Denver ~2x A57 on dense GEMM; A57 L1d is 32 KB vs
# Denver 64 KB, so matmul tiles of 64/80 (48/75 KB working set) spill A57 L1
# and run at a lower per-element rate there; tile 96 spills both L1s into the
# 2 MB shared L2.  Short tasks (tile 32 -> ~10 us) have noisy measurements,
# which is what makes the PTT weight ratio matter in the paper's Fig. 8.
# ---------------------------------------------------------------------------

def _compute_eff(w: int) -> float:
    return {1: 1.0, 2: 0.95, 4: 0.90, 5: 0.90, 8: 0.85, 10: 0.85, 16: 0.80}.get(w, 0.8)


def _memory_eff(w: int) -> float:
    # Streaming: molding widens the stream but shares one memory pipe; the
    # win is mainly *not* co-running w independent streams (contention model).
    return {1: 1.0, 2: 0.80, 4: 0.60, 5: 0.55, 8: 0.45, 10: 0.40, 16: 0.35}.get(w, 0.3)


def _cache_eff(w: int) -> float:
    # Cache-intensive: pooling the shared L2 gives slightly superlinear
    # efficiency at the cluster width.
    return {1: 1.0, 2: 1.05, 4: 1.10, 5: 1.05, 8: 0.95, 10: 0.90, 16: 0.85}.get(w, 0.8)


# per-(kind) GEMM rate in FLOP/s, by tile regime: fits-L1 / spills-to-L2.
# Denver's wide 7-way core is ~3x an A57 on dense fp32 GEMM.
_MM_RATE = {
    "denver": {"l1": 9.0e9, "l2": 7.5e9},
    "a57": {"l1": 3.0e9, "l2": 1.9e9},
    "haswell": {"l1": 3.4e10, "l2": 2.9e10},
    "pod": {"l1": 1.97e14, "l2": 1.80e14},
    # previous-gen pod slice (v4-class): ~0.45x the dense-GEMM rate of the
    # current generation — the static asymmetry of a mixed TPU fleet
    "pod_v4": {"l1": 0.90e14, "l2": 0.82e14},
}
_L1_BYTES = {"denver": 64 * 1024, "a57": 32 * 1024, "haswell": 32 * 1024,
             "pod": 1 << 60, "pod_v4": 1 << 60}


def matmul_type(tile: int = 64) -> TaskType:
    """Compute-intensive GEMM node; per-task tile NxN fp32 (paper: 64)."""
    flops = 2.0 * tile ** 3
    wset = 3 * 4 * tile * tile
    serial = {}
    for kind, rates in _MM_RATE.items():
        regime = "l1" if wset <= _L1_BYTES[kind] else "l2"
        serial[kind] = flops / rates[regime]
    # Molding a tiny GEMM across cores pays a sync cost comparable to the
    # work itself; the efficiency curve improves with tile size.
    if tile <= 64:
        eff = lambda w: {1: 1.0, 2: 0.72, 4: 0.40, 5: 0.36, 8: 0.28,
                         10: 0.25, 16: 0.20}.get(w, 0.2)
    elif tile <= 96:
        eff = lambda w: {1: 1.0, 2: 0.85, 4: 0.65, 5: 0.60, 8: 0.50,
                         10: 0.45, 16: 0.40}.get(w, 0.4)
    else:
        eff = _compute_eff
    # tile 32 -> ~10 us tasks: timer noise is a large fraction of the reading
    # and OS jitter shows up as multi-x spikes; longer tasks average it out.
    noise = {32: 0.20, 64: 0.06, 80: 0.04, 96: 0.03}.get(tile, 0.05)
    spike_p = {32: 0.08, 64: 0.02, 80: 0.01, 96: 0.01}.get(tile, 0.01)
    spike_m = {32: 6.0, 64: 2.0, 80: 1.5, 96: 1.5}.get(tile, 1.5)
    return TaskType(f"matmul{tile}", serial, efficiency=eff,
                    bw_demand=0.05e9, mem_sensitivity=0.15, noise=noise,
                    spike_prob=spike_p, spike_mag=spike_m)


def copy_type(tile: int = 1024) -> TaskType:
    """Memory-intensive streaming copy; tile x tile fp32 read+write.
    Single-core effective stream bandwidth (TX2 ~3 GB/s class)."""
    bytes_moved = 2.0 * 4.0 * tile * tile
    bw = {"denver": 3.5e9, "a57": 2.5e9, "haswell": 1.2e10, "pod": 8.19e11,
          "pod_v4": 3.7e11}
    return TaskType(
        f"copy{tile}", {k: bytes_moved / b for k, b in bw.items()},
        efficiency=_memory_eff,
        bw_demand=3.0e9, mem_sensitivity=1.0, noise=0.03,
    )


def stencil_type(tile: int = 1024) -> TaskType:
    """Cache-intensive 5-point stencil over a tile x tile fp32 grid."""
    flops = 5.0 * tile * tile * 4      # 4 sweeps per task
    rate = {"denver": 5.5e9, "a57": 2.8e9, "haswell": 2.2e10, "pod": 9.0e13,
            "pod_v4": 4.0e13}
    return TaskType(
        f"stencil{tile}", {k: flops / r for k, r in rate.items()},
        efficiency=_cache_eff,
        bw_demand=2.0e9, mem_sensitivity=0.5, noise=0.03,
    )


def mpi_exchange_type(boundary_kb: float = 64.0) -> TaskType:
    """Ghost-cell exchange for the distributed 2D Heat app.  Message passing
    is single-core work, but reserving a width-2 place keeps the co-located
    cache quiet, which measurably helps MPI (paper §5.4 citing [25]) —
    modeled as a small efficiency credit at width 2."""
    t = boundary_kb * 1024 / 1.2e9     # FDR IB effective pt2pt + sw overhead
    eff = lambda w: {1: 1.0, 2: 0.56}.get(w, 1.0 / w)
    return TaskType(
        "mpi_exchange",
        {"haswell": t, "denver": t, "a57": t, "pod": t / 50,
         "pod_v4": t / 25},
        efficiency=eff, bw_demand=1.0e9, mem_sensitivity=0.8, noise=0.05,
    )


def kmeans_map_type(points: int, dims: int, k: int) -> TaskType:
    """K-means assignment step over a chunk of points (data-parallel map)."""
    flops = 3.0 * points * dims * k
    rate = {"haswell": 2.6e10, "denver": 7.0e9, "a57": 3.5e9, "pod": 1.5e14,
            "pod_v4": 6.8e13}
    return TaskType(
        f"kmeans_map{points}x{dims}x{k}",
        {kind: flops / r for kind, r in rate.items()},
        efficiency=_compute_eff, bw_demand=4.0e9, mem_sensitivity=0.4,
        noise=0.04,
    )


def kmeans_reduce_type(k: int, dims: int, chunks: int) -> TaskType:
    """Centroid update (reduction) — the largest serial unit, marked HIGH."""
    flops = 2.0 * k * dims * chunks * 50
    rate = {"haswell": 1.2e10, "denver": 5.0e9, "a57": 2.5e9, "pod": 1.0e14,
            "pod_v4": 4.5e13}
    return TaskType(
        f"kmeans_reduce{k}x{dims}",
        {kind: flops / r for kind, r in rate.items()},
        efficiency=lambda w: {1: 1.0, 2: 0.8}.get(w, 0.6), bw_demand=1.0e9,
        mem_sensitivity=0.3, noise=0.04,
    )
