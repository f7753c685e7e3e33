"""Batched multi-run DES engine: sweep-level parallelism across host cores.

The paper's headline results are *grids* of independent discrete-event
runs — Fig. 4 is (3 kernels x 5 parallelism x 7 schedulers) cells, Fig. 8
is (4 tiles x 4 PTT weights), the sensitivity and throughput sweeps add
seeds and topologies on top.  A single run was made ~6x faster by the
incremental-dispatch engine; this module makes the *sweep* scale with the
host by fanning cells across a ``multiprocessing`` pool.

Design rules
------------
* **Declarative, spawn-safe specs.**  A :class:`RunSpec` cell names
  registry entries (task types, DAG builders, topologies, background
  apps, speed profiles) plus plain-data kwargs, so the whole grid is
  picklable under the ``spawn`` start method: no live ``Topology`` /
  ``random.Random`` / lambda objects ever cross the process boundary.
  ``spawn`` is used unconditionally (never ``fork``) so results cannot
  depend on parent-process state and the engine behaves identically on
  every platform.
* **Deterministic per-cell seeding.**  Every cell carries its own seed
  and is rebuilt from scratch inside whichever process runs it, so
  results are bit-identical for any ``workers`` value — including the
  in-process ``workers=1`` path — and any chunk layout.  (Global counters
  such as ``Task.tid`` differ between processes, but nothing in the
  engine's behavior depends on absolute tid values.)
* **Chunked distribution.**  Cells are handed to the pool in contiguous
  chunks (``len/(workers*4)`` by default) so a 100+-cell grid amortizes
  IPC without serializing the tail onto one worker.
* **Compact results.**  Workers reduce each :class:`~.metrics.RunMetrics`
  to a plain dict (makespan/throughput + requested collectors), so a
  32k-task run ships a few hundred bytes back, not 32k ``TaskRecord``\\ s.
* **Cached pool.**  The spawn pool is kept alive between ``run_cells``
  calls (spawning costs ~0.65 s/worker of fixed interpreter+import
  overhead per call otherwise) and torn down by :func:`shutdown_pool`
  (registered atexit).  Reuse cannot change results: every cell is
  rebuilt from its spec inside whichever worker runs it.

The benchmark harnesses (``benchmarks/bench_interference.py`` etc.) build
their grids out of these specs; see ``benchmarks/README.md`` for the
worker/seed semantics contract.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import time
from multiprocessing import get_context
from typing import Iterable, Optional, Sequence

from .dag import (DAG, decode_pool_dag, heat_dag, kmeans_dag, mixed_dag,
                  synthetic_dag)
from .faults import FaultModel, RecoveryPolicy, mmpp_faults, task_faults
from .interference import (BackgroundApp, LoadCoupledGovernor,
                           PeriodicProfile, SpeedProfile, SpeedProfileBase,
                           burst_episodes, corun_chain, corun_socket,
                           dvfs_denver, governor_profile, mmpp_burst_episodes,
                           random_walk_trace)
from .metrics import RunMetrics
from .places import (Topology, haswell, haswell_cluster, tpu_pod_slices, tx2,
                     tx2_xl)
from .preemption import (PreemptionModel, mmpp_preemption,
                         pod_slice_preemption, sub_slice_preemption)
from .schedulers import make_scheduler
from .shards import ShardingSpec
from .simulator import simulate
from .task import (TaskType, copy_type, kmeans_map_type, kmeans_reduce_type,
                   matmul_type, mpi_exchange_type, stencil_type)

# --------------------------------------------------------------------------
# Registries: every name a RunSpec may reference.  Specs are (name, kwargs)
# pairs; builders are looked up here inside the worker process.
# --------------------------------------------------------------------------

TASK_TYPES = {
    "matmul": matmul_type,
    "copy": copy_type,
    "stencil": stencil_type,
    "mpi_exchange": mpi_exchange_type,
    "kmeans_map": kmeans_map_type,
    "kmeans_reduce": kmeans_reduce_type,
}

TOPOLOGIES = {
    "tx2": tx2,
    "tx2_xl": tx2_xl,
    "haswell": haswell,
    "haswell_cluster": haswell_cluster,
    "tpu_pod_slices": tpu_pod_slices,
}


def _synthetic(task_type: TaskType, **kw) -> DAG:
    return synthetic_dag(task_type, **kw)


def _heat(task_type=None, **kw) -> DAG:          # heat builds its own types
    return heat_dag(**kw)


def _kmeans(task_type=None, **kw) -> DAG:
    return kmeans_dag(**kw)


def _mixed(task_types=(), **kw) -> DAG:
    # task_types is a tuple of (name, kwargs) pairs, resolved here so the
    # spec stays plain data (the singular task_type resolution only covers
    # one type)
    return mixed_dag([_build_task_type(t) for t in task_types], **kw)


def _decode_pool(task_types=(), **kw) -> DAG:
    # (prefill, decode) as (name, kwargs) pairs, mixed-dag idiom
    pre, dec = (_build_task_type(t) for t in task_types)
    return decode_pool_dag(pre, dec, **kw)


DAG_BUILDERS = {
    "synthetic": _synthetic,
    "heat": _heat,
    "kmeans": _kmeans,
    "mixed": _mixed,
    "decode_pool": _decode_pool,
}


def _bg_chain(task_type: TaskType, **kw) -> BackgroundApp:
    return corun_chain(task_type, **kw)


def _bg_socket(task_type: TaskType, cores: Sequence[int], **kw) -> BackgroundApp:
    return corun_socket(task_type, tuple(cores), **kw)


def _bg_bursty(task_type: TaskType, cores: Sequence[int],
               **kw) -> tuple[BackgroundApp, ...]:
    return burst_episodes(task_type, tuple(cores), **kw)


def _bg_mmpp_bursty(task_type: TaskType, core_groups: Sequence[Sequence[int]],
                    **kw) -> tuple[BackgroundApp, ...]:
    # MMPP-correlated bursts: one calm/storm timeline shared by all core
    # groups, so co-runner pressure clusters in time across the fleet.
    return mmpp_burst_episodes(task_type,
                               [tuple(g) for g in core_groups], **kw)


# Builders may return one BackgroundApp or a tuple of them (bursty
# episodes); run_cell flattens.
BACKGROUND_BUILDERS = {
    "chain": _bg_chain,
    "socket": _bg_socket,
    "bursty": _bg_bursty,
    "mmpp_bursty": _bg_mmpp_bursty,
}


# Speed builders receive the cell's built Topology (per-partition governors
# need the partition layout, everything else just reads n_cores).
def _speed_dvfs_denver(topo: Topology, **kw) -> SpeedProfileBase:
    return dvfs_denver(n_cores=topo.n_cores, **kw)


def _speed_square_wave(topo: Topology, cores: Sequence[int],
                       **kw) -> SpeedProfile:
    return SpeedProfile(topo.n_cores).add_square_wave(tuple(cores), **kw)


def _speed_constant(topo: Topology, cores: Sequence[int],
                    speed: float) -> SpeedProfile:
    return SpeedProfile(topo.n_cores).set_constant(tuple(cores), speed)


def _speed_periodic_square(topo: Topology, cores: Sequence[int],
                           **kw) -> PeriodicProfile:
    return PeriodicProfile.square_wave(topo.n_cores, tuple(cores), **kw)


def _speed_governor(topo: Topology, **kw) -> PeriodicProfile:
    return governor_profile(topo, **kw)


def _speed_governor_load(topo: Topology, *, coupling: float = 0.3,
                         **kw) -> SpeedProfileBase:
    # per-partition governors whose detune additionally deepens with the
    # partition's occupancy (see interference.LoadCoupledGovernor)
    return LoadCoupledGovernor(governor_profile(topo, **kw), topo,
                               coupling=coupling)


def _speed_trace_walk(topo: Topology, cores: Sequence[int] = (),
                      **kw) -> SpeedProfileBase:
    return random_walk_trace(topo.n_cores, tuple(cores), **kw)


SPEED_BUILDERS = {
    "dvfs_denver": _speed_dvfs_denver,
    "square_wave": _speed_square_wave,
    "constant": _speed_constant,
    "periodic_square": _speed_periodic_square,
    "governor": _speed_governor,
    "governor_load": _speed_governor_load,
    "trace_walk": _speed_trace_walk,
}


# Preemption builders receive the cell's built Topology (episodes are
# partition-granular and seeded per partition name).
def _pre_pod_slices(topo: Topology, **kw) -> PreemptionModel:
    return pod_slice_preemption(topo, **kw)


def _pre_mmpp(topo: Topology, **kw) -> PreemptionModel:
    return mmpp_preemption(topo, **kw)


def _pre_sub_slices(topo: Topology, **kw) -> PreemptionModel:
    return sub_slice_preemption(topo, **kw)


PREEMPTION_BUILDERS = {
    "pod_slices": _pre_pod_slices,
    "mmpp": _pre_mmpp,
    "sub_slices": _pre_sub_slices,
}


# Fault-model builders are topology-free (faults are drawn per task, not per
# partition) — they take only their own seeded kwargs.
def _faults_independent(**kw) -> FaultModel:
    return task_faults(**kw)


def _faults_mmpp(**kw) -> FaultModel:
    return mmpp_faults(**kw)


FAULT_BUILDERS = {
    "independent": _faults_independent,
    "mmpp": _faults_mmpp,
}

# Result collectors beyond the always-present makespan/throughput summary.
COLLECTORS = {
    "placement_counts": lambda m: m.placement_counts(),
    "high_placement_counts": lambda m: m.placement_counts(priority=1),
    "priority_placement": lambda m: m.priority_placement(),
    "per_core_worktime_s": lambda m: m.per_core_worktime(),
    "per_type_mean_duration_s": lambda m: m.per_type_mean_duration(),
    "preemption": lambda m: {"events": m.preempt_events,
                             "tasks_preempted": m.tasks_preempted,
                             "work_lost_s": round(m.work_lost_s, 9)},
    "migration": lambda m: {"migrations": m.migrations,
                            "overflow_migrations": m.overflow_migrations,
                            "rebalance_rounds": m.rebalance_rounds,
                            "migrated_load_s": round(m.migrated_load_s, 9)},
    "faults": lambda m: m.fault_summary(),
    "task_sojourn": lambda m: m.task_sojourn_stats(),
    # continuous batching: the exact multiset of fused-dispatch
    # compositions, sorted — bitwise-comparable across worker counts
    "batching": lambda m: {"n_batches": len(m.batches),
                           "compositions": sorted(m.batches)},
}


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One cell of a sweep grid — everything needed to reproduce one
    seeded DES run, expressed as registry names + plain kwargs.

    ``dag`` / ``topology`` / ``speed`` / ``preemption`` / ``faults`` are
    ``(name, kwargs)`` pairs; ``background`` is a tuple of such pairs.
    ``recovery`` is a plain kwargs dict for
    :class:`~.faults.RecoveryPolicy` (ignored without ``faults``).
    ``sharding`` is a tuple of ``(field, value)`` pairs for
    :class:`~.shards.ShardingSpec` (kept as pairs, not a dict, so the
    frozen spec stays hashable); ``None`` runs the flat kernel.
    DAG and background kwargs may contain a ``task_type`` entry that is
    itself a ``(name, kwargs)`` pair resolved through :data:`TASK_TYPES`
    (the mixed DAG builder takes a ``task_types`` tuple of such pairs).
    ``collect`` names extra :data:`COLLECTORS` to evaluate in the worker;
    ``measure_wall`` times the ``simulate`` call (wall seconds +
    simulated-tasks/s).
    ``sim_kwargs`` is a tuple of ``(name, value)`` pairs forwarded to
    :func:`~.simulator.simulate` verbatim — e.g. ``(("event_mode",
    "scalar"),)`` re-runs a cell on the scalar reference event loop, or
    ``compact_min_stale``/``compact_heap_frac`` stress heap compaction;
    scheduler-side knobs like ``placement_backend`` go through
    ``sched_kwargs`` instead.  Defaults (empty) leave the cell on the
    cohort loop the goldens pin.
    """

    key: str
    dag: tuple
    scheduler: str
    topology: tuple = ("tx2", {})
    seed: int = 1
    sched_kwargs: dict = dataclasses.field(default_factory=dict)
    background: tuple = ()
    speed: Optional[tuple] = None
    preemption: Optional[tuple] = None
    faults: Optional[tuple] = None
    recovery: Optional[dict] = None
    sharding: Optional[tuple] = None
    horizon: float = 1e6
    collect: tuple = ()
    measure_wall: bool = False
    sim_kwargs: tuple = ()


def _lookup(registry: dict, spec, what: str):
    name, kwargs = spec
    try:
        builder = registry[name]
    except KeyError:
        raise KeyError(f"unknown {what} {name!r}; "
                       f"known: {', '.join(sorted(registry))}") from None
    return builder, dict(kwargs)


def _build_task_type(spec) -> TaskType:
    builder, kwargs = _lookup(TASK_TYPES, spec, "task type")
    return builder(**kwargs)


def _resolve_task_type(kwargs: dict) -> dict:
    if "task_type" in kwargs:
        kwargs["task_type"] = _build_task_type(kwargs["task_type"])
    return kwargs


def run_cell(spec: RunSpec) -> dict:
    """Execute one cell (in whatever process this is called from) and
    reduce it to a plain result dict."""
    topo_builder, topo_kwargs = _lookup(TOPOLOGIES, spec.topology, "topology")
    topo: Topology = topo_builder(**topo_kwargs)
    sched = make_scheduler(spec.scheduler, topo, seed=spec.seed,
                           **spec.sched_kwargs)
    dag_builder, dag_kwargs = _lookup(DAG_BUILDERS, spec.dag, "dag builder")
    dag = dag_builder(**_resolve_task_type(dag_kwargs))
    background = []
    for bg_spec in spec.background:
        bg_builder, bg_kwargs = _lookup(BACKGROUND_BUILDERS, bg_spec,
                                        "background app")
        built = bg_builder(**_resolve_task_type(bg_kwargs))
        if isinstance(built, BackgroundApp):
            background.append(built)
        else:                       # episode tuple (e.g. bursty)
            background.extend(built)
    speed = None
    if spec.speed is not None:
        speed_builder, speed_kwargs = _lookup(SPEED_BUILDERS, spec.speed,
                                              "speed profile")
        speed = speed_builder(topo, **speed_kwargs)
    preemption = None
    if spec.preemption is not None:
        pre_builder, pre_kwargs = _lookup(PREEMPTION_BUILDERS,
                                          spec.preemption, "preemption model")
        preemption = pre_builder(topo, **pre_kwargs)
    faults = None
    if spec.faults is not None:
        fault_builder, fault_kwargs = _lookup(FAULT_BUILDERS, spec.faults,
                                              "fault model")
        faults = fault_builder(**fault_kwargs)
    recovery = (RecoveryPolicy(**spec.recovery)
                if spec.recovery is not None else None)
    sharding = (ShardingSpec(**dict(spec.sharding))
                if spec.sharding is not None else None)

    t0 = time.perf_counter()
    m: RunMetrics = simulate(dag, sched, background=background, speed=speed,
                             preemption=preemption, faults=faults,
                             recovery=recovery, sharding=sharding,
                             horizon=spec.horizon, **dict(spec.sim_kwargs))
    wall = time.perf_counter() - t0

    out = {
        "n_tasks": m.n_tasks,
        "makespan_s": m.makespan,
        "throughput_tps": m.throughput,
    }
    if spec.measure_wall:
        out["wall_s"] = round(wall, 4)
        out["sim_tasks_per_s"] = round(m.n_tasks / wall, 1) if wall > 0 else 0.0
    for name in spec.collect:
        try:
            collector = COLLECTORS[name]
        except KeyError:
            raise KeyError(f"unknown collector {name!r}; "
                           f"known: {', '.join(sorted(COLLECTORS))}") from None
        out[name] = collector(m)
    return out


def default_workers() -> int:
    """Worker count used when the caller passes ``workers=None``."""
    return os.cpu_count() or 1


# -- cached spawn pool -------------------------------------------------------
# Spawning a pool costs ~0.65 s per worker (fresh interpreter + imports), a
# fixed overhead every ``run_cells`` call used to pay.  The pool is cached
# across calls (suites reuse it); ``shutdown_pool`` releases it explicitly
# and runs at interpreter exit.  Cells are rebuilt from their specs inside
# whichever worker runs them, so reuse cannot change any result.
_pool = None
_pool_workers = 0


def _get_pool(workers: int):
    global _pool, _pool_workers
    if _pool is not None and _pool_workers != workers:
        shutdown_pool()
    if _pool is None:
        # spawn, never fork: workers import a fresh interpreter so cell
        # results cannot depend on inherited parent state (and the same
        # start method runs everywhere).
        _pool = get_context("spawn").Pool(processes=workers)
        _pool_workers = workers
    return _pool


def shutdown_pool() -> None:
    """Release the cached worker pool (idempotent).  Registered atexit, so
    callers only need it to free workers early (e.g. before a fork-hostile
    section or between test suites)."""
    global _pool, _pool_workers
    if _pool is not None:
        _pool.terminate()       # what Pool.__exit__ does; workers are idle
        _pool.join()
        _pool = None
        _pool_workers = 0


atexit.register(shutdown_pool)


def run_cells(specs: Iterable[RunSpec], *, workers: Optional[int] = None,
              chunksize: Optional[int] = None) -> dict:
    """Run a grid of cells, fanned across ``workers`` processes.

    Returns ``{spec.key: result_dict}`` in the order the specs were
    given.  ``workers=None`` uses every host core; ``workers<=1`` (or a
    single-cell grid) runs in-process through the exact same
    :func:`run_cell` path, so results are bit-identical for every worker
    count and chunk layout (each cell is rebuilt from its spec with its
    own seed wherever it runs).  The worker pool is cached across calls
    (see :func:`shutdown_pool`).
    """
    specs = list(specs)
    keys = [s.key for s in specs]
    if len(set(keys)) != len(keys):
        dupes = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(f"duplicate RunSpec keys: {', '.join(dupes)}")
    if not specs:
        return {}
    if workers is None:
        workers = default_workers()
    workers = max(1, min(int(workers), len(specs)))
    if workers == 1:
        results = [run_cell(s) for s in specs]
    else:
        if chunksize is None:
            chunksize = max(1, len(specs) // (workers * 4))
        pool = _get_pool(workers)
        try:
            results = pool.map(run_cell, specs, chunksize=chunksize)
        except BaseException:   # incl. KeyboardInterrupt: workers may still
            shutdown_pool()     # be chewing abandoned chunks — don't reuse
            raise
    return dict(zip(keys, results))
