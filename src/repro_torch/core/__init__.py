"""The paper's scheduler and everything around it: verbatim copies of the
JAX package's ``core`` modules (the port imports nothing of that package),
with the same public surface as ``repro.core``: the places, the PTT, the
task types and DAG builders, the schedulers and the shared scheduling
kernel, interference, preemption, faults, the sharded control plane, the
discrete-event simulator (``simulate``) and the multi-run sweep engine
(``run_cells``), and the threaded runtime whose payloads run the port's
kernels.

The one edit is in ``schedulers.make_scheduler``: ``placement_backend``
takes ``"torch"`` (``placement_torch``, the score on the card) where the
reference takes ``"jax"``, which raises here.
"""
from .dag import (DAG, chain_dag, decode_pool_dag, heat_dag, kmeans_dag,
                  mixed_dag, synthetic_dag)
from .faults import (Fault, FaultModel, RecoveryPolicy, mmpp_faults,
                     task_faults)
from .lifecycle import SchedulingKernel, ptt_observe, split_by_priority
from .interference import (BackgroundApp, LoadCoupledGovernor,
                           PeriodicProfile, SpeedProfile, SpeedProfileBase,
                           TraceProfile, burst_episodes, corun_chain,
                           corun_socket, dvfs_denver, governor_profile,
                           mmpp_burst_episodes, mmpp_on_off,
                           mmpp_state_timeline, random_walk_trace,
                           renewal_on_off)
from .metrics import RequestRecord, RunMetrics, TaskRecord
from .multirun import (RunSpec, default_workers, run_cell, run_cells,
                       shutdown_pool)
from .places import ExecutionPlace, LiveView, ResourcePartition, Topology, \
    haswell, haswell_cluster, tpu_pod_slices, tx2, tx2_xl
from .preemption import (PreemptionModel, mmpp_preemption,
                         pod_slice_preemption, prune_full_outages,
                         sub_slice_preemption)
from .ptt import PTT, PTTBank
from .queues import BatchingConfig, SplitWSQ, WorkQueues
from .runtime import ThreadedRuntime, run_threaded
from .schedulers import ALL_SCHEDULERS, Scheduler, make_scheduler
from .shards import (GlobalRebalancer, ShardedControlPlane, ShardingSpec,
                     make_control_plane)
from .simulator import Simulator, simulate
from .task import (Priority, Task, TaskType, batch_bucket, copy_type,
                   kmeans_map_type, kmeans_reduce_type, matmul_type,
                   mpi_exchange_type, stencil_type)

__all__ = [
    "DAG", "chain_dag", "decode_pool_dag", "heat_dag", "kmeans_dag",
    "mixed_dag", "synthetic_dag",
    "BackgroundApp", "PeriodicProfile", "SpeedProfile", "SpeedProfileBase",
    "TraceProfile", "burst_episodes", "corun_chain", "corun_socket",
    "dvfs_denver", "governor_profile", "LoadCoupledGovernor",
    "mmpp_burst_episodes", "mmpp_on_off", "mmpp_state_timeline",
    "random_walk_trace", "renewal_on_off",
    "RequestRecord", "RunMetrics", "TaskRecord", "ExecutionPlace", "LiveView",
    "ResourcePartition", "Topology", "haswell", "haswell_cluster",
    "tpu_pod_slices", "tx2", "tx2_xl",
    "PreemptionModel", "mmpp_preemption", "pod_slice_preemption",
    "prune_full_outages", "sub_slice_preemption",
    "GlobalRebalancer", "ShardedControlPlane", "ShardingSpec",
    "make_control_plane",
    "Fault", "FaultModel", "RecoveryPolicy", "mmpp_faults", "task_faults",
    "SchedulingKernel", "ptt_observe", "split_by_priority",
    "BatchingConfig", "SplitWSQ", "WorkQueues", "batch_bucket",
    "PTT", "PTTBank", "ThreadedRuntime",
    "run_threaded", "ALL_SCHEDULERS", "Scheduler", "make_scheduler",
    "RunSpec", "default_workers", "run_cell", "run_cells", "shutdown_pool",
    "Simulator", "simulate", "Priority", "Task", "TaskType", "copy_type",
    "kmeans_map_type", "kmeans_reduce_type", "matmul_type",
    "mpi_exchange_type", "stencil_type",
]
