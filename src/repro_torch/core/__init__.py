"""The paper's scheduler, as the serving engine and the threaded runtime
use it, and the paper's task types and DAG builders whose payloads the
runtime runs: verbatim copies of the JAX package's ``core`` modules (the
port imports nothing of that package).  The discrete-event simulator and
the multi-run sweep engine are not part of the port.

The one edit is in ``schedulers.make_scheduler``: ``placement_backend="jax"``
raises ``ValueError`` instead of importing the jitted placement kernel.
"""
from .dag import DAG, chain_dag, decode_pool_dag, mixed_dag, synthetic_dag
from .faults import Fault, FaultModel, RecoveryPolicy, task_faults
from .lifecycle import SchedulingKernel, ptt_observe, split_by_priority
from .metrics import RequestRecord, RunMetrics, TaskRecord
from .places import ExecutionPlace, LiveView, ResourcePartition, Topology, \
    haswell, haswell_cluster, tpu_pod_slices, tx2, tx2_xl
from .preemption import PreemptionModel, pod_slice_preemption
from .ptt import PTT, PTTBank
from .queues import BatchingConfig, SplitWSQ, WorkQueues
from .runtime import ThreadedRuntime, run_threaded
from .schedulers import ALL_SCHEDULERS, Scheduler, make_scheduler
from .shards import ShardingSpec
from .task import Priority, Task, TaskType, batch_bucket, copy_type, \
    matmul_type, stencil_type

__all__ = [
    "DAG", "chain_dag", "decode_pool_dag", "mixed_dag", "synthetic_dag",
    "Fault", "FaultModel", "RecoveryPolicy", "task_faults",
    "SchedulingKernel", "ptt_observe", "split_by_priority",
    "RequestRecord", "RunMetrics", "TaskRecord",
    "ExecutionPlace", "LiveView", "ResourcePartition", "Topology",
    "haswell", "haswell_cluster", "tpu_pod_slices", "tx2", "tx2_xl",
    "PreemptionModel", "pod_slice_preemption", "PTT", "PTTBank",
    "BatchingConfig", "SplitWSQ", "WorkQueues", "ThreadedRuntime",
    "run_threaded", "ALL_SCHEDULERS", "Scheduler", "make_scheduler",
    "ShardingSpec", "Priority", "Task", "TaskType", "batch_bucket",
    "copy_type", "matmul_type", "stencil_type",
]
