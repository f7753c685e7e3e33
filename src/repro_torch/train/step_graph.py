"""The train step as one captured CUDA graph: the port's counterpart of the
reference's ``jax.jit(make_train_step(...))`` (``repro/train/trainer.py``,
``examples/quickstart.py``), which makes a train step one executable.

A :class:`TrainStepGraph` holds the static buffers of one train step's
batch (``tokens`` and ``labels``, and for a prefixed model ``frontend``,
as ``configs.train_batch_specs`` lays them out), the params and optimizer
state it steps (updated in place, read by the graph at their addresses)
and, on the card, one ``torch.cuda.CUDAGraph`` of ``make_train_step``'s
body: the loss and its gradients (``_value_and_grad``), then AdamW's
update (``apply_updates``).  The step's metrics are the graph's static
0-d outputs: a caller reads them (``float(v)``) before the next step.

A step (:meth:`TrainStepGraph.step`) copies the batch into the buffers and
replays the graph, on the current stream: a checkpoint's snapshot taken
there after a step (``Checkpointer.save_async``) is ordered after its
replay and before the next.

The first step on the card is its warm-up: ``make_train_step`` runs
eagerly on a stream of the graph's own, which builds the kernels, loads
every kernel the step launches, creates that stream's cuBLAS handle and
workspace and leaves the step's own values, a real step 1.  Then the step
is captured on that stream, in a memory pool of its own, after the
warm-up's cached blocks are released.  A capture runs nothing, so it
leaves the params and the state as they were; from the second step on,
each step is a replay.  The pool keeps the step's activations and
gradients for as long as the graph lives, where eager steps free them each
step: :meth:`close` frees it.

A replay runs none of the kernel wrappers' Python: the capture takes each
launch counter's delta and each replay adds it back (``graphs.capture``,
``graphs.replay``), so the counters read the launches a step makes either
way.  The graph reads cuBLAS's workspace of its stream, which the process
keeps: the last graph to close, a decode slot or a train step, clears them
(``repro_torch/graphs.py``).

On the CPU the step runs ``make_train_step`` directly on the same
buffers: its plain version, as each kernel wrapper takes its plain version
for CPU tensors.  On the card there is no fallback: a capture or a replay
that fails raises.  DTensor params or state are refused (the dry-run's
step on a mesh runs eagerly), and so is a batch whose keys, shapes or
dtypes are not the buffers'.
"""
from __future__ import annotations

import time

import torch

from .. import graphs
from ..configs.base import ModelConfig
from ..kernels import adamw, flash_attention, slstm_scan, ssd_scan
from ..kernels.common import LaunchCounter
from ..optim import AdamWConfig
from ..optim.adamw import leaves
from ..parallel.sharding import is_distributed
from .train_step import make_train_step


def train_counters() -> list[LaunchCounter]:
    """The launch counters of every kernel a train step may reach, with
    their by-path and by-route counts: flash attention and the SSD scan,
    forward and backward, the sLSTM scan both ways, AdamW's update and
    norm."""
    return [flash_attention.launches, *flash_attention.path_launches.values(),
            flash_attention.bwd_launches,
            *flash_attention.bwd_path_launches.values(),
            ssd_scan.launches, *ssd_scan.path_launches.values(),
            ssd_scan.bwd_launches, *ssd_scan.bwd_path_launches.values(),
            slstm_scan.launches, slstm_scan.bwd_launches,
            adamw.launches, adamw.norm_launches]


class TrainStepGraph:
    """One train step's static batch buffers and, on the card, its captured
    graph over ``params`` and ``opt_state`` (``init_opt_state``'s), which
    every step updates in place.  ``batch_specs`` maps each batch key to a
    tensor (a meta spec, or any tensor) whose shape and dtype the batches
    have.  ``remat`` as ``make_train_step``'s."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig, params,
                 opt_state: dict, batch_specs: dict, *,
                 remat: bool = True) -> None:
        for what, tree in (("params", params), ("optimizer state", opt_state)):
            if is_distributed(*leaves(tree)):
                raise ValueError(f"TrainStepGraph: DTensor {what}; a step on "
                                 f"a mesh runs eagerly (make_train_step)")
        self.params, self.opt_state = params, opt_state
        self.device = next(leaves(params)).device
        self._step = make_train_step(cfg, opt_cfg, remat=remat)
        self.batch = {k: torch.zeros(tuple(v.shape), dtype=v.dtype,
                                     device=self.device)
                      for k, v in batch_specs.items()}
        self.graph = None
        self.metrics: dict | None = None     # the graph's static outputs
        self.deltas: graphs.Deltas = []
        self.steps = 0               # steps taken, either route
        self.replays = 0             # of them, graph replays
        self.warmup_s = self.capture_s = 0.0   # the first step's two parts
        self.pool_bytes = 0          # the card memory the graph's pool holds
        self.closed = False
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def _run(self) -> dict:
        _, _, metrics = self._step(self.params, self.opt_state, self.batch)
        return metrics

    def load(self, batch: dict) -> None:
        """Copy ``batch`` (tensors or numpy arrays, on any device) into the
        static buffers, on the current stream."""
        if set(batch) != set(self.batch):
            raise ValueError(f"TrainStepGraph: batch keys {sorted(batch)}; "
                             f"the buffers' are {sorted(self.batch)}")
        theirs = {k: torch.as_tensor(v) for k, v in batch.items()}
        for key, mine in self.batch.items():
            t = theirs[key]
            if t.shape != mine.shape or t.dtype != mine.dtype:
                raise ValueError(
                    f"TrainStepGraph: batch {key} is {tuple(t.shape)} "
                    f"{t.dtype}; the buffer's is {tuple(mine.shape)} "
                    f"{mine.dtype}")
        for key, mine in self.batch.items():
            mine.copy_(theirs[key])

    def step(self, batch: dict) -> dict:
        """One train step on ``batch``: the params and the optimizer state
        updated in place; the step's metrics, 0-d tensors on the params'
        device, valid until the next step."""
        if self.closed:
            raise RuntimeError("TrainStepGraph: closed")
        self.load(batch)
        if self.graph is not None:
            graphs.replay(self.graph, self.deltas)
            self.replays += 1
            metrics = self.metrics
        elif self.device.type == "cuda":     # step 1: the module doc
            metrics = self._warm_up()
            self._capture()
        else:
            metrics = self._run()
        self.steps += 1
        return metrics

    def _warm_up(self) -> dict:
        """Step 1, eagerly on the graph's stream: its metrics."""
        t0 = time.perf_counter()
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            metrics = self._run()
        here.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        return metrics

    def _capture(self) -> None:
        """The step captured on the graph's stream, in its own pool."""
        t0 = time.perf_counter()
        dev = self.device
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph, self.metrics, self.deltas = graphs.capture(
            self._run, self.stream, train_counters())
        graphs.hold(self)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def close(self) -> None:
        """Release the graph, its pool, the buffers and the hold on the
        params and state; the last graph of the process to close, of any
        kind, also clears cuBLAS's workspaces (``graphs.release``)."""
        if self.graph is not None:
            graphs.release(self, self.graph, self.device)
        self.graph = None
        self.params = self.opt_state = self.metrics = None
        self.batch = {}
        self.closed = True
