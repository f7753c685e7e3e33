"""Fault-tolerant training loop (port of ``repro/train/trainer.py``).

Integrates every substrate: synthetic data stream (exact skip-ahead),
AdamW, async checkpointing, heartbeat failure detection, and the paper's
technique as the straggler layer — a PodMonitor (PTT over pods, 1:4
weighted) observing measured step times and emitting rebalance/drain
plans.  The "pods" are simulated via an injectable per-pod slowdown
schedule (by default each pod reports the measured step time), but every
code path (detection, plan, restart, resume) is the real one.

The loop is the reference's.  The params live on ``device`` (the card
unless the caller asks for the CPU), drawn by ``init_params(cfg, seed,
device=...)``.  The step is a ``TrainStepGraph`` over them
(``train/step_graph.py``), the counterpart of the reference's
``jax.jit(make_train_step(...))``: on the card a captured graph, replayed
from the second step on, on the CPU the plain step.  Each batch is copied
into its static buffers; a step's wall time ends when its metrics reach
the host, after the card is done.  A restore writes the checkpoint into
the params and state the graph reads.  :meth:`Trainer.close` frees the
graph and its pool.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..checkpoint import Checkpointer
from ..configs.base import ModelConfig
from ..data import DataConfig, SyntheticStream
from ..models import init_params
from ..optim import (AdamWConfig, init_error_feedback,
                     init_opt_state)
from ..runtime import HeartbeatMonitor, PodMonitor, Supervisor
from .step_graph import TrainStepGraph


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    seed: int = 0
    remat: bool = False
    grad_compression: str = "none"       # none | int8
    n_pods: int = 2                       # monitored pods (simulated here)
    straggler_check_every: int = 5


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 ckpt_dir: str, *,
                 pod_time_fn: Optional[Callable[[int, int], float]] = None,
                 device="cuda"):
        """``pod_time_fn(step, pod) -> seconds`` injects simulated per-pod
        step times for the straggler monitor (None = measure wall time)."""
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.device = torch.device(device)
        self.ckpt = Checkpointer(ckpt_dir)
        self.stream = SyntheticStream(data_cfg)
        self.pod_time_fn = pod_time_fn

        self.params = init_params(cfg, tcfg.seed, device=self.device)
        self.opt_state = init_opt_state(self.params)
        self.step_fn = TrainStepGraph(
            cfg, opt_cfg, self.params, self.opt_state,
            {k: torch.as_tensor(v) for k, v in self.stream.batch_at(0).items()},
            remat=tcfg.remat)
        self.error_fb = (init_error_feedback(self.params)
                         if tcfg.grad_compression != "none" else None)
        self.step = 0

        self.supervisor = Supervisor(
            heartbeat=HeartbeatMonitor(list(range(tcfg.n_pods)), timeout=30.0),
            pods=PodMonitor(tcfg.n_pods))
        self.history: list[dict] = []

    # -- checkpoint glue --------------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self):
        self.ckpt.save_async(self.step, self._state_tree(),
                             extra={"data": self.stream.state()})

    def try_restore(self) -> bool:
        if self.ckpt.latest_step() is None:
            return False
        # into the params and state the step's graph reads
        _, manifest = self.ckpt.restore(self._state_tree())
        self.step = manifest["step"]
        self.stream.skip_to(manifest["extra"]["data"]["step"])
        return True

    # -- main loop ----------------------------------------------------------------
    def run(self) -> list[dict]:
        tcfg = self.tcfg
        while self.step < tcfg.total_steps:
            batch = next(self.stream)
            t0 = time.perf_counter()
            metrics = {k: float(v)
                       for k, v in self.step_fn.step(batch).items()}
            wall = time.perf_counter() - t0
            self.step += 1

            # feed the straggler monitor (paper's PTT over pods)
            for pod in range(tcfg.n_pods):
                t = (self.pod_time_fn(self.step, pod)
                     if self.pod_time_fn else wall)
                self.supervisor.pods.observe(pod, t)
                self.supervisor.heartbeat.beat(pod)

            if self.step % tcfg.straggler_check_every == 0:
                plan = self.supervisor.elastic_plan(self.step)
                if plan is not None and plan.kind != "none":
                    metrics["rescale"] = plan.kind
            if self.step % tcfg.checkpoint_every == 0:
                self.save()
            rec = {"step": self.step, "wall_s": wall, **metrics}
            self.history.append(rec)
            if self.step % tcfg.log_every == 0:
                print(f"[train] step {self.step:5d} loss={metrics['loss']:.4f} "
                      f"lr={metrics['lr']:.2e} gnorm={metrics['grad_norm']:.2f} "
                      f"({wall*1e3:.0f} ms)")
        self.ckpt.wait()
        return self.history

    def close(self) -> None:
        """Wait for a checkpoint in flight; free the step's graph and its
        pool."""
        self.ckpt.wait()
        self.step_fn.close()
