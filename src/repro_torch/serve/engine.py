"""Serving engine scheduled by the paper's technique.

Mapping (DESIGN.md §2): requests are a *dynamic DAG* — a prefill task
(HIGH priority: it releases the request's entire decode chain, exactly
like the paper's critical tasks releasing the next DAG layer) followed by
decode tasks (LOW, moldable).  Execution places are submeshes of the
serving fleet; the PTT (one per task type = per prompt-length bucket)
learns each place's current speed from *measured* dispatch wall times, so
an interfered or throttled submesh is steered around within ~3 requests
(the paper's 1:4 hysteresis).

This is the PyTorch port of ``repro/serve/engine.py``: the scheduling is
the same code (a verbatim copy of the JAX package's ``core``), and the
payloads run the torch model.  The places are worker slots of the
threaded runtime; they share one device, and a payload returns only when
the device has finished its work (the ``int(argmax)``), so the PTT learns
run times, not launch times.  ``cfg=None`` selects
**synthetic-payload mode**: request payloads are calibrated sleeps
(``prefill_s`` / ``decode_s``) instead of model dispatches.

Two submission modes:

* **batch** — ``submit()`` everything, then ``run()`` (the original
  closed-loop shape, still used by the smoke tests);
* **open loop** — ``run_open_loop(prompts, rate_rps=...)`` starts the
  runtime first and submits continuously with seeded Poisson
  inter-arrival gaps, the serving-benchmark shape: queueing delay under
  interference shows up in the TTFT tail instead of being hidden by
  batch submission.  Per-request latency percentiles land in
  ``RunMetrics.request_latency_stats()``.

Robustness under load (this is the serving half of the load-aware
kernel, DESIGN.md §2):

* **Warm start** — ``warm_start=True`` (default) primes the PTT for each
  new task type via :meth:`SchedulingKernel.prime_ptt` before its first
  request is placed, so a cold table never herds early arrivals onto one
  unexplored place.  :meth:`prime` does it explicitly.
* **Load-aware admission** — ``_admission_estimate`` is per-place: the
  best over places of (outstanding estimated work *at that place* +
  the prefill estimate there), plus the decode chain at the fleet-best
  decode estimate.  A request is rejected (``reject_cause="deadline"``)
  only when even that estimate misses its deadline.
* **Backpressure** — ``max_pending`` bounds the number of admitted
  in-flight requests; past it, admission refuses immediately
  (``reject_cause="backpressure"``) instead of growing an unbounded
  queue.
* **Brownout ladder** — pass a :class:`~.overload.BrownoutConfig` to
  attach an :class:`~.overload.OverloadController` driven by the
  kernel's backlog signal (outstanding estimated seconds per live core),
  updated at every admission and completion.  Under sustained saturation
  it degrades LOW-tier traffic in order of destroyed value: rung 1
  clamps ``max_new_tokens`` to ``min_tokens``, rung 2 sheds queued LOW
  decode chains (``shed_cause="brownout"``), rung 3 rejects LOW
  admissions outright.  Each rung has hysteresis; every transition lands
  in ``RunMetrics.brownout_transitions`` and is counted by
  ``request_latency_stats()``.  HIGH-tier requests (``tier="high"``)
  are exempt from all three rungs.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import (BatchingConfig, Priority, RequestRecord, Task, TaskType,
                    ThreadedRuntime, Topology, make_scheduler)
from ..core.dag import DAG
from ..core.preemption import PreemptionModel
from ..models import decode_step, init_params, prefill
from .batching import BatchSlot, DecodeBatcher
from .overload import BrownoutConfig, OverloadController


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.  Asking for
    CUDA without one raises: there is no silent fallback to the CPU.  On the
    card, float32 products stay float32 (no TF32), as the reference's."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for and is not available; "
                               "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # [S] int32
    max_new_tokens: int
    tier: str = "low"              # "high" is exempt from the brownout ladder
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    deadline_s: float = 0.0        # 0 = no deadline
    rejected: bool = False         # refused at admission, nothing ran
    shed: bool = False             # decode chain truncated
    reject_cause: str = ""         # "deadline" | "backpressure"
    shed_cause: str = ""           # "deadline" | "brownout"
    tokens_clamped: bool = False   # brownout rung 1 shrank max_new_tokens


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


class ServingEngine:
    """PTT-scheduled engine: a real model on ``device`` (the card unless
    the caller passes ``device="cpu"``) when ``cfg`` is given,
    calibrated-sleep payloads when ``cfg is None``."""

    def __init__(self, cfg: Optional[ModelConfig], topology: Topology, *,
                 scheduler: str = "DAM-P", seed: int = 0,
                 max_len: int = 256,
                 slowdown: Optional[dict[int, float]] = None,
                 preemption: Optional[PreemptionModel] = None,
                 faults=None, recovery=None, supervisor=None,
                 queue_penalty: float = 1.0, warm_start: bool = True,
                 max_pending: Optional[int] = None,
                 brownout: Optional[BrownoutConfig] = None,
                 sharding=None,
                 batching: Optional[BatchingConfig] = None,
                 prefill_s: float = 8e-3, decode_s: float = 2e-3,
                 device=None):
        self.cfg = cfg
        self.max_len = max_len
        self.prefill_s = prefill_s
        self.decode_s = decode_s
        # continuous batching: max_batch=1 is the unbatched path by
        # definition — normalize to None so every batching branch is dead
        if batching is not None and not batching.enabled:
            batching = None
        self.batching = batching
        self.batcher = DecodeBatcher(batching) if batching is not None \
            else None
        if cfg is not None:
            # real-model mode: torch payloads on ``device``, weights drawn
            # there from the seed (tests overwrite ``params`` with bridged
            # reference weights)
            self.device = resolve_device(device)
            self.params = init_params(cfg, seed, self.device)
        self.sched = make_scheduler(scheduler, topology, seed=seed,
                                    queue_penalty=queue_penalty,
                                    track_load=True)
        self.runtime = ThreadedRuntime(self.sched, slowdown=slowdown,
                                       preemption=preemption, faults=faults,
                                       recovery=recovery,
                                       supervisor=supervisor,
                                       sharding=sharding, batching=batching)
        self.warm_start = warm_start
        self.max_pending = max_pending
        self.controller = (OverloadController(brownout)
                           if brownout is not None else None)
        self.tokens_clamped = 0
        self.requests: dict[int, Request] = {}
        self._rid = 0
        self._pending = 0              # admitted, not yet finalized
        self._admit_lock = threading.Lock()
        self._primed: set[str] = set()
        # hoisted task types: one shared decode TaskType per engine and
        # one prefill TaskType per prompt-length bucket — per-request
        # construction built a fresh (value-equal) type object per submit
        # and defeated TaskType's batched-variant cache
        self._dec_type: Optional[TaskType] = None
        self._pre_types: dict[int, TaskType] = {}
        # batch-delay flusher (batched mode only): pumps the batcher so a
        # partial batch never waits past its delay window
        self._flush_stop = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None

    # -- task payloads ---------------------------------------------------------
    def _run_prefill(self, req: Request) -> tuple:
        if self.cfg is None:
            time.sleep(self.prefill_s)
            req.out_tokens.append(0)
            return None, 0
        # inference mode is thread-local: each payload enters its own
        with torch.inference_mode():
            toks = torch.as_tensor(req.prompt, device=self.device)[None, :]
            logits, state = prefill(self.params, self.cfg, toks, self.max_len)
            # int() waits for the card, so the PTT sees the run time, not
            # the launch time
            nxt = int(torch.argmax(logits[0]))
        req.out_tokens.append(nxt)
        return state, nxt

    def _run_decode(self, req: Request, state, tok: int) -> tuple:
        if self.cfg is None:
            time.sleep(self.decode_s)
            req.out_tokens.append(0)
            return None, 0
        with torch.inference_mode():
            toks = torch.tensor([tok], device=self.device)
            logits, state = decode_step(self.params, self.cfg, state, toks)
            nxt = int(torch.argmax(logits[0]))
        req.out_tokens.append(nxt)
        return state, nxt

    # -- PTT warmup --------------------------------------------------------------
    def prime(self, *task_types: TaskType) -> int:
        """Explicitly seed the PTT for ``task_types`` (every unexplored
        place gets its cost-model prior — see
        :meth:`SchedulingKernel.prime_ptt`).  Returns entries primed."""
        n = 0
        for tt in task_types:
            n += self.runtime.kernel.prime_ptt(tt)
            self._primed.add(tt.name)
        return n

    def _maybe_prime(self, *task_types: TaskType) -> None:
        if not self.warm_start:
            return
        for tt in task_types:
            if tt.name not in self._primed:
                self.prime(tt)

    # -- graceful degradation ----------------------------------------------------
    def _best_estimate(self, task_type: TaskType) -> float:
        """Fleet-best per-task seconds for ``task_type`` (PTT entry or
        cost-model prior, whichever the kernel's estimator resolves)."""
        kernel = self.runtime.kernel
        return min(kernel.estimate_seconds(task_type, p)
                   for p in self.sched.topology.places())

    def _admission_estimate(self, pre_type: TaskType, dec_type: TaskType,
                            max_new_tokens: int) -> float:
        """Per-place, load-aware completion-time estimate for deadline
        admission: the best over places of (outstanding estimated work
        already at that place + the prefill estimate there), plus the
        request's decode chain.

        The chain is priced at the *batched* service rate when continuous
        batching is on — ``per_tok * (1 + member_cost*(b-1)) / b`` per
        token at fill ``b = max_batch``, plus one ``delay_s`` of batch
        fill — and carries the kernel's fleet-wide backlog signal once:
        the old estimate assumed every decode step lands on an idle
        fleet-best place, which under-estimated exactly when admission
        control matters (a loaded fleet) and admitted deadline-doomed
        requests."""
        kernel = self.runtime.kernel
        places = self.sched.topology.places()
        if kernel.track_load:
            load = kernel.place_load()
            start = min(load[i] + kernel.estimate_seconds(pre_type, p)
                        for i, p in enumerate(places))
            backlog = kernel.backlog_signal()
        else:
            start = self._best_estimate(pre_type)
            backlog = 0.0
        per_tok = self._best_estimate(dec_type)
        b = self.batching
        if b is not None:
            per_tok *= (1.0 + b.member_cost * (b.max_batch - 1)) / b.max_batch
            start += b.delay_s
        chain = max(max_new_tokens - 1, 0) * per_tok
        return start + chain + backlog

    def _elapsed(self) -> float:
        t0 = self.runtime.t0
        return 0.0 if t0 is None else time.perf_counter() - t0

    def _update_controller(self) -> int:
        """Fold the kernel's backlog signal into the brownout controller
        (called at every admission and completion)."""
        if self.controller is None:
            return 0
        signal = (self.runtime.kernel.backlog_signal()
                  if self.runtime.kernel.track_load else 0.0)
        with self._admit_lock:
            return self.controller.update(signal, self._elapsed())

    def _request_done(self, req: Request) -> None:
        req.t_done = time.perf_counter()
        with self._admit_lock:
            self._pending -= 1
        self._update_controller()

    # -- request -> dynamic DAG --------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 8,
               deadline_s: float = 0.0, tier: str = "low") -> Request:
        self._rid += 1
        req = Request(self._rid, np.asarray(prompt).astype(np.int32),
                      max_new_tokens, tier=tier,
                      t_submit=time.perf_counter(), deadline_s=deadline_s)
        self.requests[req.rid] = req

        def _reject(cause: str) -> Request:
            req.rejected = True
            req.reject_cause = cause
            req.t_first_token = req.t_done = req.t_submit
            return req

        # backpressure: a bounded pending queue, never unbounded growth —
        # past the bound the fleet refuses immediately rather than
        # queueing work it will finish long past anyone's patience
        if self.max_pending is not None and self._pending >= self.max_pending:
            return _reject("backpressure")

        self._update_controller()
        ctl = self.controller
        if ctl is not None and tier != "high":
            if ctl.reject_low:          # rung 3: refuse LOW at admission
                return _reject("backpressure")
            if ctl.shrink_low and max_new_tokens > ctl.config.min_tokens:
                # rung 1+: degrade LOW output length before dropping work
                req.max_new_tokens = max_new_tokens = ctl.config.min_tokens
                req.tokens_clamped = True
                self.tokens_clamped += 1

        pre_type = self._prefill_type(len(prompt))
        dec_type = self._decode_type()
        self._maybe_prime(pre_type, dec_type)

        if deadline_s > 0.0 and self._admission_estimate(
                pre_type, dec_type, max_new_tokens) > deadline_s:
            # deadline-aware admission: refuse rather than burn fleet time
            # on a request that cannot finish in time (nothing is queued)
            return _reject("deadline")

        with self._admit_lock:
            self._pending += 1
        # per-request step state bound to tasks via ``Task.args`` — no
        # per-token payload closures; payloads/commits are bound methods
        ctx: dict = {"step": 0}
        pre_task = Task(pre_type, priority=Priority.HIGH,
                        payload=self._prefill_payload, args=(req, ctx))
        pre_task.on_commit = self._prefill_commit
        self.runtime.submit(DAG([pre_task], 1 + max_new_tokens))
        return req

    # -- hoisted task types ------------------------------------------------------
    def _decode_type(self) -> TaskType:
        tt = self._dec_type
        if tt is None:
            kinds = {p.kind for p in self.sched.topology.partitions}
            dec_s = self.decode_s if self.cfg is None else 1e-4
            tt = self._dec_type = TaskType(
                "decode", serial_time={k: dec_s for k in kinds})
        return tt

    def _prefill_type(self, prompt_len: int) -> TaskType:
        b = _bucket(prompt_len)
        tt = self._pre_types.get(b)
        if tt is None:
            kinds = {p.kind for p in self.sched.topology.partitions}
            pre_s = self.prefill_s if self.cfg is None else 1e-3
            tt = self._pre_types[b] = TaskType(
                f"prefill_{b}", serial_time={k: pre_s for k in kinds})
        return tt

    # -- unbatched decode chain --------------------------------------------------
    def _prefill_payload(self, width: int, req: Request, ctx: dict) -> None:
        ctx["state"], ctx["tok"] = self._run_prefill(req)

    def _prefill_commit(self, task: Task) -> list[Task]:
        # first token leaves the engine at prefill *commit* — after any
        # injected slowdown, when a real client would see it
        req, ctx = task.args
        req.t_first_token = time.perf_counter()
        if req.max_new_tokens <= 1:
            self._request_done(req)
            return []
        if self.batcher is not None:
            # continuous batching: the ready decode step parks in the
            # batcher (outside the WSQs — HIGH prefills are never queued
            # behind batch fill) and dispatches when a trigger fires
            return self._groups_to_tasks(
                self.batcher.add(req, ctx, time.perf_counter()))
        return [self._make_decode_task(req, ctx)]

    def _make_decode_task(self, req: Request, ctx: dict) -> Task:
        t = Task(self._decode_type(), priority=Priority.LOW,
                 payload=self._decode_payload, args=(req, ctx))
        t.on_commit = self._decode_commit
        return t

    def _shed_check(self, req: Request) -> bool:
        """Load shedding: queued LOW decode work is dropped instead of
        executed — the request finalizes truncated and the fleet time
        goes to requests that still matter — when its deadline already
        passed, or the brownout ladder is at its shed rung and the
        request is LOW tier.  Returns True when ``req`` was shed."""
        if req.shed:
            return True
        if (req.deadline_s > 0.0 and time.perf_counter()
                > req.t_submit + req.deadline_s):
            req.shed = True
            req.shed_cause = "deadline"
            return True
        ctl = self.controller
        if ctl is not None and ctl.shed_low and req.tier != "high":
            req.shed = True
            req.shed_cause = "brownout"
            return True
        return False

    def _decode_payload(self, width: int, req: Request, ctx: dict) -> None:
        if self._shed_check(req):
            return
        ctx["state"], ctx["tok"] = self._run_decode(
            req, ctx["state"], ctx["tok"])

    def _decode_commit(self, task: Task) -> list[Task]:
        req, ctx = task.args
        ctx["step"] += 1
        if not req.shed and ctx["step"] < req.max_new_tokens - 1:
            return [self._make_decode_task(req, ctx)]
        self._request_done(req)
        return []

    # -- batched decode path (continuous batching) -------------------------------
    def _groups_to_tasks(self, groups: list[list[BatchSlot]]) -> list[Task]:
        return [self._make_batch_task(g) for g in groups]

    def _make_batch_task(self, slots: list[BatchSlot]) -> Task:
        """One fused moldable LOW dispatch over ``slots``: typed via
        :meth:`TaskType.batched` so the placement search, run charge and
        PTT observation all see the batch-size bucket."""
        btype = self._decode_type().batched(len(slots),
                                            self.batching.member_cost)
        t = Task(btype, priority=Priority.LOW, payload=self._batch_payload,
                 args=(tuple(slots),))
        t.on_commit = self._batch_commit
        return t

    def _batch_payload(self, width: int, slots: tuple) -> None:
        # membership re-check at dispatch: rung-2 shedding (and passed
        # deadlines) remove members, never the dispatch — survivors ride
        live = [s for s in slots if not self._shed_check(s.req)]
        if not live:
            return
        if self.cfg is None:
            # batched decode is memory-bound: one fused step costs the
            # base time plus member_cost per extra live member
            time.sleep(self.decode_s *
                       (1.0 + self.batching.member_cost * (len(live) - 1)))
            for s in live:
                s.req.out_tokens.append(0)
        else:
            for s in live:
                s.ctx["state"], s.ctx["tok"] = self._run_decode(
                    s.req, s.ctx["state"], s.ctx["tok"])

    def _batch_commit(self, task: Task) -> list[Task]:
        """Commit of a fused dispatch: finalize shed/finished members,
        re-park survivors' next steps in the batcher, and return any
        newly due dispatches (they wake as zero-dep successors)."""
        (slots,) = task.args
        now = time.perf_counter()
        ready: list[Task] = []
        for s in slots:
            req = s.req
            if not req.shed:
                s.ctx["step"] += 1
            if req.shed or s.ctx["step"] >= req.max_new_tokens - 1:
                self._request_done(req)
            else:
                ready.extend(self._groups_to_tasks(
                    self.batcher.readd(s, now)))
        return ready

    def _pump_batcher(self, drain: bool = False) -> None:
        """Flush due (or, on drain, all) pending batches into the
        runtime — the timer half of the delay window."""
        groups = self.batcher.poll(time.perf_counter(), drain=drain)
        for g in groups:
            self.runtime.submit(DAG([self._make_batch_task(g)], len(g)))

    def _flusher(self) -> None:
        period = max(self.batching.delay_s / 2.0, 1e-4)
        while not self._flush_stop.wait(timeout=period):
            self._pump_batcher()

    def _start_flusher(self) -> None:
        if self._flush_thread is None:
            self._flush_stop.clear()
            self._flush_thread = threading.Thread(target=self._flusher,
                                                  daemon=True)
            self._flush_thread.start()

    def _drain_batched(self, timeout: float):
        """Batched-mode drain: pump the batcher until every admitted
        request finalizes (slots parked in the batcher are invisible to
        the runtime's outstanding count — ``runtime.drain`` alone could
        return with requests still waiting on formation), then drain the
        runtime itself."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._admit_lock:
                if self._pending == 0:
                    break
            self._pump_batcher(drain=True)
            time.sleep(2e-3)
        self._flush_stop.set()
        m = self.runtime.drain(
            timeout=max(deadline - time.monotonic(), 1.0))
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=5.0)
            self._flush_thread = None
        return m

    def run(self, timeout: float = 120.0):
        if self.batcher is not None:
            self.runtime.start()
            self._start_flusher()
            m = self._drain_batched(timeout)
        else:
            m = self.runtime.run(timeout=timeout)
        self._finalize_requests()
        return m

    def run_open_loop(self, prompts: Sequence[np.ndarray], *,
                      rate_rps: float, max_new_tokens: int = 8,
                      arrival_seed: int = 0, deadline_s: float = 0.0,
                      tier: str = "low", timeout: float = 300.0):
        """Open-loop serving: start the runtime, then submit one request
        per prompt with Poisson inter-arrival gaps (seeded ``expovariate``
        at ``rate_rps`` requests/s) while earlier requests execute.
        ``deadline_s`` > 0 puts every request under that deadline
        (admission rejection + decode shedding).  Returns the
        :class:`RunMetrics` with per-request latency records attached."""
        arrivals = random.Random(f"serve-arrival:{arrival_seed}")
        self.runtime.start()
        if self.batcher is not None:
            self._start_flusher()
        for i, prompt in enumerate(prompts):
            if i:
                time.sleep(arrivals.expovariate(rate_rps))
            self.submit(np.asarray(prompt), max_new_tokens=max_new_tokens,
                        deadline_s=deadline_s, tier=tier)
        if self.batcher is not None:
            m = self._drain_batched(timeout)
        else:
            m = self.runtime.drain(timeout=timeout)
        self._finalize_requests()
        return m

    # -- metrics ----------------------------------------------------------------
    def _finalize_requests(self) -> None:
        """Fold completed requests into the runtime metrics as
        :class:`RequestRecord` rows (feeds p50/p95/p99 TTFT / e2e) and
        copy the brownout controller's transition log across."""
        metrics = self.runtime.metrics
        seen = {r.rid for r in metrics.request_records}
        for r in self.requests.values():
            if (r.t_done > 0 or r.rejected) and r.rid not in seen:
                metrics.record_request(RequestRecord(
                    rid=r.rid, t_submit=r.t_submit,
                    t_first_token=r.t_first_token, t_done=r.t_done,
                    deadline_s=r.deadline_s, rejected=r.rejected,
                    shed=r.shed, reject_cause=r.reject_cause,
                    shed_cause=r.shed_cause))
        if self.controller is not None:
            metrics.brownout_transitions = list(self.controller.transitions)

    def latency_stats(self) -> dict:
        """Flat-key view over ``RunMetrics.request_latency_stats()`` (one
        stat path — the engine only reshapes keys for the CLI callers)."""
        self._finalize_requests()
        stats = self.runtime.metrics.request_latency_stats()
        if not stats:
            return {}
        out = {
            "completed": stats["completed"],
            "rejected": stats["rejected"],
            "rejected_deadline": stats["rejected_deadline"],
            "rejected_backpressure": stats["rejected_backpressure"],
            "shed": stats["shed"],
            "shed_deadline": stats["shed_deadline"],
            "shed_brownout": stats["shed_brownout"],
            "deadline_miss": stats["deadline_miss"],
            "tokens_clamped": self.tokens_clamped,
        }
        if "brownout" in stats:
            out["brownout_transitions"] = stats["brownout"]["transitions"]
            out["brownout_max_rung"] = stats["brownout"]["max_rung"]
        if "ttft_ms" in stats:      # at least one request actually ran
            out.update({
                "ttft_ms_mean": stats["ttft_ms"]["mean"],
                "ttft_ms_p50": stats["ttft_ms"]["p50"],
                "ttft_ms_p95": stats["ttft_ms"]["p95"],
                "ttft_ms_p99": stats["ttft_ms"]["p99"],
                "e2e_ms_mean": stats["e2e_ms"]["mean"],
                "e2e_ms_p99": stats["e2e_ms"]["p99"],
            })
        return out
