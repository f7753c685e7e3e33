"""The serving engine's prefill as captured CUDA graphs, one a length
bucket: the port's counterpart of the reference's ``jax.jit(prefill)``
(``repro/serve/engine.py``), which makes a prefill one executable.

The reference's jit traces a prefill again for every prompt length.  Here
a prompt runs in its length bucket, the engine's PTT task type
(``prefill_<bucket>``, ``ServingEngine._prefill_type``), cut at
``max_len``: 16, 32, ..., the powers of two below ``max_len``, and
``max_len`` itself.  Every bucket is captured before the run starts (in
``ServingEngine.params``' setter, beside the decode slots: a capture
beside the workers' launches is refused, ``decode_graph.py``), so the
thing the PTT times for a task type is one replay of one graph.

A :class:`PrefillBucket` holds the static buffers of one bucket's batch-1
prefill: the token ids ``[1, b]`` (padded with 0), the real length and
what derives from it (``models.PadLength``: for an MoE model its routing
group and capacity, computed on the host by the unpadded path's functions
and written in before each replay), and the outputs, the float32 logits
``[1, V]``, their argmax and a decode state at ``max_len``.  The prefill
is the padded one (``models.prefill(..., length=)``), which computes the
reference's prefill of the real prompt: the pads are no input.

On the card the bucket also holds one ``torch.cuda.CUDAGraph`` of that
prefill, captured on a stream of its own after a warm-up run on that
stream, in a memory pool of its own: two buckets may replay at once from
different worker threads, and a pool shared by graphs is safe only for
replays in capture order, one at a time.  One lock a bucket: a second
prefill in the same bucket waits for the first to have copied its state
out and read its token.

A prefill (:meth:`PrefillBucket.prefill`) writes the tokens and the
numbers of the length, replays the graph, copies the state out into the
request's own fresh tensors (the next replay overwrites the static ones)
and reads the argmax with one ``int()``, the one wait on the card.  The
launch counters see a replay through ``graphs.capture`` /
``graphs.replay``; the graphs count among the process's live graphs
(``graphs.hold`` / ``graphs.release``).

On the CPU the bucket runs the padded prefill directly on the same static
buffers: its plain version, as each kernel wrapper takes its plain
version for CPU tensors.  DTensor params are refused: the dry-run's
prefill on a mesh stays eager.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from .. import graphs
from ..kernels.common import LaunchCounter
from ..models import fill_pad_length, init_decode_state, pad_length, prefill
from ..parallel.sharding import is_distributed
from .decode_graph import _leaves, decode_counters

WARMUP_RUNS = 1


def prefill_buckets(max_len: int, bucket_of: Callable[[int], int]
                    ) -> list[int]:
    """The lengths the prompts of 1..``max_len`` tokens run at: each one's
    ``bucket_of`` (the engine's PTT bucket), cut at ``max_len``."""
    return sorted({min(bucket_of(n), max_len) for n in range(1, max_len + 1)})


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class PrefillBucket:
    """One length bucket's static buffers and, on the card, its captured
    graph.  ``params`` are read by the graph at their addresses at
    capture: a bucket is made anew when the params are replaced."""

    def __init__(self, params, cfg, bucket: int, max_len: int,
                 device) -> None:
        device = torch.device(device)
        self.params, self.cfg, self.device = params, cfg, device
        self.bucket, self.max_len = bucket, max_len
        self.lock = threading.Lock()
        self.graph = None
        self.deltas: list[tuple[LaunchCounter, int]] = []
        self.steps = 0              # prefills through the bucket, either route
        self.replays = 0            # of them, graph replays
        self.capture_s = 0.0
        self.pool_bytes = 0         # the graph's pool on the card
        self.logits = self.argmax = self.state = None
        with torch.inference_mode():
            self.tokens = torch.zeros((1, bucket), dtype=torch.int64,
                                      device=device)
            self.pad = pad_length(cfg, bucket, device)
            if device.type == "cuda":
                self._capture()
        self.state_bytes = sum(
            t.numel() * t.element_size() for _, t in _leaves(
                init_decode_state(cfg, 1, max_len, device="meta")))

    def _run(self):
        logits, state = prefill(self.params, self.cfg, self.tokens,
                                self.max_len, length=self.pad)
        return logits, torch.argmax(logits[0]), state

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_RUNS):
                self._run()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph, (self.logits, self.argmax, self.state), self.deltas = \
            graphs.capture(self._run, self.stream, decode_counters())
        graphs.hold(self)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def prefill(self, prompt: np.ndarray) -> tuple[dict, int]:
        """The prefill of ``prompt`` (1..bucket token ids): (its decode
        state, the request's own tensors, and its greedy token).
        ``self.logits`` holds its logits until the bucket's next prefill."""
        with self.lock:
            state = self._launch(prompt)
            # int() waits for the card, so the PTT sees the run time
            return state, int(self.argmax)

    def launch(self, prompt: np.ndarray) -> dict:
        """The prefill without its wait: the tokens, the length, the replay
        and the state's copy issued, the argmax left on the card in
        ``self.argmax`` (for one thread's timing; the engine's payloads
        call :meth:`prefill`, which holds the bucket until its wait)."""
        with self.lock:
            return self._launch(prompt)

    def _launch(self, prompt: np.ndarray) -> dict:
        n = len(prompt)
        if not 0 < n <= self.bucket:
            raise ValueError(f"PrefillBucket {self.bucket}: a prompt of {n} "
                             f"tokens")
        ids = np.zeros((1, self.bucket), dtype=np.int64)
        ids[0, :n] = prompt
        with torch.inference_mode():
            self.tokens.copy_(torch.from_numpy(ids))
            fill_pad_length(self.pad, self.cfg, n)
            if self.graph is None:
                self.logits, self.argmax, self.state = self._run()
            else:
                graphs.replay(self.graph, self.deltas)
                self.replays += 1
            self.steps += 1
            return _clone(self.state)

    def close(self) -> None:
        """Release the graph, its pool, the static buffers and the bucket's
        hold on the params (``graphs.release``)."""
        if self.graph is not None:
            graphs.release(self, self.graph, self.device)
        self.graph = None
        self.params = self.tokens = self.pad = None
        self.logits = self.argmax = self.state = None


class PrefillGraphs:
    """Every length bucket of an engine's prompts (:func:`prefill_buckets`),
    one :class:`PrefillBucket` each, captured in order of length."""

    def __init__(self, params, cfg, max_len: int, device,
                 bucket_of: Callable[[int], int]) -> None:
        if is_distributed(*(t for _, t in _leaves(params))):
            raise ValueError("PrefillGraphs: DTensor params; a prefill on a "
                             "mesh runs eagerly (prefill)")
        self.max_len, self.bucket_of = max_len, bucket_of
        self.buckets = {b: PrefillBucket(params, cfg, b, max_len, device)
                        for b in prefill_buckets(max_len, bucket_of)}

    def bucket(self, n: int) -> PrefillBucket:
        """The bucket a prompt of ``n`` tokens runs in."""
        if not 0 < n <= self.max_len:
            raise ValueError(f"prefill: a prompt of {n} tokens; max_len "
                             f"{self.max_len}")
        return self.buckets[min(self.bucket_of(n), self.max_len)]

    def prefill(self, prompt: np.ndarray) -> tuple[dict, int]:
        """(decode state, greedy token) of ``prompt`` through its bucket."""
        return self.bucket(len(prompt)).prefill(prompt)

    def stats(self) -> dict:
        """Buckets, graphs captured, prefills and replays of them, and each
        bucket's capture seconds, graph pool bytes and state bytes."""
        bs = list(self.buckets.values())
        return {"buckets": [b.bucket for b in bs],
                "captures": sum(b.graph is not None for b in bs),
                "steps": sum(b.steps for b in bs),
                "replays": sum(b.replays for b in bs),
                "steps_by_bucket": {b.bucket: b.steps for b in bs},
                "capture_s": [b.capture_s for b in bs],
                "pool_bytes": [b.pool_bytes for b in bs],
                "state_bytes": [b.state_bytes for b in bs]}

    def close(self) -> None:
        for b in self.buckets.values():
            b.close()
        self.buckets = {}
