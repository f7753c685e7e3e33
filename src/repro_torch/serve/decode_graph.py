"""The serving engine's decode step as captured CUDA graphs: the port's
counterpart of the reference's ``jax.jit(decode_step)``
(``repro/serve/engine.py``), which makes a decode step one executable.

A :class:`DecodeSlot` holds the static buffers of one batch-1 decode step:
the token ``[1]``, a decode state at the engine's ``max_len``
(``init_decode_state``) and the step's outputs, the float32 logits and
their argmax.  On the card it also holds one ``torch.cuda.CUDAGraph`` of
``decode_step`` over those buffers, captured on a stream of its own after
warm-up steps on that stream (they build the sLSTM kernel, create the
cuBLAS handle and its workspace for the stream, and fill the allocator),
in a memory pool of its own: slots are replayed from several threads at
once, and a pool shared by graphs is safe only for replays in capture
order, one at a time.

A step (:meth:`DecodeSlot.step`) copies the request's state into the
slot's, fills the token, replays the graph, copies the state back into the
request's tensors and reads the argmax with one ``int()``, the one wait on
the card.  The request's state stays its own, as the reference's jitted
step (no ``donate_argnums``) returns a new state each step.

A replay runs none of the kernel wrappers' Python, so the launch counters
do not see it: at capture the slot takes each counter's delta, and every
replay adds it back (``graphs.capture``, ``graphs.replay``).

cuBLAS keeps a workspace for each stream it runs on, a slot's capture
stream's too, which the graph reads by address.  The slots that live are
counted for the process with the prefill buckets and the captured train
steps (``repro_torch/graphs.py``), and only the last graph of any kind to
close clears the workspaces, so that no graph outlives one it reads.

On the CPU the slot runs ``decode_step`` directly on the same static
buffers: its plain version, as each kernel wrapper takes its plain
version for CPU tensors.  DTensor params or state are refused: the
dry-run's decode on a mesh stays eager.
"""
from __future__ import annotations

import time
from typing import Iterator

import torch

from .. import graphs
from ..kernels import flash_attention, slstm_scan, ssd_scan
from ..kernels.common import LaunchCounter
from ..models import decode_step, init_decode_state
from ..parallel.sharding import is_distributed

WARMUP_STEPS = 3


def decode_counters() -> list[LaunchCounter]:
    """The launch counters of the forward kernels a decode step may reach
    (today only the sLSTM scan launches, at S = 1), with their by-path
    counts."""
    return [flash_attention.launches, *flash_attention.path_launches.values(),
            ssd_scan.launches, *ssd_scan.path_launches.values(),
            slstm_scan.launches]


def _leaves(tree, path=()) -> Iterator[tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (key,))
    else:
        yield path, tree


def _at(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _refuse_distributed(what: str, tree) -> None:
    if is_distributed(*(t for _, t in _leaves(tree))):
        raise ValueError(f"DecodeSlot: DTensor {what}; a decode step on a "
                         f"mesh runs eagerly (decode_step)")


class DecodeSlot:
    """One batch-1 decode step's static buffers and, on the card, its
    captured graph.  ``params`` are read by the graph at their addresses
    at capture: a slot is made anew when the params are replaced."""

    def __init__(self, params, cfg, max_len: int, device) -> None:
        device = torch.device(device)
        _refuse_distributed("params", params)
        self.params, self.cfg, self.device = params, cfg, device
        self.graph = None
        self.deltas: list[tuple[LaunchCounter, int]] = []
        self.steps = 0              # steps through the slot, either route
        self.replays = 0            # of them, graph replays
        self.capture_s = 0.0
        # the card memory the slot holds: its buffers and its stream's
        # cuBLAS workspace, and its graph's pool (``pool_bytes``)
        self.device_bytes = self.pool_bytes = 0
        self.logits = self.argmax = None
        with torch.inference_mode():
            self.token = torch.zeros(1, dtype=torch.int64, device=device)
            self.state = init_decode_state(cfg, 1, max_len, device=device)
            self._buffers = list(_leaves(self.state))
            if device.type == "cuda":
                self._capture()
        self.state_bytes = sum(t.numel() * t.element_size()
                               for _, t in self._buffers)

    def _run(self) -> tuple[torch.Tensor, torch.Tensor]:
        logits, _ = decode_step(self.params, self.cfg, self.state, self.token)
        return logits, torch.argmax(logits[0])

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        torch.cuda.synchronize(dev)
        allocated = torch.cuda.memory_allocated(dev) - sum(
            t.numel() * t.element_size() for _, t in self._buffers)
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                self._run()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.device_bytes = torch.cuda.memory_allocated(dev) - allocated
        self.graph, (self.logits, self.argmax), self.deltas = graphs.capture(
            self._run, self.stream, decode_counters())
        graphs.hold(self)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.device_bytes += self.pool_bytes
        self.capture_s = time.perf_counter() - t0

    def step(self, state, tok: int) -> int:
        """One decode step of the request whose decode state is ``state``
        (updated in place, as ``decode_step`` updates it) at token
        ``tok``: the next token.  ``self.logits`` holds the step's logits
        until the slot's next step."""
        self.launch(state, tok)
        return int(self.argmax)

    def launch(self, state, tok: int) -> None:
        """The step without its wait: the copies, the token and the replay
        issued, the argmax left on the card in ``self.argmax``."""
        _refuse_distributed("state", state)
        with torch.inference_mode():
            for path, mine in self._buffers:
                theirs = _at(state, path)
                if (theirs.shape != mine.shape or theirs.dtype != mine.dtype
                        or theirs.device != mine.device):
                    raise ValueError(
                        f"DecodeSlot: state {'/'.join(path)} is "
                        f"{tuple(theirs.shape)} {theirs.dtype} on "
                        f"{theirs.device}; the slot's is "
                        f"{tuple(mine.shape)} {mine.dtype} on {mine.device}")
                mine.copy_(theirs)
            self.token.fill_(tok)
            if self.graph is None:
                self.logits, self.argmax = self._run()
            else:
                graphs.replay(self.graph, self.deltas)
                self.replays += 1
            for path, mine in self._buffers:
                _at(state, path).copy_(mine)
            self.steps += 1

    def close(self) -> None:
        """Release the graph, its pool, the static buffers and the slot's
        hold on the params; the last graph of the process to close, of
        any kind, also clears cuBLAS's workspaces (``graphs.release``)."""
        if self.graph is not None:
            graphs.release(self, self.graph, self.device)
        self.graph = None
        self.params = self.state = self.token = None
        self.logits = self.argmax = None
        self._buffers = []
