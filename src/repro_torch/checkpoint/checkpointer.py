"""Sharded, atomic, async checkpointing — port of
``repro/checkpoint/checkpointer.py``, with the same files, so that each
package restores the other's checkpoints.

Layout:
  <dir>/step_000123/
      arrays.npz          — all leaves, keyed by flattened tree path
      manifest.json       — step, data-stream state, tree structure digest
  <dir>/LATEST            — text file naming the last *complete* step dir

Writes go to ``step_X.tmp`` then ``os.replace`` (atomic on POSIX), and
LATEST is only updated after the rename — a crash mid-save can never leave
a half checkpoint as the restore target.  ``save_async`` copies the tree to
the host and hands it to a writer thread so the train loop does not stall
on disk.

A key is the path's dict keys and list indices joined by ``/``, as the
reference flattens with ``jax.tree_util`` (which walks a dict in sorted key
order; the npz is keyed, so the order is moot).  A bfloat16 leaf is stored
as the reference's numpy ``bfloat16`` array is: its raw 16-bit words, as
2-byte void (``V2``).  A leaf restores onto the template's device and
dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..optim.adamw import tree_map

PyTree = Any
_SEP = "/"


def _paths(tree: PyTree, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield _SEP.join(str(p) for p in prefix), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16 words
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _host(tree: PyTree) -> PyTree:
    """A host copy of every leaf (a copy on the CPU too: the caller goes on
    updating its tensors in place)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _unflatten(template: PyTree, flat: dict[str, np.ndarray],
               prefix: tuple = ()) -> PyTree:
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten(v, flat, prefix + (i,))
                for i, v in enumerate(template)]
    key = _SEP.join(str(p) for p in prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{key}: shape {arr.shape} != "
                         f"{tuple(template.shape)}")
    return _to_torch(arr, template)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: PyTree, extra: Optional[dict] = None) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "extra": extra or {},
                    "n_leaves": len(flat)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # LATEST updated only after the atomic rename
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def save_async(self, step: int, tree: PyTree,
                   extra: Optional[dict] = None) -> None:
        self.wait()                       # one in flight at a time
        host_tree = _host(tree)           # snapshot before training mutates

        def run():
            try:
                self.save(step, host_tree, extra)
            except BaseException as e:    # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, template: PyTree, step: Optional[int] = None
                ) -> tuple[PyTree, dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return _unflatten(template, flat), manifest

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
