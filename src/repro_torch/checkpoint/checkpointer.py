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
2-byte void (``V2``).

The npz is ``np.savez``'s file: a zip of ``<key>.npy`` members, stored
uncompressed, each member's CRC-32 in the zip's directory.  It is written
and read here a leaf at a time, each leaf's bytes in one call, where
numpy's own writer copies them in 16 MB pieces twice and its reader goes
256 KB at a time (on an H100's host, 0.6 and 0.5 GB/s for the 43 GB of
qwen3-moe-30b-a3b x 4's bfloat16 params, float32 master copy and moments).
A restore reads the next leaf while the last one goes to the card, checks
each member's CRC-32 against the directory's, and writes each leaf into the
template's own tensor (its device and dtype), so that it holds no second
copy of the state: the ``Trainer`` restores into its live params and
optimizer state.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

PyTree = Any
_SEP = "/"
_LOCAL_HEADER = 30   # bytes of a zip local file header before its name


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


def _bytes(arr: np.ndarray) -> memoryview:
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data


def _write_npz(path: str, leaves: Iterable[tuple[str, np.ndarray]]) -> int:
    """``np.savez``'s file from ``(key, array)`` pairs, written as they
    come; returns their number."""
    n = 0
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in leaves:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(_bytes(arr))
            n += 1
    return n


def _member(fh, info: zipfile.ZipInfo) -> tuple[int, int, tuple, np.dtype]:
    """Where one stored ``.npy`` member of the open file ``fh`` starts, the
    length of its ``.npy`` header, and its array's shape and dtype."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{info.filename}: compressed member")
    fh.seek(info.header_offset)
    local = fh.read(_LOCAL_HEADER)
    start = info.header_offset + _LOCAL_HEADER + sum(
        struct.unpack("<HH", local[26:30]))
    fh.seek(start)
    version = np.lib.format.read_magic(fh)
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0(fh)
                             if version == (1, 0) else
                             np.lib.format.read_array_header_2_0(fh))
    if fortran or dtype.hasobject:
        raise ValueError(f"{info.filename}: not a C-ordered plain array")
    return start, fh.tell() - start, shape, dtype


def _read_leaf(fh, info: zipfile.ZipInfo) -> np.ndarray:
    """The array of one stored ``.npy`` member of the open file ``fh``,
    read in one call; raises if its length or CRC-32 is not the
    directory's."""
    start, head_len, shape, dtype = _member(fh, info)
    fh.seek(start)
    crc = zlib.crc32(fh.read(head_len))
    arr = np.empty(shape, dtype)
    body = _bytes(arr)
    got = 0
    while got < len(body):
        n = fh.readinto(body[got:])
        if not n:
            break
        got += n
    crc = zlib.crc32(body, crc)
    if got != len(body) or head_len + got != info.file_size or (
            crc != info.CRC):
        raise zipfile.BadZipFile(f"{info.filename}: bad length or CRC-32")
    return arr


@torch.no_grad()
def _into(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16 words
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return like.copy_(t)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: PyTree, extra: Optional[dict] = None) -> str:
        return self._save(step, ((key, _to_numpy(leaf))
                                 for key, leaf in _paths(tree)), extra)

    def _save(self, step: int, leaves: Iterable[tuple[str, np.ndarray]],
              extra: Optional[dict]) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        n_leaves = _write_npz(os.path.join(tmp, "arrays.npz"), leaves)
        manifest = {"step": step, "extra": extra or {},
                    "n_leaves": n_leaves}
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
        # the snapshot, taken before training goes on to mutate the tree
        leaves = [(key, _to_numpy(leaf.detach().to("cpu", copy=True)))
                  for key, leaf in _paths(tree)]

        def run():
            try:
                self._save(step, leaves, extra)
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
        """(``template``, each of its tensors overwritten with the
        checkpoint's leaf; the manifest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        path = os.path.join(d, "arrays.npz")
        with zipfile.ZipFile(path) as zf:
            infos = {i.filename: i for i in zf.infolist()}
        targets = [(key, leaf, infos.get(key + ".npy"))
                   for key, leaf in _paths(template)]
        with open(path, "rb") as fh, ThreadPoolExecutor(1) as reader:
            for key, leaf, info in targets:   # every shape before any write
                if info is None:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                shape = _member(fh, info)[2]
                if tuple(shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: shape {shape} != "
                                     f"{tuple(leaf.shape)}")
            ahead = [reader.submit(_read_leaf, fh, info)
                     for _, _, info in targets[:1]]
            for i, (_, leaf, _) in enumerate(targets):
                arr = ahead.pop().result()
                if i + 1 < len(targets):   # the next leaf read meanwhile
                    ahead.append(reader.submit(_read_leaf, fh,
                                               targets[i + 1][2]))
                _into(arr, leaf)
        return template, manifest

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
