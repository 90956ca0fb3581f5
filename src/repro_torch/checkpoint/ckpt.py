"""Async, atomic checkpoints in the JAX package's on-disk layout.

  * `save()` snapshots the tree to host memory, then writes it on a
    background thread, atomically: into ``.tmp-{step}``, then
    `os.replace` to ``step-{step:09d}``, so a preemption mid-save never
    corrupts the latest checkpoint;
  * keep-k garbage collection bounds disk usage;
  * storage is one ``state.npz`` (and ``meta.json``) per checkpoint, keyed
    by the JAX package's path keys: a NamedTuple field is ``.name``, a
    dict key its name, joined by ``//`` (``.params//stage0//b0//attn//wq``,
    ``.opt//.step``, ``.opt//.mu//embed``, ``.ef//.residual//...``,
    ``.rng``).  A list of per-layer units (the port's stage, ``enc`` and
    ``dec`` lists) is stored as one stacked ``(R, ...)`` leaf per key path,
    as the JAX package stacks a stage.  bf16 leaves are widened to fp32
    (npz has no bf16) and cast back on restore.

So a checkpoint written by either package restores into the other.  The
stored arrays are whole (unsharded), so `restore(specs=, mesh=)` places
every leaf by its spec on the *current* mesh: a job restarts on another
mesh shape (the elastic path).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.convert import to_numpy

_SEP = "//"


def _walk(tree, path: tuple) -> Iterator[tuple[str, Any]]:
    """(key, leaf) pairs of one layer's (or a whole tree's) leaves; a list
    yields (key, list of the layers' leaves), one stacked leaf a key."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):                       # a NamedTuple
        for name in tree._fields:
            yield from _walk(getattr(tree, name), path + ("." + name,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, list):
        per_layer = [list(_walk(unit, path)) for unit in tree]
        for same in zip(*per_layer):
            yield same[0][0], [leaf for _, leaf in same]
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _stacked(leaves: list) -> np.ndarray:
    first = to_numpy(leaves[0])
    out = np.empty((len(leaves),) + first.shape, first.dtype)
    out[0] = first
    for r, leaf in enumerate(leaves[1:], 1):
        out[r] = to_numpy(leaf)
    return out


def flatten(tree) -> dict[str, np.ndarray]:
    """{path key: host array} of every leaf, lists stacked."""
    return {key: _stacked(leaf) if isinstance(leaf, list) else to_numpy(leaf)
            for key, leaf in _walk(tree, ())}


def _like(arr: np.ndarray, leaf):
    """`arr` as `leaf`'s kind, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.array(arr))       # a 0-d copy stays 0-d
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def _check(key: str, got: tuple, want: tuple) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"checkpoint/model mismatch at {key}: "
                         f"{tuple(got)} vs {tuple(want)}")


def _restore(tree, path: tuple, data):
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_restore(getattr(tree, n), path + ("." + n,),
                                     data) for n in tree._fields))
    if isinstance(tree, dict):
        return {k: _restore(v, path + (str(k),), data)
                for k, v in tree.items()}
    if isinstance(tree, list):
        arrays = {}
        for key, layers in _walk(tree, path):
            arr = data[key]
            for leaf in layers:
                _check(key, arr.shape, (len(layers),) + tuple(leaf.shape))
            arrays[key] = arr
        return [_unit(unit, path, arrays, r) for r, unit in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(_restore(v, path + (str(i),), data)
                     for i, v in enumerate(tree))
    key = _SEP.join(path)
    arr = data[key]
    _check(key, arr.shape, tuple(tree.shape) if isinstance(
        tree, torch.Tensor) else np.shape(tree))
    return _like(arr, tree)


def _unit(unit, path: tuple, arrays: dict, r: int):
    """Layer `r` of a stacked list, rebuilt from the stacked arrays."""
    if isinstance(unit, dict):
        return {k: _unit(v, path + (str(k),), arrays, r)
                for k, v in unit.items()}
    return _like(arrays[_SEP.join(path)][r], unit)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot `tree` to host memory now (after the previous write
        has finished, so one snapshot is held at a time); serialize and
        publish it on a background thread.  In a process group every rank
        takes the snapshot (a `DTensor` leaf is gathered whole) and rank 0
        alone writes it."""
        self.wait()
        flat = flatten(tree)
        if _rank() != 0:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, flat), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}")
        final = os.path.join(self.directory, f"step-{step:09d}")
        if os.path.exists(final):          # idempotent re-save of a step
            shutil.rmtree(final, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step}, f)
        os.replace(tmp, final)                     # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step-(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: int | None = None,
                specs: Any = None, mesh=None) -> Any:
        """Restore into the structure of `like`: each leaf takes the
        dtype and device of `like`'s (bf16 cast back from the stored fp32;
        a `DTensor` leaf its mesh's device); a shape that differs raises
        ValueError.  With `specs` and `mesh`, every leaf is placed as a
        `DTensor` by its spec on `mesh` (`sharding.shard_like`)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step-{step:09d}", "state.npz")
        with np.load(path) as data:
            tree = _restore(like, (), data)
        if specs is not None and mesh is not None:
            from repro_torch.distributed.sharding import shard_like
            tree = shard_like(tree, specs, mesh)
        return tree
