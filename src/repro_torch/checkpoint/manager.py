"""Checkpoint/restart: the fault-tolerance substrate.

The port's copy of `repro/checkpoint/manager.py`.  Its own tree flatten
(dicts by sorted key, lists, tuples and NamedTuples of tensors, arrays and
scalars) names every leaf as the JAX package does (`"/".join` of dict
keys and sequence indices, ".field" for a NamedTuple field), so a
checkpoint written by either package restores in the other.  Restored
leaves are tensors on the device the caller gives (the card unless the
caller asks for the CPU).  Restoring onto a new multi-card layout
(`shardings=`) is not ported.

Design (DESIGN.md §7):
  * pytree flattened to name-indexed .npz shards + JSON manifest
    (step, config hash, mesh shape, tree structure);
  * writes go to a temp dir then os.replace -> atomic: a crash mid-write
    never corrupts the latest checkpoint;
  * keep-last-k garbage collection;
  * optional background-thread writer (training continues during I/O).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["CheckpointManager"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_names(tree) -> list[tuple[str, Any]]:
    """(name, leaf) in JAX's tree-flatten order and naming: dict keys
    sorted, sequence indices, ".field" for NamedTuple fields; None is an
    empty subtree."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), path + ("." + f,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))
    walk(tree, ())
    return out


def _unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a copy: later writes to the leaf do
    not reach a checkpoint in flight)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        if self.async_write:
            self.wait()  # one outstanding write at a time
            named = [(n, _host(l)) for n, l in _flatten_with_names(tree)]
            self._thread = threading.Thread(   # snapshot taken above
                target=self._save_named, args=(step, named, extra or {}))
            self._thread.start()
            return os.path.join(self.dir, f"step_{step:08d}")
        return self._save_sync(step, tree, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _save_sync(self, step: int, tree: Any, extra: dict) -> str:
        return self._save_named(
            step, [(n, _host(l)) for n, l in _flatten_with_names(tree)], extra)

    def _save_named(self, step: int, named: list, extra: dict) -> str:
        """Write (name, host array) leaves as checkpoint `step`."""
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {}
        manifest = {"step": step, "extra": extra, "leaves": [], "time": time.time()}
        for name, arr in named:
            key = hashlib.md5(name.encode()).hexdigest()[:16]
            arrays[key] = arr
            manifest["leaves"].append(
                {"name": name, "key": key, "shape": list(arr.shape),
                 "dtype": str(arr.dtype)})
        np.savez(os.path.join(tmp, "shards.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()
        return final

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if not d.startswith("step_") or d.endswith(".tmp"):
                continue
            try:
                step = int(d[5:])
            except ValueError:
                continue
            # a checkpoint exists only once its manifest parses — a torn
            # or corrupted directory must not shadow the last good one
            try:
                with open(os.path.join(self.dir, d, "manifest.json")) as f:
                    json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            out.append(step)
        return sorted(out)

    def manifest(self, step: int) -> dict:
        """The saved manifest (incl. `extra`) for one checkpoint step."""
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None,
                device: str | torch.device = "cuda") -> tuple[int, Any]:
        """Restore into the structure of `like` (its leaves name the
        arrays to read; their values are not used), as tensors on
        `device`.  `shardings` (a multi-card layout) is not ported."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) needs multi-card meshes, which the "
                "port does not have yet")
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "shards.npz"))
        by_name = {leaf["name"]: data[leaf["key"]] for leaf in manifest["leaves"]}

        leaves = []
        for n, _ in _flatten_with_names(like):
            if n not in by_name:
                raise KeyError(f"checkpoint missing leaf {n!r}")
            arr = np.array(by_name[n], order="C")   # keeps 0-d leaves 0-d
            leaves.append(torch.from_numpy(arr).to(dev))
        return manifest["step"], _unflatten(like, leaves)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
