"""Checkpoints in the reference's on-disk format, with async writes.

Layout (the reference's ``repro/checkpoint/ckpt.py``):

    <dir>/step_<N>/
        manifest.json        leaf paths, shapes, dtypes, "extra" (loader cursor)
        leaf_<sha1[:16]>.npy one file a leaf (np.save), named by its path

A leaf's path is what ``jax.tree_util.keystr`` makes of it: a dict key as
``['name']`` (keys in sorted order), a NamedTuple field as ``.name``; a
None entry has no leaves. So a
``TrainState`` of the port writes ``.params['layers']['attn']['wq']``,
``.opt.step``, ``.opt.m['embed']`` ... as the reference's does, and each
package restores the other's checkpoints. bfloat16 leaves are written as
the reference writes them (2-byte raw values, dtype "bfloat16" in the
manifest).

Writes go to ``step_<N>.tmp`` and are renamed once the manifest is synced,
so a save cut short never corrupts the latest complete checkpoint.
``AsyncCheckpointer`` copies the state to host memory at once and writes
it in a background thread, one save outstanding at a time.

Unlike the reference's, ``restore_checkpoint`` copies each leaf INTO the
tensor of `like` at its path (on its device, in its dtype) and returns
`like`: restoring a ``TrainState`` overwrites the model's own parameters
and the optimizer's moments, with no second copy of the state in device
memory.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf of `tree`, paths as the reference's."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name in tree._fields
                for pair in leaf_paths(getattr(tree, name),
                                       f"{prefix}.{name}")]
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in leaf_paths(tree[key], f"{prefix}[{key!r}]")]
    return [(prefix, tree)]


def _fname(key: str) -> str:
    h = hashlib.sha1(key.encode()).hexdigest()[:16]
    return f"leaf_{h}.npy"


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to np.save, dtype name for the manifest)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:     # bfloat16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Blocking save of a tree of tensors."""
    return _write(directory, step, leaf_paths(tree), extra)


def _write(directory: str, step: int, pairs, extra: Optional[Dict]) -> str:
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in pairs:
        arr, dtype = _to_numpy(leaf)
        fn = _fname(key)
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, like):
    """Copy every leaf of checkpoint `step` into the tensor of `like` at
    the same path, IN PLACE; returns (like, extra). A leaf missing from the
    checkpoint, or of another shape, raises before anything is copied."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    stored = manifest["leaves"]
    targets = leaf_paths(like)
    for key, leaf in targets:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"{key}: restore needs a tensor to copy into, "
                            f"got {type(leaf).__name__}")
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key}")
        if tuple(stored[key]["shape"]) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape "
                             f"{tuple(stored[key]['shape'])} != "
                             f"{tuple(leaf.shape)}")
    for key, leaf in targets:
        arr = np.load(os.path.join(path, stored[key]["file"]))
        leaf.copy_(_from_numpy(arr))
    return like, manifest.get("extra", {})


class AsyncCheckpointer:
    """One outstanding write at a time: `save` copies the tree to host
    memory, then writes it in a background thread; `wait` joins it and
    raises what the write raised."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, tree, extra=None):
        self.wait()
        # a copy in host memory that later updates cannot touch
        host = [(key, leaf.detach().to("cpu", copy=True))
                for key, leaf in leaf_paths(tree)]

        def work():
            try:
                _write(self.directory, step, host, extra)
                self._gc()
            except Exception as e:          # raised again by the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
