"""Fault-tolerant checkpointing: atomic, async, device-agnostic.

The port of ``repro/checkpoint/checkpointer.py`` (``Checkpointer`` :55,
``CheckpointManager`` :138), with its on-disk layout: a directory of
``.npy`` files plus a JSON manifest of tree paths (``a/b/c``, keys joined
by ``/``), written to ``step_NNNNNNNN.tmp/`` and renamed, so a crash
mid-save never leaves a half-written checkpoint; ``CheckpointManager``
snapshots to host memory on the caller's thread and writes on a worker
thread, keeping the ``keep_n`` newest.  A tree is nested dicts (and
lists) of tensors or numbers.

bfloat16 (and the float8 types) have no numpy dtype without the
``ml_dtypes`` package, which the port does not use: such a tensor is
stored as its raw words (uint16, uint8) and the manifest names its dtype,
as the JAX package stores them, so either package reads the other's
files.  ``restore`` puts each leaf on its template's device and dtype.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

# dtypes numpy has no type for: stored as unsigned words of the same width
_VIEW = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
         torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
         torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8)}
_BY_NAME = {name: (dt, word) for dt, (name, _, word) in _VIEW.items()}


def _flatten(tree, prefix=""):
    """[(path, leaf)] in a stable order: dict keys as given, list items in
    order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like, leaves: dict, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(like))
    return leaves[prefix]


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array that is written: a tensor's raw words for
    the dtypes numpy lacks."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype in _VIEW:
            _, np_word, word = _VIEW[t.dtype]
            return t.contiguous().view(word).numpy().view(np_word)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype in _VIEW:
        return _VIEW[leaf.dtype][0]
    return str(arr.dtype)


class Checkpointer:
    """Synchronous core: save/restore one tree atomically."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, tree) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for key, leaf in _flatten(tree):
            arr = _to_host(leaf)
            fname = f"{len(manifest):06d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": _dtype_name(leaf, arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic on POSIX
        return final

    def latest_step(self) -> int | None:
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d[5:]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, step: int, like_tree):
        """Restore into the structure of ``like_tree``: each leaf a tensor
        on the template leaf's device, in its dtype (a template that is
        no tensor gives a CPU tensor of the stored dtype)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        leaves = {}
        for key, like in _flatten(like_tree):
            if key not in manifest:
                raise KeyError(f"checkpoint missing leaf {key}")
            entry = manifest[key]
            arr = np.load(os.path.join(d, entry["file"]))
            t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
            if entry["dtype"] in _BY_NAME:
                dt, word = _BY_NAME[entry["dtype"]]
                t = t.view(word).view(dt)
            shape = tuple(getattr(like, "shape", ()))
            if tuple(t.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(t.shape)} vs model {shape}")
            if isinstance(like, torch.Tensor):
                t = t.to(like.device, like.dtype)
            leaves[key] = t
        return _unflatten(like_tree, leaves)

    def prune(self, keep_n: int):
        all_steps = sorted(
            int(d[5:]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in all_steps[:-keep_n]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


class CheckpointManager:
    """Async wrapper: snapshot on the caller thread, write on a worker."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.ckpt = Checkpointer(directory)
        self.keep_n = keep_n
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                self.ckpt.save(step, tree)
                self.ckpt.prune(self.keep_n)
            except Exception as e:      # surfaced on next save()
                self._err = e
            finally:
                self._q.task_done()

    def save_async(self, step: int, tree):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        # snapshot now (a host copy) so training can update in place
        host = [(k, v.detach().to("cpu", copy=True)
                 if isinstance(v, torch.Tensor) else v)
                for k, v in _flatten(tree)]
        self._q.put((step, dict(host)))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)

    # passthroughs
    def latest_step(self):
        return self.ckpt.latest_step()

    def restore(self, step, like_tree):
        return self.ckpt.restore(step, like_tree)
