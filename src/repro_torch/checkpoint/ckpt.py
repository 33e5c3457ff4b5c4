"""Atomic, async checkpointing of tensor trees (port of
``repro.checkpoint.ckpt``; the on-disk layout is the reference's).

* Atomic: write to <dir>.tmp then rename; a manifest with per-leaf checksums
  detects torn writes.
* Async: a single background writer thread; `wait()` joins before the next
  save or at exit.  `submit` takes host copies that own their bytes, so
  the caller may update its state in place while bytes hit disk.

A tree is nested dicts, lists and tuples over array leaves (numpy arrays,
torch tensors, scalars).  A leaf's key joins its path with ``|``: dict keys
in sorted order and sequence indices, as ``jax.tree_util`` names them, so a
checkpoint written by the reference restores here and the other way round.
Sharded state.  A DTensor leaf is saved whole (its blocks all-gathered:
every rank of the group calls ``save`` / ``submit``, rank 0 writes).
``restore(..., shardings=)`` is the ELASTIC path: given a tree of
``distributed.sharding.NamedSharding`` over any mesh (``launch.steps.
_to_shardings``), each leaf becomes a DTensor at that sharding, so a
checkpoint written on one mesh restores onto another.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

_SEP = "|"


def _whole(leaf):
    """A DTensor's full value (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        from repro_torch.distributed.sharding import full_tensor
        return full_tensor(leaf.detach())
    return leaf


def host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf).detach().cpu().numpy()
    return np.asarray(leaf)


def _host_copy(leaf) -> np.ndarray:
    """A host array that owns its bytes: the caller may update ``leaf`` in
    place as soon as this returns (``host_array`` of a CPU tensor is a
    view of it)."""
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf).detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _writes() -> bool:
    """Whether this process writes checkpoints: always, but in a process
    group only rank 0."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def tree_items(tree, prefix=()):
    """(path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _flatten(tree) -> dict:
    return {_SEP.join(str(p) for p in path): leaf
            for path, leaf in tree_items(tree)}


def _unflatten_into(template, flat: dict, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, prefix + (i,))
                              for i, v in enumerate(template))
    if template is None:
        return None
    return flat[_SEP.join(str(p) for p in prefix)]


def save(state, path: str, step: int | None = None):
    """Blocking checkpoint write (atomic)."""
    flat = {key: host_array(leaf) for key, leaf in _flatten(state).items()}
    return _write(flat, path, step) if _writes() else None


def _write(flat: dict, path: str, step):
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, arr in flat.items():
        fn = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {
            "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return manifest


def restore(template, path: str, shardings=None, verify: bool = True):
    """Restore into ``template``'s structure: leaves become numpy arrays,
    or with ``shardings`` (a matching tree of ``NamedSharding``) DTensors
    at those shardings, each rank keeping its blocks."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(path, meta["file"]))
        if verify:
            got = hashlib.sha1(arr.tobytes()).hexdigest()
            if got != meta["sha1"]:
                raise IOError(f"checkpoint corruption in leaf {key}")
        flat[key] = arr
    state = _unflatten_into(template, flat)
    if shardings is not None:
        state = _place(state, shardings)
    return state, manifest.get("step")


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s) for v, s in zip(tree, shardings))
    return shardings.place(torch.from_numpy(np.asarray(tree)))


class AsyncCheckpointer:
    """One background writer; at most one save in flight."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            flat, path, step = item
            try:
                _write(flat, path, step)
            except Exception as e:          # pragma: no cover
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, state, path: str, step: int):
        if self._err:
            raise self._err
        host_state = {k: _host_copy(v) for k, v in _flatten(state).items()}
        if _writes():
            self._q.put((host_state, path, step))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()


def latest_step(base_dir: str) -> int | None:
    """The largest N of the ``step_N`` directories under ``base_dir``, or
    None."""
    if not os.path.isdir(base_dir):
        return None
    steps = []
    for d in os.listdir(base_dir):
        if d.startswith("step_") and os.path.isdir(os.path.join(base_dir, d)):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None
