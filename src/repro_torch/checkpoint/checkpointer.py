"""Atomic, async checkpointing — port of
``repro.checkpoint.checkpointer`` with its on-disk layout, so that each
package restores the other's checkpoints::

    <dir>/step_<N>/
        meta.json            (step, each leaf's key, shape and dtype)
        arrays.npz           (one entry per leaf, keyed by its path)
    <dir>/LATEST             (atomic pointer file)

A leaf's key is its path joined by ``::``, as the JAX package's
``tree_flatten_with_path`` spells it: a dict key as it is (dicts in
sorted key order), a list or tuple index as its number, a NamedTuple
field as ``.`` and its name (``OptState``'s ``.mu``, ``.nu``,
``.count``).  bf16 leaves are stored as their uint16 bits (npz has no
bf16) and viewed back through the target leaf's dtype.  Writes go to a
tmp dir published by ``os.replace``: a crash mid-save never corrupts the
previous checkpoint.  ``save_async`` copies the tree to the host before
it returns and writes on a worker thread, so training can go on.
``restore`` puts each leaf on the device of the matching leaf of the
tree it restores into (or on ``device``).

Sharded state (DTensor leaves, ``launch.steps`` on a mesh) is gathered
whole before it is written — every rank of the mesh calls ``save`` —
and only rank 0 of the process group writes; ``restore`` re-places each
leaf under the placements of the DTensor it restores into.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import whole

__all__ = ["all_steps", "latest_step", "restore", "save", "save_async"]

_SEP = "::"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_path(tree, path=()) -> list:
    """[(path, leaf)] in the JAX package's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten_with_path(getattr(tree, f),
                                             path + ("." + f,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_path(v, path + (str(i),))]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure, its dicts in their own key order, with its
    leaves taken from the iterator ``leaves`` in the order of
    :func:`_flatten_with_path`."""
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _writes() -> bool:
    """Whether this process writes: rank 0, or no process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = whole(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            # npz has no bf16 descriptor: store the raw bits; restore views
            # them back via the target leaf dtype.
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf)
            for path, leaf in _flatten_with_path(tree)}


def save(tree, ckpt_dir: str, step: int) -> str:
    """Write ``tree`` (nested dicts, lists, tuples and NamedTuples of
    tensors, arrays or numbers) as step ``step``; returns its directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    arrays = _flatten(tree)
    if not _writes():
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = dict(step=step,
                leaves={k: dict(shape=list(v.shape), dtype=str(v.dtype))
                        for k, v in arrays.items()})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def _to_host(tree):
    """A host copy of every tensor leaf (a copy, a CPU tensor's too)."""
    flat = _flatten_with_path(tree)
    return _unflatten(tree, iter(
        [whole(leaf).detach().to("cpu", copy=True)
         if isinstance(leaf, torch.Tensor) else leaf for _, leaf in flat]))


def save_async(tree, ckpt_dir: str, step: int) -> threading.Thread:
    """Copy ``tree`` to host memory now, write it on a worker thread;
    returns the started thread (join it before the next save)."""
    host_tree = _to_host(tree)
    t = threading.Thread(target=save if _writes() else lambda *a: None,
                         args=(host_tree, ckpt_dir, step), daemon=False)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def all_steps(ckpt_dir: str) -> list[int]:
    """The published steps in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def _replace_like(leaf, t: torch.Tensor) -> torch.Tensor:
    """``t`` under the placements of ``leaf`` where that is a DTensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(leaf, DTensor):
        return distribute_tensor(t, leaf.device_mesh, leaf.placements,
                                 src_data_rank=None)
    return t


def restore(tree_like, ckpt_dir: str, step: int | None = None,
            device=None):
    """Restore into the structure of ``tree_like`` (shapes must match;
    each leaf takes the dtype of ``tree_like``'s leaf, bf16 from its
    stored bits).  Returns (tree, step); ``step`` None is ``LATEST``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    leaves = []
    with np.load(path) as data:
        for pathk, leaf in _flatten_with_path(tree_like):
            key = _SEP.join(pathk)
            arr = data[key]
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {want}")
            if isinstance(leaf, torch.Tensor):
                # np.load hands back a fresh C-ordered array: no copy
                if leaf.dtype == torch.bfloat16:
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr).to(leaf.dtype)
                t = t.to(leaf.device if device is None
                         else torch.device(device))
                leaves.append(_replace_like(leaf, t))
            else:
                leaves.append(arr)
    return _unflatten(tree_like, iter(leaves)), step
