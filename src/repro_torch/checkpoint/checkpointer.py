"""Atomic checkpoints of a tree of tensors (torch port of
``repro.checkpoint.checkpointer``).

* Each leaf is saved as an ``.npy`` under ``step_XXXXXXXX.tmp/``; the
  manifest is fsynced and the directory atomically renamed to
  ``step_XXXXXXXX``, so a torn write is never taken for a checkpoint.
* ``manifest.json`` lists every leaf under the name the reference gives
  it (``jax.tree_util``'s key path: ``['params']__['layers']__['attn']__
  ['wq']``, ``['opt']__.m__...``, ``['opt']__.step``; dict keys sorted,
  a NamedTuple's fields in order, list items as ``[i]``), with its file,
  dtype and shape.  bfloat16 is stored as its raw uint16 bits.  File
  names come from ``hash(name)``, which varies by process, so leaves are
  read through the manifest only.  A checkpoint written by either package
  restores in the other.
* ``latest_step`` finds the newest complete checkpoint; the train
  launcher resumes from it.

The reference's ``specs`` and ``mesh=`` arguments place leaves on a
device mesh; the port restores onto the devices of the tree it is given,
and re-sharding waits for the port's mesh and sharding (ROADMAP.md,
Queue 1 item 2).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]


def _flatten_with_paths(tree, path=()):
    """``[(name, leaf)]`` in the reference's order and naming."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("__".join(path), tree)]
    out = []
    for key, v in items:
        out.extend(_flatten_with_paths(v, (*path, key)))
    return out


def _to_numpy(t: torch.Tensor):
    """``(array to save, logical dtype name)``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, state):
    """Atomically save a tree of tensors (dicts, lists, NamedTuples);
    returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for name, leaf in _flatten_with_paths(state):
        arr, logical_dtype = _to_numpy(leaf)
        fn = f"{abs(hash(name)) % 10**10}_{len(manifest['leaves'])}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn,
                                   "dtype": logical_dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step with a complete checkpoint (a ``.tmp`` directory or
    one without a manifest is ignored), or ``None``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like):
    """Restore into ``like``, a tree of tensors of the saved structure:
    every leaf is overwritten in place with the saved values (its shape
    and dtype must be the saved ones) and ``like`` is returned.  Writing
    in place keeps one copy of the state on the device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        by_name = {e["name"]: e for e in json.load(f)["leaves"]}
    for name, leaf in _flatten_with_paths(like):
        entry = by_name[name]
        arr = np.load(os.path.join(path, entry["file"]))
        if entry["dtype"] == "bfloat16":
            src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(arr)
        want = str(leaf.dtype).removeprefix("torch.")
        if entry["dtype"] != want or tuple(src.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{name}: saved {entry['dtype']}{tuple(src.shape)}, restoring "
                f"into {want}{tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(src)
    return like
