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
* With ``specs`` (a tree of ``PartitionSpec`` entries at the state's paths),
  each leaf's logical spec goes into the manifest in the reference's
  form, so ``restore_checkpoint(..., mesh=...)`` re-shards onto *any*
  ``DeviceMesh`` whose axis names match: each leaf becomes a DTensor
  placed with its saved spec resolved on that mesh (elastic shrink/grow
  across restarts).
* DTensor leaves are saved whole (every rank gathers them; rank 0 of the
  default process group writes, and the ranks meet at a barrier before
  the directory is published).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]


def _flatten_with_paths(tree, path=()):
    """``[(name, leaf)]`` in the reference's order and naming; a
    ``PartitionSpec`` is a leaf."""
    from repro_torch.models.layers import PartitionSpec

    if isinstance(tree, PartitionSpec):
        return [("__".join(path), tree)]
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


def _spec_to_json(spec):
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def _spec_from_json(entries):
    from repro_torch.models.layers import P

    return P(*(tuple(e) if isinstance(e, list) else e for e in entries))


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _to_numpy(t: torch.Tensor):
    """``(array to save, logical dtype name)``."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, state, specs=None):
    """Atomically save a tree of tensors (dicts, lists, NamedTuples), with
    each leaf's logical spec from ``specs`` when given; returns the
    checkpoint's directory."""
    writer = _rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    spec_map = dict(_flatten_with_paths(specs)) if specs is not None else {}
    manifest = {"step": step, "leaves": []}
    for name, leaf in _flatten_with_paths(state):
        arr, logical_dtype = _to_numpy(leaf)  # collective for a DTensor
        fn = f"{abs(hash(name)) % 10**10}_{len(manifest['leaves'])}.npy"
        if writer:
            np.save(os.path.join(tmp, fn), arr)
        entry = {"name": name, "file": fn, "dtype": logical_dtype,
                 "shape": list(arr.shape)}
        if name in spec_map:
            entry["spec"] = _spec_to_json(spec_map[name])
        manifest["leaves"].append(entry)
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)  # atomic publish
    _barrier()
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


def restore_checkpoint(ckpt_dir: str, step: int, like, mesh=None):
    """Restore into ``like``, a tree of tensors of the saved structure.

    Without ``mesh``, every leaf is overwritten in place with the saved
    values (its shape and dtype must be the saved ones; a DTensor leaf
    takes its own shard) and ``like`` is returned: writing in place keeps
    one copy of the state on the device.  With ``mesh`` (a
    ``DeviceMesh``), a new tree of ``like``'s structure is returned whose
    leaves are DTensors placed with their saved logical spec resolved on
    ``mesh`` (leaves saved without a spec are replicated): elastic
    re-sharding.  Every rank reads the files and keeps its own slice."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        by_name = {e["name"]: e for e in json.load(f)["leaves"]}
    placed = {}
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
        if mesh is not None:
            from repro_torch.launch.sharding import placements_for
            from repro_torch.models.layers import P

            spec = _spec_from_json(entry["spec"]) if "spec" in entry else P()
            dev = mesh.device_type
            if dev == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            placed[name] = distribute_tensor(
                src.to(dev), mesh, placements_for(src.shape, spec, mesh),
                src_data_rank=None)
            continue
        with torch.no_grad():
            if isinstance(leaf, DTensor):
                shard = distribute_tensor(src.to(leaf.to_local().device),
                                          leaf.device_mesh, leaf.placements,
                                          src_data_rank=None)
                leaf.to_local().copy_(shard.to_local())
            else:
                leaf.copy_(src)
    if mesh is None:
        return like
    return _rebuild(like, placed)


def _rebuild(tree, placed, path=()):
    """``tree``'s structure with the leaf at each path taken from
    ``placed`` (names as :func:`_flatten_with_paths` gives them)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), placed,
                                     (*path, f".{f}")) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, placed, (*path, f"[{k!r}]"))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, placed, (*path, f"[{i}]"))
                          for i, v in enumerate(tree))
    return placed["__".join(path)]
