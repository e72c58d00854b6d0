"""Logical -> physical sharding glue (torch port of
``repro.launch.sharding``).

Parameter specs are written against logical axis names (``data``,
``model``; :class:`~repro_torch.models.layers.PartitionSpec`); the batch
is sharded over every pure-DP axis present in the mesh (``pod``
included when it exists).  Everything resolves against the actual
``DeviceMesh`` at launch time, so the same model code runs on
(data, model) and (pod, data, model) meshes and on any reshape of them.

A resolved spec becomes DTensor placements (``spec_placements``): one
``Shard(dim)`` or ``Replicate()`` per mesh dimension, several mesh
dimensions on one tensor dimension in mesh order.  :func:`distribute`
places a real or fake tree; an uneven shard raises, so DTensor never pads
one (drop the axes that do not divide first, as the dry-run's
``sanitize_specs`` does).

:class:`Partitioner` is what XLA's partitioner is to the reference: a
dispatch mode that lets the unmodified step run on DTensors.  DTensor
shards an op as its inputs stand where it can; where it cannot, the mode
re-places the inputs and runs the op again (see its docstring).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.models.layers import P, PartitionSpec, spec_placements

__all__ = [
    "batch_axes",
    "batch_spec",
    "resolve_spec",
    "param_sharding",
    "batch_shardings",
    "placements_for",
    "distribute",
    "map_specs",
    "Partitioner",
]


def batch_axes(mesh):
    """Axes the global batch is sharded over (pod + data when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh) -> PartitionSpec:
    return P(batch_axes(mesh))


def resolve_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop mesh axes that don't exist (e.g. ``pod`` on a single-pod mesh)."""
    names = set(mesh.mesh_dim_names)

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(fix(e) for e in spec))


def map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a spec tree and trees of the same
    structure (dicts, lists, tuples and NamedTuples, and dataclasses such
    as ``Cache``, whose non-tree fields are taken from ``specs``); a
    :class:`PartitionSpec` is a leaf."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if dataclasses.is_dataclass(specs):
        return dataclasses.replace(specs, **{
            f.name: map_specs(fn, getattr(specs, f.name),
                              *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(specs)
            if isinstance(getattr(specs, f.name),
                          (PartitionSpec, dict, list, tuple))})
    if isinstance(specs, (list, tuple)):
        items = [map_specs(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(specs)]
        if hasattr(specs, "_fields"):
            return type(specs)(*items)
        return type(specs)(items)
    return specs


def param_sharding(specs, mesh):
    """Spec tree -> tree of DTensor placements resolved on ``mesh``."""
    return map_specs(lambda s: spec_placements(resolve_spec(s, mesh), mesh),
                     specs)


def batch_shardings(batch_tree, mesh):
    """Placements that shard every batch input on its leading (batch)
    dimension."""
    return tree_map(lambda _: spec_placements(batch_spec(mesh), mesh),
                    batch_tree)


def placements_for(shape, spec: PartitionSpec, mesh) -> list:
    """Placements of ``spec`` for a tensor of ``shape``; raises when a
    sharded dimension does not divide evenly over its mesh axes."""
    spec = resolve_spec(spec, mesh)
    sizes = {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        ways = 1
        for a in axes:
            ways *= sizes.get(a, 1) if a is not None else 1
        if shape[dim] % ways:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide over {entry} ({ways} ways)")
    return spec_placements(spec, mesh)


def distribute(tree, specs, mesh):
    """Place every tensor of ``tree`` on ``mesh`` with its spec in
    ``specs`` (a tree of the same structure).  Each rank keeps the slice
    of its own copy that its placements name (no collective: every rank
    must hold the same full values, as seeded runs do)."""
    from torch.distributed.tensor import distribute_tensor

    def one(spec, t):
        return distribute_tensor(t, mesh, placements_for(t.shape, spec, mesh),
                                 src_data_rank=None)

    return map_specs(one, specs, tree)


# -- the partitioner ---------------------------------------------------------


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def _odd_placement(out) -> bool:
    """An output placement that later ops cannot take apart: a strided
    shard (from flattening two sharded dims) or a mask partial (from a
    vocab-parallel gather)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) and any(
        type(p).__name__ in ("_StridedShard", "_MaskPartial")
        for p in t.placements) for t in tree_leaves(out))


def _same(a, b) -> bool:
    """Equal placement lists, without ``==`` on partial placements (a mask
    partial compares its buffers, which a fake tensor cannot)."""
    return len(a) == len(b) and all(
        p is q or (not p.is_partial() and not q.is_partial() and p == q)
        for p, q in zip(a, b))


def _restore(specs) -> None:
    for t, spec in specs:
        t._spec = spec


def _moved(func, ran_on, specs) -> bool:
    """An in-place op that DTensor let change its first argument's
    placements without moving its data (seen with ``index_copy_``)."""
    if not func._schema.is_mutable or not ran_on:
        return False
    before = {id(t): spec for t, spec in specs}
    t = ran_on[0]
    return id(t) in before and not _same(t._spec.placements,
                                         before[id(t)].placements)


def _replace(t, level: int):
    """``t`` re-placed: level 1 keeps only the shards of dim 0 and the
    partials, level 2 replicates everything."""
    from torch.distributed.tensor import Replicate, Shard

    if level == 2:
        pl = [Replicate()] * len(t.placements)
    else:
        pl = [p if p.is_partial() or (type(p) is Shard and p.dim == 0)
              else Replicate() for p in t.placements]
    return t if _same(pl, t.placements) else t.redistribute(t.device_mesh, pl)


_aten = torch.ops.aten
#: Products and the positions of their two operands.
_DOTS = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
         _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2)}


def _gather_whole_dim(args):
    """``gather`` along a sharded dim, or of a partial sum: DTensor answers
    with a mask partial that later ops cannot always reduce; the dim is
    gathered and the sum reduced first."""
    from torch.distributed.tensor import Replicate, Shard

    x, dim = args[0], args[1] % args[0].dim()
    pl = [Replicate() if p.is_partial() or p == Shard(dim) else p
          for p in x.placements]
    if _same(pl, x.placements):
        return args
    return (x.redistribute(x.device_mesh, pl), *args[1:])


def _pre_place(func, args):
    """Placements chosen before DTensor sees ``func``: a ``gather`` along a
    sharded dim, or of a partial sum, gathers that dim and reduces the sum
    first; for a product ``a @ b``, FSDP's and
    Megatron's rules, which DTensor's cost model alone does not keep: on
    every mesh dimension where ``a`` is
    sharded on its rows (the dims before the contraction; the batch dim of
    a ``bmm`` when ``b`` shares it excepted), ``b`` is gathered, so only
    the weights travel; where ``a`` is a partial sum and ``b`` is sharded
    on its columns, ``a`` is reduced first, so the product stays
    column-parallel."""
    from torch.distributed.tensor import Replicate, Shard

    if func is _aten.gather.default:
        return _gather_whole_dim(args)
    if func not in _DOTS:
        return args
    ia, ib = _DOTS[func]
    a, b = args[ia], args[ib]
    batched = a.dim() == 3
    pa_new, pb_new = list(a.placements), list(b.placements)
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        rows = type(pa) is Shard and pa.dim < a.dim() - 1
        shared_batch = batched and type(pa) is type(pb) is Shard \
            and pa.dim == pb.dim == 0
        if rows and not shared_batch and not pb.is_replicate():
            pb_new[i] = Replicate()
        elif pa.is_partial() and type(pb) is Shard and pb.dim == b.dim() - 1:
            pa_new[i] = Replicate()  # reduce before a column-parallel product
    args = list(args)
    if not _same(pa_new, a.placements):
        args[ia] = a.redistribute(a.device_mesh, pa_new)
    if not _same(pb_new, b.placements):
        args[ib] = b.redistribute(b.device_mesh, pb_new)
    return tuple(args)


class Partitioner(TorchDispatchMode):
    """Lets a step written for plain tensors run on DTensors.

    For every op on DTensors, in order:

    0. plain tensors among the arguments join as replicated DTensors; the
       second operand of a product is gathered where the first is sharded
       on its rows (FSDP: weights travel, activations stay); DTensor
       shards the op as its inputs stand;
    1. if it cannot (no sharding it can propagate, an uneven flatten or
       a local view DTensor sized wrong, a redistribution that reads data
       a fake tensor does not have), or
       the result is placed so that later ops cannot take it
       apart (a strided shard, a mask partial of ``gather``), or an
       in-place op moved its target's placements without its data, the
       inputs keep only their shards of dim 0 (the batch) and their
       partials;
    2. then every input is replicated;
    3. an op DTensor has no strategy for (or still cannot shard) runs on
       replicated local tensors and its result is replicated (as GSPMD
       replicates an op it cannot partition).

    An in-place op that ran on re-placed inputs is written back into its
    DTensor with that DTensor's placements.  ``repairs`` counts, per op
    and level, how often each step past 0 was taken.  Enter it last
    (innermost), above ``stats`` (a
    :class:`~repro_torch.launch.hlo_stats.TraceStats`), whose counts of an
    attempt that is thrown away are taken back.
    """

    def __init__(self, stats=None):
        super().__init__()
        self._passthrough = False
        self._stats = stats
        self.repairs: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import DataDependentOutputException
        from torch.distributed.tensor import DTensor, Replicate

        kwargs = kwargs or {}
        if not any(_is_dtensor_type(t) for t in types):
            return func(*args, **kwargs)
        if self._passthrough:  # our own call below: let DTensor run it
            self._passthrough = False
            return NotImplemented
        mesh = next(t.device_mesh for t in tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))

        def join(t):
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
            return t

        args, kwargs = tree_map(join, (args, kwargs))
        args = _pre_place(func, args)
        snap = self._stats.snapshot() if self._stats is not None else None
        no_strategy = False
        for level in (0, 1, 2, 3):
            if level and snap is not None:
                self._stats.restore(snap)
            if level == 3:
                out, ran_on = self._local(func, args, kwargs, mesh), (None,)
            elif no_strategy:
                continue
            else:
                a, k = (args, kwargs) if level == 0 else tree_map(
                    lambda t: _replace(t, level) if isinstance(t, DTensor)
                    else t, (args, kwargs))
                # a failed in-place attempt may leave its new spec behind
                tried = [(t, t._spec) for t in tree_leaves((a, k))
                         if isinstance(t, DTensor)]
                try:
                    self._passthrough = True
                    with self:
                        out = func(*a, **k)
                except NotImplementedError as e:  # no strategy: go local
                    self._passthrough = False
                    if "sharding strategy" not in str(e):
                        raise
                    _restore(tried)
                    no_strategy = True
                    continue
                except RuntimeError as e:  # DataDependentOutputException too
                    self._passthrough = False
                    msg = str(e)
                    if not (isinstance(e, DataDependentOutputException)
                            or "Sharding propagation failed" in msg
                            or "unevenly" in msg
                            or "is invalid for input of size" in msg):
                        raise
                    _restore(tried)
                    continue
                if level < 2 and (_odd_placement(out)
                                  or _moved(func, a, tried)):
                    _restore(tried)
                    continue
                ran_on = a
            if level:
                key = f"{func}@{level}"
                self.repairs[key] = self.repairs.get(key, 0) + 1
                out = self._write_back(func, args, ran_on, out)
            return out

    def _local(self, func, args, kwargs, mesh):
        from torch.distributed.tensor import DTensor, Replicate

        a, k = tree_map(lambda t: _replace(t, 2).to_local()
                        if isinstance(t, DTensor) else t, (args, kwargs))
        out = func(*a, **k)
        return tree_map(lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    @staticmethod
    def _write_back(func, args, ran_on, out):
        """After an in-place op ran on a re-placed copy of its first
        argument, copy the result into the original DTensor."""
        from torch.distributed.tensor import DTensor

        if not func._schema.is_mutable or not args:
            return out
        orig, copy = args[0], ran_on[0]
        if not isinstance(orig, DTensor) or copy is orig:
            return out
        if isinstance(out, DTensor):
            copy = out
        back = copy.redistribute(orig.device_mesh, orig.placements)
        orig._local_tensor.copy_(back._local_tensor)
        return orig
