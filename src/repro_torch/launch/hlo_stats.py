"""Per-device FLOPs, bytes and collective traffic of a traced step (torch
port of ``repro.launch.hlo_stats``).

There is no HLO here: the reference parses the partitioned module that
XLA compiled, the port counts the ops a step dispatches on one device.
:class:`TraceStats` is a ``TorchDispatchMode`` that steps aside for
DTensor (it returns ``NotImplemented`` when a DTensor is among the
arguments), so DTensor first splits every op into its local op and the
collectives of its redistributions, and the mode then counts those on
this rank's local shards.  Entered above DTensor it would count the
global product instead.  Under ``FakeTensorMode`` nothing is computed
and the counts are the same.  The ops DTensor runs on global fake tensors
of its own to propagate shapes are not counted: the counter counts ops on
real tensors, or on the fake tensors of the ``fake_mode`` it is given.

* dot FLOPs: ``2 * out * contract`` of every ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv`` and ``dot`` (``einsum`` and ``matmul`` reach the
  dispatcher as these), as ``hlo_flops_bytes`` counts ``dot``;
* bytes: twice the bytes every op produces (read about equals write),
  views, collectives and waits excluded; an in-place op is charged twice
  the bytes of its other tensor operands (the update), as the reference
  charges a ``dynamic-update-slice``;
* collectives: the output bytes and the count of every functional
  collective (``_c10d_functional``) and every ``c10d`` collective, under
  the reference's names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``);
* memory: the peak of the live bytes of this device's storages, the
  tensors given to :meth:`TraceStats.track` (the step's arguments) and
  every storage an op makes, each counted until it is freed.  The
  reference reads ``memory_analysis()``; the port's counterpart is this
  peak (torch's ``MemTracker`` on torch 2.11 predicted peaks well above a
  real step's ``max_memory_allocated``).

A step is counted op by op as it runs, so a loop over layers or
microbatches is counted once per trip and there are no trip counts to
recover.
"""

from __future__ import annotations

import os
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["TraceStats", "COLLECTIVES", "trace_stats"]

_aten = torch.ops.aten

#: The reference's collective kinds, keyed by the port's op-name stems.
COLLECTIVES = {
    "all_gather": "all-gather",
    "allgather": "all-gather",
    "all_reduce": "all-reduce",
    "allreduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "alltoall": "all-to-all",
}

_PROPAGATOR = os.path.join("tensor", "_sharding_prop.py")

_FREE = {"wait_tensor", "detach", "alias", "lift_fresh", "_local_scalar_dense",
         "empty", "empty_strided", "new_empty", "new_empty_strided"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _dot_flops(func, args, out) -> int:
    """``2 * out * contract`` of a product, else 0."""
    if func in (_aten.mm.default, _aten.bmm.default, _aten.mv.default,
                _aten.dot.default):
        a = args[0]
    elif func in (_aten.addmm.default, _aten.baddbmm.default):
        a = args[1]
    else:
        return 0
    contract = a.shape[-1] if a.dim() else 1
    return 2 * out.numel() * contract


def _collective(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "_c10d_functional_autograd", "c10d"):
        return None
    name = func._schema.name.split("::")[-1]
    for stem, kind in COLLECTIVES.items():
        if stem in name:
            return kind
    return None


class TraceStats(TorchDispatchMode):
    """Counts the dot FLOPs, bytes and collective bytes of the ops this
    process dispatches below DTensor; enter it under (inside) any
    ``FakeTensorMode``.  Read the totals with :meth:`flops_bytes` and
    :meth:`collective_bytes`."""

    def __init__(self, by_op: bool = False, fake_mode=None):
        super().__init__()
        self._fake_mode = fake_mode
        #: ``{"op shapes": FLOPs}`` of every product when ``by_op``: what
        #: to compare when two counts of one step differ.
        self.by_op: dict[str, int] | None = defaultdict(int) if by_op else None
        self.flops = 0
        self.bytes = 0
        self.per_op_bytes: dict[str, int] = defaultdict(int)
        self.op_counts: dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def _foreign(self, args, kwargs) -> bool:
        """DTensor's shape propagation, not this device's work: an op on
        fake tensors of another fake mode, or one called from DTensor's
        sharding propagator (which some torch releases run under the
        caller's own fake mode)."""
        from torch._subclasses.fake_tensor import FakeTensor

        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, FakeTensor) and t.fake_mode is not self._fake_mode
               for t in leaves):
            return True
        if self._fake_mode is None:
            return False
        frame = sys._getframe(2)
        while frame is not None:
            if frame.f_code.co_filename.endswith(_PROPAGATOR):
                return True
            frame = frame.f_back
        return False

    def track(self, *tensors) -> None:
        """Count the storages of ``tensors`` (local shards of DTensors) as
        live from now on."""
        from torch.distributed.tensor import DTensor

        for t in tensors:
            self._allocated(t.to_local() if isinstance(t, DTensor) else t)

    def _allocated(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self._foreign(args, kwargs):
            return out
        kind = _collective(func)
        if kind is not None:
            self.per_op_bytes[kind] += sum(_nbytes(t) for t in tree_leaves(out))
            self.op_counts[kind] += 1
            return out
        name = func._schema.name.split("::")[-1]
        if func.is_view or name in _FREE:
            return out
        flops = _dot_flops(func, args, out) if isinstance(
            out, torch.Tensor) else 0
        self.flops += flops
        if flops and self.by_op is not None:
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            self.by_op[f"{func} {shapes}"] += flops
        if func._schema.is_mutable:
            self.bytes += 2 * sum(_nbytes(t) for t in tree_leaves(
                (args[1:], kwargs)))
        else:
            leaves = tree_leaves(out)
            self.bytes += 2 * sum(_nbytes(t) for t in leaves)
            for t in leaves:
                self._allocated(t)
        return out

    def snapshot(self):
        """The counts as they stand, for :meth:`restore`."""
        return (self.flops, self.bytes, dict(self.per_op_bytes),
                dict(self.op_counts))

    def restore(self, snap) -> None:
        """Drop what was counted since ``snap`` (an attempt whose result
        was thrown away)."""
        self.flops, self.bytes = snap[0], snap[1]
        self.per_op_bytes = defaultdict(int, snap[2])
        self.op_counts = defaultdict(int, snap[3])

    def delta(self, snap):
        """What was counted since ``snap``, for :meth:`add`."""
        now = self.snapshot()
        return (now[0] - snap[0], now[1] - snap[1],
                {k: v - snap[2].get(k, 0) for k, v in now[2].items()},
                {k: v - snap[3].get(k, 0) for k, v in now[3].items()})

    def add(self, delta) -> None:
        """Count ``delta`` (from :meth:`delta`) once more."""
        self.flops += delta[0]
        self.bytes += delta[1]
        for k, v in delta[2].items():
            self.per_op_bytes[k] += v
        for k, v in delta[3].items():
            self.op_counts[k] += v

    def flops_bytes(self) -> dict:
        """``{"flops", "bytes"}``: the per-device dot FLOPs and byte
        estimate (``hlo_flops_bytes``' keys)."""
        return {"flops": int(self.flops), "bytes": int(self.bytes)}

    def collective_bytes(self) -> dict:
        """``{"total_bytes", "per_op_bytes", "op_counts"}`` on this device
        (``collective_bytes``' keys)."""
        return {"total_bytes": int(sum(self.per_op_bytes.values())),
                "per_op_bytes": dict(self.per_op_bytes),
                "op_counts": dict(self.op_counts)}


def trace_stats(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`TraceStats`;
    returns ``(result, stats)``."""
    stats = TraceStats()
    with stats:
        out = fn(*args, **kwargs)
    return out, stats
