"""The collectives of the distributed layer, in the reference's SPMD idiom.

The reference's distributed code runs inside ``shard_map`` and names a
mesh axis; the port's runs in every rank of a ``torch.distributed``
process group and takes the group in the same position.  This module is
the one place that maps the reference's collectives onto
``torch.distributed`` (the counterpart of ``repro.core.compat``'s
``axis_size``):

=================================  =========================================
reference                          here
=================================  =========================================
``compat.axis_size(axis)``         :func:`size` (``dist.get_world_size``)
``lax.axis_index(axis)``           :func:`index` (``dist.get_rank``)
``lax.all_gather(x, axis)``        :func:`all_gather` -> ``(p, *x.shape)``
``... tiled=True``                 :func:`all_gather_tiled`
``lax.psum`` / ``lax.pmax``        :func:`psum` / :func:`pmax` (on a copy:
                                   the reference's are functional)
``lax.all_to_all(tiled=True)``     :func:`all_to_all` (equal slots) and
                                   :func:`ragged_all_to_all` (real rows only)
=================================  =========================================

The group's backend decides where the bytes go: gloo (CPU ranks, or
several ranks sharing one card) and NCCL both take the tensors where they
lie; no collective here stages through the host.  While ``repro_torch.obs``
is enabled every collective counts the bytes it delivers to this rank as
``collectives.bytes`` (labels ``op``, ``dtype``, ``elements``), and
:func:`host_ints` counts each read of a ragged exchange's split sizes on
the host as ``collectives.host_reads``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs

__all__ = [
    "size",
    "index",
    "all_gather",
    "all_gather_tiled",
    "psum",
    "pmax",
    "all_to_all",
    "ragged_all_to_all",
    "host_ints",
]


def size(group) -> int:
    """Ranks in ``group`` (the reference's ``axis_size``)."""
    return dist.get_world_size(group)


def index(group) -> int:
    """This rank's index in ``group`` (the reference's ``axis_index``)."""
    return dist.get_rank(group)


def _count(op: str, t: torch.Tensor) -> None:
    if obs.enabled():
        obs.counter("collectives.bytes", t.numel() * t.element_size(), op=op,
                    dtype=str(t.dtype).removeprefix("torch."),
                    elements=t.numel())


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``(p, *x.shape)``."""
    x = x.contiguous()
    out = x.new_empty((size(group), *x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    _count("all_gather", out)
    return out


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the first axis."""
    return all_gather(x, group).reshape(-1, *x.shape[1:])


def _all_reduce(x: torch.Tensor, group, op, name: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    _count(name, out)
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``x``, on a copy."""
    return _all_reduce(x, group, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of every rank's ``x``, on a copy."""
    return _all_reduce(x, group, dist.ReduceOp.MAX, "pmax")


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """Slot transpose over the ranks: ``send`` is ``(p, cap, ...)`` with row
    ``d`` bound for rank ``d``; row ``src`` of the result is what rank
    ``src`` sent here.  Every slot travels whole."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count("all_to_all", recv)
    return recv


def host_ints(*tensors: torch.Tensor) -> list[list[int]]:
    """The integer vectors ``tensors`` (equal lengths) on the host, in one
    read: a ragged exchange's split sizes, which ``all_to_all_single``
    takes as Python integers."""
    if obs.enabled():
        obs.counter("collectives.host_reads", 1)
    return torch.stack(tensors).tolist()


def ragged_all_to_all(send: torch.Tensor, send_lengths: list[int],
                      recv_lengths: list[int], group, fill) -> torch.Tensor:
    """:func:`all_to_all` that ships only the heads of the slots.

    Row ``d`` of ``send`` holds ``send_lengths[d]`` real rows for rank
    ``d``; ``recv_lengths[src]`` rows arrive from rank ``src`` (the
    sender's ``send_lengths``).  The result keeps the slot layout
    ``(p, cap, ...)``: row ``src`` head-packed, its tail ``fill`` -- the
    senders' padding value, so the result equals the whole-slot
    transpose's wherever the senders padded with ``fill``.  The split
    sizes are host integers: the caller reads them from the device once.
    """
    wire = torch.cat([send[d, :n] for d, n in enumerate(send_lengths)])
    got = wire.new_empty((sum(recv_lengths), *send.shape[2:]))
    dist.all_to_all_single(got, wire, recv_lengths, send_lengths, group=group)
    _count("ragged_all_to_all", got)
    recv = torch.full_like(send, fill)
    for src, part in enumerate(torch.split(got, recv_lengths)):
        recv[src, : part.shape[0]] = part
    return recv
