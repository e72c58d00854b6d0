"""Balanced ``all_to_all`` exchange built on exact splitters (torch port of
``repro.distributed.exchange``).

Because the splitters are *exact* co-ranks (the paper's perfect balance),
every rank's output block is exactly ``N/p`` elements: the exchange is
balanced by construction.  What is *not* balanced is the per-(sender,
receiver) segment: on adversarial data (an already-sorted array) one peer
pair carries a whole ``N/p`` block while the others carry nothing.  The
exchange keeps the reference's fixed-capacity slots as its interface:

* each sender packs, for every peer, a ``(capacity,)`` slot holding the
  co-rank segment of its run destined for that peer (head = real
  elements, tail = order-preserving sentinel padding);
* one ``all_to_all`` transposes the ``(p, capacity)`` slot matrix, so
  receiver ``d`` ends with slot row ``r`` = the segment sent by run
  ``r``: rows arrive in rank order, which is the k-way merge's tie-break
  order, so stability and duplicates survive the wire;
* a ``lengths`` sideband (``p`` int32 a rank) tells the ragged k-way
  merge where real data ends, so sentinel values that also occur in the
  payload are never confused with padding.

On the wire the port ships only the real rows: ``all_to_all_single``
takes uneven split sizes, which it needs as host integers, so each ragged
exchange reads its sideband on the host once.  The received slots are
rebuilt with the senders' padding, so inputs and outputs keep the
reference's layout exactly.  ``capacity`` defaults to the worst-case-safe
``N/p``; a smaller one truncates segments (MoE-style capacity dropping,
accounted by the sideband).
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.mergesort import sentinel_max
from repro_torch.distributed import _collectives as C

__all__ = [
    "balanced_exchange",
    "exchange_block",
    "slot_transpose",
    "sentinel_max",
    "window",
    "window_rows",
]


def _window_index(n: int, lo, hi, s: int, device):
    """Indices ``lo + t`` (clamped into ``x``) and the mask ``t < hi - lo``
    of the ``(..., s)`` windows of the bounds ``lo``/``hi`` (shape
    ``(...)``)."""
    lo = torch.as_tensor(lo, device=device)[..., None]
    hi = torch.as_tensor(hi, device=device)[..., None]
    t = torch.arange(s, dtype=lo.dtype, device=device)
    idx = torch.clamp(lo + t, 0, max(n - 1, 0))
    return idx, t < hi - lo


def window(x: torch.Tensor, lo, hi, s: int) -> torch.Tensor:
    """``x[lo:hi]`` placed at the head of a length-``s`` buffer, tail =
    sentinel.  ``lo``/``hi`` are ints or tensors of one shape ``(...)``
    (the reference's ``vmap`` over windows): the result is ``(..., s)``.
    ``hi - lo`` must be ``<= s`` for the copy to be lossless."""
    idx, mask = _window_index(x.shape[0], lo, hi, s, x.device)
    fill = sentinel_max(x.dtype).item()
    if x.shape[0] == 0:
        return torch.full(mask.shape, fill, dtype=x.dtype, device=x.device)
    return torch.where(mask, x[idx], fill)


def window_rows(x: torch.Tensor, lo, hi, s: int) -> torch.Tensor:
    """Rows ``x[lo:hi]`` head-packed into an ``(..., s, d)`` buffer, tail
    zero-filled: the payload analogue of :func:`window` (payload rows past
    the segment are dead, and zeros keep them inert under scatter-add
    combines)."""
    n, d = x.shape
    idx, mask = _window_index(n, lo, hi, s, x.device)
    if n == 0:
        return x.new_zeros((*mask.shape, d))
    return torch.where(mask[..., None], x[idx], 0)


def balanced_exchange(send: torch.Tensor, lengths: torch.Tensor | None = None,
                      group=None, *, fill=0, constrain=None, in_spec=None,
                      out_spec=None):
    """Ragged balanced ``all_to_all``: slots + an exact lengths sideband.

    ``send`` is a ``(p, capacity, ...)`` slot buffer, row ``d``
    head-packed with ``lengths[d]`` real elements for rank ``d`` and
    padded with ``fill`` (the sentinel for key windows, zero for payload
    rows).  Returns ``(recv, recv_lengths)``: ``recv`` row ``src`` is the
    segment rank ``src`` sent here (head-packed, same capacity, tail
    ``fill``), and ``recv_lengths`` the transposed sideband: entry
    ``src`` is sender ``src``'s ``lengths[me]``, so raggedness is
    *accounted*, never inferred.

    ``lengths=None`` is the static-shape special case: every slot travels
    whole, no sideband, ``recv_lengths`` is ``None`` (``slot_transpose``).
    ``group=None`` is the form without explicit collectives: the swap of
    the two leading (peer, slot) axes, under the sharding constraints
    ``constrain(x, *spec)`` of ``in_spec`` before it and ``out_spec``
    after it (``models.layers.constrain_spec``, as the reference passes
    it).  On DTensors sharded with groups on the batch axes and experts on
    ``model``, the constraints make the swap one redistribution of equal
    bytes per peer; without a mesh they change nothing.
    """
    if group is None:
        if lengths is not None:
            raise ValueError(
                "balanced_exchange: the ragged form (lengths sideband) "
                "needs a process group")
        if constrain is not None and in_spec is not None:
            send = constrain(send, *in_spec)
        recv = send.transpose(0, 1)
        if constrain is not None and out_spec is not None:
            recv = constrain(recv, *out_spec)
        return recv, None
    if lengths is None:
        return C.all_to_all(send, group), None
    lengths = lengths.to(torch.int32)
    recv_lengths = C.all_to_all(lengths, group)
    sent, got = C.host_ints(lengths, recv_lengths)
    return C.ragged_all_to_all(send, sent, got, group, fill), recv_lengths


def exchange_block(run_shard: torch.Tensor, cuts: torch.Tensor, group,
                   capacity: int | None = None):
    """Ship every rank its exact output block's segments.

    Every rank of ``group`` calls it.  ``cuts`` is this rank's ``(2, p)``
    cut matrix from ``distributed_co_rank_kway``: row 0/1 the cut vectors
    of its block's lower/upper rank.  Rank ``r`` must *send* according to
    everyone else's cuts restricted to run ``r``, so the cut matrices are
    shared first (one ``all_gather`` of ``2 p^2`` int32, the only
    metadata collective the exchange adds).

    Returns ``(segments, lengths)``: ``segments`` is ``(p, capacity)``,
    row ``src`` the co-rank segment of run ``src`` belonging to this
    rank's block (head-packed, sentinel tail), and ``lengths`` the
    ``(p,)`` real segment lengths (``lengths.sum()`` is the block size,
    the perfect-balance guarantee).

    ``capacity`` bounds the per-peer slot; ``None`` means the safe
    ``run_shard.shape[0]`` (= ``N/p``).  A smaller capacity truncates
    oversized segments: the receiver's ragged merge then drops the
    missing elements and zero-fills its block tail (wrong for an exact
    sort, see ``sharded_merge_kway``).
    """
    w = run_shard.shape[0]
    r = C.index(group)
    cap = w if capacity is None else int(capacity)
    with obs.span("repro.exchange_block"):
        all_cuts = C.all_gather(cuts.to(torch.int32), group)  # (p, 2, p)
        lo_mine = all_cuts[:, 0, r]  # (p,) peers' segment bounds in MY run
        hi_mine = all_cuts[:, 1, r]
        send = window(run_shard, lo_mine, hi_mine, cap)  # row d: for peer d
        # Sender r's entry d is cuts_d[1, r] - cuts_d[0, r], so receiver
        # d's entry r equals its own cut difference (clipped to cap).
        send_lengths = torch.clamp(hi_mine - lo_mine, max=cap)
        segments, lengths = balanced_exchange(
            send, send_lengths, group,
            fill=sentinel_max(run_shard.dtype).item())
        if obs.enabled():
            p = segments.shape[0]
            itemsize = run_shard.element_size()
            obs.gauge("exchange.send_lengths", send_lengths, capacity=cap,
                      device=r)
            obs.gauge("exchange.peer_bytes", lengths * itemsize,
                      capacity=cap, itemsize=itemsize, device=r)
            # Proposition 2 over the wire: real elements received == the
            # receiver's exact output block (N/p on the sort path).
            obs.gauge("exchange.block_elements", lengths.sum(), device=r)
            obs.gauge("exchange.padding_slots", p * cap - lengths.sum(),
                      capacity=cap, device=r)
            obs.gauge("exchange.length_skew", lengths.max() - lengths.min(),
                      device=r)
    return segments, lengths


def slot_transpose(x: torch.Tensor, constrain=None, in_spec=None,
                   out_spec=None) -> torch.Tensor:
    """Swap the two leading (peer-group, slot) axes of a capacity-padded
    dispatch buffer: the form of the balanced exchange without explicit
    collectives (MoE capacity dispatch over local groups).  ``constrain``
    is a ``(x, *spec) -> x`` sharding constraint
    (``repro_torch.models.layers.constrain_spec``), ``in_spec`` /
    ``out_spec`` the spec entries before / after the swap; ``None`` skips
    them."""
    recv, _ = balanced_exchange(x, constrain=constrain, in_spec=in_spec,
                                out_spec=out_spec)
    return recv
