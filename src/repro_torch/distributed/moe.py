"""Dropless expert-parallel MoE dispatch on exact segment cuts (torch port
of ``repro.distributed.moe``).

Capacity-factor dispatch over-provisions every expert with a fixed slot
block and drops the tokens past it.  The co-rank machinery removes the
trade: the stable sort by expert id makes per-expert segments contiguous,
``distributed_segment_cuts`` resolves every global segment boundary in one
``O(p E)``-scalar collective round, and the ragged ``balanced_exchange``
ships exactly those segments with a lengths sideband.  No token is dropped
at any skew.

The exchange keeps ``(p, capacity)`` slots as its interface.
``capacity=None`` is the worst-case-safe local assignment count ``n =
t_loc * top_k``, which guarantees zero drops; a smaller ``capacity``
trades memory for *accounted* truncation: the cut matrix says how many
assignments each peer planned to send, the sideband how many arrived, and
the difference is the drop count.

Pipeline (every rank of the group, with its own tokens):

1. stable-sort the flat ``(t_loc * k,)`` expert ids
   (``core.mergesort.sort_key_val``: ties keep assignment order);
2. ``distributed_segment_cuts`` -> the ``(p, E + 1)`` cut matrix, the
   whole send/receive schedule;
3. slice the sorted run at the expert-ownership boundaries (expert ``e``
   lives on rank ``e // ceil(E/p)``) and ``balanced_exchange`` the
   segments with their sideband;
4. merge the ``p`` received sorted runs (the ragged k-way merge, on the
   card ``merge_kway_tile``): rank order is the stable tie-break, so the
   grouped rows are in the globally stable (expert, rank, position) order
   -- the order of a single process's stable sort of all the tokens;
5. one product per owned expert (``models.moe.grouped_gemm``) over the
   merged rows with ``group_sizes`` counted from the received runs;
6. combine: the reverse exchange sends each result back to its
   ``(owner, position)`` slot, and the weighted results scatter to tokens
   through the *unique* sorted-assignment indices before the sum over the
   choice axis -- the order of the single-process dropless layer, hence
   bit for bit with it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.mergesort import sort_key_val
from repro_torch.distributed import _collectives as C
from repro_torch.distributed.api import ragged_merge
from repro_torch.distributed.exchange import (
    balanced_exchange,
    window,
    window_rows,
)
from repro_torch.distributed.splitters import distributed_segment_cuts

__all__ = [
    "DroplessPlan",
    "dropless_dispatch",
    "dropless_combine",
    "dropless_moe_ffn",
]


class DroplessPlan(NamedTuple):
    """Everything ``dropless_combine`` and the drop accounting need.

    ``xg``/``group_sizes`` feed the grouped products; the rest reverses
    the exchange.  ``planned - recv_lengths`` (both per source rank) is
    the exact per-peer drop count: zero when ``capacity`` was ``None``.
    """

    xg: torch.Tensor  # (p * cap, d) rows grouped by owned expert
    group_sizes: torch.Tensor  # (e_per,) rows per owned expert
    perm: torch.Tensor  # (p * cap,) merged position -> recv slot row
    valid: torch.Tensor  # (p * cap,) bool, real (non-padding) merged rows
    recv_lengths: torch.Tensor  # (p,) real rows received per source rank
    planned: torch.Tensor  # (p,) rows each source planned to send me
    send_lo: torch.Tensor  # (p,) my sorted run's segment start per peer
    send_lengths: torch.Tensor  # (p,) segment lengths actually sent
    sorted_e: torch.Tensor  # (n,) my expert ids, stable-sorted
    sorted_idx: torch.Tensor  # (n,) my assignment index (token * k + choice)


def _expert_ownership(n_experts: int, p: int):
    """Static contiguous expert -> rank map: ``e_per = ceil(E/p)`` experts
    a rank, boundaries clipped to ``E`` (trailing ranks may own fewer;
    ``group_sizes`` handles it).  Returns ``(e_per, [p + 1 bounds])``."""
    e_per = -(-n_experts // p)
    return e_per, [min(q * e_per, n_experts) for q in range(p + 1)]


def dropless_dispatch(xt: torch.Tensor, experts: torch.Tensor, n_experts: int,
                      group, capacity: int | None = None) -> DroplessPlan:
    """Exact-cut dispatch of this rank's tokens to the experts' owners.

    ``xt`` is ``(t_loc, d)`` local tokens, ``experts`` ``(t_loc, k)``
    routing choices.  Returns a :class:`DroplessPlan` whose ``xg`` rows
    are this rank's *received* assignments grouped by owned expert, ready
    for the grouped products with ``group_sizes``.  ``capacity=None`` is
    the worst-case-safe per-peer slot ``n = t_loc * k``; smaller values
    keep each (sender, owner) segment's earliest rows, the overflow
    visible as ``plan.planned - plan.recv_lengths``.
    """
    p, r = C.size(group), C.index(group)
    dev = xt.device
    t, k = experts.shape
    n = t * k
    d = xt.shape[-1]
    cap = n if capacity is None else int(capacity)

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    sorted_e, sorted_idx = sort_key_val(experts.reshape(-1).to(torch.int32),
                                        idx)
    xs = xt[sorted_idx.long() // k]  # (n, d) rows in expert order

    # The complete schedule: one collective round of O(p * E) scalars.
    cuts = distributed_segment_cuts(sorted_e, n_experts, group)
    e_per, owner_bounds = _expert_ownership(n_experts, p)
    send_lo = cuts[r, owner_bounds[:-1]]  # (p,)
    send_hi = cuts[r, owner_bounds[1:]]
    send_lengths = torch.clamp(send_hi - send_lo, max=cap)

    send_x = window_rows(xs, send_lo, send_hi, cap)  # (p, cap, d)
    send_e = window(sorted_e, send_lo, send_hi, cap)  # sentinel tails: sorted
    recv_x, recv_lengths = balanced_exchange(send_x, send_lengths, group)
    recv_e, _ = balanced_exchange(send_e, group=group)

    # What each source *planned* to send me, from the cuts: the drop
    # accounting, exact by construction.
    lob, hib = owner_bounds[r], owner_bounds[r + 1]
    planned = cuts[:, hib] - cuts[:, lob]  # (p,)

    # Merge the p received sorted runs; rank order is the stable
    # tie-break, so the merged order is the global (expert, rank, pos).
    row_ids = torch.arange(p * cap, dtype=torch.int32,
                           device=dev).reshape(p, cap)
    _, perm = ragged_merge(recv_e, recv_lengths, p * cap, vals=row_ids)
    valid = torch.arange(p * cap, device=dev) < recv_lengths.sum()
    xg = torch.where(valid[:, None], recv_x.reshape(p * cap, d)[perm.long()],
                     0)

    # Per-owned-expert group sizes from the RECEIVED rows (clipped by the
    # sideband, so padding never counts): exact under truncation too.
    seg_vals = lob + torch.arange(e_per + 1, dtype=torch.int32, device=dev)
    rl = engine.value_cut_counts(recv_e, seg_vals.expand(p, -1).contiguous(),
                                 recv_lengths[:, None])  # (p, e_per + 1)
    group_sizes = (rl[:, 1:] - rl[:, :-1]).sum(dim=0, dtype=torch.int32)

    if obs.enabled():
        obs.gauge("moe.planned_per_source", planned, capacity=cap, device=r)
        obs.gauge("moe.recv_per_source", recv_lengths, device=r)
        # Exact overflow accounting: planned minus arrived, summed -- zero
        # at the worst-case-safe default capacity, never silent otherwise.
        obs.counter("moe.overflow", (planned - recv_lengths).sum(),
                    capacity=cap, device=r)
        obs.gauge("moe.group_sizes", group_sizes, n_experts=n_experts,
                  device=r)
        mean = torch.clamp(group_sizes.sum().float() / e_per, min=1e-9)
        obs.gauge("moe.routing_skew", group_sizes.max().float() / mean,
                  device=r)

    return DroplessPlan(xg=xg, group_sizes=group_sizes, perm=perm, valid=valid,
                        recv_lengths=recv_lengths, planned=planned,
                        send_lo=send_lo, send_lengths=send_lengths,
                        sorted_e=sorted_e, sorted_idx=sorted_idx)


def dropless_combine(ys: torch.Tensor, w: torch.Tensor, plan: DroplessPlan,
                     group, top_k: int) -> torch.Tensor:
    """Return expert outputs to their source tokens and combine.

    ``ys`` is ``(p * cap, d)`` aligned with ``plan.xg``'s rows; ``w`` is
    this rank's ``(t_loc, top_k)`` combine weights.  The reverse exchange
    sends back exactly the rows received (the sideband is
    ``plan.recv_lengths``), so each assignment's result lands at its
    ``(owner, position)`` slot; dropped assignments contribute zero.  The
    final scatter through the *unique* sorted-assignment indices, then the
    sum over the choice axis, is the single-process dropless order.
    """
    p = plan.recv_lengths.shape[0]
    n = plan.sorted_e.shape[0]
    cap = plan.perm.shape[0] // p
    d = ys.shape[-1]

    # Un-merge to the received-slot layout, then reverse the exchange.
    back = ys.new_zeros((p * cap + 1, d))
    back[torch.where(plan.valid, plan.perm, p * cap).long()] = ys
    ret, _ = balanced_exchange(back[:-1].reshape(p, cap, d),
                               plan.recv_lengths, group)
    # ret[q] = results for the segment I sent to peer q.

    e_per = plan.group_sizes.shape[0]
    owner = torch.clamp(plan.sorted_e // e_per, 0, p - 1).long()
    pos = torch.arange(n, device=ys.device) - plan.send_lo[owner]
    kept = pos < plan.send_lengths[owner]
    res = torch.where(
        kept[:, None],
        ret.reshape(p * cap, d)[owner * cap + torch.clamp(pos, 0, cap - 1)],
        0)  # (n, d) per sorted assignment

    sorted_idx = plan.sorted_idx.long()
    token_w = w.reshape(-1)[sorted_idx].to(ys.dtype)
    out = ys.new_zeros((n, d))
    out[sorted_idx] = res * token_w[:, None]
    return out.reshape(n // top_k, top_k, d).sum(dim=1)  # (t_loc, d)


def dropless_moe_ffn(xt: torch.Tensor, experts: torch.Tensor, w: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, n_experts: int, group,
                     capacity: int | None = None):
    """Full dropless expert-parallel FFN for this rank's tokens.

    The weight arguments are this rank's *owned* shards ``(e_per, d,
    ff)`` / ``(e_per, ff, d)``.  Returns ``(out, plan)``: ``out`` is
    ``(t_loc, d)``; ``plan`` carries the exact drop accounting (all zeros
    for ``capacity=None``).
    """
    from repro_torch.models.moe import grouped_gemm

    dt = xt.dtype
    with obs.span("repro.dropless_moe_ffn"):
        with obs.span("repro.dropless_dispatch"):
            plan = dropless_dispatch(xt, experts, n_experts, group, capacity)
        with obs.span("repro.moe_grouped_gemm"):
            gate = grouped_gemm(plan.xg, w_gate.to(dt), plan.group_sizes)
            up = grouped_gemm(plan.xg, w_up.to(dt), plan.group_sizes)
            ys = grouped_gemm(F.silu(gate) * up, w_down.to(dt),
                              plan.group_sizes)
        with obs.span("repro.dropless_combine"):
            out = dropless_combine(ys, w, plan, group, experts.shape[-1])
    return out, plan
