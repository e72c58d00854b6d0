"""Mixture-of-Experts with stable-sort token dispatch (torch port of
``repro.models.moe``).

Dispatch sorts the flat ``(token, choice)`` assignment list by expert id
with the port's co-rank merge sort (``core.mergesort.sort_key_val``):
equal expert ids keep assignment order, so the plan is deterministic,
capacity drops are latest-first, and each expert's assignments form one
contiguous segment.  On the card every tile-sized pass of that sort is a
grouped launch of ``merge_kway_tile``, and so is the router's top-k
(``core.topk.merge_topk_batch``, whose ties go to the lower expert index
as ``jax.lax.top_k``'s do).

Two dispatch semantics, as in the reference (``moe_apply(dispatch=...)``):

* ``"capacity"``: every expert gets ``ceil(T k / E * capacity_factor)``
  slots and assignments past them are dropped;
* ``"dropless"``: the sorted segments feed one product per expert
  (:func:`grouped_gemm`), zero drops.

The reference's ``lax.ragged_dot`` becomes a loop over the non-empty
segments, whose bounds reach the host once per layer: a decode step
reads only the experts its tokens chose.  A fake trace (the dry-run) has
no sizes to read and takes the balanced split instead, ``T k / E`` rows
per expert with the remainder to the first experts: the products' FLOPs
(``sum_e s_e d ff 2``) and buffer sizes do not depend on the split.  With
the experts sharded over a mesh (DTensor weights), each rank multiplies
only its own experts' segments (expert parallelism) and the outputs sum
over the expert axis (``layers.on_local_shards``).  Both combines
scatter each assignment's weighted output to its unique index ``token *
k + choice`` and sum over the choice axis -- a fixed order, with no
atomics, the order of :func:`moe_dense_reference` (the reference's
capacity combine adds into the token rows instead; the two agree within
float32 rounding).
GShard-style local dispatch (``dispatch_groups > 1``) fills per-group
capacity slots and swaps the (group, expert) slot axes with
``distributed.exchange.slot_transpose``, as the reference does.

Under a profiler :func:`moe_apply` records the spans ``moe.route``,
``moe.dispatch`` (the sort, the bounds and the group sizes' host read),
``moe.experts`` and ``moe.combine`` (``repro_torch.obs``); with obs on,
the dropless dispatch records the gauge ``moe.expert_load`` from the
sizes it has read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch import obs
from repro_torch.core.mergesort import sort_key_val
from repro_torch.core.topk import merge_topk_batch
from repro_torch.distributed.exchange import slot_transpose
from repro_torch.models.layers import (
    P,
    constrain_spec,
    get_batch_axes,
    init_mlp,
    is_dtensor,
    mlp,
    mlp_specs,
    on_local_shards,
    shard_offset,
    truncated_normal,
)

__all__ = [
    "init_moe",
    "moe_specs",
    "route_topk",
    "moe_dispatch",
    "moe_dispatch_dropless",
    "grouped_gemm",
    "moe_dense_reference",
    "moe_apply",
    "load_balance_loss",
]


def init_moe(gen, d: int, ff: int, n_experts: int, n_shared: int = 0,
             shared_ff: int | None = None, *, device, layers: tuple = (),
             dtype=torch.float32):
    """Router, routed experts (``(E, d, ff)`` gate and up, ``(E, ff, d)``
    down) and optional shared experts, stored in ``dtype``; ``layers``
    prepends stacked-layer axes to each."""
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(ff)
    p = {
        "router": truncated_normal(gen, (*layers, d, n_experts), std_in,
                                   dtype, device=device),
        "w_gate": truncated_normal(gen, (*layers, n_experts, d, ff), std_in,
                                   dtype, device=device),
        "w_up": truncated_normal(gen, (*layers, n_experts, d, ff), std_in,
                                 dtype, device=device),
        "w_down": truncated_normal(gen, (*layers, n_experts, ff, d), std_out,
                                   dtype, device=device),
    }
    if n_shared:
        p["shared"] = init_mlp(gen, d, shared_ff or ff * n_shared,
                               kind="swiglu", device=device, layers=layers,
                               dtype=dtype)
    return p


def moe_specs(n_shared: int = 0):
    """Logical specs of :func:`init_moe`'s tree (experts EP-sharded on
    ``model``)."""
    s = {"router": P("data", None), "w_gate": P("model", "data", None),
         "w_up": P("model", "data", None), "w_down": P("model", None, "data")}
    if n_shared:
        s["shared"] = mlp_specs("swiglu")
    return s


def _sort_assignments(experts: torch.Tensor):
    """Stable sort of the flat assignment indices ``token * k + choice``
    (int32) by expert id: ``(sorted_e, sorted_idx)``."""
    t, k = experts.shape
    idx = torch.arange(t * k, dtype=torch.int32, device=experts.device)
    return sort_key_val(experts.reshape(-1).to(torch.int32), idx)


def route_topk(router_logits: torch.Tensor, k: int, *,
               scoring: str = "softmax", router_bias=None):
    """Per-token top-k experts and combine weights: ``(T, E)`` logits ->
    ``(weights (T, k) float32, experts (T, k) int32)``.

    ``softmax`` (DBRX): the weights are the chosen softmax scores,
    renormalised.  ``sigmoid`` (DeepSeek-V3, aux-free): sigmoid scores
    plus ``router_bias`` select the experts; the weights are the chosen
    sigmoid scores, renormalised.
    """
    if scoring == "sigmoid":
        scores = torch.sigmoid(router_logits.float())
        select = scores + (router_bias if router_bias is not None else 0.0)
    else:
        scores = torch.softmax(router_logits.float(), dim=-1)
        select = scores
    _, experts = merge_topk_batch(select.detach(), k)
    # The weights are gathered from the scores, not taken from the top-k's
    # keys: the values are the same bits, and the gather carries the
    # router's gradient on every merge backend (the grouped launch has none).
    w = torch.gather(scores, -1, experts.long())
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w, experts


def moe_dispatch(experts: torch.Tensor, n_experts: int, capacity: int):
    """Stable-sort dispatch plan with a capacity.

    experts: ``(T, k)`` int32.  Returns ``(sorted_e, slot_token,
    slot_choice, slot_pos, keep)``: per sorted assignment its expert, its
    token, which of the token's choices it was, its position in the
    expert's segment, and whether that position is under ``capacity``.
    """
    k = experts.shape[1]
    sorted_e, sorted_idx = _sort_assignments(experts)
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left",
                                   out_int32=True)
    slot_pos = torch.arange(sorted_e.numel(), dtype=torch.int32,
                            device=experts.device) - seg_start
    keep = slot_pos < capacity
    return sorted_e, sorted_idx // k, sorted_idx % k, slot_pos, keep


def moe_dispatch_dropless(experts: torch.Tensor, n_experts: int):
    """Exact-cut dispatch plan: ``(sorted_e, sorted_idx, group_sizes)``,
    the stable-sorted expert ids, each sorted slot's assignment index
    ``token * k + choice``, and the ``(E,)`` int32 segment sizes (they sum
    to ``T * k``: nothing is dropped)."""
    sorted_e, sorted_idx = _sort_assignments(experts)
    bounds = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, dtype=torch.int32,
                               device=experts.device),
        side="left", out_int32=True)
    return sorted_e, sorted_idx, bounds[1:] - bounds[:-1]


def _segments(group_sizes, rows: int) -> list[tuple[int, int, int]]:
    """``(expert, first row, end row)`` of every non-empty group: the
    sizes reach the host here, once.  Fake sizes (a fake trace) have no
    values: ``rows`` rows split evenly, the remainder to the first
    experts."""
    if is_fake(group_sizes):
        base, rem = divmod(rows, group_sizes.shape[0])
        sizes = [base + (e < rem) for e in range(group_sizes.shape[0])]
    else:
        if is_dtensor(group_sizes):
            group_sizes = group_sizes.full_tensor()
        sizes = torch.as_tensor(group_sizes).tolist()
    out, lo = [], 0
    for e, n in enumerate(sizes):
        if n:
            out.append((e, lo, lo + n))
        lo += n
    return out


def _segment_gemm(x: torch.Tensor, w: torch.Tensor, segments) -> torch.Tensor:
    """One product per segment, concatenated (autograd passes through it),
    then zeros for the rows past the last segment."""
    if is_dtensor(w):
        return _segments_ep(x, [w], segments, torch.matmul)
    end = segments[-1][2] if segments else 0
    parts = [x[lo:hi] @ w[e] for e, lo, hi in segments]
    parts.append(x.new_zeros((x.shape[0] - end, w.shape[-1])))
    return torch.cat(parts)


def _segments_ep(x, ws, segments, fn):
    """``fn(x[lo:hi], *(w[e] for w in ws))`` for every segment, with the
    experts of the DTensor weights ``ws`` sharded over the mesh axes their
    placements name on dim 0: each rank gathers the rows and runs only its
    own experts' segments, so the result is a partial sum over those axes
    (other rows are zeros there)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ws[0].device_mesh
    ep = [p == Shard(0) for p in ws[0].placements]
    first = shard_offset(ws[0], 0)  # this rank's first expert
    width = ws[-1].shape[-1]

    def run(xs, *local):
        parts, at = [], 0
        for e, lo, hi in segments:
            if 0 <= e - first < local[0].shape[0]:
                y = fn(xs[lo:hi], *(w[e - first] for w in local))
                parts += [xs.new_zeros((lo - at, y.shape[-1])), y]
                at = hi
        parts.append(xs.new_zeros((xs.shape[0] - at, width)))
        return torch.cat(parts)

    w_on = [Shard(0) if s else Replicate() for s in ep]
    return on_local_shards(
        run, mesh, [(x, [Replicate()] * mesh.ndim), *((w, w_on) for w in ws)],
        [Partial() if s else Replicate() for s in ep])


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes):
    """``(m, d)`` rows grouped by expert times ``(g, d, f)`` stacked
    weights -> ``(m, f)``: row ``i`` of group ``e`` gets ``x[i] @ w[e]``.
    Rows ``[sum(gs[:e]), sum(gs[:e+1]))`` are group ``e``; rows past
    ``sum(gs)`` give zeros.  One product per non-empty group."""
    return _segment_gemm(x, w, _segments(group_sizes, x.shape[0]))


def _expert_ffn(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _dropless_moe(params, xt, w, experts, n_experts, top_k):
    """Expert FFN over the exact sorted segments; the combine scatters
    through the unique ``sorted_idx`` and sums over the choice axis."""
    t, d = xt.shape
    dt = xt.dtype
    with obs.span("moe.dispatch"):
        _, sorted_idx, group_sizes = moe_dispatch_dropless(experts, n_experts)
        sorted_idx = sorted_idx.long()
        segments = _segments(group_sizes, sorted_idx.shape[0])
        if obs.enabled() and segments:
            # the largest expert's rows over the mean, from the host sizes
            obs.gauge("moe.expert_load",
                      max(hi - lo for _, lo, hi in segments) * n_experts
                      / sorted_idx.shape[0], experts=n_experts, top_k=top_k)
        xs = xt[sorted_idx // top_k]  # (T*k, d) rows in expert order
    with obs.span("moe.experts"):
        ws = [params[n].to(dt) for n in ("w_gate", "w_up", "w_down")]
        if is_dtensor(ws[0]):
            ys = _segments_ep(xs, ws, segments, _expert_ffn)
        else:
            gate = _segment_gemm(xs, ws[0], segments)
            up = _segment_gemm(xs, ws[1], segments)
            ys = _segment_gemm(F.silu(gate) * up, ws[2], segments)
    with obs.span("moe.combine"):
        token_w = w.reshape(-1)[sorted_idx].to(dt)
        out = xt.new_zeros((t * top_k, d))
        out[sorted_idx] = ys * token_w[:, None]
        return out.reshape(t, top_k, d).sum(dim=1)


def _shared(params, x, t, d):
    return mlp(params["shared"], x, kind="swiglu").reshape(t, d)


def moe_dense_reference(params, x: torch.Tensor, *, n_experts: int,
                        top_k: int, scoring: str = "softmax"):
    """All-experts dense reference: every expert runs every token (a loop
    of plain products), contributions stacked ``(T, k, d)`` and summed over
    the choice axis."""
    b, s, d = x.shape
    dt = x.dtype
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    logits = xt @ params["router"].to(dt)
    w, experts = route_topk(logits, top_k, scoring=scoring)
    ys = torch.stack([
        (F.silu(xt @ params["w_gate"][e].to(dt)) * (xt @ params["w_up"][e].to(dt)))
        @ params["w_down"][e].to(dt)
        for e in range(n_experts)])  # (E, T, d)
    rows = torch.arange(t, device=x.device)
    contrib = torch.stack(
        [ys[experts[:, c].long(), rows] * w[:, c, None].to(dt)
         for c in range(top_k)], dim=1)  # (T, k, d)
    out = contrib.sum(dim=1)
    if "shared" in params:
        out = out + _shared(params, x, t, d)
    return out.reshape(b, s, d)


def _dispatch_combine_one_group(xt, w, experts, n_experts, top_k, capacity):
    """Dispatch one group's tokens into ``(E, C, d)`` slots; returns
    ``(ex_in, combine)``.  Dropped assignments land in a spare row that is
    cut off, and contribute zeros to the combine."""
    t, d = xt.shape
    n_slots = n_experts * capacity
    sorted_e, slot_token, slot_choice, slot_pos, keep = moe_dispatch(
        experts, n_experts, capacity)
    flat_slot = sorted_e.long() * capacity + slot_pos
    flat_slot = torch.where(keep, flat_slot, n_slots)
    ex_in = xt.new_zeros((n_slots + 1, d))
    ex_in[flat_slot] = xt[slot_token.long()]
    ex_in = ex_in[:n_slots].reshape(n_experts, capacity, d)
    assignment = (slot_token * top_k + slot_choice).long()  # a permutation

    def combine(ex_out):
        flat_out = ex_out.reshape(n_slots, d)
        token_w = w.reshape(-1)[assignment].to(xt.dtype)
        contrib = torch.where(
            keep[:, None],
            flat_out[flat_slot.clamp(max=n_slots - 1)] * token_w[:, None],
            0.0)
        out = xt.new_zeros((t * top_k, d))
        out[assignment] = contrib
        return out.reshape(t, top_k, d).sum(dim=1)

    return ex_in, combine


def _capacity_moe(params, xt, w, experts, n_experts, top_k, capacity, g):
    """Capacity dispatch over ``g`` local groups of ``t / g`` tokens (one
    group: the whole batch).

    All groups dispatch at once: group ``i``'s expert ``e`` is the virtual
    expert ``i * E + e`` of one stable sort, whose segments are the
    groups' own sorted segments, so slot positions, capacity and the
    latest-first drops are per group.  The ``(g, E, C, d)`` slots swap to
    ``(E, g, C, d)`` for one batched product per expert and back.
    """
    t, d = xt.shape
    dt = xt.dtype
    ba = get_batch_axes()
    constrain = constrain_spec if ba is not None else None
    with obs.span("moe.dispatch"):
        group_of = torch.arange(t, dtype=torch.int32,
                                device=xt.device) // (t // g)
        ex_in, combine = _dispatch_combine_one_group(
            xt, w, experts + group_of[:, None] * n_experts, g * n_experts,
            top_k, capacity)
        # groups on the batch axes, experts on the EP axis: with a mesh,
        # the swap is the balanced all_to_all (equal bytes per peer)
        ex_g = slot_transpose(ex_in.reshape(g, n_experts, capacity, d),
                              constrain=constrain,
                              in_spec=(ba, None, None, None),
                              out_spec=("model", ba, None, None))
        ex_g = ex_g.reshape(n_experts, g * capacity, d)  # (E, g*C, d)
    with obs.span("moe.experts"):
        gate = torch.bmm(ex_g, params["w_gate"].to(dt))
        up = torch.bmm(ex_g, params["w_up"].to(dt))
        ex_out = torch.bmm(F.silu(gate) * up, params["w_down"].to(dt))
    with obs.span("moe.combine"):
        ex_out = slot_transpose(ex_out.reshape(n_experts, g, capacity, d),
                                constrain=constrain,
                                in_spec=("model", ba, None, None),
                                out_spec=(ba, None, None, None))
        return combine(ex_out.reshape(g * n_experts, capacity, d))


def moe_apply(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, scoring: str = "softmax",
              dispatch_groups: int = 1,
              dispatch: str = "capacity"):
    """Full MoE layer on ``(b, s, d)`` activations.

    ``dispatch``: ``"capacity"`` (fixed ``capacity_factor`` slots,
    overflow dropped latest-first) or ``"dropless"`` (exact segments, zero
    drops; ``capacity_factor`` and ``dispatch_groups`` are ignored).

    ``dispatch_groups > 1`` is GShard-style local dispatch: the tokens
    split into ``g`` groups (``g`` the largest divisor of the token count
    not above ``dispatch_groups``), each group sorts and fills its own
    ``(E, C, d)`` capacity slots, and the ``(g, E)`` slot axes swap for
    the expert products and back (``slot_transpose``).  Capacity is per
    group.
    """
    if dispatch not in ("capacity", "dropless"):
        raise ValueError(f"moe_apply: unknown dispatch {dispatch!r} "
                         "(expected 'capacity' or 'dropless')")
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    xt = x.reshape(t, d)
    with obs.span("moe.route"):
        logits = xt @ params["router"].to(dt)
        w, experts = route_topk(logits, top_k, scoring=scoring)

    if dispatch == "dropless":
        out = _dropless_moe(params, xt, w, experts, n_experts, top_k)
    else:
        g = max(1, min(dispatch_groups, t))
        while t % g:
            g -= 1
        tg = t // g
        capacity = max(int(math.ceil(tg * top_k / n_experts * capacity_factor)),
                       top_k)
        out = _capacity_moe(params, xt, w, experts, n_experts, top_k,
                            capacity, g)
    if "shared" in params:
        with obs.span("moe.combine"):
            out = out + _shared(params, x, t, d)
    return out.reshape(b, s, d)


def load_balance_loss(router_logits: torch.Tensor, experts: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss (off for sigmoid/aux-free)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(experts[:, 0].long(), n_experts).float().mean(dim=0)
    return n_experts * torch.sum(me * ce)
