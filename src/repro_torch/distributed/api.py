"""Sharded merge/sort entry points (torch port of ``repro.distributed.api``):
one ``strategy=`` switch, three ways to move (or not move) the data.

All strategies use the *same* exact co-rank partition -- every rank
produces exactly its ``N/p``-element output block -- and differ only in
memory and wire traffic:

* ``"allgather"`` -- replicate the runs with one ``all_gather`` (``O(N)``
  memory and receive traffic a rank), then every rank co-ranks and merges
  its block locally.
* ``"corank"`` (pairwise merge only) -- the search is distributed
  (``O(log)`` rounds of ``O(p)``-scalar collectives), then the data for
  the local windows is still fetched with one ``all_gather``.
* ``"exchange"`` -- the no-replication path: distributed k-way co-rank
  splitters, then a balanced ``all_to_all`` ships each rank exactly its
  block's segments (``O(N/p)`` real payload a rank), then one local
  ragged k-way merge.

Every rank of a ``torch.distributed`` group calls these functions with its
shard (the reference calls them inside ``shard_map``).  The local merges
go through the port's backend dispatch: on CUDA tensors the ragged k-way
merge is ``ops.merge_window`` (the ``merge_kway_tile`` kernel), the
pairwise one ``ops.stable_merge`` (``merge_tile``), and the local sort's
tile-sized passes the grouped launch of ``merge_kway_tile``.
:func:`sharded_sort_host` pads uneven sizes with sentinels and strips
them again.  The library spawns no process: the caller starts the ranks
(``torchrun``) and initialises the group.
"""

from __future__ import annotations

import os
from typing import Literal

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.corank import co_rank
from repro_torch.core.kway import co_rank_kway_batch
from repro_torch.core.mergesort import DEFAULT_FANOUT, merge_sort
from repro_torch.distributed import _collectives as C
from repro_torch.distributed.exchange import exchange_block, sentinel_max, window
from repro_torch.distributed.splitters import (
    distributed_co_rank,
    distributed_co_rank_kway,
)
from repro_torch.kernels import ops

__all__ = [
    "distributed_merge",
    "distributed_merge_corank",
    "distributed_sort",
    "sharded_merge_kway",
    "sharded_sort",
    "sharded_sort_host",
]

MergeStrategy = Literal["allgather", "corank"]
SortStrategy = Literal["allgather", "exchange"]


def ragged_merge(segments: torch.Tensor, lengths: torch.Tensor, out_len: int,
                 vals: torch.Tensor | None = None):
    """The local stable merge of the ``p`` received sorted segments (the
    reference's ``merge_kway_ranked(segments, lengths=..., out_len=...)``).

    ``ops.merge_window`` leaves positions past ``lengths.sum()`` to the
    backend; the reference zero-fills them, which shows when a small
    capacity truncated a segment, so they are zeroed here on every
    backend.
    """
    out = ops.merge_window(segments, vals, lengths, out_len=out_len)
    real = (torch.arange(out_len, device=segments.device)
            < lengths.sum())
    if vals is None:
        return torch.where(real, out, 0)
    return torch.where(real, out[0], 0), torch.where(real, out[1], 0)


# ---------------------------------------------------------------------------
# pairwise merge (allgather | corank)
# ---------------------------------------------------------------------------


def _merge_windows(a, b, j_lo, j_hi, k_lo, k_hi, s: int) -> torch.Tensor:
    """This rank's block: the first ``s`` outputs of the stable merge of
    the sentinel-padded windows ``a[j_lo:j_hi]`` and ``b[k_lo:k_hi]``
    (``(j_hi - j_lo) + (k_hi - k_lo) == s``)."""
    return ops.stable_merge(window(a, j_lo, j_hi, s),
                            window(b, k_lo, k_hi, s))[:s]


def distributed_merge(a_shard: torch.Tensor, b_shard: torch.Tensor, group,
                      strategy: MergeStrategy = "allgather") -> torch.Tensor:
    """Stable merge of two sorted, evenly sharded arrays.

    ``a_shard``/``b_shard`` are this rank's contiguous shards; the global
    arrays are their concatenations in rank order.  Returns this rank's
    contiguous shard of the merged output (``(m+n)/p`` elements; ``p``
    must divide ``m+n``: callers pad with sentinels).

    ``strategy="allgather"`` co-ranks on replicated arrays;
    ``strategy="corank"`` runs the co-rank search itself over collectives
    (``distributed_co_rank``) and gathers only for the data windows.
    """
    if strategy == "corank":
        return distributed_merge_corank(a_shard, b_shard, group)
    if strategy != "allgather":
        raise ValueError(
            f"distributed_merge strategy must be 'allgather' or 'corank', "
            f"got {strategy!r}")
    p, r = C.size(group), C.index(group)
    a = C.all_gather_tiled(a_shard, group)
    b = C.all_gather_tiled(b_shard, group)
    total = a.shape[0] + b.shape[0]
    if total % p:
        raise ValueError(f"distributed_merge: pad the inputs so that p = {p} "
                         f"divides m + n = {total}")
    s = total // p
    j_lo, k_lo, _ = co_rank(r * s, a, b)
    j_hi, k_hi, _ = co_rank(r * s + s, a, b)
    return _merge_windows(a, b, j_lo, j_hi, k_lo, k_hi, s)


def distributed_merge_corank(a_shard: torch.Tensor, b_shard: torch.Tensor,
                             group) -> torch.Tensor:
    """Merge with the distributed co-rank for the partition (the data is
    still fetched with one ``all_gather`` for the local windows; the
    *search* is distributed: the Siebert-Träff split of search and data
    movement)."""
    p, r = C.size(group), C.index(group)
    total = (a_shard.shape[0] + b_shard.shape[0]) * p
    s = total // p
    j_lo, k_lo = distributed_co_rank(r * s, a_shard, b_shard, group)
    j_hi, k_hi = distributed_co_rank(min((r + 1) * s, total), a_shard,
                                     b_shard, group)
    a = C.all_gather_tiled(a_shard, group)
    b = C.all_gather_tiled(b_shard, group)
    return _merge_windows(a, b, j_lo, j_hi, k_lo, k_hi, s)


# ---------------------------------------------------------------------------
# k-way merge / sort (allgather | exchange)
# ---------------------------------------------------------------------------


def sharded_merge_kway(run_shard: torch.Tensor, group,
                       strategy: SortStrategy = "exchange",
                       capacity: int | None = None) -> torch.Tensor:
    """Global stable k-way merge of ``p`` sorted runs, one a rank.

    Rank ``r`` holds sorted run ``r`` (width ``N/p``); it gets back its
    contiguous ``N/p``-element block of the global merge (ties break by
    rank order: bit-exact with a global stable sort of the concatenation
    when the runs are locally sorted shards).

    ``strategy="exchange"`` (default): distributed splitters + balanced
    ``all_to_all`` + local ragged merge; no run is ever replicated.
    ``strategy="allgather"``: replicate the runs and cut locally.

    ``capacity`` bounds the exchange's per-peer slot.  The default
    (``None`` = ``N/p``) is exact for every input.  A smaller capacity
    truncates any (sender, receiver) segment longer than it: the dropped
    elements vanish and the block's tail is zero-filled -- acceptable for
    MoE-style capacity dropping, **incorrect for a sort**.
    """
    if strategy not in ("allgather", "exchange"):
        raise ValueError(
            f"sharded sort/merge strategy must be 'allgather' or "
            f"'exchange', got {strategy!r}")
    p, r = C.size(group), C.index(group)
    s = run_shard.shape[0]  # every output block is N/p (Proposition 2)
    bounds = torch.tensor([r * s, (r + 1) * s], dtype=torch.int32,
                          device=run_shard.device)
    with obs.span(f"repro.sharded_merge_kway.{strategy}"):
        if strategy == "exchange":
            with obs.span("repro.splitters"):
                cuts = distributed_co_rank_kway(bounds, run_shard, group)
            segments, lengths = exchange_block(run_shard, cuts, group,
                                               capacity=capacity)
            with obs.span("repro.local_merge"):
                return ragged_merge(segments, lengths, s)
        runs = C.all_gather(run_shard, group)  # (p, N/p) replicated
        lo, hi = co_rank_kway_batch(bounds, runs)  # (2, p) local cuts
        windows = torch.stack([window(runs[q], lo[q], hi[q], s)
                               for q in range(p)])
        return ragged_merge(windows, hi - lo, s)


def sharded_sort(x_shard: torch.Tensor, group,
                 strategy: SortStrategy = "exchange",
                 capacity: int | None = None,
                 fanout: int = DEFAULT_FANOUT) -> torch.Tensor:
    """Globally stable sort of an evenly sharded array.

    Local stable merge sort (fan-out ``fanout``), then the strategy's
    splitter and data-movement path (:func:`sharded_merge_kway`).  Rank
    order breaks ties across shards, as a global stable sort of the
    concatenated input does.
    """
    with obs.span("repro.sharded_sort"):
        with obs.span("repro.local_sort"):
            local = merge_sort(x_shard, fanout=fanout)
        return sharded_merge_kway(local, group, strategy=strategy,
                                  capacity=capacity)


def distributed_sort(x_shard: torch.Tensor, group,
                     strategy: SortStrategy = "exchange") -> torch.Tensor:
    """Back-compat alias of :func:`sharded_sort` (exchange by default)."""
    return sharded_sort(x_shard, group, strategy=strategy)


# ---------------------------------------------------------------------------
# host-level wrapper (sentinel padding)
# ---------------------------------------------------------------------------


def _default_device(group) -> torch.device:
    """The card of this rank: ``cuda:{local rank % device_count}``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("sharded_sort_host: no CUDA device; pass "
                           "device='cpu' to sort on the CPU")
    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local is not None else (
        C.index(group) if dist.is_initialized() else 0)
    return torch.device("cuda", rank % n)


def sharded_sort_host(x: torch.Tensor, strategy: SortStrategy = "exchange",
                      group=None, device=None,
                      capacity: int | None = None) -> torch.Tensor:
    """Global stable sort over every rank of ``group`` (default: the world).

    Every rank passes the same ``x`` and gets back the whole sorted ``x``
    on ``device`` (default the rank's card).  Handles what the SPMD core
    cannot: pads uneven sizes to a multiple of ``p`` with order-preserving
    sentinels (dtype max sorts to the global tail, after every real
    element -- including real dtype-max keys, which precede the padding by
    position), sorts, gathers and strips the pad.  Without an initialised
    process group, or with ``p == 1``, it is ``merge_sort(x)``.
    """
    dev = _default_device(group) if device is None else torch.device(device)
    x = x.to(dev)
    n = x.shape[0]
    p = C.size(group) if dist.is_initialized() else 1
    if n == 0 or p == 1:
        return merge_sort(x)
    group = dist.group.WORLD if group is None else group
    w = -(-n // p)
    r = C.index(group)
    pad = torch.full((w * p - n,), sentinel_max(x.dtype).item(),
                     dtype=x.dtype, device=dev)
    shard = torch.cat([x, pad])[r * w:(r + 1) * w]
    out = sharded_sort(shard, group, strategy=strategy, capacity=capacity)
    return C.all_gather_tiled(out, group)[:n]
