"""Distributed co-ranking: exact global splitters over collectives (torch
port of ``repro.distributed.splitters``).

The co-rank of an output rank is a pure *search*, so it distributes
without moving run data: every remote probe is a value lookup or a
``searchsorted`` count that the run's owner answers locally, and the
``p`` ranks' searches advance in lock-step rounds of ``O(p^2)``-scalar
collectives.  All three searches instantiate the one co-rank engine
(``repro_torch.core.engine``) with *remote* reads; this module supplies
only the collective read, count and reduce plumbing:

* :func:`distributed_co_rank` -- the pairwise Algorithm 1
  (``engine.co_rank_pairwise``) with each boundary read answered by
  :func:`_remote_read` (publish indices with ``all_gather``, owners
  answer through a masked ``psum``), run to the engine's static
  ``pairwise_lockstep_rounds`` so every rank's search shares the rounds.
* :func:`distributed_co_rank_kway` -- the k-way bisection
  (``engine.co_rank_search``) through :class:`_CollectiveProbe`: one
  sorted run a rank, ``B`` output ranks a rank, ``kway_round_bound(w)``
  rounds of one ``all_gather`` of ``(B, p)`` candidates and two ``psum``s
  of ``(p, B, p)`` scalars; no run element leaves its rank.
* :func:`distributed_segment_cuts` -- the value-keyed case that MoE
  dispatch needs: with boundary *values* ``0..E`` known, the search
  collapses to the engine's ``value_cut_counts`` and all ``E + 1``
  boundaries resolve in one ``all_gather`` of ``O(p E)`` int32.

Every rank of the group calls these functions with its own shard; the
results equal the single-process ``co_rank`` / ``co_rank_kway_batch`` of
the gathered runs bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES
from repro_torch.distributed import _collectives as C

__all__ = [
    "distributed_co_rank",
    "distributed_co_rank_kway",
    "distributed_segment_cuts",
]


# ---------------------------------------------------------------------------
# pairwise (Algorithm 1 over collectives)
# ---------------------------------------------------------------------------


def _remote_read(shard: torch.Tensor, gidx: torch.Tensor, group):
    """Every rank reads global element ``gidx`` (its own request, any
    shape) of the evenly sharded array: publish the indices, owners answer
    through a masked ``psum``.  The engine clamps ``gidx`` into the global
    range; the clamps here guard the uniform-shard arithmetic."""
    p, r = C.size(group), C.index(group)
    sz = shard.shape[0]
    wanted = C.all_gather(gidx, group)  # (p, ...) every rank's request
    owner = torch.clamp(wanted // sz, 0, p - 1)
    local = torch.where(owner == r, wanted - r * sz, 0)
    vals = shard[torch.clamp(local, 0, sz - 1)]  # my answers
    answers = C.psum(torch.where(owner == r, vals, torch.zeros_like(vals)),
                     group)
    return answers[r]


def distributed_co_rank(i, a_shard: torch.Tensor, b_shard: torch.Tensor,
                        group):
    """Algorithm 1 with remote reads over collectives: the global co-ranks
    ``(j, k)`` of this rank's output rank(s) ``i``.

    ``a_shard``/``b_shard`` are this rank's contiguous shards (uniform
    sizes) of the sorted global arrays.  The ``p`` searches run the
    engine's static ``pairwise_lockstep_rounds`` schedule, so converged
    searches idle while the collectives stay aligned.
    """
    p = C.size(group)
    m = a_shard.shape[0] * p
    n = b_shard.shape[0] * p
    i = torch.as_tensor(i, dtype=torch.int32, device=a_shard.device)
    j, k, _ = engine.co_rank_pairwise(
        i,
        m,
        n,
        read_a=lambda idx: _remote_read(a_shard, idx, group),
        read_b=lambda idx: _remote_read(b_shard, idx, group),
        rounds=engine.pairwise_lockstep_rounds(m, n),
        metric="splitters.pairwise_rounds",
        labels={"device": C.index(group)},
    )
    return j, k


# ---------------------------------------------------------------------------
# k-way (one sorted run per rank, batched ranks)
# ---------------------------------------------------------------------------


class _CollectiveProbe:
    """Engine probe over one sorted run per rank.

    ``values`` publishes every rank's ``(B, p)`` candidate indices
    (``all_gather``) and resolves them with a masked ``psum`` (owners
    answer); ``counts`` is this rank's local ``searchsorted`` of every
    candidate value into its own run, both Lemma-1 sides; ``reduce``
    ``psum``s the per-owner contributions and keeps this rank's own
    ``(B, p)`` searches.  No run element leaves its rank.
    """

    xp = torch
    run_loop = staticmethod(engine.run_fori)

    def __init__(self, run_shard: torch.Tensor, group, lengths, batch: int):
        self._run = run_shard
        self._group = group
        self._p = C.size(group)
        self._r = C.index(group)
        self._b = batch
        self._run_ids = torch.arange(self._p, dtype=torch.int32,
                                     device=run_shard.device)
        self.width = run_shard.shape[0]
        self.lengths = lengths[None, :]  # (p,) run lengths vs (B, p) cuts
        self.owner_ids = self._r  # I own only my run's counts
        self.query_ids = self._run_ids[None, None, :]
        self.owner_lengths = lengths[self._r]

    def init_bounds(self, i):
        lo = torch.zeros((self._b, self._p), dtype=torch.int32,
                         device=self._run.device)
        return lo, self.lengths.expand(self._b, self._p)

    def values(self, t):
        # Every rank's candidates: (p, B, p); entry [d, q, rp] is rank d's
        # probe into run rp for its rank i[q].  Owners answer column r.
        cand = C.all_gather(t, self._group)
        mine = self._run[torch.clamp(cand[:, :, self._r], 0, self.width - 1)]
        return C.psum(
            torch.where(self._run_ids[None, None, :] == self._r,
                        mine[:, :, None], torch.zeros_like(mine[:, :, None])),
            self._group,
        )  # vals[d, q, rp] = run_rp[cand[d, q, rp]]

    def counts(self, x):
        # My Lemma-1 count for every candidate value (the engine picks the
        # side against owner_ids).
        flat = x.reshape(-1).contiguous()
        le = torch.searchsorted(self._run, flat, side=SIDE_TIES,
                                out_int32=True)
        lt = torch.searchsorted(self._run, flat, side=SIDE_STRICT,
                                out_int32=True)
        return le.reshape(x.shape), lt.reshape(x.shape)

    def reduce(self, cnt):
        return C.psum(cnt, self._group)[self._r]  # (B, p): my searches


def distributed_co_rank_kway(i, run_shard: torch.Tensor, group,
                             length=None) -> torch.Tensor:
    """Cut matrices of output ranks ``i`` into the group's ``p`` sorted runs.

    Rank ``r`` holds ``run_shard``, sorted run ``r`` of the global k-way
    merge (``k = p``, width ``w``), and asks for the cut vectors of its own
    ``B`` output ranks ``i`` (``B`` equal on every rank).  Ragged runs pad
    with row-maximal values and declare ``length``, their real count.

    Returns int32 ``(B, p)``: row ``b`` is the cut vector of rank ``i[b]``;
    ``out[b].sum() == min(i[b], total)``, and ties break by rank order
    (lower rank first), as ``co_rank_kway``'s do.  ``kway_round_bound(w)``
    rounds, each one ``all_gather`` of ``(B, p)`` int32 and two ``psum``s
    of ``(p, B, p)`` scalars.
    """
    p, r = C.size(group), C.index(group)
    w = run_shard.shape[0]
    dev = run_shard.device
    i = torch.as_tensor(i, dtype=torch.int32, device=dev)
    b = i.shape[0]
    if length is None:
        lengths = torch.full((p,), w, dtype=torch.int32, device=dev)
    else:
        lengths = C.all_gather(
            torch.as_tensor(length, dtype=torch.int32, device=dev), group)
    probe = _CollectiveProbe(run_shard, group, lengths, b)
    return engine.co_rank_search(
        i[:, None],
        probe,
        metric="splitters.kway_rounds",
        labels={"w": w, "batch": b, "device": r},
    )


# ---------------------------------------------------------------------------
# value-keyed segment cuts (one round: boundary values known a priori)
# ---------------------------------------------------------------------------


def distributed_segment_cuts(run_shard: torch.Tensor, n_segments: int, group,
                             length=None) -> torch.Tensor:
    """All ``n_segments + 1`` global segment boundaries over ``p`` runs.

    Rank ``r`` holds its locally sorted run of integer segment keys in
    ``[0, n_segments)`` (MoE: the stable-sorted expert ids of its
    assignments; ragged runs pad with any value ``>= n_segments`` and
    declare ``length``).

    Returns int32 ``(p, n_segments + 1)``, the same on every rank: entry
    ``[d, s]`` is the number of rank ``d``'s elements with key ``< s``.
    ``cuts[:, s].sum()`` is segment ``s``'s global start, ``cuts[:, s+1]
    - cuts[:, s]`` the per-(rank, segment) counts (the whole schedule of a
    dropless exchange), and column ``s`` equals the
    ``distributed_co_rank_kway`` cut vector of that start rank.  One
    ``all_gather`` of ``O(p E)`` int32.
    """
    dev = run_shard.device
    bounds = torch.arange(n_segments + 1, dtype=run_shard.dtype, device=dev)
    local = engine.value_cut_counts(
        run_shard, bounds,
        None if length is None else torch.as_tensor(length, dtype=torch.int32,
                                                     device=dev))
    cuts = C.all_gather(local, group)  # (p, n_segments + 1)
    if obs.enabled():
        obs.counter("splitters.segment_cut_scalars",
                    cuts.shape[0] * (n_segments + 1), n_segments=n_segments,
                    device=C.index(group))
    return cuts
