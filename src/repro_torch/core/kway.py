"""Multi-way co-ranking and perfectly load-balanced k-way stable merge
(torch port of ``repro.core.kway``).

An output rank ``i`` of the stable merge of ``k`` sorted runs induces a
unique cut vector ``(j_0, ..., j_{k-1})``, ``sum(j_r) == i``: the first
``i`` merged elements are exactly ``runs[0][:j_0] ∪ ... ∪
runs[k-1][:j_{k-1}]``.  Stability is "run index breaks ties", so the
merged rank of element ``(r, t)`` is

    rank(r, t) = t + sum_{r' < r} |{u : runs[r'][u] <= runs[r][t]}|
                   + sum_{r' > r} |{u : runs[r'][u] <  runs[r][t]}|

and the cut ``j_r(i) = |{t : rank(r, t) < i}|`` is one bisection per run
(``repro_torch.core.engine.co_rank_search``).

On top of the cut sit ``merge_kway_ranked`` (every element scattered to
its merged rank) and ``merge_kway`` (Algorithm 2's partitioned form).
Ragged runs are supported via ``lengths``: rows must stay sorted over
their full width (pad with a value >= every real element, e.g. dtype
max); padded positions are never counted or emitted.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES
from repro_torch.core.merge import partition_bounds

__all__ = [
    "co_rank_kway",
    "co_rank_kway_batch",
    "kway_positions",
    "merge_kway_ranked",
    "merge_kway",
]


class _DenseProbe:
    """Engine probe over a ``(k, w)`` run tensor, for ``b`` ranks at once.

    Cuts have shape ``(b, k)``; ``counts`` searches every candidate value
    into every run with one batched ``torch.searchsorted`` per Lemma-1
    side, laid out ``(owner run, rank, query run)``.
    """

    xp = torch
    run_loop = staticmethod(engine.run_fori)

    def __init__(self, runs: torch.Tensor, lengths: torch.Tensor):
        k, w = runs.shape
        self.runs = runs
        self.width = w
        self.lengths = lengths  # (k,)
        ids = torch.arange(k, dtype=torch.int32, device=runs.device)
        self.owner_ids = ids[:, None, None]
        self.query_ids = ids[None, None, :]
        self.owner_lengths = lengths[:, None, None]
        self._rows = ids

    def init_bounds(self, i):
        b, k = i.shape[0], self.runs.shape[0]
        lo = torch.zeros((b, k), dtype=torch.int32, device=self.runs.device)
        return lo, self.lengths.expand(b, k)

    def values(self, t):
        return self.runs[self._rows, torch.clamp(t, 0, self.width - 1)]

    def counts(self, x):
        k = self.runs.shape[0]
        q = x.reshape(1, -1).expand(k, -1).contiguous()  # (k, b*k)
        le = torch.searchsorted(self.runs, q, side=SIDE_TIES, out_int32=True)
        lt = torch.searchsorted(self.runs, q, side=SIDE_STRICT,
                                out_int32=True)
        return le.reshape(k, *x.shape), lt.reshape(k, *x.shape)

    def reduce(self, cnt):
        return cnt.sum(dim=0, dtype=torch.int32)


def _lengths_or_full(runs: torch.Tensor, lengths) -> torch.Tensor:
    k, w = runs.shape
    if lengths is None:
        return torch.full((k,), w, dtype=torch.int32, device=runs.device)
    return torch.as_tensor(lengths, dtype=torch.int32, device=runs.device)


def co_rank_kway_batch(
    i, runs: torch.Tensor, lengths=None
) -> torch.Tensor:
    """Cut vectors of the ranks ``i`` (shape ``(b,)``) -> int32 ``(b, k)``.

    The dense instantiation of ``engine.co_rank_search``:
    ``kway_round_bound(w)`` lock-step rounds; every row of the result sums
    to ``min(i, sum(lengths))``.
    """
    k, w = runs.shape
    i = torch.as_tensor(i, dtype=torch.int32, device=runs.device)
    return engine.co_rank_search(
        i[:, None],
        _DenseProbe(runs, _lengths_or_full(runs, lengths)),
        metric="kway.corank_rounds",
        labels={"k": k, "w": w},
    )


def co_rank_kway(i, runs: torch.Tensor, lengths=None) -> torch.Tensor:
    """Cut vector ``j`` (int32, shape ``(k,)``) of output rank ``i``.

    Args:
      i: output rank, ``0 <= i <= sum(lengths)``.
      runs: ``(k, w)`` tensor, every row sorted ascending over its full
        width (pad ragged rows with row-wise maximal values).
      lengths: optional ``(k,)`` real lengths; defaults to ``w`` each.
    """
    i = torch.as_tensor(i, dtype=torch.int32, device=runs.device)
    return co_rank_kway_batch(i.reshape(1), runs, lengths)[0]


def _count_into(row: torch.Tensor, queries: torch.Tensor, side: str):
    """Occupancy counts of ``queries (..., r, w)`` in the sorted ``row
    (..., w)`` (leading dims shared), int32, shaped like ``queries``."""
    flat = queries.reshape(*queries.shape[:-2], -1).contiguous()
    cnt = torch.searchsorted(row, flat, side=side, out_int32=True)
    return cnt.reshape(queries.shape)


def kway_positions(runs: torch.Tensor, lengths=None) -> torch.Tensor:
    """Merged rank of every element: ``(..., k, w) -> (..., k, w)`` int32.

    Each element is searched into exactly its ``k-1`` sibling runs: runs
    after ``rp`` count ties into ``rp`` (``SIDE_TIES``), runs before it
    count strictly (``SIDE_STRICT``).  Leading dimensions are independent
    groups.  With ``lengths`` (shape ``(..., k)``) each source row's
    counts are clipped at its real length — exact because padding is >=
    every real element.  Positions of padded elements are meaningless.
    """
    k, w = runs.shape[-2:]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=runs.device)
    cnt = torch.zeros(runs.shape, dtype=torch.int32, device=runs.device)
    for rp in range(k):
        row = runs[..., rp, :].contiguous()
        for sl, side in ((slice(rp + 1, k), SIDE_TIES),
                         (slice(0, rp), SIDE_STRICT)):
            if sl.start == sl.stop:
                continue
            c = _count_into(row, runs[..., sl, :], side)
            if lengths is not None:
                c = torch.minimum(c, lengths[..., rp, None, None])
            cnt[..., sl, :] += c
    return torch.arange(w, dtype=torch.int32, device=runs.device) + cnt


def merge_kway_ranked(
    runs: torch.Tensor,
    vals: torch.Tensor | None = None,
    lengths=None,
    out_len: int | None = None,
):
    """Stable k-way merge, data-parallel scatter formulation.

    ``runs``: ``(k, w)`` sorted rows (+ optional ``vals`` payload of the
    same shape, carried through).  Returns the merged ``(total,)`` keys
    (and payload), ``total = out_len or k*w``; padded elements and ranks
    ``>= total`` are dropped, and output positions nobody lands on
    (those ``>= sum(lengths)``) are zero.
    """
    k, w = runs.shape
    total = k * w if out_len is None else out_len
    pos = kway_positions(runs, lengths)
    keep = pos < total
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=runs.device)
        keep &= (
            torch.arange(w, dtype=torch.int32, device=runs.device)[None, :]
            < lengths[:, None]
        )
    dest = pos[keep]
    out = torch.zeros((total,), dtype=runs.dtype, device=runs.device)
    out[dest] = runs[keep]
    if vals is None:
        return out
    out_v = torch.zeros((total,), dtype=vals.dtype, device=vals.device)
    out_v[dest] = vals[keep]
    return out, out_v


def _kfinger_segment(
    runs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, seg_len: int
) -> torch.Tensor:
    """Sequential k-finger stable merge of ``runs[r][lo_r:hi_r]`` for a
    batch of processing elements (``lo``/``hi``: ``(p, k)``) into
    ``(p, seg_len)``; ``sum(hi - lo) <= seg_len`` per row."""
    k, w = runs.shape
    rows = torch.arange(k, dtype=torch.int32, device=runs.device)
    cur = lo.clone()
    out = torch.zeros((lo.shape[0], seg_len), dtype=runs.dtype,
                      device=runs.device)
    for t in range(seg_len):
        vals = runs[rows, torch.clamp(cur, 0, w - 1)]  # (p, k)
        avail = cur < hi
        # Fold min with availability flags: the engine's k-finger rule
        # (strict '<') keeps the earliest run on ties.
        best_val, best_ok = vals[:, 0], avail[:, 0]
        best_q = torch.zeros_like(cur[:, 0])
        for q in range(1, k):
            better = engine.kfinger_better(
                vals[:, q], best_val, avail[:, q], best_ok
            )
            best_val = torch.where(better, vals[:, q], best_val)
            best_q = torch.where(better, q, best_q)
            best_ok = best_ok | avail[:, q]
        out[:, t] = torch.where(best_ok, best_val, out[:, t])
        cur = cur + ((rows == best_q[:, None]) & best_ok[:, None]).to(
            cur.dtype
        )
    return out


def merge_kway(runs: torch.Tensor, p: int = 8) -> torch.Tensor:
    """Perfectly load-balanced stable merge of ``k`` sorted runs.

    Algorithm 2 with the multi-way cut: each of ``p`` processing elements
    co-ranks both endpoints of its output block (sizes differ by at most
    one, Proposition 2) and k-finger merges exactly its segments.
    """
    k, w = runs.shape
    total = k * w
    with obs.span("repro.merge_kway"):
        bounds = partition_bounds(total, p, device=runs.device)  # (p+1,)
        cuts = co_rank_kway_batch(bounds, runs)  # (p+1, k)
        seg_len = -(-total // p)
        segs = _kfinger_segment(runs, cuts[:-1], cuts[1:], seg_len)
        idx = bounds[:-1, None] + torch.arange(
            seg_len, dtype=torch.int32, device=runs.device
        )[None, :]
        valid = idx < bounds[1:, None]
        out = torch.zeros((total,), dtype=runs.dtype, device=runs.device)
        out[idx[valid]] = segs[valid]
        return out
