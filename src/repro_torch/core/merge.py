"""Stable parallel merge (Algorithm 2 of Siebert & Träff, 2013), torch port.

* ``merge_partitioned`` — a literal Algorithm 2: the output is cut into
  ``p`` blocks that differ in size by at most one element; each
  processing element (a batch row) co-ranks both endpoints of its block
  and runs a sequential two-finger stable merge of exactly its segments.
* ``merge_by_ranking`` — the data-parallel formulation: every element's
  output position is its own index plus its co-rank in the other input
  (``searchsorted`` with the engine's stability sides), one scatter.

Both are stable: ties emit all A elements (in order) before any B element.
"""

from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.corank import co_rank_batch
from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES

__all__ = [
    "merge_by_ranking",
    "merge_partitioned",
    "partition_bounds",
    "merge_segment_twofinger",
]


def partition_bounds(total: int, p: int, device=None) -> torch.Tensor:
    """Output block boundaries ``i_r = floor(r * total / p)`` for r=0..p.

    Block sizes differ by at most one element (Proposition 2).  Computed in
    Python integers so ``r * total`` can never overflow.
    """
    return torch.tensor(
        [r * total // p for r in range(p + 1)], dtype=torch.int32,
        device=device,
    )


def merge_by_ranking(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge via per-element co-ranking (scatter formulation).

    Position of ``a[x]`` is ``x + |{y : b[y] < a[x]}|`` (ties: A first) and
    of ``b[y]`` is ``y + |{x : a[x] <= b[y]}|`` — Lemma 1 element-wise.
    """
    m, n = a.shape[0], b.shape[0]
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    pos_a = torch.arange(m, device=a.device) + torch.searchsorted(
        b, a, side=SIDE_STRICT
    )
    pos_b = torch.arange(n, device=b.device) + torch.searchsorted(
        a, b, side=SIDE_TIES
    )
    out = torch.zeros((m + n,), dtype=dtype, device=a.device)
    out[pos_a] = a
    out[pos_b] = b
    return out


def merge_segment_twofinger(
    a: torch.Tensor,
    b: torch.Tensor,
    j_lo: torch.Tensor,
    j_hi: torch.Tensor,
    k_lo: torch.Tensor,
    k_hi: torch.Tensor,
    seg_len: int,
) -> torch.Tensor:
    """Sequential two-finger stable merge of ``a[j_lo:j_hi]`` and
    ``b[k_lo:k_hi]`` into a fresh buffer of static length ``seg_len``.

    The bounds may carry a batch shape (one processing element each); the
    result has that shape plus ``(seg_len,)``.  Positions past a
    segment's real length hold zero.
    """
    m, n = a.shape[0], b.shape[0]
    dtype = torch.promote_types(a.dtype, b.dtype)
    # An empty side is never available; read a zero in its place.
    a_rd = a.to(dtype) if m else torch.zeros(1, dtype=dtype, device=a.device)
    b_rd = b.to(dtype) if n else torch.zeros(1, dtype=dtype, device=a.device)
    ja, kb = j_lo.clone(), k_lo.clone()
    out = torch.zeros(tuple(j_lo.shape) + (seg_len,), dtype=dtype,
                      device=a.device)
    for t in range(seg_len):
        a_val = a_rd[torch.clamp(ja, 0, max(m - 1, 0))]
        b_val = b_rd[torch.clamp(kb, 0, max(n - 1, 0))]
        a_avail = ja < j_hi
        b_avail = kb < k_hi
        # Stability: the engine's two-finger rule (on ties take from A).
        take_a = engine.take_first(a_val, b_val, a_avail, b_avail)
        valid = a_avail | b_avail
        out[..., t] = torch.where(
            valid, torch.where(take_a, a_val, b_val), out[..., t]
        )
        ja = ja + take_a.to(ja.dtype)
        kb = kb + (valid & ~take_a).to(kb.dtype)
    return out


def merge_partitioned(
    a: torch.Tensor, b: torch.Tensor, p: int = 8
) -> torch.Tensor:
    """Algorithm 2: perfectly load-balanced stable parallel merge.

    Each of ``p`` processing elements (batch rows) co-ranks the two
    endpoints of its output block and merges exactly ``floor/ceil((m+n)/p)``
    elements.
    """
    m, n = a.shape[0], b.shape[0]
    total = m + n
    bounds = partition_bounds(total, p, device=a.device)  # (p+1,)
    cr = co_rank_batch(bounds, a, b)
    j, k = cr.j, cr.k

    seg_len = -(-total // p)  # ceil — max block size; blocks differ by <= 1
    segs = merge_segment_twofinger(
        a, b, j[:-1], j[1:], k[:-1], k[1:], seg_len
    )  # (p, seg_len)

    # Scatter the (ragged-by-at-most-one) blocks, dropping the overhang.
    idx = bounds[:-1, None] + torch.arange(seg_len, device=a.device)[None, :]
    valid = idx < bounds[1:, None]
    out = torch.zeros((total,), dtype=segs.dtype, device=a.device)
    out[idx[valid]] = segs[valid]
    return out
