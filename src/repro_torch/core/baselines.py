"""Baselines the paper compares against, for benchmarking (torch port of
``repro.core.baselines``).  Nothing else in the port calls them.

1. ``equidistant_partition`` / ``merge_equidistant`` -- the classic
   PRAM/BSP parallel merge (Shiloach-Vishkin / Hagerup-Rüb / BSP style):
   pick equidistant splitters in *both* arrays, cross-rank each by binary
   search, and merge the 2p resulting segment pairs independently.  A
   segment holds at most ``ceil(m/p) + ceil(n/p)`` elements but may hold
   none: up to a **factor-2 load imbalance** against the ideal
   ``(m+n)/p``, the inefficiency the paper removes.  With static shapes
   the imbalance becomes padding: every segment is merged in a lane sized
   for the worst case.

2. ``merge_lexicographic`` -- the standard stability workaround: sort on
   widened (key, index) keys.  A yardstick, so it calls
   ``torch.sort(stable=True)``, which orders equal keys by index as the
   reference's two-key sort does.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES
from repro_torch.core.merge import merge_segment_twofinger

__all__ = [
    "equidistant_partition",
    "merge_equidistant",
    "merge_lexicographic",
    "partition_sizes_equidistant",
]


def _cross_ranks(splitters_at, own, other, side: str, other_len: int):
    """The cross-rank of ``own[splitters_at]`` in ``other`` (``side``
    breaks ties as the stable merge does); ``other_len`` past the end of
    ``own``, and 0 for the first splitter."""
    n_own = own.shape[0]
    if n_own == 0:  # every splitter sits at the end: nothing to read
        ranks = torch.full_like(splitters_at, other_len)
    else:
        vals = own[torch.clamp(splitters_at, 0, n_own - 1).long()]
        ranks = torch.searchsorted(other, vals, side=side, out_int32=True)
        ranks = torch.where(splitters_at >= n_own, other_len, ranks)
    ranks[0] = 0
    return ranks


def equidistant_partition(a: torch.Tensor, b: torch.Tensor, p: int):
    """Classic splitter-based co-partition.

    Returns ``(j_cuts, k_cuts)``, each ``(2p+1,)`` int32: the cut points of
    the p equidistant A-splitters (with their B cross-ranks) and the p
    equidistant B-splitters (with their A cross-ranks), ordered by output
    offset; ``j_cuts[s] + k_cuts[s]`` is the output offset of segment
    ``s``.
    """
    m, n = a.shape[0], b.shape[0]
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    dev = a.device
    ja = torch.tensor([min(m, -(-m // p) * r) for r in range(p + 1)],
                      dtype=torch.int32, device=dev)
    kb = torch.tensor([min(n, -(-n // p) * r) for r in range(p + 1)],
                      dtype=torch.int32, device=dev)
    # A splitters rank strictly into B, B splitters past ties into A: the
    # engine's sides, consistent with the stable merge.
    ka = _cross_ranks(ja, a, b, SIDE_STRICT, n)
    jb = _cross_ranks(kb, b, a, SIDE_TIES, m)
    # Union of cut points, ordered by output offset (stable on ties).
    j_cuts = torch.cat([ja, jb])
    k_cuts = torch.cat([ka, kb])
    order = torch.argsort(j_cuts + k_cuts, stable=True)
    # Drop one of the two (0, 0) starts: 2p+1 cuts remain.
    return j_cuts[order][1:], k_cuts[order][1:]


def partition_sizes_equidistant(a: torch.Tensor, b: torch.Tensor, p: int):
    """Output sizes of the classic partition's 2p segments (the
    load-imbalance benchmark; ideal is (m+n)/(2p) each)."""
    j_cuts, k_cuts = equidistant_partition(a, b, p)
    return torch.diff(j_cuts + k_cuts)


def merge_equidistant(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Classic equidistant-splitter parallel merge (stable).

    Every one of the 2p segments is merged in a lane padded to the
    worst-case segment size ``ceil(m/p) + ceil(n/p)`` -- the factor-2
    overhead the co-rank merge eliminates.
    """
    m, n = a.shape[0], b.shape[0]
    j_cuts, k_cuts = equidistant_partition(a, b, p)
    seg_len = -(-m // p) + -(-n // p)  # worst case: the padding cost
    segs = merge_segment_twofinger(a, b, j_cuts[:-1], j_cuts[1:],
                                   k_cuts[:-1], k_cuts[1:], seg_len)
    off = j_cuts + k_cuts
    idx = off[:-1, None] + torch.arange(seg_len, dtype=torch.int32,
                                        device=a.device)[None, :]
    valid = idx < off[1:, None]
    out = torch.zeros((m + n,), dtype=segs.dtype, device=a.device)
    out[idx[valid].long()] = segs[valid]
    return out


def merge_lexicographic(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stability via widened keys: sort (key, index) pairs.

    The standard trick the paper renders unnecessary: it pays for a second
    comparison key and O((m+n) log(m+n)) work instead of a linear merge.
    ``-0.0`` and ``+0.0`` are equal keys, kept in input order as in the
    reference: the card's radix sort would order them apart, so floats are
    sorted as ``x + 0.0`` and the inputs gathered through the permutation.
    """
    keys = torch.cat([a, b])  # promotes as the reference's concatenate
    probe = keys + 0.0 if keys.is_floating_point() else keys
    order = torch.sort(probe, stable=True).indices
    return keys[order]
