"""Stable merge sort built from the co-rank merge primitive (torch port).

Bottom-up merge sort with configurable fan-out, run as one pass plan
(:func:`sort_plan`).  The first pass is a *leaf*: ``np2 // s`` groups of
``s`` runs of width 1, a stable k-way merge that sorts every segment of
``s`` keys at once.  Then each pass merges groups of ``fanout`` adjacent
runs of width ``w`` into runs of width ``fanout*w`` with the k-way rank
merge of ``repro_torch.core.kway``.  Every pass is stable (lower run
index wins ties, runs are laid out in input order), so the whole sort is
stable without key widening, and its output is the reference's, whose
passes start at width 1: a stable sort has one result.

The input is padded to the next power of two with :func:`sentinel_max`,
which sorts to the tail and is sliced off.  The ``g`` groups of a pass are
a leading batch dimension.  Both backends run the same plan.  On the card
every pass is a kernel (:func:`merge_runs_ranked`): groups that fit one
tile of the grouped launch go to it, wider groups to the wide grouped
launch, whose blocks co-rank their own tiles; a wide group of more runs
than that launch takes is merged in sub-groups, then again
(:func:`merge_runs_split`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import dispatch
from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES

__all__ = [
    "merge_sort",
    "merge_argsort",
    "sort_key_val",
    "merge_runs_ranked",
    "merge_pairs_ranked",
    "merge_runs_plain",
    "merge_runs_split",
    "sentinel_max",
    "sort_plan",
    "DEFAULT_FANOUT",
    "LEAF_WIDTH",
]

# Pass fan-out used when callers don't specify one (the reference's
# default; the port has not re-measured it on the card).
DEFAULT_FANOUT = 4

# Segment width of the leaf pass: the grouped launch's tile
# (``kernels.merge.GROUPS_TILE``, 4096 = 256 threads x 16 keys).  Tile and
# segment are both powers of two, so a leaf segment fills a tile exactly:
# no slot is padding, and every pass of a plan but the last merges whole
# powers of two.  The widest such segment also leaves the fewest wide
# passes after it: a sort of 2^24 keys takes 1 + 6 passes at fan-out 4,
# where s = 2048 would take 1 + 7.  The leaf's own cost per key grows
# with log2(s)^2 (a bitonic network in registers and shuffles), but it
# reads and writes every key once whatever s is, as each wide pass does.
LEAF_WIDTH = 4096


def sentinel_max(dtype) -> torch.Tensor:
    """Order-preserving padding value: sorts after every real element.

    ``+inf`` for floating dtypes, ``iinfo.max`` for integers — the single
    definition every padding site uses.  ``dtype`` is a torch dtype or
    anything ``np.dtype`` accepts; the result is a 0-d CPU tensor.
    """
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
    if dtype.is_floating_point:
        return torch.tensor(float("inf"), dtype=dtype)
    return torch.tensor(torch.iinfo(dtype).max, dtype=dtype)


def _pad_max(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    fill = torch.full((pad,), sentinel_max(x.dtype).item(), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill])


def merge_runs_plain(keys: torch.Tensor, vals: torch.Tensor | None = None):
    """Merge of groups of adjacent sorted runs in torch ops, as a tree of
    pairwise rank merges: ``keys`` ``(g, k, w)`` -> ``(g, k*w)``; ``vals``
    (same shape, or ``None``) follows the same permutation.

    Level by level, runs ``(2i, 2i+1)`` of every group merge: an element
    lands at its index in its own run plus the sibling's elements before
    it (strict for the left run, ties for the right: the lower run wins
    ties); an odd last run passes through.  ``ceil(log2 k)`` levels of one
    batched ``searchsorted`` each, so a leaf of ``k`` runs of width 1
    costs ``log2 k`` searches, not ``k``.
    """
    g, k, w = keys.shape
    dev = keys.device
    out_k = keys.reshape(g, k, w)
    out_v = None if vals is None else vals.reshape(g, k, w)
    while k > 1:
        pairs, odd = k // 2, k % 2
        lk = out_k[:, :2 * pairs].reshape(g * pairs, 2, w)
        left, right = lk[:, 0].contiguous(), lk[:, 1].contiguous()
        idx = torch.arange(w, device=dev)
        pos_l = idx + torch.searchsorted(right, left, side=SIDE_STRICT)
        pos_r = idx + torch.searchsorted(left, right, side=SIDE_TIES)
        pos = torch.cat([pos_l, pos_r], dim=1)
        merged = torch.empty((g * pairs, 2 * w), dtype=keys.dtype, device=dev)
        merged.scatter_(1, pos, lk.reshape(g * pairs, 2 * w))
        merged = merged.reshape(g, pairs, 2 * w)
        if out_v is not None:
            lv = out_v[:, :2 * pairs].reshape(g * pairs, 2 * w)
            mv = torch.empty_like(lv).scatter_(1, pos, lv)
            mv = mv.reshape(g, pairs, 2 * w)
        if odd:  # the last run passes through, padded to the new width
            merged = _with_tail(merged, out_k[:, -1:], w,
                                sentinel_max(keys.dtype).item())
            if out_v is not None:
                mv = _with_tail(mv, out_v[:, -1:], w, 0)
        out_k = merged
        out_v = None if out_v is None else mv
        k, w = pairs + odd, 2 * w
    n = keys.shape[1] * keys.shape[2]
    if keys.shape[1] == 1:  # nothing merged: a copy, as every other shape
        out_k = out_k.clone()
        out_v = None if out_v is None else out_v.clone()
    out_k = out_k.reshape(g, -1)[:, :n]
    return out_k, (None if out_v is None else out_v.reshape(g, -1)[:, :n])


def _with_tail(merged: torch.Tensor, tail: torch.Tensor, w: int, fill):
    """Append the odd run ``tail`` ``(g, 1, w)`` to ``merged`` ``(g, p,
    2w)`` as one more run of width ``2w``, its second half ``fill``.  With
    :func:`sentinel_max` as the fill the run stays sorted, and as the
    right run of every later level (the last run always is) its fill loses
    every tie, so the fill ends up after every real element."""
    pad = torch.full((tail.shape[0], 1, w), fill, dtype=tail.dtype,
                     device=tail.device)
    return torch.cat([merged, torch.cat([tail, pad], dim=2)], dim=1)


def merge_runs_split(keys: torch.Tensor, vals: torch.Tensor | None, merge,
                     limit: int):
    """Merge groups of ``k > limit`` adjacent sorted runs with ``merge``,
    which takes at most ``limit`` runs a group: ``keys`` ``(g, k, w)`` ->
    ``(g, k*w)``, ``vals`` alike.

    The ``k`` runs of a group split into ``s = ceil(k / limit)`` adjacent
    sub-groups of ``p = ceil(k / s)`` runs; ``merge`` merges every
    sub-group of every group in one call, and its ``s`` results, runs of
    width ``p*w`` in order, are merged again the same way until one run is
    left.  The ``s*p - k < p`` missing runs pad the last sub-group with
    :func:`sentinel_max` runs (payload 0) after every real run, so a
    sentinel loses every tie with a real dtype-max key, and the padding
    ends the merge and is sliced off.  Stable, as every level keeps the
    runs adjacent and in order and the lower sub-group wins ties.
    """
    g, k, w = keys.shape
    s = -(-k // limit)
    p = -(-k // s)
    pad = s * p - k
    if pad:
        fill = torch.full((g, pad, w), sentinel_max(keys.dtype).item(),
                          dtype=keys.dtype, device=keys.device)
        keys = torch.cat([keys, fill], dim=1)
        if vals is not None:
            vals = torch.cat([vals, vals.new_zeros((g, pad, w))], dim=1)
    out_k, out_v = merge(keys.reshape(g * s, p, w),
                         None if vals is None else vals.reshape(g * s, p, w))
    out_k = out_k.reshape(g, s, p * w)
    out_v = None if out_v is None else out_v.reshape(g, s, p * w)
    if s > limit:
        out_k, out_v = merge_runs_split(out_k, out_v, merge, limit)
    else:
        out_k, out_v = merge(out_k, out_v)
    out_k = out_k[:, :k * w].contiguous()
    return out_k, (None if out_v is None else out_v[:, :k * w].contiguous())


def merge_runs_ranked(keys: torch.Tensor, vals: torch.Tensor | None):
    """Merge groups of adjacent sorted runs: ``keys`` ``(g, k, w)`` with
    every ``keys[i, r]`` sorted -> ``(g, k*w)`` stably merged (lower ``r``
    wins ties).  ``vals`` (same shape) follows the same permutation.

    The backend follows ``REPRO_TORCH_MERGE_BACKEND`` (``repro_torch.backend``;
    ``auto`` is ``cuda`` for CUDA tensors).  On ``cuda`` every shape runs
    kernels: groups that fit one tile (``k*w <= GROUPS_TILE``) go to the
    grouped launch (``kernels.merge.merge_kway_tile_groups``), wider ones
    to the wide grouped launch (``kernels.merge.merge_kway_groups_wide``),
    and wider ones of more than ``WIDE_MAX_RUNS`` runs through
    :func:`merge_runs_split`, each of whose merges takes the same route.
    A kernel raises for what it does not take (a key dtype); none gives
    way to torch ops.  The ``torch`` backends run :func:`merge_runs_plain`.
    """
    op = "merge_runs_ranked"
    keys = keys.contiguous()
    vals = None if vals is None else vals.contiguous()
    if dispatch(op, None, keys, vals) == "cuda":
        return _merge_runs_kernels(keys, vals)
    return merge_runs_plain(keys, vals)


def _merge_runs_kernels(keys: torch.Tensor, vals: torch.Tensor | None):
    """:func:`merge_runs_ranked` on the card's kernels."""
    # Imported here: kernels.merge imports this module.
    from repro_torch.kernels import merge as km

    g, k, w = keys.shape
    if k * w <= km.GROUPS_TILE:
        return km.merge_kway_tile_groups(keys, vals)
    if k <= km.WIDE_MAX_RUNS:
        return km.merge_kway_groups_wide(keys, vals)
    return merge_runs_split(keys, vals, _merge_runs_kernels, km.WIDE_MAX_RUNS)


def merge_pairs_ranked(keys: torch.Tensor, vals: torch.Tensor | None):
    """Pairwise special case kept for callers and benchmarks: ``keys`` and
    ``vals`` of shape ``(r, 2, w)`` -> ``(r, 2w)``."""
    return merge_runs_ranked(keys, vals)


def _padded_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _check_fanout(fanout: int) -> int:
    """Validate and resolve a fan-out: 0 means 'library default'."""
    if not fanout:
        return DEFAULT_FANOUT
    if fanout < 2 or fanout & (fanout - 1):
        raise ValueError(
            f"fanout must be a power of two >= 2 (or 0 for the "
            f"default), got {fanout}"
        )
    return fanout


def sort_plan(n: int, fanout: int = DEFAULT_FANOUT) -> list[tuple[int, int, int]]:
    """``(g, k, w)`` of every pass of a sort of ``n`` keys: the leaf
    ``(np2 // s, s, 1)`` with ``s = min(LEAF_WIDTH, np2)``, then the
    ``fanout`` passes from width ``s`` up (the last one merges fewer runs
    when ``fanout`` does not divide what is left).  ``np2`` is ``n``
    padded to a power of two; empty for ``n <= 1``.  Both backends run
    this plan; on the card a pass with ``k*w <= GROUPS_TILE`` is one
    grouped launch and a wider one a wide launch.
    """
    fanout = _check_fanout(fanout)
    if n <= 1:
        return []
    np2 = _padded_pow2(n)
    s = min(LEAF_WIDTH, np2)
    plan = [(np2 // s, s, 1)]
    width = s
    while width < np2:
        group = min(fanout, np2 // width)  # both powers of two: divides
        plan.append((np2 // (group * width), group, width))
        width *= group
    return plan


def sort_key_val(keys: torch.Tensor, vals: torch.Tensor,
                 fanout: int = DEFAULT_FANOUT):
    """Stable sort of ``(keys, vals)`` by ``keys`` (1-D), merge-sort based.

    ``fanout``: runs merged per pass (power of two; 0 = default).
    """
    fanout = _check_fanout(fanout)
    n = keys.shape[0]
    if n <= 1:
        return keys, vals
    np2 = _padded_pow2(n)
    k = _pad_max(keys, np2 - n)
    v = torch.cat([vals, vals.new_zeros(np2 - n)]) if np2 > n else vals
    for g, group, width in sort_plan(n, fanout):
        k, v = merge_runs_ranked(
            k.reshape(g, group, width), v.reshape(g, group, width)
        )
        k, v = k.reshape(np2), v.reshape(np2)
    return k[:n], v[:n]


def merge_sort(x: torch.Tensor, fanout: int = DEFAULT_FANOUT) -> torch.Tensor:
    """Stable merge sort of a 1-D tensor (k-way bottom-up passes)."""
    fanout = _check_fanout(fanout)
    n = x.shape[0]
    if n <= 1:
        return x
    np2 = _padded_pow2(n)
    k = _pad_max(x, np2 - n)
    for g, group, width in sort_plan(n, fanout):
        k, _ = merge_runs_ranked(k.reshape(g, group, width), None)
        k = k.reshape(np2)
    return k[:n]


def merge_argsort(x: torch.Tensor,
                  fanout: int = DEFAULT_FANOUT) -> torch.Tensor:
    """Stable argsort (equal keys keep input order) via sort_key_val."""
    idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    _, order = sort_key_val(x, idx, fanout)
    return order
