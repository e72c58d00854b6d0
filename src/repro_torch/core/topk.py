"""Top-k selection built on the k-way co-rank merge (torch port of
``repro.core.topk``).

Two-stage tournament, every stage a stable merge:

  1. split the row into blocks of ``block`` elements and merge-sort each
     block (vectorised over blocks: the block's
     :func:`~repro_torch.core.mergesort.sort_plan`, one leaf merge of
     ``block`` runs of width 1 when the block fits the leaf);
  2. collapse the per-block candidate lists with k-way candidate merges:
     groups of up to ``fanout`` lists merge in one step and only the top
     ``k`` of each merged ``fanout*k`` list survive, ``log_fanout(nb)``
     rounds in all.

:func:`merge_topk_batch` runs the tournament over ``b`` rows at once: the
batch is a leading group dimension of every block sort and candidate
merge, so a whole decode batch costs one ``merge_runs_ranked`` call per
pass and per round, whatever ``b`` is.  Row ``i`` of the result equals
:func:`merge_topk` of row ``i`` bit for bit: no reshape groups across
rows.  On the card every one of those calls is a kernel launch: the
block sort one grouped launch (a block fits its tile), each round another
(a group of ``fanout*k`` candidates fits it), so a top-k is ``1 + rounds``
launches.

Stability: equal keys resolve to the lower original index (the lower run
wins ties in every merge, and runs stay in index order), as
``jax.lax.top_k`` does.  ``-0.0`` and ``+0.0`` compare equal.
"""

from __future__ import annotations

import torch

from repro_torch.core.mergesort import (
    _padded_pow2,
    merge_runs_ranked,
    sentinel_max,
    sort_plan,
)

__all__ = [
    "merge_topk",
    "merge_topk_batch",
    "candidate_blocks",
    "tournament_rounds",
    "TOURNAMENT_FANOUT",
]

# Candidate lists merged per tournament round; 16 collapses any
# realistic block count in one or two rounds.
TOURNAMENT_FANOUT = 16


def _desc_sort_blocks(keys: torch.Tensor, vals: torch.Tensor):
    """Stable ascending sort within each row of ``keys``/``vals`` (r, w),
    ``w`` a power of two: the rows' merge-sort plan (``sort_plan(w)``,
    every pass's groups times ``r``).  A row that fits the leaf is one
    merge of ``w`` runs of width 1, so the whole block sort is one call."""
    r, w = keys.shape
    k, v = keys, vals
    for g, group, width in sort_plan(w):
        k2, v2 = merge_runs_ranked(
            k.reshape(r * g, group, width), v.reshape(r * g, group, width)
        )
        k, v = k2.reshape(r, w), v2.reshape(r, w)
    return k, v


def candidate_blocks(n: int, k: int, block: int = 128) -> tuple[int, int]:
    """Static stage-1 shape of the tournament for a row of ``n`` logits:
    ``(resolved block width, number of candidate runs)``.  The block is
    rounded to a power of two >= k so the in-block sort's run reshapes
    stay aligned."""
    block = _padded_pow2(max(block, k))
    return block, -(-n // block)


def tournament_rounds(nb: int, fanout: int = 0) -> list[int]:
    """Run counts *entering* each tournament round (after padding to a
    group multiple), for ``nb`` stage-1 candidate runs.

    ``len()`` of the result is the number of merges a top-k takes after
    the block sort; the last entry times ``k`` is the candidate count of
    the final merge.  Empty when ``nb <= 1``.
    """
    fanout = fanout or TOURNAMENT_FANOUT
    rounds = []
    r = nb
    while r > 1:
        group = min(fanout, r)
        if r % group:
            r += group - r % group
        rounds.append(r)
        r //= group
    return rounds


def merge_topk_batch(x: torch.Tensor, k: int, block: int = 128,
                     fanout: int = 0):
    """Row-wise top-k of a 2-D tensor: ``(b, n) -> (values, indices)``,
    both ``(b, k)`` descending, indices int32.

    Keys are negated so the ascending stable merge yields a descending
    order with ties broken toward the lower index: floating rows are cast
    to float32 first, integer rows are negated as they are.  Blocks are
    padded with the negated dtype's :func:`sentinel_max` (indices run on
    through the padding), tournament padding lists with the sentinel and
    index 0; the values are ``-keys`` cast back to ``x.dtype``.
    ``fanout=0`` (the config-field convention) means
    ``TOURNAMENT_FANOUT``.
    """
    fanout = fanout or TOURNAMENT_FANOUT
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    b, n = x.shape
    dev = x.device
    block, nb = candidate_blocks(n, k, block)
    pad = nb * block - n
    neg = -x.float() if x.is_floating_point() else -x
    sentinel = sentinel_max(neg.dtype).item()
    keys = torch.cat([neg, neg.new_full((b, pad), sentinel)], dim=1)
    idx = torch.arange(nb * block, dtype=torch.int32, device=dev).expand(
        b, nb * block)
    keys, idx = _desc_sort_blocks(
        keys.reshape(b * nb, block), idx.reshape(b * nb, block)
    )  # ascending in negated keys
    # per-block top-k candidates: (b, nb, k)
    keys = keys.reshape(b, nb, block)[:, :, :k]
    idx = idx.reshape(b, nb, block)[:, :, :k]

    # Tournament: k-way merge candidate lists, keep the top k of each
    # merged group -- one merge for the whole batch per round.
    r = nb
    while r > 1:
        group = min(fanout, r)
        if r % group:  # pad with sentinel lists to a group multiple
            extra = group - r % group
            keys = torch.cat(
                [keys, keys.new_full((b, extra, k), sentinel)], dim=1)
            idx = torch.cat([idx, idx.new_zeros((b, extra, k))], dim=1)
            r += extra
        mk, mi = merge_runs_ranked(
            keys.reshape(b * (r // group), group, k),
            idx.reshape(b * (r // group), group, k),
        )
        keys = mk.reshape(b, r // group, group * k)[:, :, :k]
        idx = mi.reshape(b, r // group, group * k)[:, :, :k]
        r //= group

    vals = -keys[:, 0]
    return vals.to(x.dtype), idx[:, 0]


def merge_topk(x: torch.Tensor, k: int, block: int = 128, fanout: int = 0):
    """Top-k of a 1-D tensor: ``(values, indices)`` descending.

    Single-row view of :func:`merge_topk_batch` (same tournament, same
    tie-breaking, same padding).
    """
    vals, idx = merge_topk_batch(x[None], k, block=block, fanout=fanout)
    return vals[0], idx[0]
