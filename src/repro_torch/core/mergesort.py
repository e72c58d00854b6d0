"""Stable merge sort built from the co-rank merge primitive (torch port).

Bottom-up merge sort with configurable fan-out: a pass merges groups of
``fanout`` adjacent runs of width ``w`` into runs of width ``fanout*w``
with the k-way rank merge of ``repro_torch.core.kway`` — ``log_fanout(n)``
passes.  Every pass is stable (lower run index wins ties, runs are laid
out in input order), so the whole sort is stable without key widening.

The input is padded to the next power of two with :func:`sentinel_max`,
which sorts to the tail and is sliced off.  The ``g`` groups of a pass are
a leading batch dimension.  On the card, a pass whose groups fit one tile
of ``merge_kway_tile`` runs as that kernel's grouped launch
(:func:`merge_runs_ranked`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import announce, dispatch
from repro_torch.core.kway import kway_positions

__all__ = [
    "merge_sort",
    "merge_argsort",
    "sort_key_val",
    "merge_runs_ranked",
    "merge_runs_plain",
    "sentinel_max",
    "DEFAULT_FANOUT",
]

# Pass fan-out used when callers don't specify one (the reference's
# default; the port has not re-measured it on the card).
DEFAULT_FANOUT = 4


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
    fill = torch.full((pad,), sentinel_max(x.dtype).item(), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill])


def merge_runs_plain(keys: torch.Tensor, vals: torch.Tensor | None = None):
    """Rank merge of groups of adjacent sorted runs in torch ops: every
    element's output position (``kway_positions``, lower run wins ties),
    then a scatter.  ``keys`` ``(g, k, w)`` -> ``(g, k*w)``; ``vals`` (same
    shape, or ``None``) follows the same permutation."""
    g, k, w = keys.shape
    pos = kway_positions(keys).reshape(g, k * w).long()
    out_k = torch.empty((g, k * w), dtype=keys.dtype, device=keys.device)
    out_k.scatter_(1, pos, keys.reshape(g, k * w))
    if vals is None:
        return out_k, None
    out_v = torch.empty((g, k * w), dtype=vals.dtype, device=vals.device)
    out_v.scatter_(1, pos, vals.reshape(g, k * w))
    return out_k, out_v


def merge_runs_ranked(keys: torch.Tensor, vals: torch.Tensor | None):
    """Merge groups of adjacent sorted runs: ``keys`` ``(g, k, w)`` with
    every ``keys[i, r]`` sorted -> ``(g, k*w)`` stably merged (lower ``r``
    wins ties).  ``vals`` (same shape) follows the same permutation.

    The backend follows ``REPRO_TORCH_MERGE_BACKEND`` (``repro_torch.backend``;
    ``auto`` is ``cuda`` for CUDA tensors).  On ``cuda``, groups that fit
    one tile (``k*w <= KWAY_TILE``) go to the grouped launch of
    ``merge_kway_tile`` (``kernels.merge.merge_kway_tile_groups``), which
    raises for dtypes it does not take; wider groups (merge sort's later
    passes) keep :func:`merge_runs_plain`.  That choice is made by shape,
    before any launch, and is logged once as ``kernels.backend_selected``.
    """
    op = "merge_runs_ranked"
    keys = keys.contiguous()
    vals = None if vals is None else vals.contiguous()
    if dispatch(op, None, keys, vals) == "cuda":
        # Imported here: kernels.merge imports this module.
        from repro_torch.kernels import merge as km

        if keys.shape[1] * keys.shape[2] <= km.KWAY_TILE:
            return km.merge_kway_tile_groups(keys, vals)
        announce(op, "torch", "shape", keys.device)
    return merge_runs_plain(keys, vals)


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


def _passes(np2: int, fanout: int):
    """``(g, group, width)`` of every merge pass over ``np2`` elements."""
    width = 1
    while width < np2:
        group = min(fanout, np2 // width)  # both powers of two: divides
        yield np2 // (group * width), group, width
        width *= group


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
    v = torch.cat([vals, vals.new_zeros(np2 - n)])
    for g, group, width in _passes(np2, fanout):
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
    for g, group, width in _passes(np2, fanout):
        k, _ = merge_runs_ranked(k.reshape(g, group, width), None)
        k = k.reshape(np2)
    return k[:n]


def merge_argsort(x: torch.Tensor,
                  fanout: int = DEFAULT_FANOUT) -> torch.Tensor:
    """Stable argsort (equal keys keep input order) via sort_key_val."""
    idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    _, order = sort_key_val(x, idx, fanout)
    return order
