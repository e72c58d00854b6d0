"""Plain oracles for the merge kernels (torch port of ``repro.kernels.ref``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES

__all__ = ["merge_ref", "merge_np", "sort_ref", "topk_ref"]


def merge_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge oracle: element-wise co-ranking in torch ops.

    (The engine-independent oracle is ``merge_np`` — numpy's stable sort;
    the tie-break sides here come from the engine.)
    """
    m, n = a.shape[0], b.shape[0]
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    pos_a = torch.arange(m, device=a.device) + torch.searchsorted(
        b, a, side=SIDE_STRICT
    )
    pos_b = torch.arange(n, device=a.device) + torch.searchsorted(
        a, b, side=SIDE_TIES
    )
    out = torch.empty((m + n,), dtype=dtype, device=a.device)
    out[pos_a] = a
    out[pos_b] = b
    return out


def merge_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """NumPy oracle: stable merge == stable sort of the concatenation."""
    return np.sort(np.concatenate([a, b]), kind="stable")


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).values


def topk_ref(x: torch.Tensor, k: int):
    """Top-k oracle of a 1-D tensor: a stable descending argsort, cut to
    ``k`` -- ``(values, int32 indices)``, equal values in index order.

    ``x + 0`` folds ``-0.0`` into ``+0.0`` before the sort, so the two
    zeros tie as they do in the reference's comparison sort (a radix sort,
    as ``torch.sort`` runs on the card, would order them apart).
    """
    order = torch.argsort(-(x + 0), stable=True)[:k]
    return x[order], order.to(torch.int32)
