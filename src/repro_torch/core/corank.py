"""Co-ranking (Algorithm 1 of Siebert & Träff, 2013), torch port.

For a stable merge ``C = stable_merge(A, B)`` and an output rank ``i``,
``co_rank`` finds the unique ``(j, k)`` with ``j + k = i`` such that

    (1) j == 0  or  A[j-1] <= B[k]        (first Lemma condition)
    (2) k == 0  or  B[k-1] <  A[j]        (second Lemma condition)

i.e. ``C[0:i] == stable_merge(A[0:j], B[0:k])``.  This module is the
local-tensor instantiation of the one engine (``repro_torch.core.engine``):
it supplies reads into two tensors.  Lanes are a batch dimension: ``i`` of
any shape co-ranks every element at once, which is what the reference's
``vmap`` over ``co_rank`` computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine
from repro_torch.core.engine import prop1_bound  # noqa: F401  (re-export)

__all__ = ["co_rank", "co_rank_batch", "CoRankResult", "prop1_bound"]


class CoRankResult(NamedTuple):
    """``j``/``k`` are the unique co-ranks; ``iterations`` counts the
    Algorithm-1 rounds in which the lane had not yet converged (checked
    against Proposition 1's bound)."""

    j: torch.Tensor
    k: torch.Tensor
    iterations: torch.Tensor


def co_rank(i, a: torch.Tensor, b: torch.Tensor) -> CoRankResult:
    """Algorithm 1: co-ranks ``(j, k)`` of output rank(s) ``i``.

    Args:
      i: output rank(s), ``0 <= i <= m + n``: a Python int or an integer
        tensor of any shape (every element is an independent lane).
      a: ordered tensor of shape ``(m,)``.
      b: ordered tensor of shape ``(n,)``, on ``a``'s device.

    Returns:
      ``CoRankResult(j, k, iterations)``, int32, shaped like ``i``, with
      ``j + k == i``.
    """
    i = torch.as_tensor(i, dtype=torch.int32, device=a.device)
    m, n = a.shape[0], b.shape[0]
    j, k, iters = engine.co_rank_pairwise(
        i,
        m,
        n,
        read_a=lambda idx: a[idx],
        read_b=lambda idx: b[idx],
        metric="corank.iterations",
    )
    return CoRankResult(j, k, iters)


def co_rank_batch(i, a: torch.Tensor, b: torch.Tensor) -> CoRankResult:
    """Co-ranks of a batch of ranks ``i`` of shape ``(r,)``: all lanes in
    lock-step, ``prop1_bound(m, n)`` masked rounds (Proposition 1)."""
    return co_rank(i, a, b)
