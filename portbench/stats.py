"""The arithmetic of the end-to-end metrics and of device busy time."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    the closest ranks (numpy's default): rank ``q/100 * (n - 1)`` of the
    sorted values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = q / 100.0 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total
