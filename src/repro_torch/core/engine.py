"""One co-rank engine: the paper's search, defined exactly once (torch port).

Port of ``repro.core.engine``.  Every tier runs the same stable co-rank
search of Siebert & Träff (2013) against a different way of reading the
runs:

======================  =====================================  ==========
tier                    probe / reads                          loop
======================  =====================================  ==========
``core.corank``         tensor indexing                        Prop.-1 bounded masked rounds (no host sync)
``core.kway``           batched ``torch.searchsorted`` (k, w)  static Python loop of device ops
``external.planner``    ``np.searchsorted`` over mmap'd runs   plain Python loop
``kernels.merge``       staged shared-memory windows (CUDA)    per-thread search in the kernel
======================  =====================================  ==========

The Lemma-1 predicates, the ``<=`` / ``<`` tie-break pair, the padding
clamp and the round bounds live here and nowhere else.  Functions that
the host planner shares with the device tiers take an ``xp`` array
namespace: ``torch`` on tensors, ``numpy`` on host arrays.  ``torch``
returns int64 counts and indices; the engine casts them to int32, the
reference's cut type, wherever a device cut is produced.

Paper mapping
-------------

* **Lemma 1** — rank ``i`` of the stable merge of A and B cuts them at
  the unique ``(j, k)``, ``j + k = i``, with ``A[j-1] <= B[k]`` and
  ``B[k-1] < A[j]`` (:func:`first_condition_holds` /
  :func:`second_condition_violated`); for ``k`` runs, runs before the
  query's run count ties and runs after it count strictly
  (:func:`lemma1_counts`).
* **Algorithm 1** — the double-ended binary search for ``(j, k)``:
  :func:`co_rank_pairwise`; the k-way form is one monotone bisection
  per run: :func:`co_rank_search`.
* **Proposition 1** — the iteration bound ``ceil(log2 min(m, n)) + 1``
  (:func:`prop1_bound`).  The port runs exactly that many masked rounds
  in place of the reference's dynamic ``lax.while_loop``: a converged
  lane's step is a no-op, so ``(j, k)`` and the per-lane iteration count
  equal the dynamic loop's, and no round needs the host to test for
  convergence.
"""

from __future__ import annotations

from typing import Any, Callable, Protocol

import numpy as np
import torch

from repro_torch import obs

__all__ = [
    "SIDE_TIES",
    "SIDE_STRICT",
    "counts_ties",
    "count_side",
    "count_below",
    "first_condition_holds",
    "first_condition_violated",
    "second_condition_violated",
    "take_first",
    "kfinger_better",
    "lemma1_counts",
    "value_cut_counts",
    "prop1_bound",
    "kway_round_bound",
    "pairwise_lockstep_rounds",
    "run_fori",
    "run_host",
    "Probe",
    "merged_rank",
    "co_rank_search",
    "co_rank_pairwise",
]


# ---------------------------------------------------------------------------
# §1  Stability: the Lemma-1 predicates and the <= / < tie-break pair.
# ---------------------------------------------------------------------------

#: ``searchsorted`` sides implementing the pair: an owner run that
#: *precedes* the query's run counts ties (``<=`` -> ``side='right'``);
#: one that *follows* counts strictly (``<`` -> ``side='left'``).  The
#: same strings select the side in ``np.searchsorted`` and
#: ``torch.searchsorted``.
SIDE_TIES = "right"
SIDE_STRICT = "left"


def counts_ties(owner_run: int, query_run: int) -> bool:
    """Does run ``owner_run`` count ties against a query from ``query_run``?

    True iff the owner precedes the query's run in the stable order — the
    run-index tie-break (static run indices).
    """
    return owner_run < query_run


def count_side(owner_run: int, query_run: int) -> str:
    """``searchsorted`` side for run ``owner_run`` counting against
    queries from run ``query_run`` (static run indices)."""
    return SIDE_TIES if counts_ties(owner_run, query_run) else SIDE_STRICT


def count_below(v, x, ties: bool):
    """``v <= x`` (ties) or ``v < x`` (strict) — THE comparison pair."""
    return (v <= x) if ties else (v < x)


def first_condition_holds(a_prev, b_val):
    """Lemma 1, first condition: ``A[j-1] <= B[k]`` (ties to A)."""
    return count_below(a_prev, b_val, ties=True)


def first_condition_violated(a_prev, b_val):
    """``A[j-1] > B[k]`` — j must decrease (Algorithm 1, lines 6-10)."""
    return ~first_condition_holds(a_prev, b_val)


def second_condition_violated(b_prev, a_val):
    """``B[k-1] >= A[j]`` — k must decrease (Algorithm 1, lines 11-15)."""
    return ~count_below(b_prev, a_val, ties=False)


def take_first(first_val, second_val, first_avail, second_avail):
    """Two-finger merge decision: take from the *earlier* input?

    Yes iff it has elements left and (the later input is exhausted or
    ``first <= second``) — ties always emit the earlier input first.
    """
    return first_avail & (
        ~second_avail | count_below(first_val, second_val, ties=True)
    )


def kfinger_better(val, best_val, avail, best_ok):
    """k-finger merge decision: does a *later* run's head beat the best?

    Only strictly (``<``): on ties the earlier run (already in ``best``)
    wins — the run-index tie-break.
    """
    return avail & (~best_ok | count_below(val, best_val, ties=False))


def lemma1_counts(count_le, count_lt, owner, query, owner_length, xp=torch):
    """Select each run pair's Lemma-1 side and clamp away padding.

    Owners before the query's run contribute their tie count, owners after
    their strict count, a run contributes nothing to its own queries, and
    no run ever counts its padded tail (the ``owner_length`` clip — valid
    because padding is required to be >= every real element).  ``xp`` is
    ``torch`` or ``numpy``; both spell the three calls alike.
    """
    cnt = xp.where(owner < query, count_le, count_lt)
    cnt = xp.where(owner == query, xp.zeros_like(cnt), cnt)
    return xp.minimum(cnt, owner_length)


def _searchsorted_i32(xp, run, x, side: str):
    """``searchsorted`` in ``xp``, as int32 (the reference's cut type)."""
    if xp is np:
        return np.searchsorted(run, x, side=side).astype(np.int32)
    return torch.searchsorted(run, x, side=side, out_int32=True)


def value_cut_counts(run, boundary_values, length=None, xp=torch):
    """Degenerate Lemma-1 search when the boundary *values* are known.

    The cut of a known boundary value ``v`` is the strictly-below count
    (``SIDE_STRICT``): every element equal to ``v`` sorts after the
    boundary, so one ``searchsorted`` per boundary replaces the
    bisection.  ``length`` clamps away padded tails.
    """
    local = _searchsorted_i32(xp, run, boundary_values, SIDE_STRICT)
    if length is not None:
        local = xp.minimum(local, length)
    return local


# ---------------------------------------------------------------------------
# §2  Round bounds (Proposition 1 and its lock-step paddings).
# ---------------------------------------------------------------------------


def prop1_bound(m: int, n: int) -> int:
    """Proposition 1's iteration bound ``ceil(log2 min(m, n)) + 1``."""
    mn = min(m, n)
    if mn <= 0:
        return 0
    return (mn - 1).bit_length() + 1


def kway_round_bound(w: int) -> int:
    """Static lock-step schedule for one run of width ``w``:
    ``ceil(log2(w + 1)) + 1`` rounds over the ``w + 1`` candidate cuts."""
    return max(1, w).bit_length() + 1


def pairwise_lockstep_rounds(m: int, n: int) -> int:
    """Static schedule for the lock-step pairwise search: Proposition 1's
    range plus one safety round."""
    return kway_round_bound(min(m, n)) + 1


# ---------------------------------------------------------------------------
# §3  Loop runners.
# ---------------------------------------------------------------------------


def run_fori(rounds: int, body: Callable, state):
    """Device runner: a static Python loop of tensor ops.  The round count
    is fixed before the loop starts, so no round waits for the device."""
    for _ in range(rounds):
        state = body(state)
    return state


#: Host runner (numpy / mmap probes): the same static loop.
run_host = run_fori


# ---------------------------------------------------------------------------
# §4  The k-way lock-step bisection, probe-parameterized.
# ---------------------------------------------------------------------------


class Probe(Protocol):
    """How a tier reads its runs (``repro.core.engine.Probe``'s protocol).

    ``xp`` is ``torch`` or ``numpy``; ``counts(x)`` returns both Lemma-1
    sides ``(count_le, count_lt)``; ``reduce`` folds sibling contributions
    into the cut shape.
    """

    xp: Any
    width: int
    lengths: Any
    owner_ids: Any
    query_ids: Any
    owner_lengths: Any

    def init_bounds(self, i):
        ...

    def values(self, t):
        ...

    def counts(self, x):
        ...

    def reduce(self, cnt):
        ...

    def run_loop(self, rounds: int, body: Callable, state):
        ...


def merged_rank(probe: Probe, t):
    """Stable merged rank of candidate elements ``(r, t_r)``:
    ``t + sum_{rp != r} |{u : runs[rp][u] (<= | <) runs[r][t]}|``."""
    x = probe.values(t)
    count_le, count_lt = probe.counts(x)
    cnt = lemma1_counts(
        count_le,
        count_lt,
        probe.owner_ids,
        probe.query_ids,
        probe.owner_lengths,
        xp=probe.xp,
    )
    return t + probe.reduce(cnt)


def co_rank_search(
    i,
    probe: Probe,
    *,
    metric: str | None = None,
    labels: dict | None = None,
):
    """Cut vector of output rank(s) ``i``: the k-way Lemma-1 bisection.

    One monotone binary search per run, all runs in lock-step, for
    ``j_r(i) = |{t : rank(r, t) < i}|``; ``kway_round_bound(width)``
    rounds.  ``i`` must broadcast against the probe's cut shape.
    """
    xp = probe.xp
    rounds = kway_round_bound(probe.width)
    lengths = probe.lengths

    def body(lo_hi):
        lo, hi = lo_hi
        mid = (lo + hi) // 2
        pred = (mid < lengths) & (merged_rank(probe, mid) < i)
        return xp.where(pred, mid + 1, lo), xp.where(pred, hi, mid)

    lo, hi = probe.init_bounds(i)
    lo, _ = probe.run_loop(rounds, body, (lo, hi))
    if metric is not None and obs.enabled():
        obs.gauge(metric, rounds, bound=rounds, **(labels or {}))
    return lo


# ---------------------------------------------------------------------------
# §5  The pairwise Algorithm 1 (double-ended search), read-parameterized.
# ---------------------------------------------------------------------------


def _violations(state, reads, m: int, n: int):
    """Both Lemma-1 conditions at the current search state (four boundary
    reads; the guards make out-of-range reads moot)."""
    j, k = state[0], state[1]
    a_jm1, b_k, b_km1, a_j = reads(j, k)
    fv = (j > 0) & (k < n) & first_condition_violated(a_jm1, b_k)
    sv = (k > 0) & (j < m) & second_condition_violated(b_km1, a_j)
    return fv, sv


def _algorithm1_step(state, fv, sv):
    """One Algorithm-1 refinement step given the two violation masks.

    First condition violated -> decrease ``j``; else second violated ->
    decrease ``k``; else hold (a converged lane idles).
    """
    j, k, j_low, k_low = state
    delta_j = (j - j_low + 1) // 2  # ceil((j - j_low)/2)
    delta_k = (k - k_low + 1) // 2  # ceil((k - k_low)/2)
    new_k_low = torch.where(fv, k, k_low)
    new_j_low = torch.where(fv | ~sv, j_low, j)
    new_j = torch.where(fv, j - delta_j, torch.where(sv, j + delta_k, j))
    new_k = torch.where(fv, k + delta_j, torch.where(sv, k - delta_k, k))
    return new_j, new_k, new_j_low, new_k_low


def co_rank_pairwise(
    i,
    m: int,
    n: int,
    read_a: Callable,
    read_b: Callable,
    *,
    rounds: int | None = None,
    metric: str | None = None,
    labels: dict | None = None,
):
    """Algorithm 1: co-ranks ``(j, k)`` of output rank(s) ``i``.

    ``i`` is an int32 tensor of any shape (each element a lane);
    ``read_a(idx)`` / ``read_b(idx)`` receive already-clamped index
    tensors.  ``rounds=None`` runs ``prop1_bound(m, n)`` masked rounds
    and counts, per lane, the rounds in which a Lemma-1 condition was
    still violated — the reference's dynamic while-loop count; an integer
    runs that many rounds and reports it for every lane.

    Returns ``(j, k, iterations)``.
    """
    i = torch.as_tensor(i, dtype=torch.int32)

    # Extreme initial assumption: as many of the i elements as possible
    # come from A.
    j = torch.clamp(i, max=m)
    k = i - j
    j_low = torch.clamp(i - n, min=0)
    k_low = torch.zeros_like(i)

    # Degenerate sides: Prop. 1's bound is 0 and the initial guess is
    # already the answer — never read the empty array.
    if m == 0 or n == 0:
        if metric is not None and obs.enabled() and rounds is None:
            obs.histogram(metric, k_low, bound=0, m=m, n=n, **(labels or {}))
        return j, k, torch.zeros_like(i)

    def reads(j, k):
        a_jm1 = read_a(torch.clamp(j - 1, 0, m - 1))
        b_k = read_b(torch.clamp(k, 0, n - 1))
        b_km1 = read_b(torch.clamp(k - 1, 0, n - 1))
        a_j = read_a(torch.clamp(j, 0, m - 1))
        return a_jm1, b_k, b_km1, a_j

    state = (j, k, j_low, k_low)
    iters = torch.zeros_like(i)
    for _ in range(prop1_bound(m, n) if rounds is None else rounds):
        fv, sv = _violations(state, reads, m, n)
        if rounds is None:
            iters += (fv | sv).to(torch.int32)
        state = _algorithm1_step(state, fv, sv)
    if rounds is not None:
        iters = torch.full_like(i, rounds)

    j, k = state[0], state[1]
    if metric is not None and obs.enabled():
        if rounds is None:
            obs.histogram(
                metric, iters, bound=prop1_bound(m, n), m=m, n=n,
                **(labels or {}),
            )
        else:
            obs.gauge(
                metric, rounds, bound=rounds, prop1_bound=prop1_bound(m, n),
                m=m, n=n, **(labels or {}),
            )
    return j, k, iters
