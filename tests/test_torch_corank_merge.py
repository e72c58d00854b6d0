"""Parity of the port's pairwise co-rank and merges with the JAX reference.

``co_rank``/``co_rank_batch`` must return the reference's ``(j, k)`` and
its per-lane iteration counts (Proposition 1's evidence).  The port runs
``prop1_bound(m, n)`` masked rounds instead of a dynamic while loop, so the
tests also check, independently in numpy, that every lane ends on a cut
that satisfies both Lemma-1 conditions.  Merges are permutations of the
inputs: they must match bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.corank import co_rank as ref_co_rank
from repro.core.corank import co_rank_batch as ref_co_rank_batch
from repro.core.merge import merge_by_ranking as ref_merge_by_ranking
from repro.core.merge import merge_partitioned as ref_merge_partitioned
from repro.core.merge import merge_segment_twofinger as ref_twofinger
from repro_torch.core import engine
from repro_torch.core.corank import co_rank, co_rank_batch
from repro_torch.core.merge import (
    merge_by_ranking,
    merge_partitioned,
    merge_segment_twofinger,
    partition_bounds,
)

SIZES = [(1, 1), (1, 50), (50, 1), (37, 63), (128, 128), (300, 7),
         (0, 9), (9, 0)]


def _sorted(rng, n, lo, hi, dtype=np.int32):
    return np.sort(rng.integers(lo, hi, n)).astype(dtype)


def _lemma1_holds(a, b, j, k):
    m, n = len(a), len(b)
    first = j == 0 or k == n or a[j - 1] <= b[k]
    second = k == 0 or j == m or b[k - 1] < a[j]
    return first and second


@pytest.mark.parametrize("universe", [3, 1000])
@pytest.mark.parametrize("m,n", SIZES)
def test_co_rank_batch_matches_reference_and_converges(m, n, universe):
    rng = np.random.default_rng(m * 1000 + n + universe)
    a, b = _sorted(rng, m, 0, universe), _sorted(rng, n, 0, universe)
    ranks = np.arange(m + n + 1, dtype=np.int32)
    got = co_rank_batch(torch.from_numpy(ranks), torch.from_numpy(a),
                        torch.from_numpy(b))
    want = ref_co_rank_batch(jnp.asarray(ranks), jnp.asarray(a),
                             jnp.asarray(b))
    for field in ("j", "k", "iterations"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field)
    # Lane convergence: after prop1_bound masked rounds no lane still
    # violates a Lemma-1 condition, and none needed more rounds.
    for j, k, i in zip(got.j.numpy(), got.k.numpy(), ranks):
        assert j + k == i
        assert _lemma1_holds(a, b, j, k), (i, j, k)
    assert got.iterations.max().item() <= engine.prop1_bound(m, n)


def test_co_rank_scalar_matches_reference():
    rng = np.random.default_rng(1)
    a, b = _sorted(rng, 40, 0, 6), _sorted(rng, 25, 0, 6)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for i in (0, 1, 17, 40, 64, 65):
        got = co_rank(i, ta, tb)
        want = ref_co_rank(i, jnp.asarray(a), jnp.asarray(b))
        assert (got.j.item(), got.k.item(), got.iterations.item()) == (
            int(want.j), int(want.k), int(want.iterations))


def test_float_extremes_corank():
    a = np.array([-np.inf, -0.0, 0.0, 0.0, 1.5, np.inf], np.float32)
    b = np.array([-np.inf, 0.0, -0.0, np.inf, np.inf], np.float32)
    ranks = np.arange(12, dtype=np.int32)
    got = co_rank_batch(torch.from_numpy(ranks), torch.from_numpy(a),
                        torch.from_numpy(b))
    want = ref_co_rank_batch(jnp.asarray(ranks), jnp.asarray(a),
                             jnp.asarray(b))
    np.testing.assert_array_equal(got.j.numpy(), np.asarray(want.j))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))


def test_static_rounds_report_schedule():
    a = torch.arange(10, dtype=torch.int32)
    b = torch.arange(5, 15, dtype=torch.int32)
    i = torch.arange(21, dtype=torch.int32)
    rounds = engine.pairwise_lockstep_rounds(10, 10)
    j, k, iters = engine.co_rank_pairwise(
        i, 10, 10, lambda x: a[x], lambda x: b[x], rounds=rounds)
    want = co_rank_batch(i, a, b)
    np.testing.assert_array_equal(j.numpy(), want.j.numpy())
    np.testing.assert_array_equal(k.numpy(), want.k.numpy())
    assert (iters == rounds).all()


@pytest.mark.parametrize("m,n", SIZES)
def test_merge_by_ranking_matches_reference(m, n):
    rng = np.random.default_rng(m + 7 * n)
    a, b = _sorted(rng, m, -5, 5), _sorted(rng, n, -5, 5)
    got = merge_by_ranking(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(ref_merge_by_ranking(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b]),
                                               kind="stable"))


@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("m,n", [(37, 63), (1, 50), (64, 0)])
def test_merge_partitioned_matches_reference(m, n, p):
    rng = np.random.default_rng(m * 3 + n + p)
    a, b = _sorted(rng, m, 0, 4), _sorted(rng, n, 0, 4)
    got = merge_partitioned(torch.from_numpy(a), torch.from_numpy(b), p=p)
    np.testing.assert_array_equal(
        got.numpy(), np.sort(np.concatenate([a, b]), kind="stable"))
    if m and n:  # the reference cannot read an empty side
        want = ref_merge_partitioned(jnp.asarray(a), jnp.asarray(b), p=p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merge_segment_twofinger_matches_reference():
    rng = np.random.default_rng(9)
    a, b = _sorted(rng, 30, 0, 5), _sorted(rng, 20, 0, 5)
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    for j_lo, j_hi, k_lo, k_hi, seg in ((0, 30, 0, 20, 50), (3, 9, 4, 4, 8),
                                        (10, 10, 2, 12, 12), (5, 8, 1, 3, 7)):
        got = merge_segment_twofinger(
            ta, tb, *(torch.tensor(v, dtype=torch.int32)
                      for v in (j_lo, j_hi, k_lo, k_hi)), seg)
        want = ref_twofinger(ja, jb, *(jnp.int32(v)
                                       for v in (j_lo, j_hi, k_lo, k_hi)), seg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_partition_bounds_match_reference():
    from repro.core.merge import partition_bounds as ref_bounds

    for total, p in ((0, 1), (10, 3), (1 << 30, 7), (5, 8)):
        np.testing.assert_array_equal(
            partition_bounds(total, p).numpy(), np.asarray(ref_bounds(total, p)))
