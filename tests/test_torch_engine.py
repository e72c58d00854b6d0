"""Parity of the port's co-rank engine with the JAX reference engine.

The shared oracle cases of ``tests/_engine_cases.py`` (duplicate-heavy
keys, +-inf, real dtype-max keys among dtype-max padding, pre-sorted and
ragged/zero-length runs) go through the reference's dense k-way cut, the
port's dense probe (torch) and the port's host planner (numpy ``xp``).
Cuts are integer results: they must agree bit for bit, with each other
and with the brute-force oracle.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _engine_cases import (
    kway_cases,
    oracle_cuts,
    oracle_pairwise,
    pairwise_cases,
    rank_sweep,
)
from repro.core import engine as ref_engine
from repro.core.corank import co_rank_batch as ref_co_rank_batch
from repro.core.kway import co_rank_kway_batch as ref_co_rank_kway_batch
from repro_torch.core import engine
from repro_torch.core.corank import co_rank_batch
from repro_torch.core.kway import co_rank_kway, co_rank_kway_batch
from repro_torch.external.planner import co_rank_kway_host

KWAY_KS = (2, 3, 5)
CASE_NAMES = ("dup_heavy", "pm_inf", "dtype_max", "pre_sorted", "ragged_zero")


def _case(k, name):
    return {n: (runs, lengths) for n, runs, lengths in kway_cases(k)}[name]


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("k", KWAY_KS)
def test_kway_cuts_match_reference_oracle_and_host(k, name):
    runs, lengths = _case(k, name)
    total = int(lengths.sum())
    ranks = np.asarray(rank_sweep(total), np.int32)
    port = co_rank_kway_batch(
        torch.from_numpy(ranks), torch.from_numpy(runs),
        torch.from_numpy(lengths),
    ).numpy()
    ref = np.asarray(ref_co_rank_kway_batch(
        jnp.asarray(ranks), jnp.asarray(runs), jnp.asarray(lengths)
    ))
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, ref)
    segs = [runs[q, : lengths[q]] for q in range(k)]
    for row, i in zip(port, ranks):
        np.testing.assert_array_equal(row, oracle_cuts(runs, lengths, i))
        host = co_rank_kway_host(int(i), segs, lengths)
        np.testing.assert_array_equal(host, row)
        assert host.dtype == np.int64


def test_co_rank_kway_scalar_matches_batch():
    runs, lengths = _case(3, "ragged_zero")
    t_runs, t_len = torch.from_numpy(runs), torch.from_numpy(lengths)
    for i in rank_sweep(int(lengths.sum())):
        np.testing.assert_array_equal(
            co_rank_kway(i, t_runs, t_len).numpy(),
            oracle_cuts(runs, lengths, i),
        )


@pytest.mark.parametrize("name", [c[0] for c in pairwise_cases()])
def test_pairwise_corank_matches_reference_and_oracle(name):
    a, b = {n: (a, b) for n, a, b in pairwise_cases()}[name]
    ranks = np.asarray(rank_sweep(len(a) + len(b)), np.int32)
    got = co_rank_batch(torch.from_numpy(ranks), torch.from_numpy(a),
                        torch.from_numpy(b))
    want = ref_co_rank_batch(jnp.asarray(ranks), jnp.asarray(a),
                             jnp.asarray(b))
    np.testing.assert_array_equal(got.j.numpy(), np.asarray(want.j))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    for j, k, i in zip(got.j.numpy(), got.k.numpy(), ranks):
        assert (j, k) == oracle_pairwise(a, b, i)


def test_round_bounds_match_reference():
    for m in (0, 1, 2, 3, 7, 8, 9, 1000, 1 << 20, (1 << 27) + 1):
        for n in (0, 1, 5, 1 << 16):
            assert engine.prop1_bound(m, n) == ref_engine.prop1_bound(m, n)
            assert (engine.pairwise_lockstep_rounds(m, n)
                    == ref_engine.pairwise_lockstep_rounds(m, n))
        assert engine.kway_round_bound(m) == ref_engine.kway_round_bound(m)


def test_tie_break_predicates_match_reference():
    assert (engine.SIDE_TIES, engine.SIDE_STRICT) == (
        ref_engine.SIDE_TIES, ref_engine.SIDE_STRICT)
    for o in range(4):
        for q in range(4):
            assert engine.counts_ties(o, q) == ref_engine.counts_ties(o, q)
            assert engine.count_side(o, q) == ref_engine.count_side(o, q)
    rng = np.random.default_rng(3)
    v, x = rng.integers(0, 3, 64), rng.integers(0, 3, 64)
    fa, sa = rng.integers(0, 2, 64).astype(bool), rng.integers(0, 2, 64).astype(bool)
    tv, tx = torch.from_numpy(v), torch.from_numpy(x)
    tfa, tsa = torch.from_numpy(fa), torch.from_numpy(sa)
    jv, jx, jfa, jsa = map(jnp.asarray, (v, x, fa, sa))
    for ties in (True, False):
        np.testing.assert_array_equal(
            engine.count_below(tv, tx, ties).numpy(),
            np.asarray(ref_engine.count_below(jv, jx, ties)))
    pairs = (
        (engine.first_condition_violated(tv, tx),
         ref_engine.first_condition_violated(jv, jx)),
        (engine.second_condition_violated(tv, tx),
         ref_engine.second_condition_violated(jv, jx)),
        (engine.take_first(tv, tx, tfa, tsa),
         ref_engine.take_first(jv, jx, jfa, jsa)),
        (engine.kfinger_better(tv, tx, tfa, tsa),
         ref_engine.kfinger_better(jv, jx, jfa, jsa)),
    )
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("xp", ["torch", "numpy"])
def test_lemma1_and_value_cut_counts_match_reference(xp):
    rng = np.random.default_rng(5)
    k = 4
    le = rng.integers(0, 20, (k, k)).astype(np.int32)
    lt = np.minimum(le, rng.integers(0, 20, (k, k))).astype(np.int32)
    owner, query = np.arange(k)[:, None], np.arange(k)[None, :]
    own_len = rng.integers(0, 20, (k, 1)).astype(np.int32)
    run = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    bounds = np.arange(-1, 11, dtype=np.int32)
    want_cnt = np.asarray(ref_engine.lemma1_counts(
        jnp.asarray(le), jnp.asarray(lt), jnp.asarray(owner),
        jnp.asarray(query), jnp.asarray(own_len)))
    want_cut = np.asarray(ref_engine.value_cut_counts(
        jnp.asarray(run), jnp.asarray(bounds), 30))
    if xp == "numpy":
        got_cnt = engine.lemma1_counts(le, lt, owner, query, own_len, xp=np)
        got_cut = engine.value_cut_counts(run, bounds, 30, xp=np)
    else:
        t = torch.from_numpy
        got_cnt = engine.lemma1_counts(
            t(le), t(lt), t(owner), t(query), t(own_len)).numpy()
        got_cut = engine.value_cut_counts(
            t(run), t(bounds), torch.tensor(30, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got_cnt, want_cnt)
    np.testing.assert_array_equal(got_cut, want_cut)
    assert got_cut.dtype == np.int32
