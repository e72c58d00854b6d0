"""Parity of the port's k-way merges and merge sort with the JAX reference.

Positions, merges, sorts and permutations are integer results or
permutations of the inputs: bit for bit, no tolerance.
"""

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _engine_cases import kway_cases
from repro.core import kway as ref_kway
from repro.core import mergesort as ref_ms
from repro_torch.core import kway, mergesort

CASE_NAMES = ("dup_heavy", "pm_inf", "dtype_max", "pre_sorted", "ragged_zero")

# The reference's eager functions run op by op; the tests call them jitted.
ref_kway_positions = jax.jit(ref_kway.kway_positions)
ref_merge_sort = ref_ms.merge_sort_jit
ref_sort_key_val = ref_ms.sort_key_val_jit
ref_merge_argsort = jax.jit(ref_ms.merge_argsort, static_argnames="fanout")
ref_merge_kway_ranked = jax.jit(ref_kway.merge_kway_ranked,
                                static_argnames="out_len")


def _case(k, name):
    return {n: (runs, lengths) for n, runs, lengths in kway_cases(k)}[name]


def _oracle_positions(runs, lengths):
    """Merged rank of every real element: the stable (value, run, offset)
    order, by brute force."""
    k, w = runs.shape
    real = np.arange(w)[None, :] < lengths[:, None]
    run_ids = np.broadcast_to(np.arange(k)[:, None], (k, w))[real]
    offs = np.broadcast_to(np.arange(w)[None, :], (k, w))[real]
    order = np.lexsort((offs, run_ids, runs[real]))
    pos = np.empty(len(order), np.int64)
    pos[order] = np.arange(len(order))
    return pos, real


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("k", [2, 4, 5])
def test_kway_positions_match_oracle(k, name, ragged):
    runs, lengths = _case(k, name)
    if not ragged:
        lengths = np.full(k, runs.shape[1], np.int32)
    t_len = torch.from_numpy(lengths) if ragged else None
    got = kway.kway_positions(torch.from_numpy(runs), t_len).numpy()
    want, real = _oracle_positions(runs, lengths)
    np.testing.assert_array_equal(got[real], want)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_kway_positions_match_reference(name, ragged):
    runs, lengths = _case(4, name)
    t_len = torch.from_numpy(lengths) if ragged else None
    j_len = jnp.asarray(lengths) if ragged else None
    got = kway.kway_positions(torch.from_numpy(runs), t_len).numpy()
    want = np.asarray(ref_kway_positions(jnp.asarray(runs), j_len))
    if ragged:  # positions of padded elements are meaningless
        real = np.arange(runs.shape[1])[None, :] < lengths[:, None]
        got, want = got[real], want[real]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["keys", "payload", "lengths", "out_len"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_merge_kway_ranked_matches_reference(name, form):
    runs, lengths = _case(4, name)
    k, w = runs.shape
    vals = np.arange(k * w, dtype=np.int32).reshape(k, w)
    kw_t, kw_j = {}, {}
    if form in ("payload", "lengths", "out_len"):
        kw_t["vals"], kw_j["vals"] = torch.from_numpy(vals), jnp.asarray(vals)
    if form in ("lengths", "out_len"):
        kw_t["lengths"] = torch.from_numpy(lengths)
        kw_j["lengths"] = jnp.asarray(lengths)
    if form == "out_len":
        kw_t["out_len"] = kw_j["out_len"] = int(lengths.sum()) // 2 + 3
    got = kway.merge_kway_ranked(torch.from_numpy(runs), **kw_t)
    want = ref_merge_kway_ranked(jnp.asarray(runs), **kw_j)
    if form == "keys":
        got, want = (got,), (want,)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("p", [1, 5])
@pytest.mark.parametrize("k", [3, 8])
def test_merge_kway_partitioned_matches_reference(k, p):
    rng = np.random.default_rng(k * 10 + p)
    runs = np.sort(rng.integers(0, 5, (k, 13)), axis=1).astype(np.int32)
    got = kway.merge_kway(torch.from_numpy(runs), p=p).numpy()
    want = np.asarray(ref_kway.merge_kway(jnp.asarray(runs), p=p))
    np.testing.assert_array_equal(got, want)


def test_co_rank_kway_batch_sums_to_rank():
    runs, lengths = _case(5, "ragged_zero")
    ranks = torch.arange(int(lengths.sum()) + 1, dtype=torch.int32)
    cuts = kway.co_rank_kway_batch(ranks, torch.from_numpy(runs),
                                   torch.from_numpy(lengths))
    assert cuts.dtype == torch.int32
    np.testing.assert_array_equal(cuts.sum(1).numpy(), ranks.numpy())


@pytest.mark.parametrize("fanout", [2, 4, 16])
@pytest.mark.parametrize("n,universe", [(1, 5), (2, 5), (37, 4), (300, 1000),
                                        (1024, 7), (1500, 1 << 30)])
def test_merge_sort_family_matches_numpy(n, universe, fanout):
    rng = np.random.default_rng(n + fanout)
    x = rng.integers(-universe, universe, n).astype(np.int32)
    v = rng.integers(0, 1 << 20, n).astype(np.int32)
    tx = torch.from_numpy(x)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(mergesort.merge_sort(tx, fanout).numpy(),
                                  x[order])
    np.testing.assert_array_equal(mergesort.merge_argsort(tx, fanout).numpy(),
                                  order)
    sk, sv = mergesort.sort_key_val(tx, torch.from_numpy(v), fanout)
    np.testing.assert_array_equal(sk.numpy(), x[order])
    np.testing.assert_array_equal(sv.numpy(), v[order])


@pytest.mark.parametrize("fanout", [2, 4, 16])
def test_merge_sort_family_matches_reference(fanout):
    rng = np.random.default_rng(fanout)
    x = rng.integers(-7, 7, 24).astype(np.int32)
    v = rng.integers(0, 1 << 20, 24).astype(np.int32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        mergesort.merge_sort(tx, fanout).numpy(),
        np.asarray(ref_merge_sort(jx, fanout=fanout)))
    np.testing.assert_array_equal(
        mergesort.merge_argsort(tx, fanout).numpy(),
        np.asarray(ref_merge_argsort(jx, fanout=fanout)))
    sk, sv = mergesort.sort_key_val(tx, torch.from_numpy(v), fanout)
    rk, rv = ref_sort_key_val(jx, jnp.asarray(v), fanout=fanout)
    np.testing.assert_array_equal(sk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(rv))


def test_merge_sort_float_extremes_match_reference():
    rng = np.random.default_rng(2)
    base = np.array([np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5,
                     np.finfo(np.float32).max], np.float32)
    x = base[rng.integers(0, len(base), 100)]
    got = mergesort.merge_argsort(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_merge_argsort(jnp.asarray(x))))
    sorted_bits = mergesort.merge_sort(torch.from_numpy(x)).numpy().view(np.int32)
    np.testing.assert_array_equal(sorted_bits, x[got].view(np.int32))


def test_merge_runs_ranked_batched_matches_reference():
    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 6, (3, 4, 8)), axis=2).astype(np.int32)
    vals = rng.integers(0, 100, (3, 4, 8)).astype(np.int32)
    gk, gv = mergesort.merge_runs_ranked(torch.from_numpy(keys),
                                         torch.from_numpy(vals))
    wk, wv = jax.jit(ref_ms.merge_runs_ranked)(jnp.asarray(keys),
                                               jnp.asarray(vals))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int16,
                                   np.uint8])
def test_sentinel_max_matches_reference(dtype):
    got = mergesort.sentinel_max(np.dtype(dtype))
    want = np.asarray(ref_ms.sentinel_max(np.dtype(dtype)))
    assert got.numpy().dtype == want.dtype
    assert got.numpy().tobytes() == want.tobytes()
    torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    assert mergesort.sentinel_max(torch_dtype).item() == got.item()


def test_sentinel_max_bfloat16_is_inf():
    assert mergesort.sentinel_max(torch.bfloat16).item() == float("inf")


@pytest.mark.parametrize("fanout", [3, 1, -2, 6])
def test_check_fanout_errors_match_reference(fanout):
    with pytest.raises(ValueError) as got:
        mergesort._check_fanout(fanout)
    with pytest.raises(ValueError) as want:
        ref_ms._check_fanout(fanout)
    assert str(got.value) == str(want.value)


def test_check_fanout_default():
    assert mergesort._check_fanout(0) == ref_ms._check_fanout(0)
    assert mergesort.DEFAULT_FANOUT == ref_ms.DEFAULT_FANOUT
    assert mergesort._check_fanout(16) == 16


def _reference_passes(np2: int, fanout: int):
    """The reference's passes, as its sort loops over them (width 1 up)."""
    passes, width = [], 1
    while width < np2:
        group = min(fanout, np2 // width)
        passes.append((np2 // (group * width), group, width))
        width *= group
    return passes


@pytest.mark.parametrize("fanout", [2, 4, 8, 16])
def test_sort_plan_is_a_leaf_then_the_reference_passes_above_it(fanout):
    """The plan: one leaf pass of s = min(LEAF_WIDTH, np2) runs of width 1,
    then exactly the reference's passes from width s up (s is a power of
    every fan-out here, so the reference's widths reach it)."""
    from repro_torch.kernels.merge import GROUPS_TILE

    assert mergesort.LEAF_WIDTH <= GROUPS_TILE
    assert mergesort.LEAF_WIDTH & (mergesort.LEAF_WIDTH - 1) == 0
    sizes = [1, 2, 3, 5, 17, 100, 128, 4095, 4096, 4097, 5000, 1 << 15,
             (1 << 15) + 1, 100_003, 1 << 24]
    for n in sizes:
        plan = mergesort.sort_plan(n, fanout)
        if n <= 1:
            assert plan == []
            continue
        np2 = mergesort._padded_pow2(n)
        s = min(mergesort.LEAF_WIDTH, np2)
        assert plan[0] == (np2 // s, s, 1)
        assert plan[1:] == [p for p in _reference_passes(np2, fanout)
                            if p[2] >= s]
        for g, k, w in plan:
            assert g * k * w == np2


def test_sort_plan_counts_of_the_main_path():
    """The dispatch sort of 32,768 assignments is a leaf and two wide
    passes; a 2^24-key spill sort a leaf and six; a top-k block of 128 one
    leaf; the default fan-out is the reference's."""
    assert mergesort.sort_plan(32768) == [(8, 4096, 1), (2, 4, 4096),
                                          (1, 2, 16384)]
    assert len(mergesort.sort_plan(1 << 24)) == 1 + 6
    assert mergesort.sort_plan(128) == [(1, 128, 1)]
    assert mergesort.sort_plan(5, 0) == mergesort.sort_plan(5, 4)
    with pytest.raises(ValueError, match="power of two"):
        mergesort.sort_plan(10, 3)


@pytest.mark.parametrize("g,k,w", [(5, 4096, 1), (3, 7, 5), (2, 3, 1000),
                                   (4, 1, 9), (2, 64, 3)])
def test_merge_runs_plain_tree_matches_reference(g, k, w):
    """The torch-ops merge as a tree of pairwise rank merges (an odd run
    passing through a level, padded with the sentinel) against a stable
    numpy sort and, up to 64 runs (its compile grows with k^2), the
    reference's rank merge, with dtype-max keys among the real ones."""
    rng = np.random.default_rng(g * k + w)
    keys = np.sort(rng.integers(-3, 3, (g, k, w)), axis=2).astype(np.int32)
    keys[..., -1:] = np.iinfo(np.int32).max
    vals = rng.integers(0, 1 << 20, (g, k, w)).astype(np.int32)
    gk, gv = mergesort.merge_runs_plain(torch.from_numpy(keys),
                                        torch.from_numpy(vals))
    if k <= 64:
        wk, wv = jax.jit(ref_ms.merge_runs_ranked)(jnp.asarray(keys),
                                                   jnp.asarray(vals))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    order = np.argsort(keys.reshape(g, -1), axis=1, kind="stable")
    np.testing.assert_array_equal(gk.numpy(), np.take_along_axis(
        keys.reshape(g, -1), order, 1))
    np.testing.assert_array_equal(gv.numpy(), np.take_along_axis(
        vals.reshape(g, -1), order, 1))


# --- groups of more runs than the wide launch takes: merge_runs_split ---------

ref_merge_runs_ranked = jax.jit(ref_ms.merge_runs_ranked)


def _many_runs(g, k, w, seed):
    """(g, k, w) sorted int32 runs, duplicate-heavy, each ending in a real
    dtype-max key (which ties with the split's sentinel runs), and a
    payload."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(-3, 3, (g, k, w)), axis=2).astype(np.int32)
    keys[..., -1:] = np.iinfo(np.int32).max
    vals = rng.integers(0, 1 << 20, (g, k, w)).astype(np.int32)
    return keys, vals


@pytest.mark.parametrize("g,k,w,limit", [(2, 128, 5, 64), (2, 128, 5, 3),
                                         (1, 200, 3, 64), (1, 200, 3, 7),
                                         (3, 65, 9, 64), (2, 256, 2, 64)])
def test_merge_runs_split_matches_reference(g, k, w, limit):
    """Sub-groups of at most ``limit`` adjacent runs merged by
    ``merge_runs_plain``, then their results again (recursively below a
    limit of 3 or 7), the last sub-group padded with sentinel runs where
    ``limit`` does not divide ``k``: against a stable numpy sort and the
    one-level torch-ops merge, and at 128 and 200 runs the reference's
    rank merge (its compile grows with k^2)."""
    keys, vals = _many_runs(g, k, w, k * limit)
    calls = []

    def merge(kk, vv):
        calls.append(kk.shape[1])
        return mergesort.merge_runs_plain(kk, vv)

    gk, gv = mergesort.merge_runs_split(torch.from_numpy(keys),
                                        torch.from_numpy(vals), merge, limit)
    assert max(calls) <= limit
    order = np.argsort(keys.reshape(g, -1), axis=1, kind="stable")
    np.testing.assert_array_equal(gk.numpy(), np.take_along_axis(
        keys.reshape(g, -1), order, 1))
    np.testing.assert_array_equal(gv.numpy(), np.take_along_axis(
        vals.reshape(g, -1), order, 1))
    pk, pv = mergesort.merge_runs_plain(torch.from_numpy(keys), torch.from_numpy(vals))
    assert torch.equal(gk, pk) and torch.equal(gv, pv)
    if k in (128, 200):
        wk, wv = ref_merge_runs_ranked(jnp.asarray(keys), jnp.asarray(vals))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("fanout,n", [(128, 3 * 4096 + 77), (256, 5 * 4096 + 3)])
def test_sort_through_the_split_matches_reference(monkeypatch, fanout, n):
    """The card's route on the CPU: ``merge_runs_ranked`` takes the kernels'
    branch (its dispatch patched to ``cuda``; on CPU tensors every kernel
    wrapper runs its plain version), with a leaf of 16 and a grouped tile of
    64, so that the fan-out pass of 128 or 256 runs goes to the wide
    launch's route and past its 64 runs through ``merge_runs_split``.
    ``sort_key_val`` and ``merge_sort`` against numpy, and at fan-out 128
    the reference's jitted ``sort_key_val`` (at 256 runs its compile takes
    minutes)."""
    from repro_torch.kernels import merge as km

    monkeypatch.setattr(mergesort, "dispatch", lambda *args, **kw: "cuda")
    monkeypatch.setattr(mergesort, "LEAF_WIDTH", 16)
    monkeypatch.setattr(km, "GROUPS_TILE", 64)
    split = []
    real_split = mergesort.merge_runs_split

    def spy(keys, vals, merge, limit):
        split.append((keys.shape[1], limit))
        return real_split(keys, vals, merge, limit)

    monkeypatch.setattr(mergesort, "merge_runs_split", spy)
    rng = np.random.default_rng(fanout)
    x = rng.integers(-50, 50, n).astype(np.int32)
    x[x > 45] = np.iinfo(np.int32).max
    idx = np.arange(n, dtype=np.int32)
    gk, gv = mergesort.sort_key_val(torch.from_numpy(x), torch.from_numpy(idx),
                                    fanout=fanout)
    assert (fanout, km.WIDE_MAX_RUNS) in split
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(gk.numpy(), x[order])
    np.testing.assert_array_equal(gv.numpy(), order)
    np.testing.assert_array_equal(
        mergesort.merge_sort(torch.from_numpy(x), fanout=fanout).numpy(), x[order])
    if fanout == 128:
        wk, wv = ref_sort_key_val(jnp.asarray(x), jnp.asarray(idx), fanout=fanout)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
