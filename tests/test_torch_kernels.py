"""The port's merge kernels against the Pallas kernels and numpy.

On the CPU the wrappers run their plain PyTorch versions (a CUDA kernel
has no interpret mode): those are held against ``merge_pallas`` /
``merge_kway_pallas`` run in interpret mode, as ``tests/test_kernels.py``
runs them, on a handful of small cases, and against ``merge_np`` /
``np.argsort(kind="stable")`` on wider sweeps.  The compiled kernels are
held against their plain versions on the card in
``tests/test_torch_kernels_cuda.py``.  All comparisons are bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.merge import merge_kway_pallas, merge_pallas
from repro.kernels.ref import merge_np
from repro_torch.core.corank import co_rank_batch
from repro_torch.core.kway import co_rank_kway_batch
from repro_torch.kernels import merge as km
from repro_torch.kernels.ref import merge_ref, sort_ref


def _sorted(rng, n, dtype):
    if dtype == "bfloat16":  # integer-valued: exact in bfloat16
        return np.sort(rng.integers(-250, 250, n)).astype(np.float32)
    if np.issubdtype(dtype, np.integer):
        return np.sort(rng.integers(-1000, 1000, n)).astype(dtype)
    return np.sort(rng.standard_normal(n).astype(np.float32) * 100)


def _to_torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _merge_at_tile(a, b, tile):
    """Both phases at any tile: the kernel's own (``merge_tiled``) at
    ``MERGE_TILE``, else phase 1 and the plain version at ``tile``."""
    if tile == km.MERGE_TILE:
        return km.merge_tiled(a, b)
    cr = co_rank_batch(km.tile_bounds(a.shape[0] + b.shape[0], tile, a.device),
                       a, b)
    return km.merge_tile_plain(a, b, cr.j, cr.k, tile=tile)


def _kway_at_tile(runs, vals=None, *, tile, lengths=None, out_len=None):
    """``merge_kway_tiled`` at any tile, as :func:`_merge_at_tile`."""
    if tile == km.KWAY_TILE:
        return km.merge_kway_tiled(runs, vals, lengths=lengths,
                                   out_len=out_len)
    total = runs.numel() if out_len is None else out_len
    cb = co_rank_kway_batch(km.tile_bounds(total, tile, runs.device), runs,
                            lengths)
    return km.merge_kway_tile_plain(runs, cb, tile=tile, vals=vals,
                                    out_len=total)


# --- pairwise: merge_tile -----------------------------------------------------


@pytest.mark.parametrize("tile", [128, 512])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, "bfloat16"])
def test_merge_tiled_matches_pallas_interpret(dtype, tile):
    rng = np.random.default_rng(tile + len(str(dtype)))
    a, b = _sorted(rng, 300, dtype), _sorted(rng, 133, dtype)
    ta, tb = _to_torch(a, dtype), _to_torch(b, dtype)
    got = _merge_at_tile(ta, tb, tile)
    assert torch.equal(km.merge_tiled(ta, tb), got)
    if dtype == "bfloat16":
        want = merge_pallas(jnp.asarray(a, jnp.bfloat16),
                            jnp.asarray(b, jnp.bfloat16), tile=tile)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
    else:
        want = merge_pallas(jnp.asarray(a), jnp.asarray(b), tile=tile)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.float().numpy(),
                                  merge_np(a, b).astype(np.float32))


@pytest.mark.parametrize("tile", [128, 512, 1024])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, "bfloat16"])
@pytest.mark.parametrize(
    "m,n", [(1, 1), (1, 4096), (4096, 1), (1000, 1000), (777, 3333), (0, 5)])
def test_merge_tiled_sweep_matches_numpy(dtype, m, n, tile):
    rng = np.random.default_rng(m * 7 + n + tile)
    a, b = _sorted(rng, m, dtype), _sorted(rng, n, dtype)
    got = _merge_at_tile(_to_torch(a, dtype), _to_torch(b, dtype), tile)
    np.testing.assert_array_equal(got.float().numpy(),
                                  merge_np(a, b).astype(np.float32))


def test_merge_tile_stability_tagged():
    """Ties: every A element precedes every equal B element (tag parity)."""
    rng = np.random.default_rng(11)
    a = np.sort(rng.integers(0, 8, 1500)).astype(np.int32)
    b = np.sort(rng.integers(0, 8, 700)).astype(np.int32)
    got = _merge_at_tile(torch.from_numpy(a * 2), torch.from_numpy(b * 2 + 1),
                         128).numpy()
    keys, origin = got // 2, got % 2
    for v in np.unique(keys):
        assert not np.any(np.diff(origin[keys == v]) < 0)
    np.testing.assert_array_equal(np.sort(keys, kind="stable"), keys)


def test_merge_tile_signed_zeros_follow_stable_order():
    a = np.array([-1.0, 0.0, 0.0, -0.0, np.inf], np.float32)
    b = np.array([-np.inf, -0.0, 0.0, np.inf], np.float32)
    got = _merge_at_tile(torch.from_numpy(a), torch.from_numpy(b), 256)
    want = np.concatenate([a, b])[np.argsort(np.concatenate([a, b]),
                                             kind="stable")]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_merge_tile_plain_uses_the_tile_windows():
    """The plain version searches only inside the windows phase 1 gave
    each tile: windows that are not co-ranks give a different output."""
    a = torch.arange(0, 8, dtype=torch.int32)
    b = torch.arange(8, 16, dtype=torch.int32)
    bounds = km.tile_bounds(16, 4, a.device)
    cr = co_rank_batch(bounds, a, b)
    np.testing.assert_array_equal(
        km.merge_tile_plain(a, b, cr.j, cr.k, tile=4).numpy(), np.arange(16))
    swapped = km.merge_tile_plain(a, b, cr.k, cr.j, tile=4).numpy()
    assert not np.array_equal(swapped, np.arange(16))


def test_oracles():
    rng = np.random.default_rng(1)
    a, b = _sorted(rng, 50, np.int32), _sorted(rng, 30, np.int32)
    np.testing.assert_array_equal(
        merge_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        merge_np(a, b))
    x = rng.integers(0, 5, 40).astype(np.int32)
    np.testing.assert_array_equal(sort_ref(torch.from_numpy(x)).numpy(),
                                  np.sort(x, kind="stable"))


# --- k-way: merge_kway_tile ---------------------------------------------------


def _ragged_dtype_max(seed, k=4, w=256, lengths=(256, 0, 100, 31)):
    """Ragged runs whose INT32_MAX padding collides with real INT32_MAX
    keys, with a payload numbering the real elements in run order."""
    hi = np.iinfo(np.int32).max
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    runs = np.full((k, w), hi, np.int32)
    vals = np.zeros((k, w), np.int32)
    nxt = 0
    for q in range(k):
        runs[q, : lengths[q]] = np.sort(
            rng.choice(np.array([hi, hi - 1, 3, -9], np.int32), lengths[q]))
        vals[q, : lengths[q]] = np.arange(nxt, nxt + lengths[q])
        nxt += int(lengths[q])
    real = np.arange(w)[None, :] < lengths[:, None]
    order = np.argsort(runs[real], kind="stable")
    return runs, vals, lengths, runs[real][order], vals[real][order]


@pytest.mark.parametrize("k,w,tile", [(2, 256, 128), (4, 160, 128)])
def test_merge_kway_payload_matches_pallas_interpret(k, w, tile):
    rng = np.random.default_rng(k * 1000 + w + tile)
    runs = np.sort(rng.integers(0, 7, (k, w)).astype(np.int32), axis=1)
    vals = np.arange(k * w, dtype=np.int32).reshape(k, w)
    gk, gv = _kway_at_tile(torch.from_numpy(runs), torch.from_numpy(vals),
                           tile=tile)
    wk, wv = merge_kway_pallas(jnp.asarray(runs), jnp.asarray(vals),
                               tile=tile)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_merge_kway_ragged_dtype_max_matches_pallas_interpret():
    runs, vals, lengths, want_k, want_v = _ragged_dtype_max(99)
    total = int(lengths.sum())
    gk, gv = _kway_at_tile(
        torch.from_numpy(runs), torch.from_numpy(vals),
        lengths=torch.from_numpy(lengths), tile=128)
    pk, pv = merge_kway_pallas(jnp.asarray(runs), jnp.asarray(vals),
                               lengths=jnp.asarray(lengths), tile=128)
    np.testing.assert_array_equal(gk.numpy()[:total], np.asarray(pk)[:total])
    np.testing.assert_array_equal(gv.numpy()[:total], np.asarray(pv)[:total])
    np.testing.assert_array_equal(gk.numpy()[:total], want_k)
    np.testing.assert_array_equal(gv.numpy()[:total], want_v)


@pytest.mark.parametrize("tile", [128, 1024])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("k", [2, 4, 8, 16])
def test_merge_kway_tiled_sweep_matches_numpy(k, dtype, tile):
    rng = np.random.default_rng(k * 31 + tile)
    w = 300
    if dtype == np.int32:
        runs = np.sort(rng.integers(0, 9, (k, w)), axis=1).astype(np.int32)
    else:
        runs = rng.standard_normal((k, w)).astype(np.float32)
        runs[rng.random((k, w)) < 0.05] = np.inf
        runs[rng.random((k, w)) < 0.05] = -np.inf
        runs = np.sort(runs, axis=1)
    vals = np.arange(k * w, dtype=np.int32).reshape(k, w)
    order = np.argsort(runs.reshape(-1), kind="stable")
    gk, gv = _kway_at_tile(torch.from_numpy(runs), torch.from_numpy(vals),
                           tile=tile)
    np.testing.assert_array_equal(gk.numpy(), runs.reshape(-1)[order])
    np.testing.assert_array_equal(gv.numpy(), order)
    keys_only = _kway_at_tile(torch.from_numpy(runs), tile=tile)
    np.testing.assert_array_equal(keys_only.numpy(), runs.reshape(-1)[order])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lengths", [(256, 0, 100, 31), (0, 0, 7, 256),
                                     (1, 2, 3, 4)])
def test_merge_kway_ragged_sweep_matches_numpy(lengths, seed):
    runs, vals, lens, want_k, want_v = _ragged_dtype_max(seed,
                                                         lengths=lengths)
    total = int(lens.sum())
    for out_len in (total, total + 5, 4 * 256):
        gk, gv = _kway_at_tile(
            torch.from_numpy(runs), torch.from_numpy(vals),
            lengths=torch.from_numpy(lens), tile=128, out_len=out_len)
        assert gk.shape == (out_len,)
        np.testing.assert_array_equal(gk.numpy()[:total], want_k)
        np.testing.assert_array_equal(gv.numpy()[:total], want_v)


@pytest.mark.parametrize("k", [1, 3, 5, 17])
def test_merge_kway_tiled_any_k_and_wide_dtypes_match_numpy(k):
    """Any run count, int64/float64 keys and an 8-byte payload, ragged
    lengths: the wrapper's own tile (KWAY_TILE) on the CPU."""
    rng = np.random.default_rng(k)
    w = 700
    lengths = rng.integers(0, w + 1, k).astype(np.int32)
    real = np.arange(w)[None, :] < lengths[:, None]
    for dtype in (np.int64, np.float64):
        runs = rng.integers(-40, 40, (k, w)).astype(dtype)
        runs[~real] = np.iinfo(np.int64).max if dtype == np.int64 else np.inf
        runs = np.sort(runs, axis=1)
        vals = rng.integers(-(1 << 40), 1 << 40, (k, w))
        order = np.argsort(runs[real], kind="stable")
        total = int(lengths.sum())
        gk, gv = km.merge_kway_tiled(torch.from_numpy(runs),
                                     torch.from_numpy(vals),
                                     lengths=torch.from_numpy(lengths))
        np.testing.assert_array_equal(gk.numpy()[:total], runs[real][order])
        np.testing.assert_array_equal(gv.numpy()[:total], vals[real][order])


# --- the merge tree of merge_kway_tile ------------------------------------------


def _tree_case(k, w, seed, form):
    """Sorted int32 runs with INT32_MAX padding and a payload numbering the
    real elements: ``dense`` (full rows), ``ragged`` (random lengths, every
    third row empty) or ``all_equal`` (one key in every run)."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(np.int32).max
    lengths = np.full(k, w, np.int32)
    if form == "ragged":
        lengths = rng.integers(0, w + 1, k).astype(np.int32)
        lengths[::3] = 0
    runs = np.full((k, w), hi, np.int32)
    for q in range(k):
        if form == "all_equal":
            runs[q, : lengths[q]] = 7
        else:
            runs[q, : lengths[q]] = np.sort(
                rng.choice(np.array([hi, 3, 1, -9], np.int32), lengths[q]))
    vals = np.arange(k * w, dtype=np.int32).reshape(k, w)
    real = np.arange(w)[None, :] < lengths[:, None]
    order = np.argsort(runs[real], kind="stable")
    return runs, vals, lengths, runs[real][order], vals[real][order]


def _pallas_kway(runs, vals, lengths, tile, group=5):
    """``merge_kway_pallas`` in interpret mode over numpy ``(k, w)`` runs
    with a payload and ragged ``lengths``: the real part of the merge.
    Above k = 17 it merges groups of ``group`` runs, then the groups (their
    padding set back to dtype-max), both levels by the Pallas kernel.  That
    is the same stable merge, as ties go to the earlier run at each level,
    and it compiles in seconds: the kernel unrolls k^2 searches, so one
    40-run call takes about two minutes to compile on a CPU."""
    total = int(lengths.sum())
    if runs.shape[0] <= 17:
        pk, pv = merge_kway_pallas(jnp.asarray(runs), jnp.asarray(vals),
                                   lengths=jnp.asarray(lengths), tile=tile)
        return np.asarray(pk)[:total], np.asarray(pv)[:total]
    k, w = runs.shape
    assert k % group == 0, "groups of one shape compile once"
    g = k // group
    gk = np.full((g, group * w), np.iinfo(runs.dtype).max, runs.dtype)
    gv = np.zeros((g, group * w), vals.dtype)
    glen = lengths.reshape(g, group).sum(axis=1).astype(np.int32)
    for i in range(g):
        part = slice(i * group, (i + 1) * group)
        gk[i, : glen[i]], gv[i, : glen[i]] = _pallas_kway(
            runs[part], vals[part], lengths[part], tile)
    return _pallas_kway(gk, gv, glen, tile)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 17, 40])
def test_merge_kway_tree_matches_pallas_interpret(k):
    """The tree tile program (plain version) against the Pallas kernel in
    interpret mode, keys and payload: ragged rows with empty ones,
    dtype-max keys among the padding, tile 32 (so at k = 40 most segments
    of a tile are empty)."""
    runs, vals, lengths, want_k, want_v = _tree_case(k, 40, k, "ragged")
    total = int(lengths.sum())
    gk, gv = _kway_at_tile(torch.from_numpy(runs), torch.from_numpy(vals),
                           lengths=torch.from_numpy(lengths), tile=32)
    pk, pv = _pallas_kway(runs, vals, lengths, tile=32)
    np.testing.assert_array_equal(gk.numpy()[:total], pk)
    np.testing.assert_array_equal(gv.numpy()[:total], pv)
    np.testing.assert_array_equal(gk.numpy()[:total], want_k)
    np.testing.assert_array_equal(gv.numpy()[:total], want_v)


def test_merge_kway_tree_all_equal_matches_pallas_interpret():
    """One key in every run: the order is the run order alone, which only
    the left-wins tie rule of every level gives."""
    runs, vals, lengths, want_k, want_v = _tree_case(5, 40, 0, "all_equal")
    gk, gv = _kway_at_tile(torch.from_numpy(runs), torch.from_numpy(vals),
                           tile=32)
    pk, pv = merge_kway_pallas(jnp.asarray(runs), jnp.asarray(vals), tile=32)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(pk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(gv.numpy(), want_v)


@pytest.mark.parametrize("tile", [16, 128])
@pytest.mark.parametrize("form", ["dense", "ragged", "all_equal"])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 17, 40])
def test_merge_kway_tree_sweep_matches_numpy(k, form, tile):
    runs, vals, lengths, want_k, want_v = _tree_case(k, 37, k + tile, form)
    total = int(lengths.sum())
    gk, gv = _kway_at_tile(torch.from_numpy(runs), torch.from_numpy(vals),
                           lengths=torch.from_numpy(lengths), tile=tile)
    np.testing.assert_array_equal(gk.numpy()[:total], want_k)
    np.testing.assert_array_equal(gv.numpy()[:total], want_v)


@pytest.mark.parametrize("k,w", [(300, 3), (64, 1)])
def test_merge_kway_tree_more_runs_than_tile_slots(k, w):
    """k far above the tile (16): most segments of every tile are empty and
    compaction leaves segments of length 0 (dropped), 1, or the only one."""
    runs, vals, lengths, want_k, want_v = _tree_case(k, w, 5, "ragged")
    total = int(lengths.sum())
    cb = co_rank_kway_batch(km.tile_bounds(total, 16, "cpu"),
                            torch.from_numpy(runs), torch.from_numpy(lengths))
    seg = (cb[1:] - cb[:-1]).numpy()
    assert ((seg > 0).sum(axis=1) <= 16).all() and (seg == 1).any()
    gk, gv = km.merge_kway_tile_plain(torch.from_numpy(runs), cb, tile=16,
                                      vals=torch.from_numpy(vals),
                                      out_len=total)
    np.testing.assert_array_equal(gk.numpy(), want_k)
    np.testing.assert_array_equal(gv.numpy(), want_v)


def test_merge_kway_tree_single_segment_tiles():
    """Tiles drawn wholly from one run need no merge level: the staged
    segment is the output."""
    runs = torch.stack([torch.arange(0, 64, dtype=torch.int32),
                        torch.arange(64, 128, dtype=torch.int32)])
    cb = co_rank_kway_batch(km.tile_bounds(128, 16, "cpu"), runs)
    assert (((cb[1:] - cb[:-1]) > 0).sum(dim=1) == 1).all()
    got = km.merge_kway_tile_plain(runs, cb, tile=16, out_len=128)
    np.testing.assert_array_equal(got.numpy(), np.arange(128))


def test_wrappers_check_alike_on_cpu_and_card():
    """The wrappers validate before they pick the plain version, so a call
    the kernel would refuse is refused on the CPU too."""
    x = torch.arange(8, dtype=torch.int32)
    bad = co_rank_batch(km.tile_bounds(16, 4, x.device), x, x)
    with pytest.raises(ValueError, match="tiles given"):
        km.merge_tile(x, x, bad.j, bad.k)
    cr = co_rank_batch(km.tile_bounds(16, km.MERGE_TILE, x.device), x, x)
    with pytest.raises(ValueError, match="keys must share"):
        km.merge_tile(x.short(), x.short(), cr.j, cr.k)
    runs = torch.zeros((3, 16), dtype=torch.int32)
    cb = co_rank_kway_batch(km.tile_bounds(48, km.KWAY_TILE, x.device), runs)
    with pytest.raises(ValueError, match="4- or 8-byte"):
        km.merge_kway_tile(runs, cb, vals=runs.short(), out_len=48)
    with pytest.raises(ValueError, match="keys must be one of"):
        km.merge_kway_tile(runs.short(), cb, out_len=48)
    with pytest.raises(ValueError, match="tiles given"):
        km.merge_kway_tile(runs, cb, out_len=48 + km.KWAY_TILE)
    with pytest.raises(ValueError, match="int32"):
        km.tile_bounds(1 << 31, km.KWAY_TILE, x.device)


def test_on_cpu_refuses_mixed_or_foreign_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        km.merge_tile(*(torch.empty(1, device="meta") for _ in range(4)))
    assert km._on_cpu(torch.zeros(1), None, torch.zeros(2))


# --- the grouped launch of merge_kway_tile ---------------------------------------


def _groups(g, k, w, seed):
    """(g, k, w) sorted float32 runs, duplicate-heavy with +-inf and +-0.0,
    and an int32 payload numbering the elements."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-8, 8, (g, k, w)).astype(np.float32)
    u = rng.random((g, k, w))
    keys[u < 0.05] = np.inf
    keys[(u >= 0.05) & (u < 0.1)] = -np.inf
    keys[(u >= 0.1) & (u < 0.2)] = -0.0
    keys = np.sort(keys, axis=-1, kind="stable")
    vals = np.arange(g * k * w, dtype=np.int32).reshape(g, k, w)
    return keys, vals


@pytest.mark.parametrize("g,k,w", [(96, 4, 1), (48, 4, 4), (24, 4, 16),
                                   (12, 2, 64), (20, 4, 50), (8, 2, 50),
                                   (6, 3, 50), (5, 16, 7)])
def test_grouped_merge_matches_reference_merge_runs_ranked(g, k, w):
    """The top-k's grouped merges (block-sort passes, tournament rounds,
    a tail group of 3) on the CPU: the wrapper's plain version and the
    port's merge_runs_ranked against the reference's, keys as bits."""
    import jax

    from repro.core.mergesort import merge_runs_ranked as ref_merge
    from repro_torch.core.mergesort import merge_runs_ranked

    keys, vals = _groups(g, k, w, g * k + w)
    rk, rv = jax.jit(ref_merge)(jnp.asarray(keys), jnp.asarray(vals))
    for gk, gv in (km.merge_kway_tile_groups(torch.from_numpy(keys),
                                             torch.from_numpy(vals)),
                   merge_runs_ranked(torch.from_numpy(keys),
                                     torch.from_numpy(vals))):
        np.testing.assert_array_equal(gk.numpy().view(np.int32),
                                      np.asarray(rk).view(np.int32))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def test_grouped_wrapper_checks_on_cpu():
    keys = torch.zeros((2, 4, 8), dtype=torch.int32)
    wide = torch.zeros((1, 4, km.KWAY_TILE // 4 + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="must fit one tile"):
        km.merge_kway_tile_groups(wide)
    with pytest.raises(ValueError, match="keys must be one of"):
        km.merge_kway_tile_groups(keys.short())
    with pytest.raises(ValueError, match="payload"):
        km.merge_kway_tile_groups(keys, keys.short())
    with pytest.raises(ValueError, match="contiguous"):
        km.merge_kway_tile_groups(keys.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\(g, k, w\)"):
        km.merge_kway_tile_groups(keys[0])
    before = km.merge_kway_tile_groups.launches
    km.merge_kway_tile_groups(keys, keys)  # CPU: the plain version
    assert km.merge_kway_tile_groups.launches == before


def test_merge_runs_ranked_cuda_backend_on_cpu_raises(monkeypatch):
    from repro_torch.core.mergesort import merge_runs_ranked
    from repro_torch.kernels import ops

    keys = torch.zeros((2, 4, 8), dtype=torch.int32)
    monkeypatch.setenv(ops.BACKEND_ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        merge_runs_ranked(keys, None)
