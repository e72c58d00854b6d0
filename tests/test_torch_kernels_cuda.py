"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (and ``nvcc`` to build the kernels); they
skip without one.  They import no JAX, so they also run on a machine that
has only PyTorch.  Comparisons are bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.corank import co_rank_batch
from repro_torch.core.kway import co_rank_kway_batch
from repro_torch import obs
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.external.api import external_argsort, external_sort
from repro_torch.kernels import merge as km
from repro_torch.kernels import ops
from repro_torch.launch.serve import LockstepDecoder
from repro_torch.models import transformer as tm
from repro_torch.models.transformer import (Cache, decode_step, init_cache,
                                            init_params)

DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64,
          torch.float16, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _sorted_rows(shape, dtype, device, seed):
    """Duplicate-heavy sorted rows; integer-valued, so exact in every dtype."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-200, 200, shape, generator=g, device=device).to(dtype)
    return torch.sort(x, dim=-1).values


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_tile_kernel_matches_plain_on_card(cuda_device, dtype):
    a = _sorted_rows((100_003,), dtype, cuda_device, 0)
    b = _sorted_rows((77_777,), dtype, cuda_device, 1)
    before = km.merge_tile.launches
    got, want = _merge_both(a, b)
    assert km.merge_tile.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16, 17, 40])
def test_merge_kway_tile_kernel_matches_plain_on_card(cuda_device, k,
                                                      with_vals):
    g = torch.Generator(device=cuda_device).manual_seed(k)
    w = 20_000
    runs = _sorted_rows((k, w), torch.int32, cuda_device, k)
    lengths = torch.randint(0, w + 1, (k,), generator=g, device=cuda_device,
                            dtype=torch.int32)
    vals = torch.arange(k * w, device=cuda_device,
                        dtype=torch.int32).reshape(k, w) if with_vals else None
    total = int(lengths.sum())
    bounds = km.tile_bounds(total, km.KWAY_TILE, cuda_device)
    cb = co_rank_kway_batch(bounds, runs, lengths)
    got = km.merge_kway_tile(runs, cb, vals=vals, out_len=total)
    want = km.merge_kway_tile_plain(runs, cb, vals=vals, out_len=total)
    for x, y in zip(got if with_vals else (got,), want if with_vals else (want,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("val_dtype", [None, torch.int32, torch.int64,
                                       torch.float64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_kway_tile_dtypes_match_plain_on_card(cuda_device, dtype,
                                                    val_dtype):
    k, w = 3, 30_000
    runs = _sorted_rows((k, w), dtype, cuda_device, 7)
    vals = None if val_dtype is None else torch.arange(
        k * w, device=cuda_device).to(val_dtype).reshape(k, w)
    bounds = km.tile_bounds(k * w, km.KWAY_TILE, cuda_device)
    cb = co_rank_kway_batch(bounds, runs)
    got = km.merge_kway_tile(runs, cb, vals=vals, out_len=k * w)
    want = km.merge_kway_tile_plain(runs, cb, vals=vals, out_len=k * w)
    for x, y in zip(got if vals is not None else (got,),
                    want if vals is not None else (want,)):
        assert torch.equal(x, y)
    order = torch.sort(runs.reshape(-1), stable=True)
    assert torch.equal(got[0] if vals is not None else got, order.values)
    if vals is not None:
        assert torch.equal(got[1], vals.reshape(-1)[order.indices])


def _launch_counts():
    return {name: getattr(km, name).launches for name in (
        "merge_tile", "merge_kway_tile", "merge_kway_tile_groups",
        "merge_kway_groups_wide")}


def _no_phase_one(monkeypatch):
    """Make the torch-ops phase 1 raise where the kernels' wrappers reach
    it: the k <= 64 routes and the pairwise merge must not."""
    def refuse(*args, **kwargs):
        raise AssertionError("phase 1 ran in torch ops")

    monkeypatch.setattr(km, "co_rank_batch", refuse)
    monkeypatch.setattr(km, "co_rank_kway_batch", refuse)


def test_entry_points_reach_the_kernels(cuda_device, monkeypatch):
    """Each merge entry is one kernel launch with no torch-ops phase 1:
    ``stable_merge`` one ``merge_tile``, ``stable_merge_kway`` and
    ``merge_window`` (k <= 64) one wide launch."""
    _no_phase_one(monkeypatch)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a, b = (torch.sort(torch.randint(0, 50, (n,), generator=g, device=cuda_device,
                                     dtype=torch.int32)).values
            for n in (5000, 3001))
    before = _launch_counts()
    got = ops.stable_merge(a, b)
    assert _launch_counts() == {**before, "merge_tile": before["merge_tile"] + 1}
    assert torch.equal(got, torch.sort(torch.cat([a, b]), stable=True).values)
    for k in (4, 3, 64):
        runs = torch.sort(torch.randint(0, 50, (k, 3000), generator=g,
                                        device=cuda_device, dtype=torch.int32),
                          dim=1).values
        before = _launch_counts()
        got = ops.stable_merge_kway(runs)
        wide = before["merge_kway_groups_wide"] + 1
        assert _launch_counts() == {**before, "merge_kway_groups_wide": wide}
        assert torch.equal(got, torch.sort(runs.reshape(-1), stable=True).values)
        lengths = torch.randint(0, 3001, (k,), generator=g, device=cuda_device,
                                dtype=torch.int32)
        vals = torch.arange(k * 3000, device=cuda_device).reshape(k, 3000)
        before = _launch_counts()
        mk, mv = ops.merge_window(runs, vals, lengths, out_len=k * 3000)
        assert _launch_counts() == {**before, "merge_kway_groups_wide": wide + 1}
        real = torch.arange(3000, device=cuda_device)[None, :] < lengths[:, None]
        order = torch.sort(runs[real], stable=True)
        total = order.values.numel()
        assert torch.equal(mk[:total], order.values)
        assert torch.equal(mv[:total], vals[real][order.indices])


@pytest.mark.parametrize("fanout", [3, 8])
def test_external_sort_ragged_groups_on_card(cuda_device, tmp_path, fanout):
    """11 runs: fanout 8 leaves a tail group of 3, fanout 3 one of 2; int64
    keys with an 8-byte payload, and int32 keys through the argsort."""
    rng = np.random.default_rng(fanout)
    n, chunk = 11 * 3000 - 17, 3000
    keys = rng.integers(-1000, 1000, n).astype(np.int64)
    vals = rng.standard_normal(n)
    order = np.argsort(keys, kind="stable")
    km.merge_kway_tile.launches = km.merge_kway_groups_wide.launches = 0
    got_k, got_v = external_sort(keys, vals, chunk=chunk, fanout=fanout,
                                 window=1000, workdir=str(tmp_path / "kv"))
    # every window is one wide launch (at most 8 runs)
    assert km.merge_kway_groups_wide.launches > 0
    assert km.merge_kway_tile.launches == 0
    np.testing.assert_array_equal(np.asarray(got_k), keys[order])
    np.testing.assert_array_equal(np.asarray(got_v), vals[order])
    keys32 = keys.astype(np.int32)
    got = external_argsort(keys32, chunk=chunk, fanout=fanout, window=1000,
                           workdir=str(tmp_path / "arg"))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.argsort(keys32, kind="stable"))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.arange(8, device=cuda_device, dtype=torch.int32)
    with pytest.raises(ValueError, match="keys must share"):
        km.merge_tile(x.short(), x.short())
    with pytest.raises(ValueError, match="1-D"):
        km.merge_tile(x[None], x)
    with pytest.raises(ValueError, match="several devices"):
        km.merge_tile(x, x.cpu())
    with pytest.raises(ValueError, match="lengths must be"):
        km.merge_kway_groups_wide(x.reshape(1, 2, 4),
                                  lengths=torch.zeros((1, 3), dtype=torch.int32,
                                                      device=cuda_device))
    runs = torch.zeros((km.KWAY_MAX_RUNS + 1, 1), device=cuda_device,
                       dtype=torch.int32)
    cb = torch.zeros((2, runs.shape[0]), device=cuda_device, dtype=torch.int32)
    with pytest.raises(ValueError, match="k must be in"):
        km.merge_kway_tile(runs, cb, out_len=runs.shape[0])
    runs = torch.zeros((4, 32), device=cuda_device, dtype=torch.int32)[:, ::2]
    cb = co_rank_kway_batch(km.tile_bounds(64, km.KWAY_TILE, cuda_device), runs)
    with pytest.raises(ValueError, match="contiguous"):
        km.merge_kway_tile(runs, cb, out_len=64)


# --- hazards of the redesigned kernels -----------------------------------------


def _merge_both(a, b):
    """merge_tile and its plain version at the kernel's tile: the cuts the
    kernel found equal ``co_rank_batch``'s bit for bit, and the merge is
    ``torch.sort(stable=True)``'s."""
    bounds = km.tile_bounds(a.numel() + b.numel(), km.MERGE_TILE, a.device)
    cr = co_rank_batch(bounds, a, b)
    got, jb, kb = km.merge_tile(a, b, cuts=True)
    assert torch.equal(jb, cr.j) and torch.equal(kb, cr.k)
    ab = torch.cat([a, b])
    order = torch.sort(ab + 0 if ab.is_floating_point() else ab, stable=True)
    assert torch.equal(got.view(torch.uint8), ab[order.indices].view(torch.uint8))
    return got, km.merge_tile_plain(a, b, cr.j, cr.k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_tile_every_alignment_on_card(cuda_device, dtype):
    """Inputs starting at every element offset inside a 16-byte block, so
    the staged windows start at every residue mod 16 bytes."""
    per_block = 16 // torch.empty((), dtype=dtype).element_size()
    base_a = _sorted_rows((60_000,), dtype, cuda_device, 3)
    base_b = _sorted_rows((50_000,), dtype, cuda_device, 4)
    for off_a in range(per_block):
        for off_b in range(per_block):
            a = base_a[off_a:off_a + 41_234 + off_b]
            b = base_b[off_b:off_b + 33_333 + off_a]
            got, want = _merge_both(a, b)
            assert torch.equal(got, want), (off_a, off_b)


def test_merge_tile_tiles_from_one_input_on_card(cuda_device):
    """A's keys all below B's: every tile but one is drawn wholly from one
    input, and the windows of the other are empty."""
    a = torch.arange(0, 50_001, device=cuda_device, dtype=torch.int32)
    b = torch.arange(60_000, 90_000, device=cuda_device, dtype=torch.int32)
    for x, y in ((a, b), (b, a)):
        got, want = _merge_both(x, y)
        assert torch.equal(got, want)
        assert torch.equal(got, torch.sort(torch.cat([x, y])).values)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n", [(5, 7), (1, 0), (0, 1), (0, 9000), (9000, 0),
                                 (km.MERGE_TILE - 1, 1), (0, 0),
                                 (km.MERGE_TILE, km.MERGE_TILE)])
def test_merge_tile_short_and_one_sided_on_card(cuda_device, m, n, dtype):
    a = _sorted_rows((m,), dtype, cuda_device, 5)
    b = _sorted_rows((n,), dtype, cuda_device, 6)
    got, want = _merge_both(a, b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,n", [(torch.float32, 3_000_001),
                                     (torch.int64, 1 << 28)])
def test_merge_tile_many_tiles_a_block_on_card(cuda_device, dtype, n):
    """More tiles than the card holds blocks, so each block co-ranks and
    merges a range of many tiles; at 2^29 int64 outputs more than the 511
    tiles a block keeps cuts for, so the grid grows past the resident
    blocks.  Duplicates with the dtype's extremes (and +-0.0, +-inf)."""
    a = _extreme_groups((1, 1, n), dtype, cuda_device, 1)[0, 0]
    b = _extreme_groups((1, 1, n + 77), dtype, cuda_device, 2)[0, 0]
    got, want = _merge_both(a, b)
    assert torch.equal(got, want)


def _kway_both(runs, vals=None, lengths=None, *, cuts_from_sort=False):
    """merge_kway_tile and its plain version at the kernel's tile, and the
    kernel against torch.sort(stable=True) of the real elements.  The cut
    matrix comes from phase 1, or (``cuts_from_sort``, for a k whose phase 1
    would need k*k*tiles words) from the stable sort itself: the cut of run
    q at boundary i is the number of run-q elements among its first i."""
    k, w = runs.shape
    dev = runs.device
    if lengths is None:
        lengths = torch.full((k,), w, device=dev, dtype=torch.int32)
    real = torch.arange(w, device=dev)[None, :] < lengths[:, None]
    order = torch.sort(runs[real], stable=True)
    total = order.values.numel()
    bounds = km.tile_bounds(total, km.KWAY_TILE, dev)
    if cuts_from_sort:
        g = bounds.numel() - 1
        run_of = torch.arange(k, device=dev)[:, None].expand(k, w)[real]
        tile_of = torch.arange(total, device=dev) // km.KWAY_TILE
        per_tile = torch.bincount(tile_of * k + run_of[order.indices],
                                  minlength=g * k).reshape(g, k)
        cb = torch.cat([per_tile.new_zeros((1, k)), torch.cumsum(per_tile, 0)])
        cb = cb.to(torch.int32).contiguous()
    else:
        cb = co_rank_kway_batch(bounds, runs, lengths)
    got = km.merge_kway_tile(runs, cb, vals=vals, out_len=total)
    want = km.merge_kway_tile_plain(runs, cb, vals=vals, out_len=total)
    if vals is None:
        got, want = (got,), (want,)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert torch.equal(got[0], order.values)
    if vals is not None:
        assert torch.equal(got[1], vals[real][order.indices])


def test_merge_kway_tile_max_runs_short_width_on_card(cuda_device):
    """k = KWAY_MAX_RUNS runs of width 3: every tile holds about 1280 of
    the runs' 16384 segments, most of length 1 after compaction."""
    k = km.KWAY_MAX_RUNS
    runs = _sorted_rows((k, 3), torch.int32, cuda_device, 8)
    vals = torch.arange(k * 3, device=cuda_device).reshape(k, 3)
    _kway_both(runs, vals, cuts_from_sort=True)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    lengths = torch.randint(0, 4, (k,), generator=g, device=cuda_device,
                            dtype=torch.int32)
    _kway_both(runs, vals, lengths, cuts_from_sort=True)


@pytest.mark.parametrize("k", [2, 5, 16, 40])
def test_merge_kway_tile_all_ties_on_card(cuda_device, k):
    """Every key equal across every run: the output is the run order, which
    only the left-wins tie rule at every level of the tree gives."""
    w = 10_000
    runs = torch.full((k, w), 3, device=cuda_device, dtype=torch.int32)
    vals = torch.arange(k * w, device=cuda_device, dtype=torch.int32).reshape(k, w)
    _kway_both(runs, vals)
    g = torch.Generator(device=cuda_device).manual_seed(k)
    lengths = torch.randint(0, w + 1, (k,), generator=g, device=cuda_device,
                            dtype=torch.int32)
    _kway_both(runs, vals, lengths)


@pytest.mark.parametrize("key_dtype", [torch.int64, torch.float64])
@pytest.mark.parametrize("k", [3, 16])
def test_merge_kway_tile_wide_keys_wide_payload_on_card(cuda_device, k,
                                                        key_dtype):
    """8-byte keys with an 8-byte payload: the widest shared-memory
    buffers, ragged rows with an empty one."""
    w = 40_000
    runs = _sorted_rows((k, w), key_dtype, cuda_device, 10 + k)
    vals = torch.arange(k * w, device=cuda_device,
                        dtype=torch.int64).reshape(k, w) * 3 - 7
    g = torch.Generator(device=cuda_device).manual_seed(k)
    lengths = torch.randint(0, w + 1, (k,), generator=g, device=cuda_device,
                            dtype=torch.int32)
    lengths[1] = 0
    _kway_both(runs, vals, lengths)
    _kway_both(runs, vals)


# --- the grouped launch of merge_kway_tile --------------------------------------

#: (g, k, w) of every merge of one top-k of qwen3-0.6b's 16 x 151936 logits
#: at k = 50, block 128, fanout 4: the block sort in one launch (and the four
#: fan-out-4 passes the reference's plan takes for it), then the six
#: tournament rounds.
TOPK_GROUPS = [(18992, 128, 1), (607744, 4, 1), (151936, 4, 4), (37984, 4, 16),
               (18992, 2, 64), (4752, 4, 50), (1200, 4, 50), (304, 4, 50),
               (80, 4, 50), (32, 4, 50), (16, 2, 50)]


def _sorted_groups(shape, dtype, device, seed):
    """(g, k, w) groups of sorted duplicate-heavy runs with +-0.0 and
    +-inf among float keys."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-40, 40, shape, generator=g, device=device).to(dtype)
    if dtype.is_floating_point:
        u = torch.rand(shape, generator=g, device=device)
        for lo, v in ((0.0, float("inf")), (0.02, float("-inf")),
                      (0.04, 0.0), (0.06, -0.0)):
            x[(u >= lo) & (u < lo + 0.02)] = v
    return torch.sort(x, dim=-1, stable=True).values


def _groups_both(keys, vals):
    _both(km.merge_kway_tile_groups, km.merge_kway_groups_plain, keys, vals)


@pytest.mark.parametrize("g,k,w", TOPK_GROUPS)
def test_grouped_launch_matches_plain_at_topk_shapes_on_card(cuda_device, g,
                                                             k, w):
    keys = _sorted_groups((g, k, w), torch.float32, cuda_device, g)
    vals = torch.arange(g * k * w, device=cuda_device,
                        dtype=torch.int32).reshape(g, k, w)
    _groups_both(keys, vals)


@pytest.mark.parametrize("g,k,w", [(1000, 3, 50), (777, 5, 7), (300, 7, 100),
                                   (50, 3, 1280), (9, 1, 3840), (1, 3840, 1),
                                   (4000, 6, 1), (123, 11, 13)])
def test_grouped_launch_any_k_and_unaligned_tiles_on_card(cuda_device, g, k,
                                                          w):
    """k not a power of two; group sizes whose tiles start off a 16-byte
    boundary; one group filling a tile; k up to the tile."""
    keys = _sorted_groups((g, k, w), torch.float32, cuda_device, k * w)
    vals = torch.arange(g * k * w, device=cuda_device,
                        dtype=torch.int32).reshape(g, k, w)
    _groups_both(keys, vals)
    _groups_both(keys, None)


@pytest.mark.parametrize("val_dtype", [None, torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16])
def test_grouped_launch_dtypes_on_card(cuda_device, dtype, val_dtype):
    g, k, w = 2000, 4, 50
    keys = _sorted_groups((g, k, w), dtype, cuda_device, 5)
    vals = None if val_dtype is None else (torch.arange(
        g * k * w, device=cuda_device) * 7 - 3).to(val_dtype).reshape(g, k, w)
    _groups_both(keys, vals)


def _extreme_groups(shape, dtype, device, seed):
    """Sorted runs of duplicates with +-0.0, +-inf and the dtype's largest
    finite value (floats) or its max and min (integers) mixed in."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-6, 6, shape, generator=g, device=device).to(dtype)
    u = torch.rand(shape, generator=g, device=device)
    if dtype.is_floating_point:
        specials = (float("inf"), float("-inf"), 0.0, -0.0,
                    torch.finfo(dtype).max)
    else:
        specials = (torch.iinfo(dtype).max, torch.iinfo(dtype).min, 0)
    for i, v in enumerate(specials):
        x[(u >= 0.05 * i) & (u < 0.05 * (i + 1))] = v
    return torch.sort(x, dim=-1, stable=True).values


def _both(launch, plain, keys, vals):
    """One launch against its plain version and a stable sort of each
    group, bits compared."""
    counter = launch.launches
    got = launch(keys, vals)
    assert launch.launches == counter + 1
    want = plain(keys, vals)
    for x, y in zip(got, want):
        if x is not None:
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    gk = keys.reshape(keys.shape[0], -1)
    order = torch.sort(gk + 0 if gk.is_floating_point() else gk, dim=1,
                       stable=True).indices
    assert torch.equal(got[0].view(torch.uint8),
                       torch.gather(gk, 1, order).view(torch.uint8))
    if vals is not None:
        assert torch.equal(got[1], torch.gather(
            vals.reshape(vals.shape[0], -1), 1, order))


VAL_DTYPES = [None, torch.int32, torch.float32, torch.int64, torch.float64]


def _payload(shape, val_dtype, device):
    if val_dtype is None:
        return None
    n = int(np.prod(shape))
    return (torch.arange(n, device=device) * 7 - 3).to(val_dtype).reshape(shape)


@pytest.mark.parametrize("val_dtype", VAL_DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_leaf_pass_every_power_of_two_on_card(cuda_device, dtype, val_dtype):
    """The sort plan's leaf ``(g, s, 1)`` at every power of two up to the
    grouped launch's tile, every key dtype and payload width."""
    s = 1
    while s <= km.GROUPS_TILE:
        g = max(1, 3 * km.GROUPS_TILE // s + 1)  # a ragged last tile
        shape = (g, s, 1)
        keys = _extreme_groups(shape, dtype, cuda_device, s)
        _both(km.merge_kway_tile_groups, km.merge_kway_groups_plain, keys,
              _payload(shape, val_dtype, cuda_device))
        s *= 2


@pytest.mark.parametrize("g,k,w", [(1, 4, 4096), (2, 2, 2049), (5, 3, 1500),
                                   (7, 8, 600), (3, 64, 97), (1, 1, 5000),
                                   (300, 4, 1025), (2, 4, 65536),
                                   (1, 2, 1 << 20), (4, 16, 4096)])
def test_wide_launch_shapes_on_card(cuda_device, g, k, w):
    """The wide grouped launch: k from 1 to 64, groups just above the tile,
    odd widths (tiles off a 16-byte boundary), one group and many."""
    shape = (g, k, w)
    keys = _extreme_groups(shape, torch.float32, cuda_device, k * w)
    _both(km.merge_kway_groups_wide, km.merge_kway_groups_wide_plain, keys,
          _payload(shape, torch.int32, cuda_device))
    _both(km.merge_kway_groups_wide, km.merge_kway_groups_wide_plain, keys,
          None)


@pytest.mark.parametrize("val_dtype", VAL_DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_launch_dtypes_on_card(cuda_device, dtype, val_dtype):
    shape = (3, 4, 2000)
    keys = _extreme_groups(shape, dtype, cuda_device, 11)
    _both(km.merge_kway_groups_wide, km.merge_kway_groups_wide_plain, keys,
          _payload(shape, val_dtype, cuda_device))


def test_wide_launch_all_ties_and_sorted_runs_on_card(cuda_device):
    """Every key equal (the lower run wins every tie), and runs that do
    not interleave at all (every cut at a run's end or start)."""
    for keys in (torch.zeros((2, 4, 3000), device=cuda_device),
                 torch.arange(2 * 4 * 3000, device=cuda_device,
                              dtype=torch.int64).reshape(2, 4, 3000),
                 torch.arange(2 * 4 * 3000, device=cuda_device,
                              dtype=torch.int32).reshape(2, 4, 3000).flip(1)
                 .contiguous()):
        _both(km.merge_kway_groups_wide, km.merge_kway_groups_wide_plain, keys,
              _payload(keys.shape, torch.int64, cuda_device))


def _wide_ragged(g, k, w, dtype, seed, *, empty_rows=True):
    """(g, k, w) runs with ragged int32 lengths (some rows empty), padded
    with the dtype's max (+inf for floats) that real max keys collide
    with, and a payload numbering the real elements group by group."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = _extreme_groups((g, k, w), dtype, "cuda", seed)
    lengths = torch.randint(0, w + 1, (g, k), generator=gen, device="cuda",
                            dtype=torch.int32)
    if empty_rows:
        lengths[:, ::3] = 0
    top = float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max
    real = torch.arange(w, device="cuda") < lengths[..., None]
    keys = torch.where(real, keys, torch.full_like(keys, top))
    keys = torch.sort(keys, dim=-1, stable=True).values
    vals = torch.arange(g * k * w, device="cuda").reshape(g, k, w) * 3 - 1
    return keys, vals, lengths, real


@pytest.mark.parametrize("val_dtype", [None, torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,k,w", [(1, 8, 20_000), (3, 5, 3000), (2, 64, 300),
                                   (1, 2, 1 << 18), (4, 16, 2000)])
def test_wide_launch_ragged_matches_plain_and_sort_on_card(cuda_device, g, k,
                                                           w, dtype, val_dtype):
    """The ragged form: every real element in stable order (payload too),
    the kernel's real part bit for bit its plain version's and
    ``torch.sort(stable=True)``'s, at out_len = k*w, the real total and
    below it."""
    keys, vals, lengths, real = _wide_ragged(g, k, w, dtype, g * k + w)
    vals = None if val_dtype is None else vals.to(val_dtype)
    totals = lengths.sum(dim=1).tolist()
    for out_len in (k * w, max(totals), max(totals) // 2 + 1):
        before = km.merge_kway_groups_wide.launches
        got = km.merge_kway_groups_wide(keys, vals, lengths, out_len=out_len)
        assert km.merge_kway_groups_wide.launches == before + 1
        want = km.merge_kway_groups_wide_plain(keys, vals, lengths,
                                               out_len=out_len)
        for i in range(g):
            n = min(out_len, totals[i])
            flat = keys[i][real[i]]
            order = torch.sort(flat + 0 if flat.is_floating_point() else flat,
                               stable=True).indices[:n]
            assert torch.equal(got[0][i, :n].view(torch.uint8),
                               want[0][i, :n].view(torch.uint8))
            assert torch.equal(got[0][i, :n].view(torch.uint8),
                               flat[order].view(torch.uint8))
            if vals is not None:
                assert torch.equal(got[1][i, :n], want[1][i, :n])
                assert torch.equal(got[1][i, :n], vals[i][real[i]][order])


def test_wide_launch_ragged_all_empty_and_all_ties_on_card(cuda_device):
    """Every row empty (nothing written, nothing read), and one key in
    every real slot: the run order alone."""
    keys = torch.full((2, 4, 5000), 7, device=cuda_device, dtype=torch.int32)
    vals = torch.arange(keys.numel(), device=cuda_device).reshape(keys.shape)
    zero = torch.zeros((2, 4), dtype=torch.int32, device=cuda_device)
    km.merge_kway_groups_wide(keys, vals, zero)
    lengths = torch.tensor([[5000, 1, 0, 4999], [0, 0, 0, 5000]],
                           dtype=torch.int32, device=cuda_device)
    got_k, got_v = km.merge_kway_groups_wide(keys, vals, lengths)
    for i in range(2):
        real = torch.arange(5000, device=cuda_device) < lengths[i][:, None]
        n = int(lengths[i].sum())
        assert torch.equal(got_v[i, :n], vals[i][real])
        assert bool((got_k[i, :n] == 7).all())


def test_merge_runs_ranked_routes_by_shape_on_card(cuda_device, monkeypatch):
    """On the card every shape runs a kernel: groups that fit the grouped
    launch's tile go to it, wider ones to the wide launch, wider ones of
    more than 64 runs to sub-groups and a merge of those, and no shape
    reaches the torch-ops merge; a key dtype neither kernel takes raises."""
    from repro_torch.core import mergesort

    def refuse(*args):
        raise AssertionError("merge_runs_plain ran on the cuda backend")

    monkeypatch.setattr(mergesort, "merge_runs_plain", refuse)
    counts = lambda: (km.merge_kway_tile_groups.launches,  # noqa: E731
                      km.merge_kway_groups_wide.launches)
    km.merge_kway_tile_groups.launches = km.merge_kway_groups_wide.launches = 0
    for shape in ((64, 4, 50), (2, 4096, 1), (2, 4, 1000), (2, 4, 1025),
                  (3, 2, 9000)):
        keys = _sorted_groups(shape, torch.float32, cuda_device, shape[2])
        got, _ = mergesort.merge_runs_ranked(keys, None)
        want = km.merge_kway_groups_plain(keys)[0]
        assert torch.equal(got, want), shape
    assert counts() == (3, 2)
    small = _sorted_groups((8, 4, 8), torch.int32, cuda_device, 3).short()
    with pytest.raises(ValueError, match="keys must be one of"):
        mergesort.merge_runs_ranked(small, None)
    with pytest.raises(ValueError, match="keys must be one of"):
        mergesort.merge_runs_ranked(small.repeat(1, 1, 1000), None)
    assert counts() == (3, 2)
    x = torch.randint(0, 100, (100_003,), device=cuda_device,
                      dtype=torch.int32)
    assert torch.equal(mergesort.merge_sort(x), torch.sort(x, stable=True).values)
    plan = mergesort.sort_plan(x.numel())
    assert counts() == (3 + 1, 2 + len(plan) - 1)  # the leaf, then wide passes


@pytest.mark.parametrize("g,k,w", [(2, 65, 100), (1, 128, 50), (3, 128, 40),
                                   (2, 200, 33), (1, 4097, 2)])
def test_more_than_64_runs_merge_on_card(cuda_device, monkeypatch, g, k, w):
    """Groups wider than the grouped launch's tile with more runs than the
    wide launch takes: sub-groups of at most 64 runs, then their merge,
    all on kernels; keys and payload equal the CPU's and a stable sort's."""
    from repro_torch.core import mergesort

    def refuse(*args):
        raise AssertionError("merge_runs_plain ran on the cuda backend")

    keys = _extreme_groups((g, k, w), torch.int32, cuda_device, k)
    vals = torch.arange(g * k * w, device=cuda_device).reshape(g, k, w)
    cpu_k, cpu_v = mergesort.merge_runs_ranked(keys.cpu(), vals.cpu())
    monkeypatch.setattr(mergesort, "merge_runs_plain", refuse)
    before = _launch_counts()
    got_k, got_v = mergesort.merge_runs_ranked(keys, vals)
    after = _launch_counts()
    assert after["merge_kway_tile"] == before["merge_kway_tile"]
    assert after["merge_kway_groups_wide"] > before["merge_kway_groups_wide"]
    assert torch.equal(got_k.cpu(), cpu_k) and torch.equal(got_v.cpu(), cpu_v)
    order = torch.sort(keys.reshape(g, -1), dim=1, stable=True)
    assert torch.equal(got_k, order.values)
    assert torch.equal(got_v, torch.gather(vals.reshape(g, -1), 1, order.indices))


@pytest.mark.parametrize("fanout", [128, 256])
def test_sorts_at_fanout_128_on_card(cuda_device, monkeypatch, fanout):
    """``sort_key_val`` and ``merge_sort`` past 2^18 keys at a fan-out
    above 64: their wide passes merge 128 or 256 runs a group."""
    from repro_torch.core import mergesort

    def refuse(*args):
        raise AssertionError("merge_runs_plain ran on the cuda backend")

    gen = torch.Generator(device=cuda_device).manual_seed(fanout)
    n = (1 << 20) + 12_345
    x = torch.randint(-1000, 1000, (n,), generator=gen, device=cuda_device,
                      dtype=torch.int32)
    x[x > 990] = torch.iinfo(torch.int32).max
    idx = torch.arange(n, device=cuda_device, dtype=torch.int32)
    assert any(k > km.WIDE_MAX_RUNS and k * w > km.GROUPS_TILE
               for _, k, w in mergesort.sort_plan(n, fanout))
    cpu_k, cpu_v = mergesort.sort_key_val(x.cpu(), idx.cpu(), fanout=fanout)
    monkeypatch.setattr(mergesort, "merge_runs_plain", refuse)
    got_k, got_v = mergesort.sort_key_val(x, idx, fanout=fanout)
    order = torch.sort(x, stable=True)
    assert torch.equal(got_k, order.values) and torch.equal(got_v.long(), order.indices)
    assert torch.equal(got_k.cpu(), cpu_k) and torch.equal(got_v.cpu(), cpu_v)
    assert torch.equal(mergesort.merge_sort(x, fanout=fanout), order.values)


def test_topk_at_fanout_128_on_card(cuda_device, monkeypatch):
    """The merge top-k of qwen3's 151,936 logits at k = 50 and fan-out 128:
    a round merges 128 runs of 50 (6,400 keys, past the grouped launch's
    tile), on kernels; indices equal ``torch.topk``'s order, a stable
    sort's and the CPU's."""
    from repro_torch.core import mergesort
    from repro_torch.core.topk import merge_topk_batch

    def refuse(*args):
        raise AssertionError("merge_runs_plain ran on the cuda backend")

    g = torch.Generator(device=cuda_device).manual_seed(128)
    x = torch.randint(-30, 30, (4, 151936), generator=g,
                      device=cuda_device).float()
    x[:, 5::97] = float("inf")
    cv, ci = merge_topk_batch(x.cpu(), 50, fanout=128)
    monkeypatch.setattr(mergesort, "merge_runs_plain", refuse)
    before = _launch_counts()
    vals, idx = merge_topk_batch(x, 50, fanout=128)
    assert _launch_counts()["merge_kway_groups_wide"] > before["merge_kway_groups_wide"]
    assert torch.equal(idx.cpu(), ci) and torch.equal(vals.cpu(), cv)
    order = torch.sort(-(x + 0.0), dim=1, stable=True).indices[:, :50]
    assert torch.equal(idx.long(), order)
    top = torch.topk(x, 50, dim=1)
    assert torch.equal(vals, top.values)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_on_card_matches_cpu_and_sort(cuda_device, dtype):
    from repro_torch.core.topk import merge_topk_batch

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(-30, 30, (16, 151936), generator=g,
                      device=cuda_device).float()
    x[:, 5::97] = float("inf")
    x[:, 7::89] = float("-inf")
    x[:, 11::13] = -0.0
    x = x.to(dtype)
    km.merge_kway_tile_groups.launches = 0
    vals, idx = merge_topk_batch(x, 50, fanout=4)
    assert km.merge_kway_tile_groups.launches == 1 + 6  # block sort, rounds
    cv, ci = merge_topk_batch(x.cpu(), 50, fanout=4)
    assert torch.equal(idx.cpu(), ci)
    assert torch.equal(vals.cpu().view(torch.int16), cv.view(torch.int16))
    order = torch.sort(-(x.float() + 0.0), dim=1, stable=True).indices[:, :50]
    assert torch.equal(idx.long(), order)


@pytest.mark.parametrize("b,vocab,steps", [(256, 50288, 2), (32, 129280, 8)])
def test_batched_sampler_equals_per_row_on_card(cuda_device, b, vocab, steps):
    """The lock-step top-k sampler at the benchmark's shapes (mamba2-2.7b's
    256 rows of 50,288 logits, deepseek-v3's 32 rows of 129,280; k = 50,
    fan-out 0): the batched form, on the grouped launch, draws the per-row
    form's token for each of 512 and 256 keys.  Eight or twenty copies of
    each logit on average, so ties cross the tournament's blocks of 128."""
    from repro_torch.serving.sampling import (
        request_keys,
        sample_topk,
        sample_topk_batched,
    )

    g = torch.Generator(device=cuda_device).manual_seed(vocab)
    x = torch.randint(-3000, 3000, (b, vocab), generator=g,
                      device=cuda_device).float() / 8
    rows = torch.arange(b, device=cuda_device)
    for i in range(steps):
        keys = request_keys(2**31 + 5, rows, torch.full_like(rows, i))
        before = km.merge_kway_tile_groups.launches
        got = sample_topk_batched(keys, x, k=50, fanout=0)
        assert km.merge_kway_tile_groups.launches > before
        want = sample_topk(keys, x, k=50, fanout=0)
        assert torch.equal(got, want)


# --- the MoE layer's merges: dispatch sort and router top-k -------------------------


def _plan_launches(n: int) -> tuple[int, int]:
    """(grouped, wide) launches of a sort of ``n`` keys: its plan's passes
    that fit the grouped launch's tile, and the others."""
    from repro_torch.core.mergesort import sort_plan

    plan = sort_plan(n)
    grouped = sum(k * w <= km.GROUPS_TILE for _, k, w in plan)
    return grouped, len(plan) - grouped


@pytest.mark.parametrize("routing", ["uniform", "one_hot"])
@pytest.mark.parametrize("t,k,n_experts", [(8192, 4, 16), (4096, 8, 256),
                                           (8, 4, 16), (4, 8, 256)])
def test_moe_dispatch_on_grouped_launch_on_card(cuda_device, monkeypatch, t,
                                                k, n_experts, routing):
    """The dispatch sort of dbrx's and deepseek-v3's shapes (a prefill
    batch and a decode batch): the sort plan's leaf a grouped launch and
    every wider pass a wide launch, the plan bit for bit the plain path's
    and ``torch.sort(stable=True)``'s."""
    from repro_torch.models.moe import moe_dispatch, moe_dispatch_dropless

    g = torch.Generator(device=cuda_device).manual_seed(t * k)
    experts = torch.randint(0, n_experts, (t, k), generator=g,
                            device=cuda_device, dtype=torch.int32)
    if routing == "one_hot":
        experts[:, 0] = 3
    km.merge_kway_tile_groups.launches = km.merge_kway_groups_wide.launches = 0
    got = moe_dispatch_dropless(experts, n_experts)
    assert (km.merge_kway_tile_groups.launches,
            km.merge_kway_groups_wide.launches) == _plan_launches(t * k)
    plan = moe_dispatch(experts, n_experts, capacity=t * k // n_experts)
    monkeypatch.setenv(ops.BACKEND_ENV_VAR, "torch")
    want = moe_dispatch_dropless(experts, n_experts)
    want_plan = moe_dispatch(experts, n_experts, capacity=t * k // n_experts)
    for x, y in zip(got + plan, want + want_plan):
        assert torch.equal(x, y)
    order = torch.sort(experts.reshape(-1), stable=True)
    assert torch.equal(got[0], order.values)
    assert torch.equal(got[1].long(), order.indices)
    assert torch.equal(got[2].long(), torch.bincount(experts.reshape(-1).long(),
                                                     minlength=n_experts))


@pytest.mark.parametrize("router", ["random", "one_hot"])
@pytest.mark.parametrize("scoring,t,n_experts,k", [
    ("softmax", 64, 16, 4), ("softmax", 8, 16, 4),
    ("sigmoid", 64, 256, 8), ("sigmoid", 4, 256, 8)])
def test_route_topk_on_grouped_launch_on_card(cuda_device, monkeypatch,
                                              scoring, t, n_experts, k,
                                              router):
    """The router's top-k on the grouped launch against the plain path
    (same scores, bit for bit) and a stable sort; the one-hot router ties
    every expert but one, and the ties go to the lower ids."""
    from repro_torch.models.moe import route_topk

    g = torch.Generator(device=cuda_device).manual_seed(t + n_experts)
    if router == "one_hot":
        logits = torch.zeros((t, n_experts), device=cuda_device)
        logits[:, 3] = 5.0
    else:
        logits = torch.randn((t, n_experts), generator=g, device=cuda_device)
    km.merge_kway_tile_groups.launches = 0
    w, e = route_topk(logits, k, scoring=scoring)
    assert km.merge_kway_tile_groups.launches > 0
    monkeypatch.setenv(ops.BACKEND_ENV_VAR, "torch")
    pw, pe = route_topk(logits, k, scoring=scoring)
    assert torch.equal(e, pe) and torch.equal(w, pw)
    scores = (torch.sigmoid(logits) if scoring == "sigmoid"
              else torch.softmax(logits, -1))
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    assert torch.equal(e.long(), order)


def _sharded_sort_rank(rank, world, port, n, queue):
    """One gloo rank on ``cuda:0``: ``sharded_sort`` of its shard of ``n``
    seeded keys on both strategies, with the kernels' launches."""
    import datetime

    import torch.distributed as dist

    from repro_torch.distributed import sharded_sort

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        dev = torch.device("cuda", 0)
        g = torch.Generator(device=dev).manual_seed(17)
        x = torch.randint(-50, 50, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        x[x > 40] = torch.iinfo(torch.int32).max
        w = n // world
        km.merge_kway_groups_wide.launches = km.merge_kway_tile_groups.launches = 0
        out = {s: sharded_sort(x[rank * w:(rank + 1) * w], dist.group.WORLD,
                               strategy=s) for s in ("exchange", "allgather")}
        want = torch.sort(x, stable=True).values[rank * w:(rank + 1) * w]
        queue.put((rank, {s: bool(torch.equal(o, want)) for s, o in out.items()},
                   km.merge_kway_groups_wide.launches,
                   km.merge_kway_tile_groups.launches))
    finally:
        dist.destroy_process_group()


def test_sharded_sort_two_gloo_ranks_on_card(cuda_device):
    """Two gloo ranks share the card: each rank's block of the sharded
    sort equals ``torch.sort(stable=True)``'s, and both ranks launched the
    local sort's grouped kernel and the ragged merge's wide launch."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_sharded_sort_rank,
                         args=(r, 2, port, 2 * 50_000, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    for _, equal, wide, groups in got:
        assert all(equal.values()), equal
        assert wide > 0 and groups > 0


# --- the SSD decode step: ssd_step.cu ------------------------------------------------


def _ssd_case(bt, h, p, n, g, dtype, device, seed):
    """One token's inputs shaped as the decode step makes them: x, B and C
    slices of one conv output row (so their rows are strided), dt after
    the softplus, and a stack of three layers' float32 states."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d_inner = h * p
    conv_out = torch.randn((bt, 1, d_inner + 2 * g * n), generator=gen,
                           device=device).to(dtype)
    x = conv_out[..., :d_inner].reshape(bt, h, p)
    b = conv_out[..., d_inner:d_inner + g * n].reshape(bt, g, n)
    c = conv_out[..., d_inner + g * n:].reshape(bt, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn((bt, 1, h), generator=gen, device=device) - 2.0)[:, 0]
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
    d_skip = torch.randn((h,), generator=gen, device=device)
    states = torch.randn((3, bt, h, p, n), generator=gen, device=device)
    return (x, dt, b, c, a_log, d_skip), states


def _bf16_step(v, up: bool):
    """The bfloat16 values one step above (``up``) or below ``v``: bf16 is
    sign and magnitude, so a step is one unit of the magnitude bits."""
    u = v.view(torch.int16).int() & 0xFFFF
    mag, neg = u & 0x7FFF, (u & 0x8000) != 0
    away = up != neg  # a step up from a positive value grows its magnitude
    mag = torch.where(away, mag + 1, mag - 1)
    neg = torch.where(mag < 0, ~neg, neg)  # a step through zero
    bits = torch.where(neg, 0x8000, 0) | mag.abs()
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).short().view(
        torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("bt,h,p,n", [(256, 80, 64, 128),  # mamba2-2.7b
                                      (32, 64, 64, 64),    # zamba2-1.2b
                                      (8, 8, 16, 16)])     # smoke width
def test_ssd_step_kernel_matches_plain_on_card(cuda_device, bt, h, p, n, g,
                                               dtype):
    """The kernel against ``ssd_step`` plus ``copy_``: the layer's state
    bit for bit (the same three roundings a value: both products, then
    the sum), the neighbouring layers' slices untouched, one launch.

    ``y`` sums ``C[n] * h'[p, n]`` over n in another order than the plain
    version's einsum.  With float32 inputs it is held within float32
    summation error: 1e-5 of the sum of its terms' magnitudes (a sum's
    rounding error scales with its terms, not with its value, which mixed
    signs can cancel to far below them; the worst case of two orders of
    128 terms is 2 * 127 * 2^-24 = 1.5e-5 of it).  With bf16 inputs the
    float32 sums round to bf16, so a sum that lands beside a rounding
    boundary may round the other way: y before the skip is the plain one or
    its bf16 neighbour, and the D skip's bf16 add follows exactly."""
    from repro_torch.kernels.ssd import ssd_step_update
    from repro_torch.models import ssm

    args, states = _ssd_case(bt, h, p, n, g, dtype, cuda_device, seed=n + g)
    want_y, want_h = ssm.ssd_step(*args, states[1])
    before = states.clone()
    launches = ssd_step_update.launches
    got_y = ssd_step_update(*args, states[1])
    torch.cuda.synchronize()
    assert ssd_step_update.launches == launches + 1
    assert torch.equal(states[1], want_h)
    assert torch.equal(states[0], before[0]) and torch.equal(states[2], before[2])
    assert got_y.dtype == dtype and got_y.shape == want_y.shape
    c_heads = args[3].float().repeat_interleave(h // g, dim=1)
    if dtype == torch.float32:
        terms = torch.einsum("bhpn,bhn->bhp", want_h.abs(), c_heads.abs())
        assert bool(((got_y - want_y).abs() <= 1e-5 * terms).all())
    else:
        # y before the skip is the plain one or a bf16 step beside it; the
        # skip is then added exactly as the plain version adds it.
        pre = torch.einsum("bhpn,bhn->bhp", want_h, c_heads).to(dtype)
        skip = (args[5][:, None] * args[0].float()).to(dtype)
        ok = torch.zeros_like(got_y, dtype=torch.bool)
        for y_pre in (pre, _bf16_step(pre, True), _bf16_step(pre, False)):
            ok |= (y_pre + skip) == got_y
        bad = (~ok).nonzero()[:5].unbind(1)
        assert bool(ok.all()), (
            f"{int((~ok).sum())} of {ok.numel()} outside one step: pre "
            f"{pre[bad].tolist()} skip {skip[bad].tolist()} want "
            f"{want_y[bad].tolist()} got {got_y[bad].tolist()}")


def test_ssd_step_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels.ssd import ssd_step_update

    args, states = _ssd_case(4, 8, 16, 16, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_step_update(*args, states[1].transpose(-1, -2).contiguous()
                        .transpose(-1, -2))
    x, dt, b, c, a_log, d_skip = args
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_step_update(x.half(), dt, b.half(), c.half(), a_log, d_skip,
                        states[1])
    args6, states6 = _ssd_case(4, 8, 16, 6, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="multiple of 4"):
        ssd_step_update(*args6, states6[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_step_update(*(t.cpu() for t in args), states[1].cpu())


def test_ssd_step_on_dtensor_shards_of_two_gloo_ranks_on_card(cuda_device):
    """``ssd_step_`` on a DTensor cache whose shards are on the card: two
    gloo ranks on ``cuda:0`` each launch the kernel once a case on their
    own rows or heads (inputs whole, replicated or sharded, one or two B/C
    groups; no collective), their shard of the state equal to the whole
    plain step's bit for bit and ``y`` within float32 summation of it,
    laid out as the state; a state sharded over the head dimension is
    refused."""
    import _torch_shard_ranks

    _torch_shard_ranks.check(_torch_shard_ranks.spawn("cuda:0"))


def test_lockstep_decode_step_launches_the_ssd_kernel_on_card(cuda_device,
                                                              monkeypatch):
    """One lock-step ``decode_step`` of the smoke mamba2 on the card runs
    the kernel once a layer.  Against the same step with the plain
    ``ssd_step`` plus ``copy_`` in the kernel's place: the first layer's
    states bit for bit (the later layers' inputs carry the kernel's other
    summation order of y), the logits within bf16 rounding."""
    from repro_torch.configs.registry import ARCHS, smoke_config
    from repro_torch.kernels.ssd import ssd_step_update
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tm

    cfg = smoke_config(ARCHS["mamba2-2.7b"])
    params = tm.init_params(cfg, torch.Generator(device=cuda_device)
                            .manual_seed(0), device=cuda_device)
    cp = tm.compute_params(cfg, params)
    tokens = torch.arange(4, device=cuda_device).reshape(4, 1) + 3
    caches, logits = [], []
    for route in ("kernel", "plain"):
        if route == "plain":
            def plain(*args):
                y, h_new = ssm.ssd_step(*args)
                args[-1].copy_(h_new)
                return y

            monkeypatch.setattr(ssm, "ssd_step_update", plain)
        cache = tm.init_cache(cfg, 4, 8, device=cuda_device)
        cache.data[1].normal_(generator=torch.Generator(device=cuda_device)
                              .manual_seed(1))
        launches = ssd_step_update.launches
        out, cache = tm.decode_step(cfg, cp, cache, tokens)
        torch.cuda.synchronize()
        assert ssd_step_update.launches == launches + (
            cfg.n_layers if route == "kernel" else 0)
        caches.append(cache)
        logits.append(out)
    assert torch.equal(caches[0].data[0][0], caches[1].data[0][0])
    assert torch.equal(caches[0].data[1][0], caches[1].data[1][0])
    scale = float(logits[1].abs().max())
    assert float((logits[0] - logits[1]).abs().max()) <= 2e-2 * scale


# --- the lock-step decode step replayed as a CUDA graph ----------------------------


class _Graphed(LockstepDecoder):
    """The lock-step decoder, keeping every logits tensor a step returns."""

    def _decode(self, tokens):
        out = super()._decode(tokens)
        self.logits.append(out)
        return out


class _Eager(_Graphed):
    """The same, with every step run by ``decode_step``."""

    def _decode(self, tokens):
        out, self.cache = decode_step(self.cfg, self.params, self.cache, tokens)
        self.logits.append(out)
        return out


def _smoke(arch, device):
    cfg = smoke_config(ARCHS[arch])
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, gen, device=device)


def _zero_in_place(dec):
    """The decoder's cache tensors zeroed, with a new length of 0."""
    for t in dec.cache.data:
        t.zero_()
    dec.cache = Cache(dec.cache.kind, dec.cache.data,
                      torch.zeros((), dtype=torch.int32, device=dec.device))


def _generate_both(cfg, params, device, sampler, batches):
    """Both decoders through ``batches`` (``(prompts, new tokens, how the
    next cache is made)``, the last a name or a function of both
    decoders); asserts equal tokens, logits and caches bit for bit after
    each batch; returns the graphed decoder."""
    decs = [cls(cfg, params, batch=4, max_len=12, sampler=sampler, top_k=8,
                seed=2**31 + 5, device=device) for cls in (_Graphed, _Eager)]
    kept = []
    for prompts, new, fresh in batches:
        if callable(fresh):
            fresh(decs)
        for dec in decs:
            if fresh == "in_place":  # the same tensors, zeroed, length 0
                _zero_in_place(dec)
            elif fresh == "new_alive":  # new storage, the old cache kept
                kept.append(dec.cache)
                dec.cache = init_cache(cfg, 4, 12, device=device)
            dec.logits = []
        got, want = (dec.generate(prompts, new) for dec in decs)
        np.testing.assert_array_equal(got, want)
        assert len(decs[0].logits) == len(decs[1].logits)
        for a, b in zip(decs[0].logits, decs[1].logits):
            assert torch.equal(a, b)
        assert int(decs[0].cache.length) == int(decs[1].cache.length) \
            == prompts.shape[1] + new
        for a, b in zip(decs[0].cache.data, decs[1].cache.data):
            assert torch.equal(a, b)
    return decs[0]


@pytest.mark.parametrize("sampler", ["greedy", "topk"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_lockstep_graph_replay_equals_eager_on_card(cuda_device, arch, sampler):
    """The lock-step decoder on the card captures its step once (after one
    eager step) and replays it: the tokens, every step's logits and the
    cache (states, zamba2's shared k/v, the length) equal the eager
    decoder's bit for bit.  A second batch on the same cache tensors,
    zeroed in place, replays the same graph; a third on a cache made while
    the old one is alive is captured again and stays equal."""
    cfg, params = _smoke(arch, cuda_device)
    prompts = np.random.default_rng(3).integers(1, cfg.vocab, (4, 3))
    dec = _generate_both(cfg, params, cuda_device, sampler,
                         [(prompts, 6, None),
                          (np.ascontiguousarray(prompts[:, ::-1]), 5, "in_place"),
                          (prompts[:, :2], 4, "new_alive")])
    # 9 + 8 steps on the first storage (the first eager), 6 on the new one
    # (the first eager)
    assert dec.graph_captures == 2
    assert dec.graph_replays == 8 + 8 + 5


def test_lockstep_moe_decoder_never_captures_on_card(cuda_device):
    """deepseek-v3 smoke has MoE layers, whose dispatch reads segment sizes
    on the host: every step runs eagerly, and its streams equal the eager
    decoder's."""
    cfg, params = _smoke("deepseek-v3-671b", cuda_device)
    prompts = np.random.default_rng(4).integers(1, cfg.vocab, (4, 3))
    dec = _generate_both(cfg, params, cuda_device, "topk", [(prompts, 4, None)])
    assert dec.graph_captures == dec.graph_replays == 0


def test_lockstep_graph_holds_its_position_tables_on_card(cuda_device):
    """zamba2's shared attention reads the rope tables, which live in a
    cache of 16 entries.  The captured step holds the tables it reads:
    with them evicted from that cache and the freed memory of the capture
    stream filled with other values, a second batch's replays still equal
    the eager decoder's."""
    cfg, params = _smoke("zamba2-1.2b", cuda_device)
    prompts = np.random.default_rng(6).integers(1, cfg.vocab, (4, 3))

    def evict_and_overwrite(decs):
        for dec in decs:
            _zero_in_place(dec)
        for n in range(16):  # other tables push the step's out of the cache
            tm._rope_tables(cfg.resolved_head_dim, 1000 + n, cfg.rope_theta,
                            cuda_device)
        with torch.cuda.stream(decs[0]._stream):  # the tables' stream
            decs[0].junk = [torch.full((128,), 7.0, device=cuda_device)
                            for _ in range(8192)]

    dec = _generate_both(cfg, params, cuda_device, "greedy",
                         [(prompts, 6, None), (prompts, 6, evict_and_overwrite)])
    assert dec.graph_captures == 1
    assert dec.graph_replays == 8 + 9


def test_lockstep_decoder_with_obs_on_never_captures_on_card(cuda_device):
    """With obs on, every record point of the step has to fire each step,
    so the mamba2 decoder on the card runs every step eagerly: no graph is
    captured or replayed, and its tokens, logits and cache equal the eager
    decoder's."""
    cfg, params = _smoke("mamba2-2.7b", cuda_device)
    prompts = np.random.default_rng(7).integers(1, cfg.vocab, (4, 3))
    with obs.capture() as records:
        dec = _generate_both(cfg, params, cuda_device, "topk",
                             [(prompts, 4, None)])
    assert dec.graph_captures == dec.graph_replays == 0
    assert any(r["metric"] == "serve.sampled_tokens" for r in records)
