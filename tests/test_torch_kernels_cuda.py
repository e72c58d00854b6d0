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
from repro_torch.external.api import external_argsort, external_sort
from repro_torch.kernels import merge as km
from repro_torch.kernels import ops

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
    bounds = km.tile_bounds(a.numel() + b.numel(), km.MERGE_TILE, cuda_device)
    cr = co_rank_batch(bounds, a, b)
    before = km.merge_tile.launches
    got = km.merge_tile(a, b, cr.j, cr.k)
    assert km.merge_tile.launches == before + 1
    want = km.merge_tile_plain(a, b, cr.j, cr.k)
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


def test_entry_points_reach_the_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a, b = (torch.sort(torch.randint(0, 50, (n,), generator=g, device=cuda_device,
                                     dtype=torch.int32)).values
            for n in (5000, 3001))
    km.merge_tile.launches = 0
    got = ops.stable_merge(a, b)
    assert km.merge_tile.launches == 1
    assert torch.equal(got, torch.sort(torch.cat([a, b]), stable=True).values)
    for k in (4, 3):
        runs = torch.sort(torch.randint(0, 50, (k, 3000), generator=g,
                                        device=cuda_device, dtype=torch.int32),
                          dim=1).values
        km.merge_kway_tile.launches = 0
        got = ops.stable_merge_kway(runs)
        assert km.merge_kway_tile.launches == 1
        assert torch.equal(got, torch.sort(runs.reshape(-1), stable=True).values)


@pytest.mark.parametrize("fanout", [3, 8])
def test_external_sort_ragged_groups_on_card(cuda_device, tmp_path, fanout):
    """11 runs: fanout 8 leaves a tail group of 3, fanout 3 one of 2; int64
    keys with an 8-byte payload, and int32 keys through the argsort."""
    rng = np.random.default_rng(fanout)
    n, chunk = 11 * 3000 - 17, 3000
    keys = rng.integers(-1000, 1000, n).astype(np.int64)
    vals = rng.standard_normal(n)
    order = np.argsort(keys, kind="stable")
    km.merge_kway_tile.launches = 0
    got_k, got_v = external_sort(keys, vals, chunk=chunk, fanout=fanout,
                                 window=1000, workdir=str(tmp_path / "kv"))
    assert km.merge_kway_tile.launches > 0
    np.testing.assert_array_equal(np.asarray(got_k), keys[order])
    np.testing.assert_array_equal(np.asarray(got_v), vals[order])
    keys32 = keys.astype(np.int32)
    got = external_argsort(keys32, chunk=chunk, fanout=fanout, window=1000,
                           workdir=str(tmp_path / "arg"))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.argsort(keys32, kind="stable"))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.arange(8, device=cuda_device, dtype=torch.int32)
    cr = co_rank_batch(km.tile_bounds(16, km.MERGE_TILE, cuda_device), x, x)
    with pytest.raises(ValueError, match="keys must share"):
        km.merge_tile(x.short(), x.short(), cr.j, cr.k)
    with pytest.raises(ValueError, match="tiles given"):
        bad = co_rank_batch(km.tile_bounds(16, 4, cuda_device), x, x)
        km.merge_tile(x, x, bad.j, bad.k)
    with pytest.raises(ValueError, match="several devices"):
        km.merge_tile(x, x.cpu(), cr.j, cr.k)
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
    """merge_tile and its plain version at the kernel's tile."""
    bounds = km.tile_bounds(a.numel() + b.numel(), km.MERGE_TILE, a.device)
    cr = co_rank_batch(bounds, a, b)
    return (km.merge_tile(a, b, cr.j, cr.k),
            km.merge_tile_plain(a, b, cr.j, cr.k))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bfloat16])
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


@pytest.mark.parametrize("m,n", [(5, 7), (1, 0), (0, 1), (0, 9000), (9000, 0),
                                 (km.MERGE_TILE - 1, 1)])
def test_merge_tile_short_and_one_sided_on_card(cuda_device, m, n):
    a = _sorted_rows((m,), torch.float32, cuda_device, 5)
    b = _sorted_rows((n,), torch.float32, cuda_device, 6)
    got, want = _merge_both(a, b)
    assert torch.equal(got, want)
    assert torch.equal(got, torch.sort(torch.cat([a, b]), stable=True).values)


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
