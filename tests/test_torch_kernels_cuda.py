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
