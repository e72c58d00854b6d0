"""The port's merge top-k against the JAX package's, bit for bit.

``repro_torch.core.topk.merge_topk_batch`` runs on the CPU through the
plain rank merge (the card's grouped launch is held against that plain
version in ``tests/test_torch_kernels_cuda.py``).  Every case goes through
the reference's jitted ``merge_topk_batch`` with the same numpy rows, and
values (as bits) and indices must be equal.  One reference compile per
(dtype, k, fanout) serves all the row kinds: rows never mix in a top-k.
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import ml_dtypes

from repro.core import topk as ref_topk
from repro.kernels import ref as ref_kref
from repro_torch.core import topk
from repro_torch.kernels import ref as kref

N = 1000  # not a multiple of the 128-wide block
KINDS = ("duplicates", "inf", "signed_zero", "dtype_max")


def _rows(dtype: str, n: int = N) -> np.ndarray:
    """One row per kind: duplicate-heavy; with +-inf; with +-0.0 among
    few values; with the dtype's extremes.  Integer rows use the dtype's
    max and min + 1 (min itself would overflow on negation)."""
    rng = np.random.default_rng(13)
    dup = rng.integers(-6, 6, n).astype(np.float64)
    inf = rng.integers(-3, 3, n).astype(np.float64)
    inf[rng.random(n) < 0.1] = np.inf
    inf[rng.random(n) < 0.1] = -np.inf
    zero = rng.choice(np.array([0.0, -0.0, 1.0, -1.0]), n)
    ext = rng.integers(-3, 3, n).astype(np.float64)
    if dtype == "int32":
        info = np.iinfo(np.int32)
        ext[rng.random(n) < 0.1] = info.max
        ext[rng.random(n) < 0.1] = info.min + 1
        return np.stack([dup, dup, dup, ext]).astype(np.int32)
    big = float(np.finfo(np.float32).max if dtype == "float32"
                 else ml_dtypes.finfo(ml_dtypes.bfloat16).max)
    ext[rng.random(n) < 0.1] = big
    ext[rng.random(n) < 0.1] = -big
    x = np.stack([dup, inf, zero, ext]).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x)


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


@functools.cache
def _both(dtype: str, k: int, fanout: int):
    x = _rows(dtype)
    rv, ri = ref_topk.merge_topk_batch(jnp.asarray(x), k, fanout=fanout)
    pv, pi = topk.merge_topk_batch(_torch(x), k, fanout=fanout)
    if pv.dtype == torch.bfloat16:
        pv = pv.view(torch.int16)
    return (_bits(rv), np.asarray(ri)), (_bits(pv.numpy()), pi.numpy())


CASES = [("float32", 50, 2), ("float32", 50, 4), ("float32", 50, 16),
         ("float32", 1, 4), ("float32", N, 16), ("bfloat16", 50, 4),
         ("int32", 7, 4)]


@pytest.mark.parametrize("row", range(len(KINDS)), ids=KINDS)
@pytest.mark.parametrize("dtype,k,fanout", CASES)
def test_merge_topk_batch_matches_reference(dtype, k, fanout, row):
    (rv, ri), (pv, pi) = _both(dtype, k, fanout)
    np.testing.assert_array_equal(pi[row], ri[row])
    np.testing.assert_array_equal(pv[row], rv[row])
    assert pi.dtype == np.int32 and pi.shape == (len(KINDS), k)


@pytest.mark.parametrize("dtype,k,fanout", CASES[:2] + CASES[5:])
def test_merge_topk_batch_matches_stable_argsort(dtype, k, fanout):
    """Independent of both packages: a stable descending argsort of the
    rows with -0.0 folded into +0.0 (equal values go to the lower index)."""
    x = _rows(dtype).astype(np.float64)
    want = np.argsort(-(x + 0.0), axis=1, kind="stable")[:, :k]
    _, (_, pi) = _both(dtype, k, fanout)
    np.testing.assert_array_equal(pi, want)


def test_rows_equal_single_row_merge_topk():
    x = _torch(_rows("float32"))
    bv, bi = topk.merge_topk_batch(x, 50, fanout=4)
    for r in range(x.shape[0]):
        v, i = topk.merge_topk(x[r], 50, fanout=4)
        assert torch.equal(i, bi[r])
        assert torch.equal(v.view(torch.int32), bv[r].view(torch.int32))


@pytest.mark.parametrize("n,k,block", [(151936, 50, 128), (1000, 50, 128),
                                       (1000, 200, 128), (7, 3, 128),
                                       (4096, 1, 64), (300, 300, 128)])
def test_candidate_blocks_match_reference(n, k, block):
    assert topk.candidate_blocks(n, k, block) == ref_topk.candidate_blocks(
        n, k, block)


@pytest.mark.parametrize("fanout", [0, 2, 3, 4, 16])
def test_tournament_rounds_match_reference(fanout):
    for nb in (0, 1, 2, 3, 5, 8, 17, 100, 1187, 4096):
        assert topk.tournament_rounds(nb, fanout) == \
            ref_topk.tournament_rounds(nb, fanout)
    assert topk.TOURNAMENT_FANOUT == ref_topk.TOURNAMENT_FANOUT


def test_qwen3_vocab_geometry():
    """The serving config's shapes: 1187 blocks of 128, six rounds."""
    assert topk.candidate_blocks(151936, 50) == (128, 1187)
    assert topk.tournament_rounds(1187, 4) == [1188, 300, 76, 20, 8, 2]


def test_fanout_below_two_raises():
    with pytest.raises(ValueError, match="fanout"):
        topk.merge_topk_batch(torch.zeros((1, 8)), 2, fanout=1)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_topk_ref_matches_reference(dtype):
    for row in _rows(dtype):
        rv, ri = ref_kref.topk_ref(jnp.asarray(row), 9)
        pv, pi = kref.topk_ref(torch.from_numpy(row), 9)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(_bits(pv.numpy()), _bits(rv))
