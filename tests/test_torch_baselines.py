"""The paper's baselines in the port (``repro_torch.core.baselines``)
against the JAX package's ``repro.core.baselines`` and numpy, on the CPU.

Cut vectors, segment sizes and merged outputs are integer results or
permutations of the inputs, so they must match bit for bit (floats
compared as their bit patterns, which tells ``-0.0`` from ``+0.0``).
Inputs come from seeded numpy generators: duplicate-heavy keys, ties
across the two inputs, mixed ``-0.0``/``+0.0``, uneven sizes.  The
reference's equidistant partition cannot take an empty side (its gather
of a splitter from a zero-length array raises), so those cases are held
against numpy alone.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import baselines as ref
from repro_torch.core import baselines

SIZES = [(1, 1), (7, 13), (64, 5), (33, 33), (100, 257)]
DTYPES = ["int32", "float32"]


def _inputs(m, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        a, b = rng.integers(0, 6, m), rng.integers(0, 6, n)
    else:  # few distinct values, zeros of both signs among them
        vals = np.array([-1.5, -0.0, 0.0, 0.0, 2.0, np.inf], np.float32)
        a, b = rng.choice(vals, m), rng.choice(vals, n)
    return (np.sort(a, kind="stable").astype(dtype),
            np.sort(b, kind="stable").astype(dtype))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _oracle_merge(a, b):
    both = np.concatenate([a, b])
    return both[np.argsort(both, kind="stable")]


def _oracle_sizes(a, b, p):
    """Segment sizes of the equidistant partition, from numpy's
    searchsorted: the splitters' output offsets, sorted."""
    m, n = len(a), len(b)
    ja = [min(m, -(-m // p) * r) for r in range(p + 1)]
    kb = [min(n, -(-n // p) * r) for r in range(p + 1)]
    off_a = [j + (n if j >= m else np.searchsorted(b, a[j], "left"))
             for j in ja[1:]]
    off_b = [k + (m if k >= n else np.searchsorted(a, b[k], "right"))
             for k in kb[1:]]
    return np.diff(np.sort([0] + off_a + off_b))


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n", SIZES)
def test_equidistant_matches_reference(m, n, dtype, p):
    a, b = _inputs(m, n, dtype, seed=m * 31 + n)
    rj, rk = ref.equidistant_partition(jnp.asarray(a), jnp.asarray(b), p)
    j, k = baselines.equidistant_partition(_t(a), _t(b), p)
    assert j.dtype == k.dtype == torch.int32 and j.shape == (2 * p + 1,)
    np.testing.assert_array_equal(j.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(k.numpy(), np.asarray(rk))
    sizes = baselines.partition_sizes_equidistant(_t(a), _t(b), p)
    np.testing.assert_array_equal(
        sizes.numpy(), np.asarray(ref.partition_sizes_equidistant(
            jnp.asarray(a), jnp.asarray(b), p)))
    np.testing.assert_array_equal(sizes.numpy(), _oracle_sizes(a, b, p))
    got = baselines.merge_equidistant(_t(a), _t(b), p).numpy()
    want = np.asarray(ref.merge_equidistant(jnp.asarray(a), jnp.asarray(b), p))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(_oracle_merge(a, b)))


@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("m,n", [(0, 9), (9, 0), (0, 0)])
def test_equidistant_empty_sides_match_numpy(m, n, p):
    a, b = _inputs(m, n, "float32", seed=p)
    j, k = baselines.equidistant_partition(_t(a), _t(b), p)
    assert j.shape == (2 * p + 1,)
    assert int(j[-1]) == m and int(k[-1]) == n
    sizes = baselines.partition_sizes_equidistant(_t(a), _t(b), p).numpy()
    np.testing.assert_array_equal(sizes, _oracle_sizes(a, b, p))
    got = baselines.merge_equidistant(_t(a), _t(b), p).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_oracle_merge(a, b)))


def test_equidistant_imbalance_reaches_factor_two():
    """The baseline's flaw, which the co-rank merge removes: with all of
    B below all of A, one segment takes a whole splitter interval of each
    input -- twice the ideal (m+n)/(2p) -- while another is empty."""
    p, m = 4, 64
    a = torch.arange(100, 100 + m, dtype=torch.int32)
    b = torch.arange(m, dtype=torch.int32)
    sizes = baselines.partition_sizes_equidistant(a, b, p)
    ideal = (2 * m) // (2 * p)
    assert int(sizes.sum()) == 2 * m
    assert int(sizes.max()) == 2 * ideal and int(sizes.min()) == 0


@pytest.mark.parametrize("dtype", DTYPES + ["bfloat16"])
@pytest.mark.parametrize("m,n", SIZES + [(0, 9), (9, 0), (0, 0)])
def test_merge_lexicographic_matches_reference(m, n, dtype):
    """Ties keep input order -- ``-0.0`` and ``+0.0`` are equal keys, as
    in the reference and numpy -- and the output holds the inputs' bits."""
    a, b = _inputs(m, n, "float32" if dtype == "bfloat16" else dtype,
                   seed=m + 7 * n)
    if dtype == "bfloat16":
        ra, rb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        got = baselines.merge_lexicographic(_t(a).bfloat16(), _t(b).bfloat16())
        want = ref.merge_lexicographic(ra, rb)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
        return
    got = baselines.merge_lexicographic(_t(a), _t(b)).numpy()
    want = np.asarray(ref.merge_lexicographic(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(_oracle_merge(a, b)))


def test_baselines_are_exported_from_core():
    from repro_torch import core

    for name in baselines.__all__:
        assert getattr(core, name) is getattr(baselines, name)
