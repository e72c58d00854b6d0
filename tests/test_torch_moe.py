"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` and numpy oracles, on the CPU.

Inputs come from seeded numpy generators; weights from the reference's
``init_moe``, carried over through numpy.  Integer results -- the experts
each token picks, every dispatch plan, the kept set -- must match bit for
bit, the reference (jitted) and a numpy stable argsort alike.  Float32
results are held within ``TOL`` times the largest magnitude of the
reference's result (the frameworks sum in other orders; the reference's
own dropless path differs from its dense reference by up to 2.4e-7 under
JAX 0.9, ROADMAP.md Queue 3).  Routing weights are held within 1e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.models import moe as ref_moe
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy

D, FF, E, K = 16, 32, 8, 2
TOL = 1e-5
ROUTINGS = ["random", "one_hot_skew", "all_equal"]


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max error {err} > {tol} x {scale}"


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _params(n_shared: int):
    p, _ = ref_moe.init_moe(jax.random.key(0), D, FF, E, n_shared=n_shared)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    return p


def _both(n_shared=0, router=None):
    p = dict(_params(n_shared))
    if router is not None:
        p["router"] = router
    ref = jax.tree.map(jnp.asarray, p)
    return ref, params_from_numpy(p, "cpu")


def _one_hot_router():
    """The reference tests' adversarial router: every token's logits tie
    at 0 except expert 3's."""
    r = np.zeros((D, E), np.float32)
    r[:, 3] = 10.0
    return r


def _x(shape=(2, 16, D), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _experts(routing: str, t: int, k: int, n_experts: int, seed=1):
    rng = np.random.default_rng(seed)
    if routing == "random":
        e = rng.integers(0, n_experts, (t, k))
    elif routing == "one_hot_skew":  # every token picks expert 3 first
        e = rng.integers(0, n_experts, (t, k))
        e[:, 0] = 3
    else:
        e = np.full((t, k), n_experts - 1)
    return e.astype(np.int32)


# --- routing ------------------------------------------------------------------------


@pytest.mark.parametrize("router", ["random", "one_hot"])
@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_route_topk_matches_reference(scoring, router):
    """Expert ids bit for bit (ties to the lower expert, as
    ``jax.lax.top_k``), weights within 1e-5; also against a numpy stable
    argsort of the port's own scores."""
    x = _x((32, D)).reshape(32, D)
    if router == "one_hot":
        logits = x @ _one_hot_router()
    else:
        logits = x @ np.random.default_rng(2).standard_normal((D, E)).astype(
            np.float32)
    f = jax.jit(functools.partial(ref_moe.route_topk, k=3, scoring=scoring))
    rw, re = f(jnp.asarray(logits))
    w, e = moe.route_topk(torch.from_numpy(logits), 3, scoring=scoring)
    assert e.dtype == torch.int32 and w.dtype == torch.float32
    _eq(e, re)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-5, rtol=0)
    t = torch.from_numpy(logits)
    scores = torch.sigmoid(t) if scoring == "sigmoid" else torch.softmax(t, -1)
    _eq(e, np.argsort(-scores.numpy(), axis=1, kind="stable")[:, :3])
    if router == "one_hot":  # the tied experts are the lowest ids
        assert set(np.unique(e.numpy())) <= {0, 1, 2, 3}


# --- dispatch plans -----------------------------------------------------------------


def _numpy_plan(experts, capacity):
    t, k = experts.shape
    flat = experts.reshape(-1)
    order = np.argsort(flat, kind="stable").astype(np.int32)
    sorted_e = flat[order]
    first = np.searchsorted(sorted_e, sorted_e, side="left")
    slot_pos = np.arange(t * k, dtype=np.int32) - first.astype(np.int32)
    return sorted_e, order // k, order % k, slot_pos, slot_pos < capacity


@pytest.mark.parametrize("capacity", [3, 1000])
@pytest.mark.parametrize("routing", ROUTINGS)
def test_moe_dispatch_matches_reference_and_numpy(routing, capacity):
    experts = _experts(routing, 50, K, E)
    f = jax.jit(functools.partial(ref_moe.moe_dispatch, n_experts=E,
                                  capacity=capacity))
    want = f(jnp.asarray(experts))
    got = moe.moe_dispatch(torch.from_numpy(experts), E, capacity)
    oracle = _numpy_plan(experts, capacity)
    assert len(got) == len(want) == 5
    for g, w, o in zip(got, want, oracle):
        _eq(g, w)
        _eq(g, o)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("t,k,n_experts", [(50, 2, 8), (37, 8, 256)])
def test_moe_dispatch_dropless_matches_reference_and_numpy(routing, t, k,
                                                           n_experts):
    experts = _experts(routing, t, k, n_experts)
    f = jax.jit(functools.partial(ref_moe.moe_dispatch_dropless,
                                  n_experts=n_experts))
    rs_e, rs_idx, rgs = f(jnp.asarray(experts))
    s_e, s_idx, gs = moe.moe_dispatch_dropless(torch.from_numpy(experts),
                                               n_experts)
    for g, w in ((s_e, rs_e), (s_idx, rs_idx), (gs, rgs)):
        assert g.dtype == torch.int32
        _eq(g, w)
    order = np.argsort(experts.reshape(-1), kind="stable")
    _eq(s_idx, order)
    _eq(gs, np.bincount(experts.reshape(-1), minlength=n_experts))
    assert int(gs.sum()) == t * k


def test_capacity_drops_latest_first():
    """Every token picks expert 3 first: expert 3 keeps its ``capacity``
    earliest assignments and drops the rest, the same set as the
    reference's ``keep``."""
    experts = _experts("one_hot_skew", 40, K, E)
    capacity = 5
    want = jax.jit(functools.partial(ref_moe.moe_dispatch, n_experts=E,
                                     capacity=capacity))(jnp.asarray(experts))
    s_e, token, choice, _, keep = moe.moe_dispatch(torch.from_numpy(experts),
                                                   E, capacity)
    _eq(keep, want[4])
    kept3 = token[(s_e == 3) & keep].tolist()
    dropped3 = token[(s_e == 3) & ~keep].tolist()
    assert len(kept3) == capacity and kept3 == sorted(kept3)
    assert max(kept3) < min(dropped3)  # the latest assignments go
    assert bool((choice[(s_e == 3) & (token < capacity)] == 0).all())


# --- grouped GEMM -------------------------------------------------------------------


@pytest.mark.parametrize("gs", [[3, 0, 5, 4, 0, 2, 1, 1], [0, 0, 7, 0, 0, 0, 0, 6]])
def test_grouped_gemm_matches_reference_and_loop(gs):
    """Empty groups (leading, inner, trailing) and padding rows past
    ``sum(gs)``, which give zeros."""
    rng = np.random.default_rng(2)
    m = sum(gs)
    x = rng.standard_normal((m + 4, D)).astype(np.float32)
    w = rng.standard_normal((E, D, FF)).astype(np.float32)
    want = jax.jit(ref_moe.grouped_gemm)(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(gs, jnp.int32))
    got = moe.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.tensor(gs, dtype=torch.int32))
    _close(got, want)
    off = 0
    for e, n in enumerate(gs):
        if n:
            _close(got[off:off + n], x[off:off + n] @ w[e])
        off += n
    assert bool((got[m:] == 0).all())


# --- the layer ----------------------------------------------------------------------


@pytest.mark.parametrize("router", ["random", "one_hot"])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("dispatch,cf", [("dropless", 1.25), ("capacity", 1.25),
                                         ("capacity", E / K)])
def test_moe_apply_matches_reference(dispatch, cf, n_shared, router):
    """Dropless and capacity (1.25 drops assignments, E/k drops none),
    with and without a shared expert, softmax routing; the one-hot router
    routes through ties."""
    ref_p, p = _both(n_shared, _one_hot_router() if router == "one_hot" else None)
    x = _x()
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf, dispatch=dispatch)
    want = jax.jit(functools.partial(ref_moe.moe_apply, **kw))(ref_p,
                                                               jnp.asarray(x))
    got = moe.moe_apply(p, torch.from_numpy(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_dense_reference_and_dropless_agree_with_reference(scoring):
    """The port's dense all-experts reference against the JAX package's,
    and the port's dropless layer against both (sigmoid routing with a
    shared expert, as deepseek-v3)."""
    ref_p, p = _both(1)
    x = _x(seed=3)
    kw = dict(n_experts=E, top_k=K, scoring=scoring)
    want = jax.jit(functools.partial(ref_moe.moe_dense_reference, **kw))(
        ref_p, jnp.asarray(x))
    dense = moe.moe_dense_reference(p, torch.from_numpy(x), **kw)
    _close(dense, want)
    drop = moe.moe_apply(p, torch.from_numpy(x), capacity_factor=1.0,
                         dispatch="dropless", **kw)
    _close(drop, want)
    _close(drop, dense.numpy())


@pytest.mark.parametrize("router", ["random", "one_hot"])
@pytest.mark.parametrize("groups", [2, 4])
def test_moe_apply_dispatch_groups_matches_reference(groups, router):
    """GShard-style local dispatch: per-group capacity slots (factor 1.25
    drops assignments within each group), the slot transpose and back,
    against the reference's ``moe_apply`` with the same arguments on one
    JAX device."""
    ref_p, p = _both(0, _one_hot_router() if router == "one_hot" else None)
    x = _x(seed=5)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25,
              dispatch="capacity", dispatch_groups=groups)
    want = jax.jit(functools.partial(ref_moe.moe_apply, **kw))(ref_p,
                                                               jnp.asarray(x))
    got = moe.moe_apply(p, torch.from_numpy(x), **kw)
    assert got.shape == x.shape
    _close(got, want)
    one = moe.moe_apply(p, torch.from_numpy(x),
                        **{**kw, "dispatch_groups": 1})
    assert not torch.equal(got, one)  # per-group capacity drops differ


def test_capacity_without_drops_matches_dropless():
    _, p = _both(0)
    x = torch.from_numpy(_x(seed=4))
    kw = dict(n_experts=E, top_k=K)
    drop = moe.moe_apply(p, x, capacity_factor=1.0, dispatch="dropless", **kw)
    cap = moe.moe_apply(p, x, capacity_factor=E / K, dispatch="capacity", **kw)
    _close(cap, drop.numpy())


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, E)).astype(np.float32)
    experts = _experts("random", 40, K, E)
    want = ref_moe.load_balance_loss(jnp.asarray(logits), jnp.asarray(experts), E)
    got = moe.load_balance_loss(torch.from_numpy(logits),
                                torch.from_numpy(experts), E)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_moe_tree_matches_reference():
    ref, _ = ref_moe.init_moe(jax.random.key(0), D, FF, E, n_shared=1,
                              shared_ff=48)
    got = moe.init_moe(torch.Generator().manual_seed(0), D, FF, E, n_shared=1,
                       shared_ff=48, device="cpu", layers=(3,),
                       dtype=torch.bfloat16)
    want = jax.tree.map(lambda a: (3, *a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(got))


def test_unported_options_raise():
    _, p = _both(0)
    x = torch.from_numpy(_x())
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_apply(p, x, dispatch="bogus", **kw)
    # the dispatch sort is the co-rank merge sort: a config asking for
    # another is refused before any weight is drawn
    cfg = dataclasses.replace(smoke_config(ARCHS["dbrx-132b"]),
                              use_merge_sort_dispatch=False)
    with pytest.raises(ValueError, match="merge sort"):
        tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    # dropless ignores dispatch_groups, as in the reference
    moe.moe_apply(p, x, dispatch_groups=2, dispatch="dropless", **kw)
