"""Dropless expert-parallel MoE (``repro_torch.distributed.moe``) on 8 gloo
ranks on the CPU, float32 at smoke width, against the JAX package's
``dropless_moe_ffn`` under ``shard_map`` on 8 fake devices and against the
port's own single-process dropless layer.

The dispatch plan (sorted ids, assignment indices, group sizes, the
merge permutation, sidebands, planned counts, the grouped rows) must equal
the reference's bit for bit.  The output must equal the port's
single-process ``moe_apply(dispatch="dropless")`` routed part bit for bit
-- the same rows reach the same ``torch.mm`` in the same order -- and the
reference's within ``TOL`` times its largest magnitude: the reference's
``lax.ragged_dot`` sums in another order (its own dropless path differs
from its dense reference by up to 9.2e-5 on values near 300 under JAX
0.9, ROADMAP.md Queue 3).
"""

from __future__ import annotations

import numpy as np
import pytest

import _torch_spmd

P = 8
E, K, D, FF = 16, 4, 16, 32
T_LOC = 32  # tokens a rank
SEED = 20131303
TOL = 1e-5
ROUTINGS = ("uniform", "one-expert", "p-hot")
SMALL_CAP = T_LOC * K // 16  # under a p-hot segment (~16 rows)
PLAN = ("xg", "group_sizes", "perm", "valid", "recv_lengths", "planned",
        "send_lo", "send_lengths", "sorted_e", "sorted_idx")


def _inputs(p: int) -> dict:
    rng = np.random.default_rng(SEED)
    t = p * T_LOC
    inp = {
        "w_gate": rng.standard_normal((E, D, FF)).astype(np.float32),
        "w_up": rng.standard_normal((E, D, FF)).astype(np.float32),
        "w_down": rng.standard_normal((E, FF, D)).astype(np.float32),
        "xt": rng.standard_normal((t, D)).astype(np.float32),
        "w": rng.random((t, K)).astype(np.float32),
    }
    hot = np.arange(p) * (E // p)
    inp["uniform"] = rng.integers(0, E, (t, K)).astype(np.int32)
    inp["one-expert"] = np.full((t, K), 5, np.int32)
    inp["p-hot"] = hot[rng.integers(0, p, (t, K))].astype(np.int32)
    return inp


#: (routing, capacity) of every run: each routing at the default capacity,
#: and the skewed ones at a capacity that truncates.
RUNS = [(r, None) for r in ROUTINGS] + [(r, SMALL_CAP) for r in ROUTINGS[1:]]


def _key(routing, cap):
    return f"{routing}.{cap or 'default'}"


def _rank(r: int, p: int) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import dropless_moe_ffn

    inp = _inputs(p)
    g = dist.group.WORLD
    e_per = E // p

    def mine(name):
        a = inp[name]
        if name.startswith("w_"):
            return torch.from_numpy(a[r * e_per:(r + 1) * e_per])
        return torch.from_numpy(a.reshape(p, -1, *a.shape[1:])[r])

    res = {}
    weights = [mine(n) for n in ("w_gate", "w_up", "w_down")]
    for routing, cap in RUNS:
        out, plan = dropless_moe_ffn(mine("xt"), mine(routing), mine("w"),
                                     *weights, E, g, cap)
        res[f"{_key(routing, cap)}.out"] = out.numpy()
        for field in PLAN:
            res[f"{_key(routing, cap)}.{field}"] = getattr(plan, field).numpy()
    again, _ = dropless_moe_ffn(mine("xt"), mine("uniform"), mine("w"),
                                *weights, E, g)
    res["again"] = again.numpy()
    return res


def _reference(p: int) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as Ps

    from repro.core.compat import shard_map
    from repro.distributed import dropless_moe_ffn

    mesh = Mesh(np.array(jax.devices()), ("x",))
    inp = _inputs(p)
    res = {}
    for routing, cap in RUNS:
        def fn(xt, e, w, wg, wu, wd, cap=cap):
            out, plan = dropless_moe_ffn(xt, e, w, wg, wu, wd, E, "x", cap)
            return out, jax.tree.map(lambda y: y[None], plan)

        f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(Ps("x"),) * 6,
                              out_specs=Ps("x")))
        out, plan = f(*map(jnp.asarray, (inp["xt"], inp[routing], inp["w"],
                                         inp["w_gate"], inp["w_up"],
                                         inp["w_down"])))
        res[f"{_key(routing, cap)}.out"] = np.asarray(out).reshape(p, T_LOC, D)
        for field in PLAN:
            res[f"{_key(routing, cap)}.{field}"] = np.asarray(
                getattr(plan, field))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref, ranks = _torch_spmd.run("test_torch_moe_ep.py", P,
                                 tmp_path_factory.mktemp("spmd"))
    return _inputs(P), ref, ranks


def _stacked(ranks, key):
    return np.stack([res[key] for res in ranks])


@pytest.mark.parametrize("routing,cap", RUNS)
def test_plan_matches_reference(runs, routing, cap):
    _, ref, ranks = runs
    for field in PLAN:
        key = f"{_key(routing, cap)}.{field}"
        _torch_spmd.assert_bits(_stacked(ranks, key), ref[key], key)


@pytest.mark.parametrize("routing,cap", RUNS)
def test_output_matches_single_process_and_reference(runs, routing, cap):
    """Bit for bit against the port's single-process dropless layer (at
    the default capacity, where nothing drops), within ``TOL`` of the
    reference's scale against the reference."""
    import torch

    from repro_torch.models.moe import _dropless_moe

    inp, ref, ranks = runs
    key = f"{_key(routing, cap)}.out"
    got = _stacked(ranks, key)
    want = ref[key]
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err
    if cap is None:
        t = torch.from_numpy
        params = {n: t(inp[n]) for n in ("w_gate", "w_up", "w_down")}
        single = _dropless_moe(params, t(inp["xt"]), t(inp["w"]),
                               t(inp[routing]), E, K)
        _torch_spmd.assert_bits(got.reshape(-1, D), single.numpy(), routing)


@pytest.mark.parametrize("routing,cap", RUNS)
def test_drop_accounting(runs, routing, cap):
    """Zero overflow at the default capacity; at a small one, what arrives
    is the planned count clipped to the capacity, and the overflow is
    exactly planned minus received.  The group sizes sum to what
    arrived."""
    _, _, ranks = runs
    k = _key(routing, cap)
    planned = _stacked(ranks, f"{k}.planned")
    recv = _stacked(ranks, f"{k}.recv_lengths")
    sizes = _stacked(ranks, f"{k}.group_sizes")
    np.testing.assert_array_equal(sizes.sum(axis=1), recv.sum(axis=1))
    if cap is None:
        np.testing.assert_array_equal(recv, planned)
        assert sizes.sum() == P * T_LOC * K
    else:
        np.testing.assert_array_equal(recv, np.minimum(planned, cap))
        assert (planned - recv).sum() > 0


def test_two_runs_agree(runs):
    _, _, ranks = runs
    for res in ranks:
        _torch_spmd.assert_bits(res["again"], res["uniform.default.out"])


if __name__ == "__main__":
    _torch_spmd.main(_rank, _reference)
