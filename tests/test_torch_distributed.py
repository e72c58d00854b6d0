"""The port's distributed layer (``repro_torch.distributed``) on 8 gloo
ranks on the CPU, against the JAX package's ``repro.distributed`` under
``shard_map`` on 8 fake devices and against numpy.

One module-scoped fixture starts the 8 ranks and the reference's process
once (``_torch_spmd.run``); every rank and the reference compute every case
on the same seeded numpy inputs (:func:`_inputs`) and write their results,
and one parametrised test per case compares them.  Cut vectors, segments,
sidebands, keys and permutations must match bit for bit.

Where the reference's ``shard_map`` path fails under JAX 0.9 -- the
allgather strategy of the k-way sort, whose ``co_rank_kway_batch`` on
replicated runs trips the varying-manual-axes check of its loop carry
(ROADMAP.md, Queue 3) -- the port is held against the reference's
single-device oracle instead: ``co_rank_kway_batch`` and ``window`` plus
``merge_kway_ranked``, jitted outside ``shard_map``, which is also how
the truncation at a small ``capacity`` is checked.  ``compressed_psum``
draws its random bits from a ``torch.Generator``, so it is held to the
reference's quantisation bound, not its bits.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import _torch_spmd

P = 8
W = 256  # keys a rank in the sort cases
SEED = 20131303
IMAX = np.iinfo(np.int32).max
E_SEG = 12  # segments of the segment-cut case


def _inputs(p: int) -> dict:
    """Every case's inputs, from one seeded generator."""
    rng = np.random.default_rng(SEED)
    inp = {}
    # pairwise: duplicate-heavy int32 with real dtype-max keys (they meet
    # the windows' sentinel tails), shards of 24 and 40
    for name, w in (("a", 24), ("b", 40)):
        x = rng.integers(0, 30, p * w)
        x[rng.random(p * w) < 0.1] = IMAX
        inp[name] = np.sort(x).astype(np.int32)
    s = (inp["a"].size + inp["b"].size) // p
    inp["corank_i"] = np.array([[r * s, r * s + s // 3 + r] for r in range(p)],
                               np.int32)
    # k-way runs: uniform width and ragged (dtype-max padding)
    inp["runs"] = np.sort(rng.integers(-3, 4, (p, 64)), axis=1).astype(np.int32)
    inp["kway_i"] = np.array([[r * 64, r * 64 + 5 + 3 * r, (r + 1) * 64]
                              for r in range(p)], np.int32)
    lens = rng.integers(1, 49, p).astype(np.int32)
    ragged = np.full((p, 48), IMAX, np.int32)
    for d in range(p):
        ragged[d, : lens[d]] = np.sort(rng.integers(0, 20, lens[d]))
    total, step = int(lens.sum()), int(lens.sum()) // p
    inp["ragged"], inp["ragged_len"] = ragged, lens
    inp["ragged_i"] = np.array([[min(r * step, total), min((r + 1) * step, total)]
                                for r in range(p)], np.int32)
    # segment cuts: sorted ids in [0, E_SEG), skewed, ragged
    seg_len = rng.integers(20, 41, p).astype(np.int32)
    seg = np.full((p, 40), IMAX, np.int32)
    for d in range(p):
        ids = np.minimum(rng.geometric(0.3, seg_len[d]) - 1, E_SEG - 1)
        seg[d, : seg_len[d]] = np.sort(ids)
    inp["seg"], inp["seg_len"] = seg, seg_len
    # sorts: duplicate-heavy int32 with dtype-max keys; float32 with +-inf,
    # +-0.0 and float32 max; an already sorted array (the adversarial
    # exchange: one peer pair carries a whole block)
    n = p * W
    x = rng.integers(-6, 6, n)
    x[rng.random(n) < 0.2] = IMAX
    inp["sort_int32"] = x.astype(np.int32)
    f = rng.standard_normal(n).astype(np.float32)
    u = rng.random(n)
    for lo, v in ((0.0, np.inf), (0.03, -np.inf), (0.06, 0.0), (0.09, -0.0),
                  (0.12, np.finfo(np.float32).max)):
        f[(u >= lo) & (u < lo + 0.03)] = v
    inp["sort_float32"] = f
    inp["sort_sorted"] = np.sort(rng.integers(0, 50, n)).astype(np.int32)
    # host wrapper: uneven sizes, half the keys dtype max
    for size in (7, 777, 1001):
        y = rng.integers(-9, 9, size)
        y[rng.random(size) < 0.5] = IMAX
        inp[f"host_{size}"] = y.astype(np.int32)
    # compressed_psum: per-rank gradients of different magnitudes
    inp["grad"] = (rng.standard_normal((p, 3000))
                   * (1.0 + np.arange(p))[:, None]).astype(np.float32)
    return inp


#: (case, capacity) of the truncation checks: the adversarial sorted input
#: at half a block, and shuffled keys at under a segment's expected size.
TRUNCATIONS = (("sort_sorted", W // 2), ("sort_int32", W // P // 2))
PSUM_SEEDS = 16


# ---------------------------------------------------------------------------
# the port: one rank
# ---------------------------------------------------------------------------


def _rank(r: int, p: int) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch import distributed as D
    from repro_torch import obs
    from repro_torch.core.mergesort import merge_sort, sort_key_val
    from repro_torch.distributed.api import ragged_merge
    from repro_torch.train.compress import compressed_psum

    g = dist.group.WORLD
    inp = _inputs(p)
    res = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def shard(a):
        return t(a.reshape(p, -1)[r])

    j, k = D.distributed_co_rank(t(inp["corank_i"][r]), shard(inp["a"]),
                                 shard(inp["b"]), g)
    res["co_rank"] = torch.stack([j, k]).numpy()
    res["co_rank_kway"] = D.distributed_co_rank_kway(
        t(inp["kway_i"][r]), t(inp["runs"][r]), g).numpy()
    res["co_rank_kway_ragged"] = D.distributed_co_rank_kway(
        t(inp["ragged_i"][r]), t(inp["ragged"][r]), g,
        length=int(inp["ragged_len"][r])).numpy()
    res["segment_cuts"] = D.distributed_segment_cuts(
        t(inp["seg"][r]), E_SEG, g, length=int(inp["seg_len"][r])).numpy()

    for name in ("sort_int32", "sort_float32", "sort_sorted"):
        x = shard(inp[name])
        bounds = torch.tensor([r * W, (r + 1) * W], dtype=torch.int32)
        run = merge_sort(x)
        cuts = D.distributed_co_rank_kway(bounds, run, g)
        seg, lengths = D.exchange_block(run, cuts, g)
        res[f"{name}.cuts"] = cuts.numpy()
        res[f"{name}.segments"] = seg.numpy()
        res[f"{name}.lengths"] = lengths.numpy()
        # the permutation rides a second exchange as a payload
        gidx = r * W + torch.arange(W, dtype=torch.int32)
        keys, idx = sort_key_val(x, gidx)
        seg_k, lens = D.exchange_block(keys, cuts, g)
        seg_i, _ = D.exchange_block(idx, cuts, g)
        out_k, out_i = ragged_merge(seg_k, lens, W, vals=seg_i)
        res[f"{name}.argsort"] = torch.stack([out_k.view(torch.int32),
                                              out_i]).numpy()
        for strategy in ("exchange", "allgather"):
            res[f"{name}.{strategy}"] = D.sharded_sort(
                x, g, strategy=strategy).numpy()

    for name, cap in TRUNCATIONS:
        run = merge_sort(shard(inp[name]))
        bounds = torch.tensor([r * W, (r + 1) * W], dtype=torch.int32)
        cuts = D.distributed_co_rank_kway(bounds, run, g)
        _, lengths = D.exchange_block(run, cuts, g, capacity=cap)
        res[f"trunc.{name}"] = D.sharded_merge_kway(run, g, capacity=cap).numpy()
        res[f"trunc.{name}.lengths"] = lengths.numpy()
        res[f"trunc.{name}.planned"] = (cuts[1] - cuts[0]).numpy()

    for strategy in ("allgather", "corank"):
        res[f"merge.{strategy}"] = D.distributed_merge(
            shard(inp["a"]), shard(inp["b"]), g, strategy=strategy).numpy()

    for key in [k for k in inp if k.startswith("host_")]:
        res[key] = D.sharded_sort_host(t(inp[key]), "exchange",
                                       device="cpu").numpy()
    res["host_777.allgather"] = D.sharded_sort_host(
        t(inp["host_777"]), "allgather", device="cpu").numpy()

    # every collective of a float32 sort, by strategy: (op, is float32,
    # elements delivered here)
    ops = ("all_gather", "psum", "pmax", "all_to_all", "ragged_all_to_all")
    for strategy in ("exchange", "allgather"):
        with obs.capture() as records:
            D.sharded_sort(shard(inp["sort_float32"]), g, strategy=strategy)
        res[f"bytes.{strategy}"] = np.array(
            [[ops.index(rec["labels"]["op"]),
              rec["labels"]["dtype"] == "float32",
              rec["labels"]["elements"]]
             for rec in records if rec["metric"] == "collectives.bytes"],
            np.int64)

    res["psum"] = np.stack([
        compressed_psum(t(inp["grad"][r]), g,
                        torch.Generator().manual_seed(1000 + s * p + r)).numpy()
        for s in range(PSUM_SEEDS)])
    return res


# ---------------------------------------------------------------------------
# the reference: shard_map on p fake devices, and its single-device oracles
# ---------------------------------------------------------------------------


def _reference(p: int) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as Ps

    from repro.core.compat import shard_map
    from repro.core.kway import co_rank_kway_batch, merge_kway_ranked
    from repro.core.mergesort import merge_sort, sort_key_val
    from repro.distributed import (
        distributed_co_rank,
        distributed_co_rank_kway,
        distributed_merge,
        distributed_segment_cuts,
        exchange_block,
        sharded_sort,
        window,
    )
    from repro.train.compress import compressed_psum

    mesh = Mesh(np.array(jax.devices()), ("x",))
    inp = _inputs(p)
    res = {}

    def smap(fn, *args):
        """``fn`` on every device's shards (leading axis split ``p`` ways);
        its outputs stacked ``(p, ...)``."""
        f = shard_map(lambda *a: jax.tree.map(lambda y: y[None], fn(*a)),
                      mesh=mesh, in_specs=(Ps("x"),) * len(args),
                      out_specs=Ps("x"))
        return jax.tree.map(np.asarray, jax.jit(f)(*map(jnp.asarray, args)))

    res["co_rank"] = np.stack(smap(
        lambda a, b, i: distributed_co_rank(i[0], a, b, "x"),
        inp["a"], inp["b"], inp["corank_i"]), axis=1)
    res["co_rank_kway"] = smap(
        lambda runs, i: distributed_co_rank_kway(i[0], runs[0], "x"),
        inp["runs"], inp["kway_i"])
    res["co_rank_kway_ragged"] = smap(
        lambda runs, i, n: distributed_co_rank_kway(i[0], runs[0], "x",
                                                    length=n[0]),
        inp["ragged"], inp["ragged_i"], inp["ragged_len"])
    res["segment_cuts"] = smap(
        lambda ids, n: distributed_segment_cuts(ids[0], E_SEG, "x",
                                                length=n[0]),
        inp["seg"], inp["seg_len"])

    def exchange(x):
        r = jax.lax.axis_index("x")
        run = merge_sort(x)
        bounds = jnp.stack([r * W, (r + 1) * W]).astype(jnp.int32)
        cuts = distributed_co_rank_kway(bounds, run, "x")
        seg, lengths = exchange_block(run, cuts, "x")
        gidx = r * W + jnp.arange(W, dtype=jnp.int32)
        keys, idx = sort_key_val(x, gidx)
        seg_k, lens = exchange_block(keys, cuts, "x")
        seg_i, _ = exchange_block(idx, cuts, "x")
        out_k, out_i = merge_kway_ranked(seg_k, vals=seg_i, lengths=lens,
                                         out_len=W)
        argsort = jnp.stack([jax.lax.bitcast_convert_type(out_k, jnp.int32),
                             out_i])
        return cuts, seg, lengths, argsort, sharded_sort(x, "x")

    @functools.partial(jax.jit, static_argnums=1)
    def single_device(runs, cap):
        """The allgather path's (and the truncation's) single-device
        oracle: cut every block, window the runs, merge each block."""
        cuts = co_rank_kway_batch(jnp.arange(p + 1, dtype=jnp.int32) * W, runs)
        lo, hi = cuts[:-1], cuts[1:]
        lengths = jnp.minimum(hi - lo, cap)
        win = jax.vmap(jax.vmap(lambda row, a, b: window(row, a, b, cap),
                                in_axes=(0, 0, 0)), in_axes=(None, 0, 0))(
            runs, lo, lo + lengths)
        return jax.vmap(lambda w_, n_: merge_kway_ranked(
            w_, lengths=n_, out_len=W))(win, lengths), lengths

    for name in ("sort_int32", "sort_float32", "sort_sorted"):
        cuts, seg, lengths, argsort, out = smap(exchange, inp[name])
        res[f"{name}.cuts"], res[f"{name}.segments"] = cuts, seg
        res[f"{name}.lengths"], res[f"{name}.argsort"] = lengths, argsort
        res[f"{name}.exchange"] = out
        runs = np.sort(inp[name].reshape(p, W), axis=1, kind="stable")
        res[f"{name}.allgather"] = np.asarray(
            single_device(jnp.asarray(runs), W)[0])
    for name, cap in TRUNCATIONS:
        runs = np.sort(inp[name].reshape(p, W), axis=1, kind="stable")
        out, lengths = single_device(jnp.asarray(runs), cap)
        res[f"trunc.{name}"], res[f"trunc.{name}.lengths"] = (
            np.asarray(out), np.asarray(lengths))

    for strategy in ("allgather", "corank"):
        res[f"merge.{strategy}"] = smap(
            lambda a, b, s=strategy: distributed_merge(a, b, "x", strategy=s),
            inp["a"], inp["b"])

    key = jax.random.key(SEED)
    res["psum"] = smap(
        lambda x: compressed_psum(
            x[0], "x", jax.random.fold_in(key, jax.lax.axis_index("x"))),
        inp["grad"])[0]
    return res


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref, ranks = _torch_spmd.run("test_torch_distributed.py", P,
                                 tmp_path_factory.mktemp("spmd"))
    return _inputs(P), ref, ranks


def _stacked(ranks, key):
    return np.stack([res[key] for res in ranks])


def _merge_order(runs_rows):
    """(run id, value) of every element of the stable merge of the given
    rows, in merged order (numpy's stable sort of the concatenation)."""
    ids = np.concatenate([np.full(len(x), q) for q, x in enumerate(runs_rows)])
    vals = np.concatenate(runs_rows)
    order = np.argsort(vals, kind="stable")
    return ids[order], vals[order]


def _cut_vector(runs_rows, i):
    ids, _ = _merge_order(runs_rows)
    return np.bincount(ids[:i], minlength=len(runs_rows))


SPLITTERS = ["co_rank", "co_rank_kway", "co_rank_kway_ragged", "segment_cuts"]


@pytest.mark.parametrize("case", SPLITTERS)
def test_splitters_match_reference_and_numpy(runs, case):
    inp, ref, ranks = runs
    got = _stacked(ranks, case)
    _torch_spmd.assert_bits(got, ref[case], case)
    for r in range(P):
        if case == "co_rank":
            m = inp["a"].size
            ids, _ = _merge_order([inp["a"], inp["b"]])
            for c, i in enumerate(inp["corank_i"][r]):
                j = int((ids[:i] == 0).sum())
                assert (got[r, 0, c], got[r, 1, c]) == (j, i - j) and j <= m
        elif case == "segment_cuts":
            rows = [inp["seg"][d, : inp["seg_len"][d]] for d in range(P)]
            want = np.array([[(row < s).sum() for s in range(E_SEG + 1)]
                             for row in rows])
            np.testing.assert_array_equal(got[r], want)
        else:
            ragged = case.endswith("ragged")
            src, ii = (("ragged", "ragged_i") if ragged else ("runs", "kway_i"))
            rows = [inp[src][d, : inp["ragged_len"][d]] if ragged
                    else inp[src][d] for d in range(P)]
            for b, i in enumerate(inp[ii][r]):
                np.testing.assert_array_equal(got[r, b], _cut_vector(rows, i))


SORTS = ["sort_int32", "sort_float32", "sort_sorted"]


@pytest.mark.parametrize("name", SORTS)
def test_exchange_block_segments_and_sideband(runs, name):
    """Segments, sideband and cuts bit for bit against the reference; the
    sideband equals the receiver's own cut differences; every block is
    exactly W elements (perfect balance)."""
    _, ref, ranks = runs
    for part in ("cuts", "segments", "lengths"):
        _torch_spmd.assert_bits(_stacked(ranks, f"{name}.{part}"),
                                ref[f"{name}.{part}"], f"{name}.{part}")
    for res in ranks:
        cuts, lengths = res[f"{name}.cuts"], res[f"{name}.lengths"]
        np.testing.assert_array_equal(lengths, cuts[1] - cuts[0])
        assert lengths.sum() == W


@pytest.mark.parametrize("strategy", ["exchange", "allgather", "argsort"])
@pytest.mark.parametrize("name", SORTS)
def test_sharded_sort_matches_reference_and_numpy(runs, name, strategy):
    """Keys (and, for ``argsort``, the permutation carried through the
    exchange) bit for bit against the reference -- under ``shard_map``
    for the exchange, its single-device oracle for the allgather path --
    and numpy's stable sort of the concatenation."""
    inp, ref, ranks = runs
    got = _stacked(ranks, f"{name}.{strategy}")
    _torch_spmd.assert_bits(got, ref[f"{name}.{strategy}"], name)
    x = inp[name]
    want = np.sort(x, kind="stable")
    if strategy == "argsort":
        _torch_spmd.assert_bits(got[:, 0].reshape(-1).view(x.dtype), want)
        np.testing.assert_array_equal(got[:, 1].reshape(-1),
                                      np.argsort(x, kind="stable"))
    else:
        _torch_spmd.assert_bits(got.reshape(-1), want)


@pytest.mark.parametrize("name,cap", TRUNCATIONS)
def test_small_capacity_truncates_with_exact_accounting(runs, name, cap):
    """Segments longer than the capacity lose their tails, the block's
    tail is zero-filled, and planned minus received is the drop count."""
    inp, ref, ranks = runs
    got = _stacked(ranks, f"trunc.{name}")
    _torch_spmd.assert_bits(got, ref[f"trunc.{name}"])
    recv = _stacked(ranks, f"trunc.{name}.lengths")
    planned = _stacked(ranks, f"trunc.{name}.planned")
    np.testing.assert_array_equal(recv, ref[f"trunc.{name}.lengths"])
    np.testing.assert_array_equal(recv, np.minimum(planned, cap))
    assert (planned - recv).sum() > 0  # the case does drop
    runs_ = np.sort(inp[name].reshape(P, W), axis=1, kind="stable")
    bounds = [_cut_vector(list(runs_), d * W) for d in range(P + 1)]
    for d in range(P):
        kept = [runs_[q, bounds[d][q]: bounds[d][q] + recv[d, q]]
                for q in range(P)]
        want = np.zeros(W, np.int32)
        merged = _merge_order(kept)[1]
        want[: merged.size] = merged
        np.testing.assert_array_equal(got[d], want)
        assert merged.size == W - (planned[d] - recv[d]).sum()


@pytest.mark.parametrize("strategy", ["allgather", "corank"])
def test_distributed_merge_matches_reference_and_numpy(runs, strategy):
    inp, ref, ranks = runs
    got = _stacked(ranks, f"merge.{strategy}")
    _torch_spmd.assert_bits(got, ref[f"merge.{strategy}"], strategy)
    want = np.sort(np.concatenate([inp["a"], inp["b"]]), kind="stable")
    np.testing.assert_array_equal(got.reshape(-1), want)


@pytest.mark.parametrize("key", ["host_7", "host_777", "host_1001",
                                 "host_777.allgather"])
def test_sharded_sort_host_uneven_sizes(runs, key):
    """Every rank gets the whole sorted input back; real dtype-max keys
    survive beside the padding sentinel."""
    inp, _, ranks = runs
    want = np.sort(inp[key.split(".")[0]], kind="stable")
    for res in ranks:
        np.testing.assert_array_equal(res[key], want)


def test_exchange_moves_no_run_values_through_all_gather(runs):
    """The byte check (the reference checks its HLO): on the exchange
    path every ``all_gather`` carries int32 metadata of at most ``2 p^2``
    elements, run values travel only through the ragged ``all_to_all``,
    exactly one block (W) of them a rank; the allgather strategy gathers
    all N keys (positive control)."""
    _, _, ranks = runs
    gather, ragged = 0, 4
    for res in ranks:
        ex = res["bytes.exchange"]
        ag = ex[ex[:, 0] == gather]
        assert len(ag) and not ag[:, 1].any() and ag[:, 2].max() <= 2 * P * P
        values = ex[(ex[:, 1] == 1) & (ex[:, 0] != 1)]  # psum: probe answers
        assert (values[:, 0] == ragged).all() and values[:, 2].sum() == W
        al = res["bytes.allgather"]
        assert ((al[:, 0] == gather) & (al[:, 1] == 1)
                & (al[:, 2] == P * W)).any()


def test_compressed_psum_within_quantisation_bound(runs):
    """Every seed's sum within the bound of the int8 payload (each rank's
    stochastic rounding, under one step of its block scale, plus the
    requantisation to the shared scale, half a step of it), the mean error
    over seeds near 0, every rank equal, and the reference's
    ``compressed_psum`` under ``shard_map`` within the same bound."""
    inp, ref, ranks = runs
    x = inp["grad"]
    exact = x.astype(np.float64).sum(axis=0)
    blocks = np.pad(np.abs(x), ((0, 0), (0, -x.shape[1] % 256)))
    smax = np.maximum(blocks.reshape(P, -1, 256).max(axis=2) / 127.0, 1e-12)
    shared = np.repeat(smax.max(axis=0), 256)[: x.shape[1]]
    bound = 1.5 * P * shared + 1e-4 * np.abs(exact)
    got = ranks[0]["psum"]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["psum"], got)
    err = got - exact
    assert (np.abs(err) <= bound).all(), float((np.abs(err) / bound).max())
    assert abs(err.mean()) <= 0.01 * bound.mean()
    assert (np.abs(ref["psum"] - exact) <= bound).all()


if __name__ == "__main__":
    _torch_spmd.main(_rank, _reference)


# -- the form without explicit collectives ------------------------------------------


def test_balanced_exchange_applies_its_constraints_around_the_swap():
    """``group=None``: ``constrain(send, *in_spec)`` before the swap and
    ``constrain(recv, *out_spec)`` after it, as the reference's GSPMD form;
    without them the swap alone."""
    import torch

    from repro_torch.distributed.exchange import balanced_exchange, slot_transpose

    x = torch.arange(2 * 3 * 4).reshape(2, 3, 4)
    calls = []

    def constrain(t, *spec):
        calls.append((tuple(t.shape), spec))
        return t

    recv, lengths = balanced_exchange(x, constrain=constrain,
                                      in_spec=(("data",), None, None),
                                      out_spec=("model", ("data",), None))
    assert lengths is None and torch.equal(recv, x.transpose(0, 1))
    assert calls == [((2, 3, 4), (("data",), None, None)),
                     ((3, 2, 4), ("model", ("data",), None))]
    assert torch.equal(slot_transpose(x), x.transpose(0, 1))
    with pytest.raises(ValueError, match="process group"):
        balanced_exchange(x, torch.ones(2, dtype=torch.int32))


def test_capacity_moe_passes_the_constraints_only_with_batch_axes():
    """The MoE capacity dispatch over local groups hands ``constrain_spec``
    to the slot swap only when a launcher set the batch axes; the layer's
    output is the same either way on plain tensors."""
    import torch

    from repro_torch.configs.registry import ARCHS, smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg = smoke_config(ARCHS["dbrx-132b"])
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    x = torch.randn(2, 8, cfg.d_model)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.moe_top_k, capacity_factor=1.25,
              dispatch_groups=2, dispatch="capacity")
    want = moe.moe_apply(lp, x, **kw)
    L.set_batch_axes(("data",))
    try:
        got = moe.moe_apply(lp, x, **kw)
    finally:
        L.set_batch_axes(None)
    assert torch.equal(got, want)
