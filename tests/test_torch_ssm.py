"""The port's Mamba2 block (``repro_torch.models.ssm``) and the SSM/hybrid
decode caches against the JAX package's, on the CPU.

Inputs come from seeded numpy generators; weights from the reference's
own ``init_mamba2`` / ``init_params``, carried over through numpy.
Tolerances, relative to the largest magnitude of the reference's result:

* float32: 1e-5 (the frameworks sum in other orders; a float32 ulp is
  6e-8).  The conv state is a copy of inputs, so it must match exactly.
* bfloat16: 3e-2 -- bf16 keeps 8 bits, and the frameworks round the
  products at different points; the casts themselves follow the
  reference's order, so a result one cast away from it would miss by a
  factor of 2^-8 per step, which the float32 cases pin down.

The lock-step ``decode_step`` of both families over five steps runs in
``tests/test_torch_models.py`` (``_lockstep_both``); here are the block's
parts, the caches and the greedy streams of the launcher's lock-step loop.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import _torch_shard_ranks

from repro.configs.registry import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.launch import serve as ref_serve
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch import obs
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy

F32_TOL = 1e-5
BF16_TOL = 3e-2
BT, S, H, P, N = 2, 8, 4, 8, 16


def _close(got, want, tol=F32_TOL):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max error {err} > {tol} x {scale}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both(a: np.ndarray, dtype="float32"):
    """``a`` as a JAX array and a torch tensor of ``dtype``."""
    ref = jnp.asarray(a).astype(dtype)
    return ref, torch.tensor(np.asarray(ref.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _ssd_inputs(g: int, seed: int = 0, s: int = S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BT, s, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (BT, s, H)).astype(np.float32)
    b = rng.standard_normal((BT, s, g, N)).astype(np.float32)
    c = rng.standard_normal((BT, s, g, N)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    h0 = rng.standard_normal((BT, H, P, N)).astype(np.float32)
    return x, dt, b, c, a_log, d, h0


# --- the SSD scan ---------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_ssd_chunked_matches_reference(chunk, g, with_h0):
    x, dt, b, c, a_log, d, h0 = _ssd_inputs(g, seed=chunk * 10 + g)
    h0 = h0 if with_h0 else None
    want_y, want_h = ref_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, b, c, a_log, d)), None, chunk=chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = ssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, b, c, a_log, d)), None, chunk=chunk,
        h0=None if h0 is None else torch.from_numpy(h0))
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_ssd_chunked_rejects_a_ragged_chunk():
    x, dt, b, c, a_log, d, _ = map(torch.from_numpy, _ssd_inputs(1))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(x, dt, b, c, a_log, d, None, chunk=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_step_matches_reference_chunk_one(g, dtype):
    """The one-token recurrence against the reference's ``ssd_chunked``
    at ``s = chunk = 1`` from a state: y in ``x``'s dtype (the D skip a
    bf16 add in a bf16 run), the state float32."""
    x, dt, b, c, a_log, d, h0 = _ssd_inputs(g, seed=g, s=1)
    rx, tx = _both(x, dtype)
    rb, tb = _both(b, dtype)
    rc, tc = _both(c, dtype)
    want_y, want_h = ref_ssm.ssd_chunked(
        rx, jnp.asarray(dt), rb, rc, jnp.asarray(a_log), jnp.asarray(d), None,
        chunk=1, h0=jnp.asarray(h0))
    got_y, got_h = ssm.ssd_step(
        tx[:, 0], torch.from_numpy(dt[:, 0]), tb[:, 0], tc[:, 0],
        torch.from_numpy(a_log), torch.from_numpy(d), torch.from_numpy(h0))
    assert got_y.dtype == getattr(torch, dtype)
    assert got_h.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(got_y, want_y[:, 0], tol)
    _close(got_h, want_h)  # float32 from the same bf16 inputs


# --- conv, gated norm -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BT, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32) * 0.3
    bias = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((BT, 3, 12)).astype(np.float32)
    rx, tx = _both(x, dtype)
    rs_, ts_ = _both(state, dtype)
    want_y, want_s = ref_ssm._causal_conv(
        rx, jnp.asarray(w), jnp.asarray(bias), rs_ if with_state else None)
    got_y, got_s = ssm._causal_conv(
        tx, torch.from_numpy(w), torch.from_numpy(bias),
        ts_ if with_state else None)
    assert got_y.dtype == got_s.dtype == getattr(torch, dtype)
    _close(got_y, want_y, F32_TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_array_equal(  # the new state is inputs, exactly
        got_s.float().numpy(), np.asarray(want_s.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((BT, 3, 32)).astype(np.float32) * 2
    z = rng.standard_normal((BT, 3, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    rx, tx = _both(x, dtype)
    rz, tz = _both(z, dtype)
    want = ref_ssm._gated_rmsnorm(rx, rz, jnp.asarray(scale))
    got = ssm._gated_rmsnorm(tx, tz, torch.from_numpy(scale))
    assert got.dtype == getattr(torch, dtype)
    # same casts in the same order: within one bf16 rounding of the result
    _close(got, want, F32_TOL if dtype == "float32" else 2 ** -7)


# --- the block --------------------------------------------------------------------


def _block(ngroups=1):
    p, _, meta = ref_ssm.init_mamba2(jax.random.key(5), 32, expand=2,
                                     headdim=8, d_state=16, ngroups=ngroups)
    return p, params_from_numpy(_np(p), "cpu"), meta


@pytest.mark.parametrize("ngroups", [1, 2])
def test_mamba2_forward_prefill_matches_reference(ngroups):
    rp, tp, meta = _block(ngroups)
    x = np.random.default_rng(6).standard_normal((BT, 8, 32)).astype(np.float32)
    want, none = ref_ssm.mamba2_forward(rp, meta, jnp.asarray(x), chunk=4)
    got, nothing = ssm.mamba2_forward(tp, meta, torch.from_numpy(x), chunk=4)
    assert none is None and nothing is None
    _close(got, want)


def _one_token_block(params, meta, x, state):
    """The oracle of the in-place one-token block: the Mamba2 block of
    ``x`` (b, 1, d) from ``state = (conv_state, ssm_state)`` through
    ``ssd_step``, returning ``(out, (conv_state, ssm_state))`` as new
    tensors and writing nothing."""
    xs, z, b, c, dt, conv = ssm._mix_in(params, meta, x, state[0])
    y, h = ssm.ssd_step(*ssm._one_token(meta, xs, dt, b, c), params["A_log"],
                        params["D"], state[1])
    return ssm._mix_out(params, meta, y, z), (conv, h)


@pytest.mark.parametrize("ngroups", [1, 2])
def test_mamba2_forward_decode_matches_reference(ngroups):
    """Three one-token calls of the decode step's block
    (``mamba2_decode_``) from a prefill's states, written into cloned
    caches, against the reference's chunk-1 calls of ``mamba2_forward``."""
    rp, tp, meta = _block(ngroups)
    rng = np.random.default_rng(7)
    conv = rng.standard_normal((BT, 3, meta["conv_dim"])).astype(np.float32)
    st = rng.standard_normal((BT, meta["nheads"], meta["headdim"],
                              meta["d_state"])).astype(np.float32)
    rstate = (jnp.asarray(conv), jnp.asarray(st))
    tconv, tst = torch.from_numpy(conv).clone(), torch.from_numpy(st).clone()
    for _ in range(3):
        x = rng.standard_normal((BT, 1, 32)).astype(np.float32)
        want, rstate = ref_ssm.mamba2_forward(rp, meta, jnp.asarray(x),
                                              chunk=1, state=rstate)
        got = ssm.mamba2_decode_(tp, meta, torch.from_numpy(x), tconv, tst)
        _close(got, want)
        np.testing.assert_array_equal(tconv.numpy(), np.asarray(rstate[0]))
        _close(tst, rstate[1])


def test_mamba2_forward_decode_leaves_the_state_alone():
    """The one-token oracle returns new states and writes none of the
    caller's, so the in-place form's writes are held against values it
    did not make."""
    _, tp, meta = _block()
    conv = torch.zeros((1, 3, meta["conv_dim"]))
    st = torch.zeros((1, meta["nheads"], meta["headdim"], meta["d_state"]))
    x = torch.ones((1, 1, 32))
    _, (conv_n, st_n) = _one_token_block(tp, meta, x, (conv, st))
    assert not conv.any() and not st.any()
    assert conv_n.any() and st_n.any()


# --- the decode step's in-place forms ---------------------------------------------


def _layer_states(shape, seed, layers=3):
    """A stack of ``layers`` float32 states; the tests write the middle one."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((layers, *shape), generator=g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_step_in_place_equals_step_and_copy(g, dtype):
    """``ssd_step_`` on the CPU writes the layer's slice of the cache bit
    for bit as ``ssd_step`` plus ``copy_``, returns the same ``y``, leaves
    the other layers alone and counts one ``kernels.dispatch_calls`` with
    ``op="ssd_step"`` and ``backend="torch"``."""
    x, dt, b, c, a_log, d, _ = _ssd_inputs(g, seed=10 + g, s=1)
    tx, tb, tc = (_both(a, dtype)[1][:, 0] for a in (x, b, c))
    args = (tx, torch.from_numpy(dt[:, 0]), tb, tc, torch.from_numpy(a_log),
            torch.from_numpy(d))
    cache = _layer_states((BT, H, P, N), seed=g)
    before = cache.clone()
    want_y, want_h = ssm.ssd_step(*args, cache[1])
    with obs.capture() as recs:
        got_y = ssm.ssd_step_(*args, cache[1])
        obs.flush()
        calls = [r for r in recs if r["metric"] == "kernels.dispatch_calls"]
    assert torch.equal(got_y, want_y) and got_y.dtype == want_y.dtype
    assert torch.equal(cache[1], want_h)
    assert torch.equal(cache[0], before[0]) and torch.equal(cache[2], before[2])
    assert [(r["value"], r["labels"]) for r in calls] == [
        (1, {"op": "ssd_step", "backend": "torch"})]


@pytest.mark.parametrize("ngroups", [1, 2])
def test_mamba2_decode_in_place_equals_forward(ngroups):
    """``mamba2_decode_`` gives the one-token oracle's output bit for bit
    over three tokens and writes its two new states into the layer's
    slices of the caches; the other layers' slices stay."""
    _, tp, meta = _block(ngroups)
    rng = np.random.default_rng(8)
    conv = torch.from_numpy(rng.standard_normal(
        (3, BT, 3, meta["conv_dim"])).astype(np.float32))
    st = _layer_states((BT, meta["nheads"], meta["headdim"], meta["d_state"]),
                       seed=ngroups)
    conv0, st0 = conv.clone(), st.clone()
    state = (conv[1].clone(), st[1].clone())
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((BT, 1, 32)).astype(np.float32))
        want, state = _one_token_block(tp, meta, x, state)
        got = ssm.mamba2_decode_(tp, meta, x, conv[1], st[1])
        assert torch.equal(got, want)
        assert torch.equal(conv[1], state[0]) and torch.equal(st[1], state[1])
    for i in (0, 2):
        assert torch.equal(conv[i], conv0[i]) and torch.equal(st[i], st0[i])


@pytest.fixture(scope="module")
def shard_ranks():
    """One spawned pair of gloo ranks for every case below."""
    return _torch_shard_ranks.spawn("cpu", layers=True)


@pytest.mark.parametrize("case", ["ssd_step", *_torch_shard_ranks.LAYER_CASES])
def test_ssd_step_in_place_on_dtensor_shards_of_two_ranks(case, shard_ranks):
    """Two gloo ranks of CPU DTensors against the plain single process.
    ``ssd_step``: the route a DTensor cache on the card takes
    (``_ssd_step_on_local_shards``), with the plain in-place step standing
    in for the kernel: each rank's shard of the state, over rows or heads,
    with inputs whole, replicated or sharded and one or two B/C groups,
    equals the whole plain step's bit for bit; ``y`` is within float32
    summation of it, laid out as the state; a state sharded over the head
    dimension is refused.  The other cases run the rest of the model
    layers through ``layers.on_local_shards``: ``ssd_chunked`` on row and
    head shards (state bit for bit), the expert segments with
    expert-parallel weights (``grouped_gemm``, the dropless MoE layer at
    dbrx's smoke width) and a decode cache's token write on caches sharded
    over positions or rows (bit for bit)."""
    if case == "ssd_step":
        _torch_shard_ranks.check(shard_ranks)
    else:
        _torch_shard_ranks.check_layer(shard_ranks, case)


# --- caches and init --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_init_cache_matches_reference(arch, dtype):
    """Kind, shapes and dtypes: the conv state (and a hybrid's k/v) in the
    cache dtype, the SSM state float32, the length a scalar 0."""
    rcfg, cfg = ref_smoke(REF_ARCHS[arch]), smoke_config(ARCHS[arch])
    want = ref_tf.init_cache(rcfg, 3, 10, dtype=getattr(jnp, dtype))
    got = tf.init_cache(cfg, 3, 10, dtype=getattr(torch, dtype), device="cpu")
    assert got.kind == want.kind == tf.cache_kind(cfg)
    assert len(got.data) == len(want.data) == (4 if cfg.attn_every else 2)
    for g, w in zip(got.data, want.data):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert not g.any()
    assert got.length.shape == () and int(got.length) == 0


def test_full_size_meta_and_cache_shapes():
    """The published widths: mamba2-2.7b 80 heads of 64 over a 128-wide
    state, conv over 5376 channels; zamba2-1.2b applies its shared block
    after layers 5, 11, ..., 35 (six k/v entries, none after 36 and 37)."""
    m = tf.mamba_meta(ARCHS["mamba2-2.7b"])
    assert (m["d_inner"], m["nheads"], m["conv_dim"]) == (5120, 80, 5376)
    z = ARCHS["zamba2-1.2b"]
    apps = [i // z.attn_every for i in range(z.n_layers)
            if (i + 1) % z.attn_every == 0]
    assert apps == list(range(z.n_layers // z.attn_every)) == list(range(6))


def test_compute_params_casts_the_ssm_tree():
    """Per layer, ``w_in``, ``conv_w`` and ``w_out`` go to the compute
    dtype; ``A_log``, ``D``, ``dt_bias``, ``conv_b`` and the norm scales
    stay float32; the hybrid's shared block is cast once, not split."""
    cfg = smoke_config(ARCHS["zamba2-1.2b"])
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cp = tf.compute_params(cfg, params)
    assert isinstance(cp["layers"], list) and len(cp["layers"]) == cfg.n_layers
    mamba = cp["layers"][1]["mamba"]
    for name in ("w_in", "conv_w", "w_out"):
        assert mamba[name].dtype == torch.bfloat16
        assert torch.equal(mamba[name], params["layers"]["mamba"][name][1]
                           .to(torch.bfloat16))
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_scale"):
        assert mamba[name].dtype == torch.float32
    assert cp["layers"][1]["ln"]["scale"].dtype == torch.float32
    shared = cp["shared_attn"]
    assert isinstance(shared, dict) and shared["attn"]["wq"].dim() == 3
    assert shared["attn"]["wq"].dtype == torch.bfloat16
    assert shared["ln1"]["scale"].dtype == torch.float32


# --- the launcher's lock-step loop ------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [("mamba2-2.7b", "float32"),
                                        ("mamba2-2.7b", "bfloat16"),
                                        ("zamba2-1.2b", "bfloat16")])
def test_greedy_lockstep_streams_match_reference(arch, dtype):
    """The port's ``_serve_lockstep`` (``LockstepDecoder``) against the
    reference launcher's lock-step loop: same weights, same prompts, the
    same greedy tokens.  Both keep their default bfloat16 cache; the
    reference's hybrid step cannot write a float32 k/v into it
    (``dynamic_update_slice`` of mixed dtypes raises), so zamba2 runs in
    its own compute dtype only."""
    rcfg = dataclasses.replace(ref_smoke(REF_ARCHS[arch]), dtype=dtype)
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype=dtype)
    ref_params, _ = ref_tf.init_params(rcfg, jax.random.key(0))
    params = params_from_numpy(_np(ref_params), "cpu")
    args = argparse.Namespace(max_batch=0, prompt_len=5, tokens=8,
                              sampler="greedy", seed=3, profile_steps=0)
    want = ref_serve._serve_lockstep(rcfg, ref_params, args, None)
    got = serve._serve_lockstep(cfg, params, args, "cpu")
    assert len(want) == rcfg.max_batch
    assert got == want


# --- bf16 against float32 at the published widths ----------------------------------


def test_bf16_gap_equals_the_reference_s_at_published_widths():
    """mamba2-2.7b at its published widths (d 2560, 80 heads, d_state 128,
    vocab 50280), cut to 2 layers: eight lock-step decode steps of batch
    8 in bfloat16 and in float32 from the same weights and tokens.  The
    relative L2 gap between the two runs' last logits is the reference's
    own, within 10% (the two frameworks round the bf16 products apart);
    the float32 runs agree within 1e-5."""
    rcfg = dataclasses.replace(REF_ARCHS["mamba2-2.7b"], n_layers=2)
    cfg = dataclasses.replace(ARCHS["mamba2-2.7b"], n_layers=2)
    ref_params = jax.jit(lambda k: ref_tf.init_params(rcfg, k)[0])(
        jax.random.key(0))
    b, steps = 8, 8
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab, (steps, b, 1)).astype(np.int32)
    ref, port = {}, {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(rcfg, dtype=dt)
        cache = ref_tf.init_cache(c, b, steps, dtype=jnp.dtype(dt))
        step = jax.jit(lambda p, cc, t, c=c: ref_tf.decode_step(c, p, cc, t))
        for s in range(steps):
            out, cache = step(ref_params, cache, jnp.asarray(toks[s]))
        ref[dt] = np.asarray(out, np.float32)
    params = params_from_numpy(_np(ref_params), "cpu")
    del ref_params
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt)
        cp = tf.compute_params(c, params)
        cache = tf.init_cache(c, b, steps, dtype=getattr(torch, dt),
                              device="cpu")
        with torch.no_grad():
            for s in range(steps):
                out, cache = tf.decode_step(c, cp, cache,
                                            torch.from_numpy(toks[s]))
        port[dt] = out.numpy()

    def gap(run):
        hi = run["float32"]
        return float(np.linalg.norm(run["bfloat16"] - hi) / np.linalg.norm(hi))

    assert gap(ref) > 0
    assert abs(gap(port) - gap(ref)) <= 0.1 * gap(ref), (gap(port), gap(ref))
    _close(torch.from_numpy(port["float32"]), ref["float32"])
