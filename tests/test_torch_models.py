"""The port's model layers and decode step against the JAX package's.

Weights come from the reference's own ``init_params`` and reach the port
through numpy (``params_from_numpy``).  Tolerances:

* float32 (``dtype="float32"``): every result within 1e-5 of the
  reference, relative to the largest magnitude of the reference's result
  (the two frameworks sum in other orders; a float32 ulp is 6e-8);
* bfloat16 (the configs' own compute dtype): logits within 3e-2 of the
  largest logit, relative -- bf16 keeps 8 bits, and the two frameworks
  round the products and the residual stream at different points.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs.registry import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

F32_TOL = 1e-5
BF16_TOL = 3e-2


def _close(got, want, tol=F32_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max error {err} > {tol} x {scale}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(name, dtype="float32"):
    return (dataclasses.replace(ref_smoke(REF_ARCHS[name]), dtype=dtype),
            dataclasses.replace(smoke_config(ARCHS[name]), dtype=dtype))


# --- configs and weights ----------------------------------------------------------


def test_configs_equal_the_reference():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(
            REF_ARCHS[name])
        assert dataclasses.asdict(smoke_config(ARCHS[name])) == \
            dataclasses.asdict(ref_smoke(REF_ARCHS[name]))
    assert ARCHS["qwen3-0.6b"].param_count() == REF_ARCHS["qwen3-0.6b"].param_count()


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-110b",
                                  "musicgen-medium", "internvl2-26b"])
def test_init_params_tree_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    ref, _ = ref_tf.init_params(rcfg, jax.random.key(0))
    got = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {k: (s, str(np.dtype(d))) for k, (s, d) in _shapes(_np(ref)).items()}
    assert _shapes(got) == want


def test_init_params_is_seeded_and_truncated():
    _, cfg = _cfgs("qwen3-0.6b")
    a = tf.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tf.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    wq = a["layers"]["attn"]["wq"]
    assert torch.equal(wq, b["layers"]["attn"]["wq"])
    std = 1 / np.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= 2 * std + 1e-7
    assert abs(float(wq.std()) / std - 0.88) < 0.05  # std of N(0,1) cut at 2


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b",
                                  "mamba2-2.7b", "zamba2-1.2b"])
def test_unported_families_raise(arch):
    _, cfg = _cfgs(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if tf.cache_kind(cfg) != "gqa":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tf.init_cache(cfg, 2, 8, device="cpu")


def test_params_from_numpy_carries_leaves_and_bf16_bits():
    rcfg, _ = _cfgs("qwen3-0.6b")
    ref, _ = ref_tf.init_params(rcfg, jax.random.key(1))
    tree = _np(ref)
    got = params_from_numpy(tree, "cpu")
    np.testing.assert_array_equal(got["layers"]["attn"]["wq"].numpy(),
                                  tree["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(got["embed"]["table"].numpy(),
                                  tree["embed"]["table"])
    bf = np.asarray([1.5, -0.0, np.inf, 3.0e38], ml_dtypes.bfloat16)
    t = tensor_from_numpy(bf, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  bf.view(np.int16))
    with pytest.raises(TypeError, match="numpy array"):
        tensor_from_numpy(jnp.zeros(3))


def test_compute_params_casts_matrices_once():
    _, cfg = _cfgs("qwen3-0.6b", "bfloat16")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cp = tf.compute_params(cfg, params)
    assert isinstance(cp["layers"], list) and len(cp["layers"]) == cfg.n_layers
    assert cp["layers"][1]["attn"]["wq"].dtype == torch.bfloat16
    assert cp["layers"][1]["ln1"]["scale"].dtype == torch.float32
    assert cp["embed"]["table"].dtype == torch.bfloat16
    assert torch.equal(cp["layers"][1]["mlp"]["w_up"],
                       params["layers"]["mlp"]["w_up"][1].to(torch.bfloat16))


# --- layers -----------------------------------------------------------------------


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rmsnorm_matches_reference():
    x = _rng().standard_normal((2, 3, 64)).astype(np.float32) * 3
    scale = _rng(1).standard_normal(64).astype(np.float32)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rcos, rsin = ref_layers.rope_frequencies(16, 40, theta)
    cos, sin = layers.rope_frequencies(16, 40, theta, device="cpu")
    _close(cos, rcos)
    _close(sin, rsin)
    x = _rng().standard_normal((3, 1, 4, 16)).astype(np.float32)
    pos = np.array([[0], [17], [39]], np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), rcos, rsin, jnp.asarray(pos))
    got = layers.apply_rope(torch.from_numpy(x), cos, sin,
                            torch.from_numpy(pos).long())
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(kind):
    p, _ = ref_layers.init_mlp(jax.random.key(2), 64, 128, kind)
    x = _rng().standard_normal((2, 1, 64)).astype(np.float32)
    want = ref_layers.mlp(p, jnp.asarray(x), kind)
    got = layers.mlp(params_from_numpy(_np(p), "cpu"), torch.from_numpy(x), kind)
    _close(got, want)


@pytest.mark.parametrize("qk_norm,bias", [(True, False), (False, True)])
def test_qkv_project_matches_reference(qk_norm, bias):
    p, _ = ref_attn.init_gqa(jax.random.key(3), 64, 4, 2, 16, qkv_bias=bias,
                             qk_norm=qk_norm)
    if bias:  # non-zero biases, so that they count
        p = {**p, **{n: jnp.full_like(p[n], 0.25) for n in ("bq", "bk", "bv")}}
    cos, sin = ref_layers.rope_frequencies(16, 32, 1e6)
    x = _rng().standard_normal((3, 1, 64)).astype(np.float32)
    pos = np.array([[0], [5], [31]], np.int32)
    want = ref_attn.qkv_project(p, jnp.asarray(x), cos, sin, jnp.asarray(pos),
                                qk_norm=qk_norm)
    tcos, tsin = layers.rope_frequencies(16, 32, 1e6, device="cpu")
    got = attention.qkv_project(params_from_numpy(_np(p), "cpu"), torch.from_numpy(x),
                                tcos, tsin, torch.from_numpy(pos).long(),
                                qk_norm=qk_norm)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention_matches_reference(per_slot):
    rng = _rng(4)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    cl = np.array([1, 7, 12], np.int32) if per_slot else np.int32(5)
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(cl))
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), torch.as_tensor(cl))
    _close(got, want)


def test_decode_attention_never_reads_past_the_length():
    rng = _rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 10, 2, 16)).astype(np.float32))
    vc = kc.clone()
    cl = torch.tensor([3, 6])
    base = attention.decode_attention(q, kc, vc, cl)
    kc[0, 3:] = 1e4
    vc[0, 3:] = 1e4
    kc[1, 6:] = -1e4
    assert torch.equal(attention.decode_attention(q, kc, vc, cl), base)


# --- the ragged decode step -------------------------------------------------------


def _ragged_both(arch, dtype, steps=4, b=3, max_len=16):
    rcfg, cfg = _cfgs(arch, dtype)
    cache_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref_params, _ = ref_tf.init_params(rcfg, jax.random.key(0))
    params = tf.compute_params(cfg, params_from_numpy(_np(ref_params), "cpu"))
    rcache = ref_tf.init_cache(rcfg, b, max_len, dtype=cache_dtype)
    cache = tf.init_cache(cfg, b, max_len, dtype=getattr(torch, dtype),
                          device="cpu")
    lengths = np.array([0, 3, 9], np.int32)[:b]
    rcache = ref_tf.Cache("gqa", rcache.data, jnp.asarray(lengths))
    step = jax.jit(lambda p, c, t, l: ref_tf.decode_step_ragged(rcfg, p, c, t, l))
    rng = _rng(6)
    out = []
    for _ in range(steps):
        tok = rng.integers(0, rcfg.vocab, (b, 1)).astype(np.int32)
        want, rcache = step(ref_params, rcache, jnp.asarray(tok),
                            jnp.asarray(lengths))
        got, cache = tf.decode_step_ragged(cfg, params, cache,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(lengths))
        assert got.dtype == torch.float32 and got.shape == (b, rcfg.vocab)
        np.testing.assert_array_equal(cache.length.numpy(), lengths + 1)
        out.append((got, want))
        lengths = lengths + 1
    return out, cache, rcache


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium",
                                  "qwen1.5-110b"])
def test_decode_step_ragged_matches_reference_float32(arch):
    """Several ragged steps (slots at lengths 0, 3 and 9): logits and the
    cache within the float32 tolerance.  qwen3: qk-norm, RoPE, GQA, tied
    embeddings; musicgen: sinusoidal positions, gelu; qwen1.5: QKV bias."""
    out, cache, rcache = _ragged_both(arch, "float32")
    for got, want in out:
        _close(got, want)
    _close(cache.data[0], rcache.data[0])
    _close(cache.data[1], rcache.data[1])


def test_decode_step_ragged_matches_reference_bf16():
    out, _, _ = _ragged_both("qwen3-0.6b", "bfloat16")
    for got, want in out:
        _close(got, want, BF16_TOL)


def test_decode_step_ragged_rejects_other_caches():
    _, cfg = _cfgs("qwen3-0.6b")
    cache = tf.init_cache(cfg, 1, 4, device="cpu")
    bad = tf.Cache("mla", cache.data, cache.length)
    with pytest.raises(NotImplementedError, match="gqa"):
        tf.decode_step_ragged(cfg, {}, bad, torch.zeros((1, 1), dtype=torch.long),
                              torch.zeros(1, dtype=torch.int32))


def test_entry_points_default_to_the_card():
    """Without a device argument the model's entry points allocate on the
    card; on a machine without one they raise instead of falling back."""
    _, cfg = _cfgs("qwen3-0.6b")
    calls = (lambda: tf.init_cache(cfg, 1, 4),
             lambda: params_from_numpy({"w": np.zeros(3, np.float32)}))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            leaf = out.data[0] if isinstance(out, tf.Cache) else out["w"]
            assert leaf.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
