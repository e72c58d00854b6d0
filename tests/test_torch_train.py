"""The port's training path against the JAX package's, on the CPU: the
chunked flash attention and its VJP, ``train_loss`` and its gradients for
every family, one train step (AdamW, gradient accumulation), the cosine
schedule, ``prefill_logits``, the MoE layer under autograd and the int8
quantisation.

Inputs come from seeded numpy generators and weights from the
reference's own ``init_params``, carried over through numpy.  Tolerances:

* float32 compute: losses within 1e-5 relative, every gradient leaf,
  attention output, parameter and moment within 1e-5 (attention, step)
  or 1e-4 (model gradients) relative L2 error -- the two frameworks sum
  in other orders, and a gradient passes through every layer's sums;
* bfloat16 compute (the configs' own): loss and gradients within 2e-2 --
  bf16 keeps 8 bits, and the frameworks round at other points;
* logits within 1e-5 of the largest logit.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.registry import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.train import compress as ref_compress
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.models import attention, moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import compress, optimizer
from repro_torch.train.train_step import build_train_step

F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
B, S = 2, 64


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# --- flash attention ---------------------------------------------------------------

# (batch, seq, heads, kv heads, qk head dim, v head dim, q chunk, kv chunk,
#  causal_skip): GQA with one and several chunks, skipping, and an MLA shape
#  whose v head dim differs from its qk head dim.
ATTN_CASES = {
    "gqa": (2, 64, 4, 2, 16, 16, 16, 32, False),
    "gqa_skip": (2, 64, 4, 2, 16, 16, 16, 16, True),
    "one_chunk": (2, 32, 4, 4, 16, 16, 32, 32, False),
    "mla_hdv": (1, 32, 4, 4, 24, 8, 8, 16, True),
}


def _attn_inputs(case):
    b, s, h, n_kv, hd, hdv, *_ = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, hd), (b, s, n_kv, hd), (b, s, n_kv, hdv), (b, s, h, hdv))]


@pytest.mark.parametrize("vjp", [False, True], ids=["autograd", "flash_vjp"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_matches_reference(case, vjp):
    """Output and the gradients of q, k and v for a random cotangent: the
    chunked forward under autograd, or the recomputing backward."""
    *_, qc, kc, skip = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(case)
    if vjp:
        ref_fa = ref_attn.make_flash_attention_vjp(causal=True, q_chunk=qc,
                                                   kv_chunk=kc)
        fa = attention.make_flash_attention_vjp(causal=True, q_chunk=qc,
                                                kv_chunk=kc)
    else:
        kw = dict(causal=True, q_chunk=qc, kv_chunk=kc, causal_skip=skip)
        ref_fa = functools.partial(ref_attn.flash_attention, **kw)
        fa = functools.partial(attention.flash_attention, **kw)
    want, back = jax.vjp(jax.jit(ref_fa), q, k, v)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    got = fa(*ts)
    assert got.shape == want.shape
    assert _rel(got, want) <= F32_TOL
    for g, w in zip(torch.autograd.grad(got, ts, torch.from_numpy(do)),
                    back(do)):
        assert _rel(g, w) <= F32_TOL


def test_flash_attention_is_causal_and_skips_nothing_it_needs():
    """Changing future keys and values changes no earlier output, with and
    without ``causal_skip``; a non-causal call equals the dense softmax."""
    q, k, v, _ = [torch.from_numpy(x) for x in _attn_inputs("gqa")]
    for skip in (False, True):
        base = attention.flash_attention(q, k, v, q_chunk=16, kv_chunk=16,
                                         causal_skip=skip)
        k2, v2 = k.clone(), v.clone()
        k2[:, 40:] = 1e3
        v2[:, 40:] = -1e3
        out = attention.flash_attention(q, k2, v2, q_chunk=16, kv_chunk=16,
                                        causal_skip=skip)
        assert torch.equal(out[:, :40], base[:, :40])
    b, s, h, hd = q.shape
    kk = k.repeat_interleave(h // k.shape[2], dim=2)
    vv = v.repeat_interleave(h // v.shape[2], dim=2)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd), -1)
    dense = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    got = attention.flash_attention(q, k, v, causal=False, q_chunk=16,
                                    kv_chunk=32)
    assert _rel(got, dense.numpy()) <= F32_TOL


def test_flash_attention_rejects_a_ragged_chunk():
    q, k, v, _ = [torch.from_numpy(x) for x in _attn_inputs("gqa")]
    with pytest.raises(ValueError, match="multiples"):
        attention.flash_attention(q, k, v, q_chunk=24, kv_chunk=16)


# --- train_loss and its gradients --------------------------------------------------

# Smoke configs with fields changed from the registry's.  deepseek-v3
# stores its params in bfloat16 as published, which rounds every gradient
# to 8 bits; its float32 case stores them in float32.
VARIANTS = {
    "granite-3-2b": ("granite-3-2b", {}),
    "granite-3-2b+remat": ("granite-3-2b", {"remat": "full"}),
    "granite-3-2b+dots": ("granite-3-2b", {"remat": "dots"}),
    "qwen3-0.6b": ("qwen3-0.6b", {}),
    "qwen3-0.6b+flash_vjp": ("qwen3-0.6b", {"flash_vjp": True,
                                             "q_chunk": 16, "kv_chunk": 16}),
    "qwen3-0.6b+skip": ("qwen3-0.6b", {"causal_skip": True, "q_chunk": 16,
                                        "kv_chunk": 16}),
    "dbrx-132b": ("dbrx-132b", {}),  # dropless, as published
    "dbrx-132b+capacity": ("dbrx-132b", {"moe_dispatch": "capacity"}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {"param_dtype": "float32"}),
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    "zamba2-1.2b": ("zamba2-1.2b", {"remat": "full"}),
    "internvl2-26b": ("internvl2-26b", {}),
    "musicgen-medium": ("musicgen-medium", {}),
}
# Which reference computation each variant is held against: remat and the
# flash VJP change what is saved, not the function, so they share one.
REF_OF = {"granite-3-2b+remat": "granite-3-2b",
          "granite-3-2b+dots": "granite-3-2b"}


def _cfgs(name, dtype="float32"):
    arch, over = VARIANTS[name]
    over = {"dtype": dtype, **over}
    return (dataclasses.replace(ref_smoke(REF_ARCHS[arch]), **over),
            dataclasses.replace(smoke_config(ARCHS[arch]), **over))


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference(name, dtype="float32"):
    """The reference's params, batch, loss and gradients (jitted), as
    numpy."""
    rcfg, _ = _cfgs(REF_OF.get(name, name), dtype)
    params, _ = ref_tf.init_params(rcfg, jax.random.key(0))
    batch = _batch(rcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: ref_tf.train_loss(rcfg, p, bt)))(
            params, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, params), batch, float(loss), _np(grads)


def _port_loss_and_grads(cfg, params_np, batch):
    params = params_from_numpy(params_np, "cpu")
    names = [n for n, _ in _flat(params)]
    leaves = [t.requires_grad_(True) for _, t in _flat(params)]
    loss = tf.train_loss(cfg, params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_loss_and_grads_match_reference_float32(name):
    """dense (granite; qwen3 with qk-norm, the flash VJP and causal skip;
    remat full and dots), MoE (dbrx: softmax router, dropless and
    capacity), MLA with a sigmoid router and a leading dense layer
    (deepseek-v3), SSM (mamba2), hybrid (zamba2), a frontend (internvl2)
    and sinusoidal positions with gelu (musicgen)."""
    _, cfg = _cfgs(name)
    params, batch, ref_loss, ref_grads = _reference(name)
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    assert abs(loss - ref_loss) <= F32_TOL * abs(ref_loss)
    want = dict(_flat(ref_grads))
    assert grads.keys() == want.keys()
    worst = max((_rel(grads[n], want[n]), n) for n in want)
    assert worst[0] <= GRAD_TOL, worst
    if cfg.moe:  # the router learns
        assert float(grads["/layers/mlp/router"].abs().max()) > 0


def test_train_loss_and_grads_match_reference_bf16():
    """granite in its own compute dtype, bfloat16."""
    _, cfg = _cfgs("granite-3-2b", "bfloat16")
    params, batch, ref_loss, ref_grads = _reference("granite-3-2b", "bfloat16")
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    assert abs(loss - ref_loss) <= BF16_TOL * abs(ref_loss)
    for n, w in _flat(ref_grads):
        assert _rel(grads[n], w) <= BF16_TOL, n


def test_first_loss_is_near_log_vocab():
    """Random weights predict nearly uniformly: the loss starts near
    ln(vocab), the check the card's train phase makes at full size."""
    _, _, loss, _ = _reference("granite-3-2b")
    assert abs(loss - math.log(256)) <= 0.05 * math.log(256)


# --- one train step ----------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One AdamW step past the warmup (so the learning rate is not 0):
    params, both moments, gnorm, loss and lr against the reference's
    jitted step; with ``grad_accum`` 2 the batch is cut in two."""
    rcfg, cfg = _cfgs("granite-3-2b")
    rcfg = dataclasses.replace(rcfg, grad_accum=accum)
    cfg = dataclasses.replace(cfg, grad_accum=accum)
    params, batch, _, _ = _reference("granite-3-2b")
    rp = jax.tree.map(jnp.asarray, params)
    ropt = ref_opt.adamw_init(rp)
    step = 250
    rp, ropt, rmet = jax.jit(ref_step.build_train_step(rcfg))(
        rp, ropt, jax.tree.map(jnp.asarray, batch), jnp.int32(step))

    tp = params_from_numpy(params, "cpu")
    topt = optimizer.adamw_init(tp)
    tp, topt, met = build_train_step(cfg)(
        tp, topt, {k: torch.from_numpy(v) for k, v in batch.items()}, step)
    assert int(topt.step) == 1 and topt.step.dtype == torch.int32
    for key in ("loss", "gnorm", "lr"):
        assert abs(float(met[key]) - float(rmet[key])) <= \
            F32_TOL * abs(float(rmet[key])), key
    for got_tree, want_tree in ((tp, rp), (topt.m, ropt.m), (topt.v, ropt.v)):
        want = dict(_flat(_np(want_tree)))
        for n, g in _flat(got_tree):
            assert _rel(g, want[n]) <= F32_TOL, n


def test_adamw_update_matches_reference_with_bf16_moments_and_clipping():
    """Three steps on a small tree with a clipped gradient (its norm above
    the clip), bfloat16 moments and float32 math; grads given per layer
    (a list, as the train step gives them) update the stacked params."""
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 8)).astype(np.float32),
              "layers": {"a": rng.standard_normal((3, 5)).astype(np.float32)}}
    rp = jax.tree.map(jnp.asarray, params)
    ropt = ref_opt.adamw_init(rp, dtype=jnp.bfloat16)
    tp = params_from_numpy(params, "cpu")
    topt = optimizer.adamw_init(tp, dtype=torch.bfloat16)
    for i in range(3):
        g = {"w": rng.standard_normal((4, 8)).astype(np.float32) * 3,
             "layers": {"a": rng.standard_normal((3, 5)).astype(np.float32)}}
        rp, ropt, rn = ref_opt.adamw_update(jax.tree.map(jnp.asarray, g), ropt,
                                            rp, lr=1e-2)
        tg = params_from_numpy(g, "cpu")
        tg["layers"] = [{"a": tg["layers"]["a"][j]} for j in range(3)]
        tp, topt, n = optimizer.adamw_update(tg, topt, tp, lr=1e-2)
        assert abs(float(n) - float(rn)) <= F32_TOL * float(rn)
        assert float(rn) > 1.0  # clipped
    assert topt.m["w"].dtype == torch.bfloat16
    # bf16 moments may round apart by one unit of the last place
    for got, want, tol in ((tp, rp, F32_TOL), (topt.m, ropt.m, 1e-2),
                           (topt.v, ropt.v, 1e-2)):
        want = dict(_flat(_np(want)))
        for n, a in _flat(got):
            assert _rel(a, want[n]) <= tol, n


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 100, 150])
def test_cosine_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    want = float(ref_opt.cosine_schedule(jnp.int32(step), **kw))
    got = optimizer.cosine_schedule(step, **kw, device="cpu")
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-7 * 3e-4


# --- prefill -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-0.6b", "deepseek-v3-671b",
                                  "zamba2-1.2b"])
def test_prefill_logits_match_reference_and_decode(name):
    """The last position's logits of a full forward equal the reference's,
    and the port's own lock-step decode of the same tokens, one at a
    time, ends on the same logits."""
    rcfg, cfg = _cfgs(name)
    params, batch, _, _ = _reference(name)
    tokens = batch["tokens"][:, :16]
    want = jax.jit(lambda p, t: ref_tf.prefill_logits(rcfg, p, t))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        got = tf.prefill_logits(cfg, tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= F32_TOL * scale
    cp = tf.compute_params(cfg, tp)
    cache = tf.init_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for t in range(16):
            dec, cache = tf.decode_step(cfg, cp, cache,
                                        torch.from_numpy(tokens[:, t:t + 1]))
    assert float((dec - got).abs().max()) <= F32_TOL * scale


# --- the MoE layer under autograd --------------------------------------------------


def _moe_inputs():
    p, _ = ref_moe.init_moe(jax.random.key(5), 16, 32, 8)
    x = np.random.default_rng(5).standard_normal((2, 12, 16)).astype(np.float32)
    return jax.tree.map(np.asarray, p), x


@pytest.mark.parametrize("dispatch", ["dropless", "capacity"])
def test_moe_layer_trains_under_autograd(dispatch):
    """Backward through the whole layer (router, dispatch, per-expert
    products, combine) equals ``jax.grad`` of the reference's layer; the
    dropless products used to write through ``out=``, which autograd
    refuses."""
    p, x = _moe_inputs()
    kw = dict(n_experts=8, top_k=2, capacity_factor=1.0, dispatch=dispatch)

    def ref_fn(params, xx):
        return jnp.sum(jnp.sin(ref_moe.moe_apply(params, xx, **kw)))

    want = jax.jit(jax.grad(ref_fn, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = params_from_numpy(p, "cpu")
    leaves = [t.requires_grad_(True) for t in tp.values()]
    tx = torch.tensor(x, requires_grad=True)
    out = torch.sin(moe.moe_apply(tp, tx, **kw)).sum()
    grads = torch.autograd.grad(out, [*leaves, tx])
    for g, (n, w) in zip(grads, [*_flat(_np(want[0])), ("x", want[1])]):
        assert _rel(g, w) <= F32_TOL, n
    assert float(grads[list(tp).index("router")].abs().max()) > 0


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_router_gradient_does_not_ride_on_the_topk_keys(scoring, monkeypatch):
    """On the card the router's top-k is a kernel launch whose outputs carry
    no autograd graph.  With the top-k run that way here too, the router
    still gets the gradient of the reference's ``lax.top_k`` (the weights
    are gathered from the scores, not taken from the top-k's keys)."""
    real = moe.merge_topk_batch

    def no_graph(scores, k, *a, **kw):
        with torch.no_grad():
            return real(scores, k, *a, **kw)

    monkeypatch.setattr(moe, "merge_topk_batch", no_graph)
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((10, 8)).astype(np.float32)
    cot = rng.standard_normal((10, 3)).astype(np.float32)

    def ref_fn(lg):
        w, _ = ref_moe.route_topk(lg, 3, scoring=scoring)
        return jnp.sum(w * cot)

    want = jax.grad(ref_fn)(jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    w, experts = moe.route_topk(tl, 3, scoring=scoring)
    _, ref_experts = ref_moe.route_topk(jnp.asarray(logits), 3, scoring=scoring)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(ref_experts))
    (g,) = torch.autograd.grad((w * torch.from_numpy(cot)).sum(), tl)
    assert float(g.abs().max()) > 0
    assert _rel(g, want) <= F32_TOL


def test_route_topk_weights_are_the_topk_keys():
    """The gathered weights are the top-k's keys, bit for bit: no served
    token changes."""
    logits = torch.from_numpy(np.random.default_rng(7)
                              .standard_normal((64, 16)).astype(np.float32))
    keys, experts = moe.merge_topk_batch(torch.softmax(logits, -1), 4)
    w, e2 = moe.route_topk(logits, 4)
    assert torch.equal(experts, e2)
    np.testing.assert_array_equal(
        w.numpy(), (keys / (keys.sum(-1, keepdim=True) + 1e-20)).numpy())


# --- int8 quantisation -------------------------------------------------------------


def test_quantize_int8_scales_equal_reference_and_round_within_a_step():
    x = (np.random.default_rng(8).standard_normal(1000) * 3).astype(np.float32)
    _, rscales, rn = ref_compress.quantize_int8(jnp.asarray(x), jax.random.key(0))
    q, scales, n = compress.quantize_int8(torch.from_numpy(x),
                                          torch.Generator().manual_seed(0))
    assert n == rn == 1000 and q.dtype == torch.int8 and q.shape == (4, 256)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(rscales))
    deq = compress.dequantize_int8(q, scales, n, (1000,), torch.float32)
    step = np.repeat(scales.numpy(), 256)[:1000]
    assert np.all(np.abs(deq.numpy() - x) <= step * (1 + 1e-6))


def test_quantize_int8_is_unbiased():
    """The mean of many draws approaches the input: within four standard
    errors of a rounding (at most half a step each) everywhere."""
    x = torch.from_numpy((np.random.default_rng(9).standard_normal(300))
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    draws = 2000
    total = torch.zeros_like(x, dtype=torch.float64)
    for _ in range(draws):
        q, scales, n = compress.quantize_int8(x, gen)
        total += compress.dequantize_int8(q, scales, n, x.shape, torch.float32)
    step = float(scales.max())
    assert float((total / draws - x).abs().max()) <= 4 * 0.5 * step / math.sqrt(draws)
