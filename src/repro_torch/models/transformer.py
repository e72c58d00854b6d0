"""Model assembly, training forward and decode (torch port of
``repro.models.transformer``).

``init_params`` builds every family -- dense (and the ``vlm``/``audio``
backbones, whose frontends are stubs in the reference too), MoE with GQA
or MLA attention and ``first_k_dense`` leading dense layers, SSM (a
Mamba2 stack) and hybrid (a Mamba2 stack with one shared attention
block).  ``hidden_states``, ``train_loss`` and ``prefill_logits`` run the
training and prefill forward on the stored params as they are, casting
per use as the reference does; ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) and each chunk of the loss.
The decode :class:`Cache`, ``init_cache`` for the ``gqa``, ``mla``,
``ssm`` and ``hybrid`` cache families, the continuous-batching step
``decode_step_ragged`` (``gqa`` caches) and the lock-step ``decode_step``
(every cache family) serve.  Every block norm and the final norm is
``cfg.norm``'s (RMSNorm, or DBRX's bias-free LayerNorm), and a GQA layer
clamps q, k and v to ``cfg.clip_qkv`` when it is set.

Params are the reference's pytree as nested dicts of tensors, layers
stacked on a leading axis (``dense_layers`` holds the leading dense layers
of a ``first_k_dense`` MoE config, ``layers`` the rest; a hybrid's
``shared_attn`` block is one unstacked layer).  Every function that runs
the layers also takes a stack as a list of per-layer trees
(:func:`layer_trees`); the trainer passes per-layer views so that each
layer's gradient is its own tensor.
:func:`compute_params` hands both stacks over as lists of per-layer trees,
so a decode step indexes no stacked tensor, and casts the weights the
reference casts on every use (those >= 2-D per layer) to the compute dtype
once, at load: the values are the same, and the ``.to(dtype)`` calls the
decode path keeps then return their input.  ``init_params`` draws every
matrix straight into ``cfg.param_dtype`` a chunk at a time
(``layers.truncated_normal``), so a full-width MoE config never holds its
experts in float32.

The decode steps update the cache tensors in place (the reference returns
new ones): the ragged step writes slot ``s``'s entry at position
``lengths[s]`` of its own cache rows, the lock-step one every row's at the
shared ``length`` (``layers.write_cache``, shard-locally on a DTensor
cache); an SSM layer overwrites its conv and SSM states.
Under a profiler each piece of a step records its span (``repro_torch.obs``):
``model.embed``, ``model.attn``, ``model.ssm`` (with ``ssm.state_write``),
``model.mlp``, ``model.moe`` and ``model.head``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

__all__ = [
    "Cache",
    "cache_kind",
    "cache_specs",
    "compute_params",
    "decode_step",
    "decode_step_capturable",
    "decode_step_ragged",
    "decode_step_tables",
    "hidden_states",
    "init_cache",
    "init_params",
    "layer_trees",
    "mamba_meta",
    "param_specs",
    "prefill_logits",
    "train_loss",
]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.moe and not cfg.use_merge_sort_dispatch:
        raise ValueError(
            f"{cfg.name}: the port dispatches with the co-rank merge sort "
            "only (use_merge_sort_dispatch=True)")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"{cfg.name}: unknown norm {cfg.norm!r} "
                         "(expected 'rmsnorm' or 'layernorm')")
    if cfg.clip_qkv and cfg.mla:
        raise ValueError(f"{cfg.name}: clip_qkv clamps the GQA projections; "
                         "MLA has none")


def _norm(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The blocks' and the final norm: ``cfg.norm``'s, with its epsilon
    (RMSNorm 1e-6, DBRX's bias-free LayerNorm 1e-5)."""
    if cfg.norm == "layernorm":
        return L.layernorm(params, x)
    return L.rmsnorm(params, x)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _layers_init(gen, cfg: ModelConfig, stack: tuple, device, *, moe: bool):
    """Attention (GQA or MLA), then an MoE FFN (``moe``) or the dense MLP,
    each weight with the leading axes ``stack``: ``(n,)`` for ``n`` stacked
    layers, ``()`` for one unstacked layer (a hybrid's shared block)."""
    dt = _dtype(cfg.param_dtype)
    if cfg.mla:
        ap = mla_mod.init_mla(
            gen, cfg.d_model, cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
            kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
            device=device, layers=stack, dtype=dt)
    else:
        ap = attn_mod.init_gqa(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            device=device, layers=stack, dtype=dt)
    if moe:
        ff = cfg.moe_ff or cfg.d_ff
        mp = moe_mod.init_moe(
            gen, cfg.d_model, ff, cfg.n_experts, n_shared=cfg.n_shared_experts,
            shared_ff=ff * max(cfg.n_shared_experts, 1), device=device,
            layers=stack, dtype=dt)
    else:
        mp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind,
                        device=device, layers=stack, dtype=dt)
    ones = torch.ones((*stack, cfg.d_model), dtype=torch.float32, device=device)
    return {"attn": ap, "mlp": mp, "ln1": {"scale": ones},
            "ln2": {"scale": ones.clone()}}


def _mamba_layers_init(gen, cfg: ModelConfig, device):
    """The SSM stack: ``n_layers`` of ``{"mamba", "ln"}``, stacked."""
    stack = (cfg.n_layers,)
    mp, _ = ssm_mod.init_mamba2(
        gen, cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
        d_state=cfg.ssm_state, ngroups=cfg.ssm_ngroups, device=device,
        layers=stack, dtype=_dtype(cfg.param_dtype))
    return {"mamba": mp, "ln": {"scale": torch.ones(
        (*stack, cfg.d_model), dtype=torch.float32, device=device)}}


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda"):
    """Random weights of ``cfg`` on ``device`` (the card unless the caller
    passes ``"cpu"``), drawn from ``gen``, a generator on that device: the
    reference's tree, dtypes and distributions, not its numbers (torch's
    generators are not JAX's)."""
    _check_ported(cfg)
    dt = _dtype(cfg.param_dtype)
    params: dict[str, Any] = {"embed": L.init_embedding(
        gen, cfg.vocab, cfg.d_model, device=device, dtype=dt)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                             device=device, dtype=dt)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device=device)
    if cfg.frontend != "none":
        params["frontend_proj"] = L.truncated_normal(
            gen, (cfg.d_model, cfg.d_model), 0.02, dt, device=device)
    if cfg.ssm:
        params["layers"] = _mamba_layers_init(gen, cfg, device)
        if cfg.attn_every:  # hybrid: one shared attention + MLP block
            params["shared_attn"] = _layers_init(gen, cfg, (), device,
                                                 moe=False)
        return _cast_params(cfg, params)
    if cfg.moe and cfg.first_k_dense:
        params["dense_layers"] = _layers_init(gen, cfg, (cfg.first_k_dense,),
                                              device, moe=False)
    params["layers"] = _layers_init(
        gen, cfg, (cfg.n_layers - (cfg.first_k_dense if cfg.moe else 0),),
        device, moe=cfg.moe)
    return _cast_params(cfg, params)


def _stacked(specs):
    """Specs of a stack of layers: a leading unsharded layer axis."""
    return _map(lambda s: L.P(None, *s), specs)


def _layer_specs(cfg: ModelConfig, *, moe: bool):
    attn = (mla_mod.mla_specs() if cfg.mla else
            attn_mod.gqa_specs(cfg.qkv_bias, cfg.qk_norm))
    mlp = (moe_mod.moe_specs(cfg.n_shared_experts) if moe
           else L.mlp_specs(cfg.mlp_kind))
    return {"attn": attn, "mlp": mlp, "ln1": L.rmsnorm_specs(),
            "ln2": L.rmsnorm_specs()}


def param_specs(cfg: ModelConfig):
    """The logical :class:`~repro_torch.models.layers.PartitionSpec` of
    every leaf of :func:`init_params`' tree, at the same paths (the
    reference's second return value of ``init_params``)."""
    _check_ported(cfg)
    specs: dict[str, Any] = {"embed": L.embedding_specs()}
    if not cfg.tie_embeddings:
        specs["unembed"] = L.embedding_specs()
    specs["final_norm"] = L.rmsnorm_specs()
    if cfg.frontend != "none":
        specs["frontend_proj"] = L.P("data", None)
    if cfg.ssm:
        specs["layers"] = _stacked({"mamba": ssm_mod.mamba2_specs(),
                                    "ln": L.rmsnorm_specs()})
        if cfg.attn_every:
            specs["shared_attn"] = _layer_specs(cfg, moe=False)
        return specs
    if cfg.moe and cfg.first_k_dense:
        specs["dense_layers"] = _stacked(_layer_specs(cfg, moe=False))
    specs["layers"] = _stacked(_layer_specs(cfg, moe=cfg.moe))
    return specs


def mamba_meta(cfg: ModelConfig) -> dict:
    """The Mamba2 block's dimensions for ``cfg`` (``init_mamba2``'s
    ``meta``)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return dict(
        d_inner=d_inner,
        nheads=d_inner // cfg.ssm_headdim,
        d_state=cfg.ssm_state,
        ngroups=cfg.ssm_ngroups,
        d_conv=4,
        headdim=cfg.ssm_headdim,
        conv_dim=d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state,
    )


def _map(fn, tree):
    if isinstance(tree, L.PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _cast_params(cfg: ModelConfig, params):
    """Store >= 2-D weights in ``cfg.param_dtype``; norms, biases and
    scalars stay float32."""
    dt = _dtype(cfg.param_dtype)
    if dt == torch.float32:
        return params
    return _map(lambda p: p.to(dt) if p.dim() >= 2 and p.dtype == torch.float32
                else p, params)


def compute_params(cfg: ModelConfig, params):
    """``params`` ready for decoding: ``layers`` (and ``dense_layers``) as
    lists of per-layer trees, and every weight that is >= 2-D *per layer*
    (the matrices, the expert stacks, the embedding tables, the QKV biases,
    the Mamba2 conv weights) in the compute dtype ``cfg.dtype`` -- the
    reference's per-use cast, done once.  Norm scales and the Mamba2
    vectors keep their dtype; a hybrid's unstacked ``shared_attn`` block
    is cast the same way."""
    dt = _dtype(cfg.dtype)
    out = dict(params)
    for name in ("dense_layers", "layers"):
        if name in out:
            out[name] = layer_trees(out[name])
    return _map(lambda p: p.to(dt) if p.dim() >= 2 and p.is_floating_point()
                else p, out)


def layer_trees(layers) -> list:
    """A stack of layers as a list of per-layer trees, each leaf a view of
    the stacked tensor; a list is returned as it is."""
    if isinstance(layers, list):
        return layers
    depth = layers
    while isinstance(depth, dict):
        depth = next(iter(depth.values()))
    return [_map(lambda a, i=i: a[i], layers) for i in range(depth.shape[0])]


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------


def _embed_inputs(cfg, params, tokens, frontend_embeds, dtype):
    x = L.embed(params["embed"], tokens, dtype)
    if cfg.frontend != "none" and frontend_embeds is not None:
        fe = torch.einsum("bfd,de->bfe", frontend_embeds.to(dtype),
                          params["frontend_proj"].to(dtype))
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    if cfg.pos_emb == "sinusoidal":
        x = x + _sinusoid_table(x.shape[1], cfg.d_model, dtype, x.device)
    return x


def _dense_attn_block(cfg, lp, x, cos, sin, positions):
    h = _norm(cfg, lp["ln1"], x)
    if cfg.mla:
        dims = dict(qk_nope_head_dim=cfg.qk_nope_head_dim,
                    qk_rope_head_dim=cfg.qk_rope_head_dim)
        a = mla_mod.mla_attention_train(
            lp["attn"], h, cos, sin, positions, dims, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, causal_skip=cfg.causal_skip)
    else:
        q, k, v = attn_mod.qkv_project(lp["attn"], h, cos, sin, positions,
                                       qk_norm=cfg.qk_norm,
                                       clip_qkv=cfg.clip_qkv)
        if cfg.flash_vjp:
            fa = attn_mod.make_flash_attention_vjp(
                causal=True, q_chunk=min(cfg.q_chunk, q.shape[1]),
                kv_chunk=min(cfg.kv_chunk, k.shape[1]))
            o = fa(q, k, v)
        else:
            o = attn_mod.flash_attention(
                q, k, v, causal=True, q_chunk=cfg.q_chunk,
                kv_chunk=cfg.kv_chunk, causal_skip=cfg.causal_skip)
        a = attn_mod.attention_output(lp["attn"], o, x.dtype)
    return x + a


_aten = torch.ops.aten


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products without batch dims (``mm``, ``addmm``, and the
    ``bmm`` of batch 1 that ``torch.einsum`` issues for them); recompute
    the rest."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``cfg.remat`` around ``fn``, when autograd records: ``full`` keeps
    only ``fn``'s inputs and recomputes the rest in the backward; ``dots``
    also keeps the outputs of the products without batch dims (the
    reference's ``dots_with_no_batch_dims_saveable``); ``none`` keeps what
    autograd keeps."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return run


def hidden_states(cfg: ModelConfig, params, tokens: torch.Tensor,
                  frontend_embeds=None) -> torch.Tensor:
    """Token (and frontend) inputs ``(b, s)`` -> the final hidden states
    ``(b, s, d)`` in the compute dtype.  ``params`` are the stored ones
    (stacked, or with the stacks as :func:`layer_trees`); every weight is
    cast where it is used.  A hybrid runs its shared block after every
    ``attn_every``-th Mamba2 layer."""
    _check_ported(cfg)
    dtype = _dtype(cfg.dtype)
    s = tokens.shape[1]
    dev = tokens.device
    x = L.constrain_batch_leading(
        _embed_inputs(cfg, params, tokens, frontend_embeds, dtype))
    cos = sin = None
    if cfg.pos_emb == "rope":
        hd = cfg.qk_rope_head_dim if cfg.mla else cfg.resolved_head_dim
        cos, sin = _rope_tables(hd, s, cfg.rope_theta, dev)
    positions = torch.arange(s, device=dev)[None, :]

    if cfg.ssm:
        meta = mamba_meta(cfg)
        shared = params.get("shared_attn")

        def mamba_body(xx, lp, idx):
            xx = L.constrain_batch_leading(xx)
            out, _ = ssm_mod.mamba2_forward(
                lp["mamba"], meta, _norm(cfg, lp["ln"], xx),
                chunk=cfg.ssm_chunk)
            xx = xx + out
            if cfg.attn_every and (idx + 1) % cfg.attn_every == 0:
                xx = _dense_attn_block(cfg, shared, xx, cos, sin, positions)
                xx = _ffn_block(cfg, shared, xx, moe_layer=False)
            return xx

        body = _remat(cfg, mamba_body)
        for idx, lp in enumerate(layer_trees(params["layers"])):
            x = body(x, lp, idx)
        return _norm(cfg, params["final_norm"], x)

    def block(xx, lp, moe_layer):
        xx = _dense_attn_block(cfg, lp, L.constrain_batch_leading(xx), cos,
                               sin, positions)
        return L.constrain_batch_leading(
            _ffn_block(cfg, lp, xx, moe_layer=moe_layer))

    body = _remat(cfg, block)
    for lp, moe_layer in _layer_list(cfg, params):
        x = body(x, lp, moe_layer)
    return _norm(cfg, params["final_norm"], x)


def _unembed_table(cfg, params):
    return params["embed" if cfg.tie_embeddings else "unembed"]["table"]


def _chunked_ce(cfg, params, hidden, labels, mask, chunk: int = 512):
    """Mean cross-entropy over the unmasked positions, ``chunk`` positions
    at a time: the (b, s, vocab) logits never exist, and under
    ``cfg.remat`` neither do a chunk's float32 logits in the backward."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    table = _unembed_table(cfg, params).to(hidden.dtype)

    def step(hc, yc, mc):
        logits = torch.einsum("bcd,vd->bcv", hc, table).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        return torch.sum((lse - gold) * mc)

    step = _remat(cfg, step)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        mc = mask[:, lo:lo + chunk]
        total = total + step(hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk],
                             mc)
        count = count + torch.sum(mc)
    return total / torch.clamp(count, min=1.0)


def train_loss(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """batch: ``{'tokens': (b, s), 'labels': (b, s), 'mask': (b, s)}`` and
    optionally ``'frontend_embeds': (b, f, d)``; a float32 scalar."""
    hidden = hidden_states(cfg, params, batch["tokens"],
                           batch.get("frontend_embeds"))
    return _chunked_ce(cfg, params, hidden, batch["labels"], batch["mask"])


def prefill_logits(cfg: ModelConfig, params, tokens: torch.Tensor,
                   frontend_embeds=None) -> torch.Tensor:
    """Inference prefill: the full forward, then float32 next-token logits
    ``(b, vocab)`` of the last position only."""
    last = hidden_states(cfg, params, tokens, frontend_embeds)[:, -1, :]
    table = _unembed_table(cfg, params)
    return torch.einsum("bd,vd->bv", last, table.to(last.dtype)).float()


# --------------------------------------------------------------------------
# serving: cache init + decode step
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Cache:
    """Per-family decode cache, stacked over layers: ``kind`` names the
    family, ``data`` holds its tensors, ``length`` the valid positions
    (a scalar, or per-slot ``(b,)`` for the ragged step)."""

    kind: str  # 'gqa' | 'mla' | 'ssm' | 'hybrid'
    data: tuple
    length: torch.Tensor


def cache_kind(cfg: ModelConfig) -> str:
    """The decode-cache family of ``cfg`` (what ``init_cache`` builds)."""
    if cfg.ssm:
        return "hybrid" if cfg.attn_every else "ssm"
    return "mla" if cfg.mla else "gqa"


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    """Zeroed decode cache on ``device``, length a scalar 0.  ``gqa``: k
    and v ``(n_layers, batch, max_len, n_kv, head_dim)``; ``mla``: the
    latent ``(n_layers, batch, max_len, kv_lora_rank)`` and the rope key
    ``(n_layers, batch, max_len, qk_rope_head_dim)``; ``ssm``: the conv
    state ``(n_layers, batch, 3, conv_dim)`` in ``dtype`` and the SSM state
    ``(n_layers, batch, nheads, headdim, d_state)`` in float32; ``hybrid``:
    those, then the shared block's k and v, one entry per application,
    ``(n_layers // attn_every, batch, max_len, n_kv, head_dim)``."""
    kind = cache_kind(cfg)
    ll = cfg.n_layers
    kv = ((batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim), dtype)
    if kind == "mla":
        specs = [((ll, batch, max_len, cfg.kv_lora_rank), dtype),
                 ((ll, batch, max_len, cfg.qk_rope_head_dim), dtype)]
    elif kind == "gqa":
        specs = [((ll, *kv[0]), dtype)] * 2
    else:
        meta = mamba_meta(cfg)
        specs = [((ll, batch, meta["d_conv"] - 1, meta["conv_dim"]), dtype),
                 ((ll, batch, meta["nheads"], meta["headdim"],
                   meta["d_state"]), torch.float32)]
        if kind == "hybrid":
            specs += [((ll // cfg.attn_every, *kv[0]), dtype)] * 2
    return Cache(kind, tuple(torch.zeros(shape, dtype=dt, device=device)
                             for shape, dt in specs),
                 torch.zeros((), dtype=torch.int32, device=device))


def cache_specs(cfg: ModelConfig, batch_axes) -> Cache:
    """Logical specs of :func:`init_cache`'s tensors, as a :class:`Cache`
    whose ``length`` is ``P()``.

    KV caches are *sequence-sharded* on the model axis (decode-time
    sequence parallelism): the GQA archs have ``n_kv`` = 8 < 16-way TP, so
    head sharding cannot use the mesh, while the 32k/500k sequence always
    divides it.
    """
    ba = batch_axes
    kind = cache_kind(cfg)
    if kind in ("ssm", "hybrid"):
        data = (L.P(None, ba, None, "model"), L.P(None, ba, "model", None, None))
        if kind == "hybrid":
            data += (L.P(None, ba, "model", None, None),) * 2
    elif kind == "mla":
        data = (L.P(None, ba, "model", None),) * 2
    else:
        data = (L.P(None, ba, "model", None, None),) * 2
    return Cache(kind, data, L.P())


def _cache_max_len(cache: Cache) -> int:
    """Positions the cache holds: the k/v (or latent) length, 1 for an
    attention-free ``ssm`` cache."""
    if cache.kind in ("gqa", "hybrid"):
        return cache.data[-1].shape[2]
    if cache.kind == "mla":
        return cache.data[0].shape[2]
    return 1


def _uncached_under_fake(fn):
    """``fn`` cached per arguments, except under a fake mode (a dry-run
    trace), whose tensors must neither enter the cache nor leave it."""
    cached = functools.lru_cache(maxsize=16)(fn)

    @functools.wraps(fn)
    def get(*args):
        from torch._guards import active_fake_mode

        return fn(*args) if active_fake_mode() is not None else cached(*args)

    return get


@_uncached_under_fake
def _rope_tables(head_dim: int, max_pos: int, theta: float, device):
    return L.rope_frequencies(head_dim, max_pos, theta, device=device)


@_uncached_under_fake
def _sinusoid_table(seq: int, d: int, dtype, device):
    return L.sinusoidal_positions(seq, d, dtype, device=device)


def decode_step_tables(cfg: ModelConfig, cache: Cache, device) -> tuple:
    """The position tables a decode step on ``cache`` reads, from their
    cache: ``(table,)`` of sinusoidal positions or the rope ``(cos, sin)``,
    for the cache's ``max_len``.  A captured step holds them, so that no
    eviction from the cache frees them while it replays."""
    max_len = _cache_max_len(cache)
    if cfg.pos_emb == "sinusoidal":
        return (_sinusoid_table(max_len + 1, cfg.d_model, _dtype(cfg.dtype),
                                device),)
    hd = cfg.qk_rope_head_dim if cfg.mla else cfg.resolved_head_dim
    return tuple(_rope_tables(hd, max_len + 1, cfg.rope_theta, device))


def decode_step_capturable(cfg: ModelConfig, cache: Cache) -> bool:
    """Whether :func:`decode_step` on ``cache`` can be captured as a CUDA
    graph: an ``ssm`` or ``hybrid`` cache of a model without MoE layers,
    whose dispatch reads segment sizes on the host."""
    return cache.kind in ("ssm", "hybrid") and not cfg.moe


def _embed_and_tables(cfg, params, cache, tokens, pos):
    """Token embeddings (plus sinusoidal positions at ``pos``, a ``(b,)``
    or scalar tensor) and the rope tables for the cache's ``max_len``."""
    with obs.span("model.embed"):
        x = L.embed(params["embed"], tokens, _dtype(cfg.dtype))
        tables = decode_step_tables(cfg, cache, tokens.device)
        if cfg.pos_emb == "sinusoidal":
            return x + tables[0][pos].reshape(-1, 1, cfg.d_model), None, None
        return x, *tables


def _logits(cfg, params, x):
    with obs.span("model.head"):
        h = _norm(cfg, params["final_norm"], x)
        table = params["embed" if cfg.tie_embeddings else "unembed"]["table"]
        logits = torch.einsum("bsd,vd->bsv", h, table.to(_dtype(cfg.dtype)))
        return logits[:, 0].float()


def _layer_list(cfg, params):
    """``(layer params, is an MoE layer)`` in cache order: the leading
    dense layers of a ``first_k_dense`` config first."""
    return ([(lp, False) for lp in layer_trees(params.get("dense_layers", []))]
            + [(lp, cfg.moe) for lp in layer_trees(params["layers"])])


def _ffn_block(cfg, lp, x, *, moe_layer):
    with obs.span("model.moe" if moe_layer else "model.mlp"):
        h = _norm(cfg, lp["ln2"], x)
        if moe_layer:
            ff = moe_mod.moe_apply(
                lp["mlp"], h, n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.capacity_factor,
                scoring=cfg.router_scoring,
                dispatch_groups=cfg.moe_dispatch_groups,
                dispatch=cfg.moe_dispatch)
        else:
            ff = L.mlp(lp["mlp"], h, kind=cfg.mlp_kind)
        return x + ff


def decode_step_ragged(cfg: ModelConfig, params, cache: Cache,
                       tokens: torch.Tensor, lengths: torch.Tensor):
    """One token for every *slot* at per-slot positions (continuous
    batching).  ``params`` as :func:`compute_params` returns them.
    tokens: (b, 1); lengths: (b,) int32 per-slot cache lengths
    -- slot ``b``'s token is written at position ``lengths[b]`` and
    attends over ``lengths[b] + 1`` cache entries.  Returns ``(logits
    (b, vocab) float32, cache)``: the same cache tensors, updated in place,
    with ``length == lengths + 1`` for every slot (the serving engine holds
    back the lengths of inactive slots itself).

    Only the ``gqa`` cache family (dense and MoE configs) has per-slot
    positions; other caches raise, as in the reference.
    """
    if cache.kind != "gqa":
        raise NotImplementedError(
            f"continuous-batching decode supports the 'gqa' cache family; "
            f"got {cache.kind!r} (use the lock-step decode_step path)")
    _check_ported(cfg)
    lengths = lengths.to(device=tokens.device, dtype=torch.int32)
    x, cos, sin = _embed_and_tables(cfg, params, cache, tokens, lengths)
    kc, vc = cache.data
    rows = torch.arange(x.shape[0], device=x.device)
    idx = lengths.long()
    positions = lengths[:, None]  # (b, 1): per-slot rope positions
    for i, (lp, moe_layer) in enumerate(_layer_list(cfg, params)):
        with obs.span("model.attn"):
            h = _norm(cfg, lp["ln1"], x)
            q, k, v = attn_mod.qkv_project(lp["attn"], h, cos, sin, positions,
                                           qk_norm=cfg.qk_norm,
                                           clip_qkv=cfg.clip_qkv)
            # per-slot scatter: slot b's token lands at its own position
            L.write_cache((kc[i], vc[i]), (k, v), idx, rows)
            o = attn_mod.decode_attention(q, kc[i], vc[i], lengths + 1)
            x = x + attn_mod.attention_output(lp["attn"], o, x.dtype)
        x = _ffn_block(cfg, lp, x, moe_layer=moe_layer)
    return _logits(cfg, params, x), Cache("gqa", cache.data, lengths + 1)


def decode_step(cfg: ModelConfig, params, cache: Cache,
                tokens: torch.Tensor):
    """One token for every row at the shared position ``cache.length``
    (the lock-step batch path).  ``params`` as :func:`compute_params`
    returns them; tokens ``(b, 1)``.  Returns ``(logits (b, vocab)
    float32, cache)``: the same cache tensors, updated in place, with the
    length one higher.  A ``gqa`` cache takes :func:`decode_step_ragged`
    with every slot at that length; an ``mla`` cache runs the absorbed MLA
    decode; ``ssm`` and ``hybrid`` caches run the Mamba2 recurrence (and
    the hybrid's shared attention block)."""
    if cache.kind not in ("gqa", "mla", "ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: unknown decode cache kind "
                         f"{cache.kind!r}")
    _check_ported(cfg)
    pos = cache.length.to(tokens.device)
    b = tokens.shape[0]
    if cache.kind == "gqa":
        logits, _ = decode_step_ragged(cfg, params, cache, tokens,
                                       pos.expand(b))
        return logits, Cache("gqa", cache.data, pos + 1)
    x, cos, sin = _embed_and_tables(cfg, params, cache, tokens, pos)
    positions = pos.reshape(1, 1).expand(b, 1)
    decode = _decode_mla if cache.kind == "mla" else _decode_ssm
    x = decode(cfg, params, cache.data, x, cos, sin, positions, pos)
    return _logits(cfg, params, x), Cache(cache.kind, cache.data, pos + 1)


def _decode_mla(cfg, params, data, x, cos, sin, positions, pos):
    at = pos.reshape(1).long()  # the cache position written this step
    dims = dict(qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim)
    ckv, kr = data
    for i, (lp, moe_layer) in enumerate(_layer_list(cfg, params)):
        with obs.span("model.attn"):
            h = _norm(cfg, lp["ln1"], x)
            q_nope, q_rope, c_kv, k_rope = mla_mod.mla_latents(
                lp["attn"], h, cos, sin, positions, dims)
            L.write_cache((ckv[i], kr[i]), (c_kv, k_rope), at)
            o = mla_mod.mla_attention_decode(lp["attn"], q_nope, q_rope, dims,
                                             ckv[i], kr[i], pos + 1)
            x = x + o
        x = _ffn_block(cfg, lp, x, moe_layer=moe_layer)
    return x


def _decode_ssm(cfg, params, data, x, cos, sin, positions, pos):
    """The Mamba2 stack, one token: each layer's conv and SSM states are
    overwritten in place (``mamba2_decode_``; on the card the SSM state by
    one kernel that reads and writes it once).  In a hybrid, the shared
    attention block runs after every ``attn_every``-th layer (application
    ``idx // attn_every`` after layer ``idx``), on its own k/v entry of the
    cache."""
    meta = mamba_meta(cfg)
    conv_c, st_c = data[:2]
    for i, lp in enumerate(params["layers"]):
        with obs.span("model.ssm"):
            h = _norm(cfg, lp["ln"], x)
            x = x + ssm_mod.mamba2_decode_(lp["mamba"], meta, h, conv_c[i],
                                           st_c[i])
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            app = i // cfg.attn_every
            x = _shared_attention(cfg, params["shared_attn"], data[2][app],
                                  data[3][app], x, cos, sin, positions, pos)
    return x


def _shared_attention(cfg, lp, kc, vc, x, cos, sin, positions, pos):
    """The hybrid's shared block (GQA attention, then the MLP) at the
    shared position ``pos``, writing its k/v into ``kc``/``vc``."""
    at = pos.reshape(1).long()
    with obs.span("model.attn"):
        h = _norm(cfg, lp["ln1"], x)
        q, k, v = attn_mod.qkv_project(lp["attn"], h, cos, sin, positions,
                                       qk_norm=cfg.qk_norm,
                                       clip_qkv=cfg.clip_qkv)
        L.write_cache((kc, vc), (k, v), at)
        o = attn_mod.decode_attention(q, kc, vc, pos + 1)
        x = x + attn_mod.attention_output(lp["attn"], o, x.dtype)
    return _ffn_block(cfg, lp, x, moe_layer=False)
