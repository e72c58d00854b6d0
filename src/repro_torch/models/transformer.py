"""Model assembly, dense GQA decode (torch port of ``repro.models.transformer``).

What is ported: ``init_params`` for the dense families (``dense``, and the
``vlm``/``audio`` backbones, whose frontends are stubs in the reference
too), ``_cast_params``, the decode :class:`Cache`, ``init_cache`` for the
``gqa`` cache family and the continuous-batching decode step
``decode_step_ragged``.  MLA, SSM and hybrid caches, MoE layers, the
lock-step ``decode_step``, ``prefill_logits`` and ``train_loss`` raise
``NotImplementedError``: they are items of ROADMAP.md's Queue 1.

Params are the reference's pytree as nested dicts of tensors, layers
stacked on a leading axis.  :func:`compute_params` hands the layers over
as a list of per-layer trees, so a decode step indexes no stacked tensor,
and casts the weights the reference casts on every use (those >= 2-D per
layer) to the compute dtype once, at load: the values are the same, and
the ``.to(dtype)`` calls the decode path keeps then return their input.

The decode step updates the cache tensors in place (the reference returns
new ones): slot ``s``'s key and value land at position ``lengths[s]`` of
its own cache rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L

__all__ = [
    "Cache",
    "cache_kind",
    "compute_params",
    "decode_step_ragged",
    "init_cache",
    "init_params",
]

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue 1 item 3)"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check_dense(cfg: ModelConfig) -> None:
    for flag, what in ((cfg.ssm, "the SSM/hybrid family"),
                       (cfg.mla, "MLA attention"), (cfg.moe, "the MoE layer")):
        if flag:
            raise NotImplementedError(f"{cfg.name}: {what} {_NOT_PORTED}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _dense_layers_init(gen, cfg: ModelConfig, n: int, device):
    """``n`` dense layers, each weight stacked on a leading axis."""
    stack = (n,)
    ap = attn_mod.init_gqa(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, device=device,
        layers=stack,
    )
    mp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind,
                    device=device, layers=stack)
    ones = torch.ones((n, cfg.d_model), dtype=torch.float32, device=device)
    return {"attn": ap, "mlp": mp, "ln1": {"scale": ones},
            "ln2": {"scale": ones.clone()}}


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda"):
    """Random weights of a dense config on ``device`` (the card unless the
    caller passes ``"cpu"``), drawn from ``gen``, a generator on that
    device: the reference's tree and distributions, not its numbers
    (torch's generators are not JAX's)."""
    _check_dense(cfg)
    params: dict[str, Any] = {"embed": L.init_embedding(
        gen, cfg.vocab, cfg.d_model, device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                             device=device)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device=device)
    if cfg.frontend != "none":
        params["frontend_proj"] = L.truncated_normal(
            gen, (cfg.d_model, cfg.d_model), 0.02, device=device)
    params["layers"] = _dense_layers_init(gen, cfg, cfg.n_layers, device)
    return _cast_params(cfg, params)


def _map(fn, tree):
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
    """``params`` ready for decoding: ``layers`` as a list of per-layer
    trees, and every weight that is >= 2-D *per layer* (the matrices, the
    embedding tables, the QKV biases) in the compute dtype ``cfg.dtype`` --
    the reference's per-use cast, done once.  Norm scales stay float32."""
    dt = _dtype(cfg.dtype)
    out = dict(params)
    layers = out["layers"]
    if isinstance(layers, dict):
        layers = [_map(lambda a, i=i: a[i], layers)
                  for i in range(_depth(layers))]
    out["layers"] = layers
    return _map(lambda p: p.to(dt) if p.dim() >= 2 and p.is_floating_point()
                else p, out)


def _depth(layers) -> int:
    while isinstance(layers, dict):
        layers = next(iter(layers.values()))
    return layers.shape[0]


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
    """Zeroed ``gqa`` cache on ``device``: k and v ``(n_layers, batch,
    max_len, n_kv, head_dim)``, length a scalar 0.  Other families raise."""
    kind = cache_kind(cfg)
    if kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: the {kind!r} decode cache {_NOT_PORTED}")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    return Cache("gqa", (k, v),
                 torch.zeros((), dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=16)
def _rope_tables(head_dim: int, max_pos: int, theta: float, device):
    return L.rope_frequencies(head_dim, max_pos, theta, device=device)


@functools.lru_cache(maxsize=16)
def _sinusoid_table(seq: int, d: int, dtype, device):
    return L.sinusoidal_positions(seq, d, dtype, device=device)


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

    Only the ``gqa`` cache family has per-slot positions; other caches
    raise, as in the reference.
    """
    if cache.kind != "gqa":
        raise NotImplementedError(
            f"continuous-batching decode supports the 'gqa' cache family; "
            f"got {cache.kind!r}")
    _check_dense(cfg)
    dtype = _dtype(cfg.dtype)
    dev = tokens.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    x = L.embed(params["embed"], tokens, dtype)
    max_len = cache.data[-1].shape[2]
    if cfg.pos_emb == "sinusoidal":
        table = _sinusoid_table(max_len + 1, cfg.d_model, dtype, dev)
        x = x + table[lengths][:, None, :]
        cos = sin = None
    else:
        cos, sin = _rope_tables(cfg.resolved_head_dim, max_len + 1,
                                cfg.rope_theta, dev)
    positions = lengths[:, None]  # (b, 1): per-slot rope positions
    x = _decode_gqa_ragged(cfg, params, cache, x, cos, sin, positions,
                           lengths)
    h = L.rmsnorm(params["final_norm"], x)
    table = params["embed" if cfg.tie_embeddings else "unembed"]["table"]
    logits = torch.einsum("bsd,vd->bsv", h, table.to(dtype))
    return logits[:, 0].float(), Cache("gqa", cache.data, lengths + 1)


def _decode_gqa_ragged(cfg, params, cache, x, cos, sin, positions, lengths):
    kc, vc = cache.data
    rows = torch.arange(x.shape[0], device=x.device)
    idx = lengths.long()
    for i, lp in enumerate(params["layers"]):
        h = L.rmsnorm(lp["ln1"], x)
        q, k, v = attn_mod.qkv_project(lp["attn"], h, cos, sin, positions,
                                       qk_norm=cfg.qk_norm)
        # per-slot scatter: slot b's token lands at its own position
        kc[i, rows, idx] = k[:, 0].to(kc.dtype)
        vc[i, rows, idx] = v[:, 0].to(vc.dtype)
        o = attn_mod.decode_attention(q, kc[i], vc[i], lengths + 1)
        x = x + attn_mod.attention_output(lp["attn"], o, x.dtype)
        x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x), kind=cfg.mlp_kind)
    return x
