"""Multi-head Latent Attention (torch port of ``repro.models.mla``).

Training and prefill (:func:`mla_attention_train`) decompress the latent
``c_kv`` into per-head K and V and run the chunked flash attention (qk
head dim ``nope + rope``, v head dim ``v_head_dim``).  Decode uses the
*absorbed* form: ``W_uk`` is folded into the query and ``W_uv`` into the
output, so attention runs directly against the compressed cache,
``kv_lora_rank + qk_rope_head_dim`` values per token.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.attention import flash_attention
from repro_torch.models.layers import P, apply_rope, rmsnorm, truncated_normal

__all__ = ["init_mla", "mla_specs", "mla_latents", "mla_attention_train",
           "mla_attention_decode"]


def init_mla(gen, d, n_heads, *, q_lora_rank, kv_lora_rank,
             qk_nope_head_dim, qk_rope_head_dim, v_head_dim, device,
             layers: tuple = (), dtype=torch.float32):
    """MLA weights, the projections stored in ``dtype`` and the two latent
    norms in float32; ``layers`` prepends stacked-layer axes to each."""
    qk_head_dim = qk_nope_head_dim + qk_rope_head_dim
    std_d = 1.0 / math.sqrt(d)

    def draw(shape, std):
        return truncated_normal(gen, (*layers, *shape), std, dtype,
                                device=device)

    def ones(n):
        return torch.ones((*layers, n), dtype=torch.float32, device=device)

    return {
        "w_dq": draw((d, q_lora_rank), std_d),
        "q_norm": ones(q_lora_rank),
        "w_uq": draw((q_lora_rank, n_heads, qk_head_dim),
                     1.0 / math.sqrt(q_lora_rank)),
        "w_dkv": draw((d, kv_lora_rank), std_d),
        "kv_norm": ones(kv_lora_rank),
        "w_krope": draw((d, qk_rope_head_dim), std_d),
        "w_uk": draw((kv_lora_rank, n_heads, qk_nope_head_dim),
                     1.0 / math.sqrt(kv_lora_rank)),
        "w_uv": draw((kv_lora_rank, n_heads, v_head_dim),
                     1.0 / math.sqrt(kv_lora_rank)),
        "wo": draw((n_heads, v_head_dim, d),
                   1.0 / math.sqrt(n_heads * v_head_dim)),
    }


def mla_specs():
    """Logical specs of :func:`init_mla`'s tree."""
    return {"w_dq": P("data", "model"), "q_norm": P(None),
            "w_uq": P(None, "model", None), "w_dkv": P("data", None),
            "kv_norm": P(None), "w_krope": P("data", None),
            "w_uk": P(None, "model", None), "w_uv": P(None, "model", None),
            "wo": P("model", None, "data")}


def mla_latents(params, x, cos, sin, positions, dims):
    """Shared front half: queries, the compressed KV latent and the rope
    key.  Returns ``q_nope (b,s,h,dn)``, ``q_rope (b,s,h,dr)``, ``c_kv
    (b,s,r)`` and ``k_rope (b,s,dr)``; the last two are what the decode
    cache stores."""
    dt = x.dtype
    cq = torch.einsum("bsd,dr->bsr", x, params["w_dq"].to(dt))
    cq = rmsnorm({"scale": params["q_norm"]}, cq)
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"].to(dt))
    dn = dims["qk_nope_head_dim"]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, cos, sin, positions)

    c_kv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"].to(dt))
    c_kv = rmsnorm({"scale": params["kv_norm"]}, c_kv)
    k_rope = torch.einsum("bsd,dk->bsk", x, params["w_krope"].to(dt))
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin, positions)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_attention_train(params, x, cos, sin, positions, dims, *,
                        q_chunk=1024, kv_chunk=1024, causal_skip=False):
    """Prefill/train path: decompress K/V, flash attention, output
    projection.  x ``(b, s, d)`` -> ``(b, s, d)``."""
    dt = x.dtype
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = mla_latents(params, x, cos, sin,
                                               positions, dims)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"].to(dt))
    h = q_nope.shape[2]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    attn = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                           kv_chunk=kv_chunk, causal_skip=causal_skip)
    return torch.einsum("bshk,hkd->bsd", attn, params["wo"].to(dt))


def mla_attention_decode(params, q_nope, q_rope, dims, ckv_cache,
                         krope_cache, cache_len):
    """Absorbed decode against the compressed cache, from the queries
    :func:`mla_latents` gave (the caller writes its ``c_kv`` and ``k_rope``
    into the cache first, so each layer computes the latents once).

    q_nope ``(b, 1, h, dn)``, q_rope ``(b, 1, h, dr)``; ckv_cache ``(b,
    smax, r)``; krope_cache ``(b, smax, dr)``; positions at or past
    ``cache_len`` are masked.  Returns ``out (b, 1, d)``.  A cache stored in
    another dtype than the queries meets them in the promoted dtype, as in
    JAX.
    """
    dt = q_nope.dtype
    ct = torch.promote_types(dt, ckv_cache.dtype)
    ckv = ckv_cache.to(ct)
    # absorb W_uk into the query: (b,1,h,dn) x (r,h,dn) -> (b,1,h,r)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(dt))
    scale = 1.0 / math.sqrt(dims["qk_nope_head_dim"] + dims["qk_rope_head_dim"])
    s_lat = torch.einsum("bshr,bkr->bshk", q_abs.to(ct), ckv)
    s_rope = torch.einsum("bshd,bkd->bshk", q_rope.to(ct),
                          krope_cache.to(ct))
    scores = (s_lat + s_rope).float() * scale  # (b, 1, h, smax)
    pos = torch.arange(ckv_cache.shape[1], dtype=torch.int32,
                       device=q_nope.device)
    scores = scores.masked_fill(~(pos < cache_len), float("-inf"))
    p = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bshk,bkr->bshr", p.to(ct), ckv)  # (b, 1, h, r)
    # absorb W_uv on the way out: (b,1,h,r) x (r,h,dv) -> (b,1,h,dv)
    out_h = torch.einsum("bshr,rhk->bshk", ctx.to(dt), params["w_uv"].to(dt))
    return torch.einsum("bshk,hkd->bsd", out_h, params["wo"].to(dt))
