"""GQA attention, decode path (torch port of ``repro.models.attention``).

GQA is written with a (kv_head, group) layout: the cache is never
repeated up to ``n_heads``.  The products are ``torch.einsum`` calls, as
the reference leaves them to XLA.  The reference's chunked
``flash_attention`` and its VJP serve prefill and training and are not
ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (
    apply_rope,
    init_rmsnorm,
    rmsnorm,
    truncated_normal,
)

__all__ = ["init_gqa", "qkv_project", "attention_output", "decode_attention"]


def init_gqa(gen, d, n_heads, n_kv, head_dim, qkv_bias=False, qk_norm=False,
             *, device, layers: tuple = (), dtype=torch.float32):
    """GQA weights, the projections stored in ``dtype``; ``layers``
    prepends stacked-layer axes to each."""
    std = 1.0 / math.sqrt(d)
    p = {
        "wq": truncated_normal(gen, (*layers, d, n_heads, head_dim), std,
                               dtype, device=device),
        "wk": truncated_normal(gen, (*layers, d, n_kv, head_dim), std,
                               dtype, device=device),
        "wv": truncated_normal(gen, (*layers, d, n_kv, head_dim), std,
                               dtype, device=device),
        "wo": truncated_normal(gen, (*layers, n_heads, head_dim, d),
                               1.0 / math.sqrt(n_heads * head_dim), dtype,
                               device=device),
    }
    zeros = dict(dtype=torch.float32, device=device)
    if qkv_bias:
        p["bq"] = torch.zeros((*layers, n_heads, head_dim), **zeros)
        p["bk"] = torch.zeros((*layers, n_kv, head_dim), **zeros)
        p["bv"] = torch.zeros((*layers, n_kv, head_dim), **zeros)
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = {"scale": init_rmsnorm(head_dim, device=device)["scale"]
                       .expand(*layers, head_dim).clone()}
    return p


def qkv_project(params, x, cos, sin, positions, qk_norm=False):
    """x (b, s, d) -> q (b, s, h, hd), k and v (b, s, n_kv, hd): q and k
    RMS-normalised per head (``qk_norm``), then rotated."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cos is not None:
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    return q, k, v


def attention_output(params, attn, x_dtype):
    return torch.einsum("bshk,hkd->bsd", attn, params["wo"].to(x_dtype))


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q (b, 1, h, hd) vs cache (b, smax, n_kv, hd).

    GQA-native: the cache is read as it is, never repeated to ``n_heads``.
    ``cache_len`` is the number of valid cache positions, a scalar or
    per-slot ``(b,)`` lengths; positions at or past it are masked with
    ``-inf``.  The softmax is taken in float32.  A cache stored in another
    dtype than ``q`` meets it in the promoted dtype, as in JAX.
    """
    b, _, h, hd = q.shape
    smax, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = h // n_kv
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    qg = (q[:, 0] / math.sqrt(hd)).reshape(b, n_kv, g, hd)
    s = torch.einsum("bcgd,bkcd->bcgk", qg.to(ct), k_cache.to(ct)).float()
    pos = torch.arange(smax, dtype=torch.int32, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.dim():  # per-slot lengths -> (b, 1, 1, 1) against (..., smax)
        cl = cl.reshape(b, 1, 1, 1)
    s = s.masked_fill(~(pos < cl), float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    vt = torch.promote_types(q.dtype, v_cache.dtype)
    out = torch.einsum("bcgk,bkcd->bcgd", p.to(vt), v_cache.to(vt))
    return out.reshape(b, 1, h, hd)
