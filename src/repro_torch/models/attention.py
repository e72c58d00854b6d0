"""GQA attention: chunked online softmax for prefill and training, and
the decode path (torch port of ``repro.models.attention``).

``flash_attention`` never materialises the full (S, S) score matrix: a
loop over query chunks and an inner loop over KV chunks carry the online
softmax statistics (running max and normaliser), so the live scores are
``q_chunk x kv_chunk`` per head.  ``causal_skip`` skips the KV chunks
wholly above the diagonal.  ``make_flash_attention_vjp`` is the same
forward as an autograd function whose backward recomputes the
probabilities chunk by chunk from the saved ``out``, ``m`` and ``l``.

GQA is written with a (kv_head, group) layout: K and V are never
repeated up to ``n_heads``.  The products are ``torch.einsum`` calls, as
the reference leaves them to XLA, and every cast is the reference's.
DTensors attend on each rank's own rows and heads
(``layers.on_local_shards`` on ``layers.row_head_layout``).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.models.layers import (
    P,
    apply_rope,
    init_rmsnorm,
    is_dtensor,
    layout_placements,
    on_local_shards,
    rmsnorm,
    rmsnorm_specs,
    row_head_layout,
    truncated_normal,
)

__all__ = [
    "init_gqa",
    "gqa_specs",
    "qkv_project",
    "flash_attention",
    "make_flash_attention_vjp",
    "attention_output",
    "decode_attention",
]


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


def gqa_specs(qkv_bias=False, qk_norm=False):
    """Logical specs of :func:`init_gqa`'s tree (heads on ``model``, d
    on ``data``)."""
    s = {"wq": P("data", "model", None), "wk": P("data", "model", None),
         "wv": P("data", "model", None), "wo": P("model", None, "data")}
    if qkv_bias:
        s.update(bq=P("model", None), bk=P("model", None),
                 bv=P("model", None))
    if qk_norm:
        s.update(q_norm=rmsnorm_specs(), k_norm=rmsnorm_specs())
    return s


def qkv_project(params, x, cos, sin, positions, qk_norm=False,
                clip_qkv=0.0):
    """x (b, s, d) -> q (b, s, h, hd), k and v (b, s, n_kv, hd): with
    their biases, clamped to ``+-clip_qkv`` when it is set (DBRX's clamp
    of its fused QKV output), q and k RMS-normalised per head
    (``qk_norm``), then rotated."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if clip_qkv:
        q, k, v = (t.clamp(-clip_qkv, clip_qkv) for t in (q, k, v))
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cos is not None:
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    return q, k, v


def _on_local_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` for DTensor inputs, run on each rank's local
    batch rows and query heads (q's layout, :func:`row_head_layout`): no
    op of the attention goes through DTensor, which cannot flatten a batch
    dim and a head dim that are both sharded.  k and v follow q, their
    heads repeated for each query head's group when the kv heads do not
    divide over the head shards (8 kv heads, 32 query heads over a
    16-wide ``model`` axis)."""
    mesh = q.device_mesh
    tags = row_head_layout(mesh, q.placements, 2)
    ways = math.prod(mesh.size(i) for i, t in enumerate(tags) if t == "heads")
    if k.shape[2] % ways:
        g = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    pl = layout_placements(tags, 0, 2)
    return on_local_shards(functools.partial(fn, **kw), mesh,
                           [(q, pl), (k, pl), (v, pl)], pl)


def _chunk_layout(q, k, v, q_chunk, kv_chunk):
    """Sizes and the chunked views: q ``(b, nq, qc, n_kv, g, hd)``, k
    ``(b, nkv, kc, n_kv, hd)``, v ``(b, nkv, kc, n_kv, hdv)``."""
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    hdv = v.shape[3]  # v head dim may differ from the qk head dim (MLA)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"sequence lengths {sq}, {skv} are not multiples "
                         f"of the chunks {q_chunk}, {kv_chunk}")
    g = h // n_kv
    nq, nkv = sq // q_chunk, skv // kv_chunk
    dims = (b, nq, nkv, n_kv, g, hd, hdv)
    return (dims, q.reshape(b, nq, q_chunk, n_kv, g, hd),
            k.reshape(b, nkv, kv_chunk, n_kv, hd),
            v.reshape(b, nkv, kv_chunk, n_kv, hdv))


def _masked_scores(qi, kc, causal, q0, k0):
    """Scores ``(b, n_kv, g, qc, kc)`` in float32 of a query chunk starting
    at position ``q0`` against a KV chunk starting at ``k0``; ``-inf``
    above the diagonal when ``causal``."""
    s = torch.einsum("bqcgd,bkcd->bcgqk", qi, kc).float()
    if causal:
        qp = torch.arange(q0, q0 + qi.shape[1], device=qi.device)
        kp = torch.arange(k0, k0 + kc.shape[1], device=qi.device)
        s = s.masked_fill(qp[:, None] < kp[None, :], float("-inf"))
    return s


def _safe(m):
    return torch.where(torch.isfinite(m), m, 0.0)


def _online_softmax(qi, kr, vr, q0, kv_hi, causal):
    """One query chunk over the first ``kv_hi`` KV chunks: ``(acc, m, l)``
    with ``acc`` ``(b, n_kv, g, qc, hdv)`` and ``m``, ``l`` ``(b, n_kv, g,
    qc)``, all float32.  The running max only shifts the exponent, so it
    is taken without a gradient: the output does not depend on it, and
    autograd then keeps no float32 copy of the scores for it."""
    b, qc, n_kv, g, _ = qi.shape
    kc = kr.shape[2]
    dev = qi.device
    acc = torch.zeros((b, n_kv, g, qc, vr.shape[-1]), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, n_kv, g, qc), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, n_kv, g, qc), dtype=torch.float32, device=dev)
    for j in range(kv_hi):
        s = _masked_scores(qi, kr[:, j], causal, q0, j * kc)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        safe_m = _safe(m_new)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bcgqk,bkcd->bcgqd", p.to(qi.dtype), vr[:, j]).float()
        m = m_new
    return acc, m, l


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024, causal_skip: bool = False):
    """Chunked online-softmax attention (GQA-native).

    q: (b, sq, h, hd); k: (b, skv, n_kv, hd); v: (b, skv, n_kv, hdv).
    Returns (b, sq, h, hdv) in ``q``'s dtype.  ``causal_skip`` (with
    ``causal`` and more than one query chunk) runs each query chunk only
    over the KV chunks that reach its last position.  Autograd
    differentiates the loops as they are; :func:`make_flash_attention_vjp`
    is the form that recomputes the probabilities instead.
    """
    if is_dtensor(q):
        return _on_local_heads(flash_attention, q, k, v, causal=causal,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               causal_skip=causal_skip)
    q_chunk = min(q_chunk, q.shape[1])
    kv_chunk = min(kv_chunk, k.shape[1])
    (b, nq, nkv, _, _, _, hdv), qr, kr, vr = _chunk_layout(
        q * (1.0 / math.sqrt(q.shape[3])), k, v, q_chunk, kv_chunk)
    skip = causal_skip and causal and nq > 1
    outs = []
    for i in range(nq):
        kv_hi = (min(nkv, ((i + 1) * q_chunk + kv_chunk - 1) // kv_chunk)
                 if skip else nkv)
        acc, _, l = _online_softmax(qr[:, i], kr, vr, i * q_chunk, kv_hi,
                                    causal)
        out = acc / torch.clamp(l, min=1e-37)[..., None]
        # (b, n_kv, g, qc, hdv) -> (b, qc, n_kv, g, hdv)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.stack(outs, dim=1).reshape(b, q.shape[1], -1, hdv)


def _flash_fwd_chunked(q, k, v, causal, q_chunk, kv_chunk):
    """Forward returning ``(out, ms, ls)``; ``ms`` and ``ls`` are ``(nq,
    b, n_kv, g, qc)`` float32."""
    (b, nq, _, _, _, _, hdv), qr, kr, vr = _chunk_layout(
        q * (1.0 / math.sqrt(q.shape[3])), k, v, q_chunk, kv_chunk)
    outs, ms, ls = [], [], []
    for i in range(nq):
        acc, m, l = _online_softmax(qr[:, i], kr, vr, i * q_chunk,
                                    kr.shape[1], causal)
        outs.append((acc / torch.clamp(l, min=1e-37)[..., None]).to(q.dtype))
        ms.append(m)
        ls.append(l)
    # (nq, b, c, g, qc, hdv) -> (b, sq, h, hdv)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        b, q.shape[1], -1, hdv)
    return out, torch.stack(ms), torch.stack(ls)


def _flash_bwd_chunked(q, k, v, out, ms, ls, dout, causal, q_chunk,
                       kv_chunk):
    """Gradients ``(dq, dk, dv)`` of the chunked attention from the saved
    statistics: each chunk's probabilities are recomputed, ``dk`` and
    ``dv`` are accumulated in float32 across query chunks."""
    (b, nq, nkv, n_kv, g, hd, hdv), qr, kr, vr = _chunk_layout(
        q, k, v, q_chunk, kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    do = dout.reshape(b, nq, q_chunk, n_kv, g, hdv)
    og = out.reshape(b, nq, q_chunk, n_kv, g, hdv)
    # delta: rowsum(do * out) per query, (nq, b, c, g, qc)
    delta = torch.einsum("bnqcgd,bnqcgd->nbcgq", do.float(), og.float())
    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, nkv, kv_chunk, n_kv, hd), **f32)
    dv = torch.zeros((b, nkv, kv_chunk, n_kv, hdv), **f32)
    dqs = []
    for i in range(nq):
        qs = (qr[:, i] * scale).to(q.dtype)
        doi = do[:, i]
        safe_m = _safe(ms[i])[..., None]
        l_i = torch.clamp(ls[i], min=1e-37)[..., None]
        dq = torch.zeros((b, q_chunk, n_kv, g, hd), **f32)
        for j in range(nkv):
            kc, vc = kr[:, j], vr[:, j]
            s = _masked_scores(qs, kc, causal, i * q_chunk, j * kv_chunk)
            p = torch.where(torch.isfinite(s), torch.exp(s - safe_m), 0.0)
            p = p / l_i  # normalised probabilities
            pb = p.to(q.dtype)
            dv[:, j] += torch.einsum("bcgqk,bqcgd->bkcd", pb, doi).float()
            dp = torch.einsum("bqcgd,bkcd->bcgqk", doi, vc).float()
            dsb = (p * (dp - delta[i][..., None])).to(q.dtype)
            dq += torch.einsum("bcgqk,bkcd->bqcgd", dsb, kc).float() * scale
            # qs already carries the 1/sqrt(d) factor, so no extra scale
            dk[:, j] += torch.einsum("bcgqk,bqcgd->bkcd", dsb, qs).float()
        dqs.append(dq.to(q.dtype))
    dq = torch.stack(dqs, dim=1).reshape(q.shape)
    return dq, dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Chunked attention whose backward recomputes the probabilities:
    saves ``q``, ``k``, ``v``, ``out`` and the per-query ``m`` and ``l``,
    no per-chunk probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk):
        out, ms, ls = _flash_fwd_chunked(q, k, v, causal, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, ms, ls)
        ctx.cfg = (causal, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, ms, ls = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_chunked(q, k, v, out, ms, ls, dout, *ctx.cfg)
        return dq, dk, dv, None, None, None


def make_flash_attention_vjp(*, causal: bool, q_chunk: int, kv_chunk: int):
    """``flash_attention`` with the flash backward (recompute, no
    probabilities saved): a function ``(q, k, v) -> out``."""

    def fa(q, k, v):
        if is_dtensor(q):
            return _on_local_heads(fa, q, k, v)
        return _FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)

    return fa


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
