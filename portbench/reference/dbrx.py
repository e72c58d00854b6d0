"""Plain float32 DBRX language model (Databricks, 2024) over whole
sequences, as the configuration file states it.

Each layer: ``h = x + attn(LN1(x)) W_o`` and ``y = h + sum_top-k w_e
SwiGLU_e(LN2(h))``.  ``LN`` is a LayerNorm with a scale and no bias, eps
1e-5.  Attention is grouped-query: ``q = LN1(x) W_q``, ``k = LN1(x) W_k``,
``v = LN1(x) W_v``, each clamped to ``+-clip_qkv``, q and k then roped
(split halves); query head ``j`` reads KV head ``j // (n_heads /
kv_n_heads)``; causal softmax of ``q k / sqrt(head_dim)``.  The router is
``softmax(LN2(h) W_r)`` over the experts; the top ``k`` (ties to the lower
index) are taken and their weights divided by their sum, the L1 norm.
Experts are cast to float32 one at a time, for the rows routed to them,
so a full-width layer fits beside its bfloat16 weights.  The logits are
``LN_f(x) W_unembed^T``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision, rope

EPS = 1e-5


def layernorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * scale.float()


def _attention(spec, a, h, prec):
    clip = spec["attn_config"]["clip_qkv"]
    theta = spec["attn_config"]["rope_theta"]
    rows, seq, _ = h.shape
    q, k, v = (prec.einsum("bsd,dhk->bshk", h, a[n]).clamp(-clip, clip)
               for n in ("wq", "wk", "wv"))
    q, k = rope(q, theta), rope(k, theta)
    group = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(q.shape[-1])
    causal = torch.ones((seq, seq), dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqs,bshk->bqhk", p, v)
    return prec.einsum("bshk,hkd->bsd", o, a["wo"])


def _swiglu(prec, x, wg, wu, wd):
    return prec.einsum("...d,df->...f",
                       F.silu(prec.einsum("...d,df->...f", x, wg))
                       * prec.einsum("...d,df->...f", x, wu), wd)


def _moe(spec, m, h, prec):
    rows, seq, d = h.shape
    ht = h.reshape(-1, d)
    k = spec["ffn_config"]["moe_top_k"]
    scores = torch.softmax(prec.einsum("td,de->te", ht, m["router"]), dim=-1)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    experts = order[:, :k]
    weights = torch.gather(scores, 1, experts)
    weights = weights / weights.sum(-1, keepdim=True)
    out = torch.zeros_like(ht)
    for e in torch.unique(experts).tolist():
        tok, choice = (experts == e).nonzero(as_tuple=True)
        y = _swiglu(prec, ht[tok], m["w_gate"][e], m["w_up"][e], m["w_down"][e])
        out.index_add_(0, tok, y * weights[tok, choice][:, None])
    return out.reshape(rows, seq, d)


def logits(spec: dict, w: dict, tokens: torch.Tensor, positions,
           prec: Precision) -> torch.Tensor:
    """``tokens`` (rows, seq) -> float32 logits (rows, len(positions),
    vocab) at the given positions."""
    x = w["embed"]["table"][tokens].float()
    stack = w["layers"]
    for i in range(stack["ln1"]["scale"].shape[0]):
        a = {k: t[i] for k, t in stack["attn"].items()}
        m = {k: t[i] for k, t in stack["mlp"].items()}
        x = x + _attention(spec, a, layernorm(x, stack["ln1"]["scale"][i]), prec)
        x = x + _moe(spec, m, layernorm(x, stack["ln2"]["scale"][i]), prec)
    h = layernorm(x[:, positions], w["final_norm"]["scale"])
    return prec.einsum("bsd,vd->bsv", h, w["unembed"]["table"])
