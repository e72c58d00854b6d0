"""Plain float32 DeepSeek-V3 language model (arXiv:2412.19437) over whole
sequences, as the configuration file states it.

Attention is MLA in its plain form: ``c_q = RMSNorm(h W_dq)``, ``q =
c_q W_uq`` split into ``q_nope`` and a roped ``q_rope``; ``c_kv =
RMSNorm(h W_dkv)``, ``k_rope = rope(h W_krope)`` shared by the heads;
``k_nope = c_kv W_uk`` and ``v = c_kv W_uv`` per head; causal softmax of
``(q_nope k_nope + q_rope k_rope) / sqrt(nope + rope)``; ``o W_o``.  The
first ``first_k_dense_replace`` layers have a SwiGLU FFN; the others an
MoE: sigmoid scores of ``h W_router`` choose the top ``k`` experts (ties
to the lower index), whose weights are the chosen scores over their sum;
each token adds its experts' SwiGLU outputs so weighted, and the shared
expert's.  Routed experts are cast to float32 one at a time, for the rows
routed to them, so a full-width MoE layer fits beside its bfloat16
weights.  The logits are ``RMSNorm(x) W_unembed^T``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision, rmsnorm, rope


def _swiglu(prec, x, wg, wu, wd):
    return prec.einsum("...d,df->...f",
                       F.silu(prec.einsum("...d,df->...f", x, wg))
                       * prec.einsum("...d,df->...f", x, wu), wd)


def _attention(spec, a, h, prec):
    eps = spec["rms_norm_eps"]
    dn, dr = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    rows, seq, _ = h.shape
    cq = rmsnorm(prec.einsum("bsd,dr->bsr", h, a["w_dq"]), a["q_norm"], eps)
    q = prec.einsum("bsr,rhk->bshk", cq, a["w_uq"])
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], spec["rope_theta"])
    ckv = rmsnorm(prec.einsum("bsd,dr->bsr", h, a["w_dkv"]), a["kv_norm"], eps)
    k_rope = rope(prec.einsum("bsd,dk->bsk", h, a["w_krope"]), spec["rope_theta"])
    k_nope = prec.einsum("bsr,rhk->bshk", ckv, a["w_uk"])
    v = prec.einsum("bsr,rhk->bshk", ckv, a["w_uv"])
    scores = (torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
              + torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope))
    scores = scores / math.sqrt(dn + dr)
    causal = torch.ones((seq, seq), dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqs,bshk->bqhk", p, v)
    return prec.einsum("bshk,hkd->bsd", o, a["wo"])


def _moe(spec, m, h, prec):
    rows, seq, d = h.shape
    ht = h.reshape(-1, d)
    k = spec["num_experts_per_tok"]
    scores = torch.sigmoid(prec.einsum("td,de->te", ht, m["router"]))
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    experts = order[:, :k]
    weights = torch.gather(scores, 1, experts)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    out = torch.zeros_like(ht)
    for e in torch.unique(experts).tolist():
        tok, choice = (experts == e).nonzero(as_tuple=True)
        y = _swiglu(prec, ht[tok], m["w_gate"][e], m["w_up"][e], m["w_down"][e])
        out.index_add_(0, tok, y * weights[tok, choice][:, None])
    if "shared" in m:
        s = m["shared"]
        out = out + _swiglu(prec, ht, s["w_gate"], s["w_up"], s["w_down"])
    return out.reshape(rows, seq, d)


def logits(spec: dict, w: dict, tokens: torch.Tensor, positions,
           prec: Precision) -> torch.Tensor:
    """``tokens`` (rows, seq) -> float32 logits (rows, len(positions),
    vocab) at the given positions."""
    eps = spec["rms_norm_eps"]
    x = w["embed"]["table"][tokens].float()
    stacks = [(w["dense_layers"], False), (w["layers"], True)]
    for stack, moe in stacks:
        depth = stack["ln1"]["scale"].shape[0]
        for i in range(depth):
            a = {k: t[i] for k, t in stack["attn"].items()}
            x = x + _attention(spec, a, rmsnorm(x, stack["ln1"]["scale"][i], eps),
                               prec)
            h = rmsnorm(x, stack["ln2"]["scale"][i], eps)
            mlp = stack["mlp"]
            if moe:
                m = {k: (t[i] if k != "shared" else {kk: tt[i] for kk, tt in t.items()})
                     for k, t in mlp.items()}
                x = x + _moe(spec, m, h, prec)
            else:
                x = x + _swiglu(prec, h, mlp["w_gate"][i], mlp["w_up"][i],
                                mlp["w_down"][i])
    h = rmsnorm(x[:, positions], w["final_norm"]["scale"], eps)
    return prec.einsum("bsd,vd->bsv", h, w["unembed"]["table"])
