"""FLOPs a DBRX model needs for one token fed at ``position`` (attending
to ``position + 1`` keys), from the configuration's widths: every product
with a weight (2 per multiply-add: the Q, K and V projections, the output
projection, the router, the ``moe_top_k`` chosen experts' three products
each, the logits) and the attention's scores and weighted sum over the
keys."""

from __future__ import annotations


def per_token(spec: dict, position: int) -> float:
    d, h = spec["d_model"], spec["n_heads"]
    kv, hd = spec["attn_config"]["kv_n_heads"], d // h
    ffn = spec["ffn_config"]
    keys = position + 1
    attn = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    attn += 2 * h * hd * keys * 2
    moe = (2 * d * ffn["moe_num_experts"]
           + ffn["moe_top_k"] * 3 * 2 * d * ffn["ffn_hidden_size"])
    return spec["n_layers"] * (attn + moe) + 2 * d * spec["vocab_size"]
