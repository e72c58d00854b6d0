"""FLOPs a DeepSeek-V3 model needs for one token fed at ``position``
(attending to ``position + 1`` keys), from the configuration's widths:
every product with a weight (2 per multiply-add: MLA's projections with
the K and V up-projections applied to the new token, the router, the
``k`` routed and the shared experts, the dense FFNs, the logits) and the
attention's scores and weighted sum over the keys."""

from __future__ import annotations


def per_token(spec: dict, position: int) -> float:
    d, h = spec["hidden_size"], spec["num_attention_heads"]
    qr, kvr = spec["q_lora_rank"], spec["kv_lora_rank"]
    dn, dr, dv = (spec["qk_nope_head_dim"], spec["qk_rope_head_dim"],
                  spec["v_head_dim"])
    keys = position + 1
    attn = 2 * (d * qr + qr * h * (dn + dr) + d * kvr + d * dr
                + kvr * h * dn + kvr * h * dv + h * dv * d)
    attn += 2 * h * (dn + dr) * keys + 2 * h * dv * keys
    dense = 2 * 3 * d * spec["intermediate_size"]
    ff = spec["moe_intermediate_size"]
    experts = spec["num_experts_per_tok"] + spec["n_shared_experts"]
    moe = 2 * d * spec["n_routed_experts"] + experts * 2 * 3 * d * ff
    k = spec["first_k_dense_replace"]
    layers = spec["num_hidden_layers"]
    return (layers * attn + k * dense + (layers - k) * moe
            + 2 * d * spec["vocab_size"])
