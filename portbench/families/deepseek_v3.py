"""The DeepSeek-V3 family: MLA attention, ``first_k_dense_replace`` dense
layers, then MoE layers of sigmoid-routed experts and a shared expert.

The file holds the published ``config.json``, its depth cut under
``reduced``; what the port runs otherwise (no node-limited groups, no
routed scaling factor, no YaRN, no MTP head) is under
``assumed.departures`` and read through ``harness.config``.
:func:`port_config` refuses a configuration that asks for what the port
does not run.
"""

from __future__ import annotations

import math

import torch

from portbench import weights as W


def prompt_vocab(spec: dict) -> int:
    return spec["vocab_size"]


def port_config(spec: dict):
    from repro_torch.configs.base import ModelConfig

    unsupported = {
        "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1.0,
        "num_nextn_predict_layers": 0, "rope_scaling": None,
        "norm_topk_prob": True, "scoring_func": "sigmoid",
        "hidden_act": "silu", "rms_norm_eps": 1e-6, "attention_bias": False,
        "moe_layer_freq": 1, "tie_word_embeddings": False,
    }
    for key, want in unsupported.items():
        if spec[key] != want:
            raise ValueError(f"{spec['name']}: the port runs {key}={want!r}, "
                             f"the file says {spec[key]!r}")
    port = spec["port"]
    return ModelConfig(
        name=spec["name"], family="moe", n_layers=spec["num_hidden_layers"],
        d_model=spec["hidden_size"], n_heads=spec["num_attention_heads"],
        n_kv_heads=spec["num_key_value_heads"],
        d_ff=spec["intermediate_size"], vocab=spec["vocab_size"],
        rope_theta=float(spec["rope_theta"]), moe=True,
        n_experts=spec["n_routed_experts"],
        moe_top_k=spec["num_experts_per_tok"],
        n_shared_experts=spec["n_shared_experts"],
        first_k_dense=spec["first_k_dense_replace"],
        moe_ff=spec["moe_intermediate_size"], router_scoring="sigmoid",
        mla=True, q_lora_rank=spec["q_lora_rank"],
        kv_lora_rank=spec["kv_lora_rank"],
        qk_nope_head_dim=spec["qk_nope_head_dim"],
        qk_rope_head_dim=spec["qk_rope_head_dim"],
        v_head_dim=spec["v_head_dim"], param_dtype=port["param_dtype"],
        dtype=port["compute_dtype"], moe_dispatch=port["moe_dispatch"])


def _layers(gen, spec, n, moe, dt, device):
    d, H = spec["hidden_size"], spec["num_attention_heads"]
    qr, kvr = spec["q_lora_rank"], spec["kv_lora_rank"]
    dn, dr, dv = (spec["qk_nope_head_dim"], spec["qk_rope_head_dim"],
                  spec["v_head_dim"])

    def draw(shape, std):
        return W.normal(gen, (n, *shape), std, dt, device)

    attn = {
        "w_dq": draw((d, qr), 1 / math.sqrt(d)),
        "q_norm": W.full((n, qr), 1.0, dt, device),
        "w_uq": draw((qr, H, dn + dr), 1 / math.sqrt(qr)),
        "w_dkv": draw((d, kvr), 1 / math.sqrt(d)),
        "kv_norm": W.full((n, kvr), 1.0, dt, device),
        "w_krope": draw((d, dr), 1 / math.sqrt(d)),
        "w_uk": draw((kvr, H, dn), 1 / math.sqrt(kvr)),
        "w_uv": draw((kvr, H, dv), 1 / math.sqrt(kvr)),
        "wo": draw((H, dv, d), 1 / math.sqrt(H * dv)),
    }
    if moe:
        e, ff = spec["n_routed_experts"], spec["moe_intermediate_size"]
        sff = ff * max(spec["n_shared_experts"], 1)
        mlp = {
            "router": draw((d, e), 1 / math.sqrt(d)),
            "w_gate": draw((e, d, ff), 1 / math.sqrt(d)),
            "w_up": draw((e, d, ff), 1 / math.sqrt(d)),
            "w_down": draw((e, ff, d), 1 / math.sqrt(ff)),
        }
        if spec["n_shared_experts"]:
            mlp["shared"] = {"w_gate": draw((d, sff), 1 / math.sqrt(d)),
                             "w_up": draw((d, sff), 1 / math.sqrt(d)),
                             "w_down": draw((sff, d), 1 / math.sqrt(sff))}
    else:
        ff = spec["intermediate_size"]
        mlp = {"w_gate": draw((d, ff), 1 / math.sqrt(d)),
               "w_up": draw((d, ff), 1 / math.sqrt(d)),
               "w_down": draw((ff, d), 1 / math.sqrt(ff))}
    return {"attn": attn, "mlp": mlp,
            "ln1": {"scale": W.full((n, d), 1.0, dt, device)},
            "ln2": {"scale": W.full((n, d), 1.0, dt, device)}}


def make_weights(spec: dict, seed: int, device) -> dict:
    """The port's tree (``init_params``' layout: ``dense_layers`` then
    ``layers``, stacked), drawn from ``seed`` with the port's init stds
    (1/sqrt(fan-in); embeddings 0.02) straight into the storage dtype;
    norm scales 1."""
    dt = getattr(torch, spec["port"]["param_dtype"])
    gen = W.generator(seed, device)
    d, v = spec["hidden_size"], spec["vocab_size"]
    k = spec["first_k_dense_replace"]
    return {
        "embed": {"table": W.normal(gen, (v, d), 0.02, dt, device)},
        "unembed": {"table": W.normal(gen, (v, d), 0.02, dt, device)},
        "final_norm": {"scale": W.full((d,), 1.0, torch.float32, device)},
        "dense_layers": _layers(gen, spec, k, False, dt, device),
        "layers": _layers(gen, spec, spec["num_hidden_layers"] - k, True, dt,
                          device),
    }


def smoke(spec: dict) -> dict:
    """The same family at a width the CPU tests can hold: one dense and two
    MoE layers of four experts, top-2, computed in float32 (the caches stay
    bfloat16), so that rounding rarely flips a router's choice."""
    return dict(spec, port=dict(spec["port"], compute_dtype="float32"),
                num_hidden_layers=3, first_k_dense_replace=1,
                hidden_size=64, intermediate_size=128, vocab_size=256,
                num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32,
                kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                v_head_dim=8, n_routed_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=32)
