"""The DBRX family: GQA attention whose fused QKV output is clamped to
``+-clip_qkv``, then an MoE of ``moe_num_experts`` SwiGLU experts, softmax
routed, top ``moe_top_k``, their weights divided by their L1 norm, with no
shared expert; every norm a LayerNorm with a scale and no bias.

The file holds the published ``config.json``, its depth cut under
``reduced``; the port runs every other key as published, so the file has
no departures.  :func:`port_config` refuses a key, or a value, that the
port does not run.
"""

from __future__ import annotations

import math

import torch

from portbench import weights as W

# The keys the port runs, each with the values it takes (None: any).
TOP = {"name": None, "family": None, "source": None, "paper": None,
       "model_type": ("dbrx",), "d_model": None, "n_heads": None,
       "n_layers": None, "vocab_size": None, "max_seq_len": None,
       "tie_word_embeddings": (False,), "attn_config": None,
       "ffn_config": None, "reduced": None, "published": None,
       "assumed": None, "port": None}
ATTN = {"kv_n_heads": None, "clip_qkv": None, "rope_theta": None}
FFN = {"ffn_hidden_size": None, "moe_num_experts": None, "moe_top_k": None,
       "moe_normalize_expert_weights": (1,),
       "ffn_act_fn": ({"name": "silu"},)}


def prompt_vocab(spec: dict) -> int:
    return spec["vocab_size"]


def _refuse(spec: dict, where: str, group: dict, runs: dict) -> None:
    for key, value in group.items():
        if key not in runs:
            raise ValueError(f"{spec['name']}: the port does not run "
                             f"{where}{key}")
        if runs[key] is not None and value not in runs[key]:
            raise ValueError(f"{spec['name']}: the port runs {where}{key} "
                             f"in {runs[key]!r}, the file says {value!r}")


def port_config(spec: dict):
    from repro_torch.configs.base import ModelConfig

    _refuse(spec, "", spec, TOP)
    _refuse(spec, "attn_config.", spec["attn_config"], ATTN)
    _refuse(spec, "ffn_config.", spec["ffn_config"], FFN)
    attn, ffn, port = spec["attn_config"], spec["ffn_config"], spec["port"]
    return ModelConfig(
        name=spec["name"], family="moe", n_layers=spec["n_layers"],
        d_model=spec["d_model"], n_heads=spec["n_heads"],
        n_kv_heads=attn["kv_n_heads"], d_ff=ffn["ffn_hidden_size"],
        vocab=spec["vocab_size"], rope_theta=float(attn["rope_theta"]),
        moe=True, n_experts=ffn["moe_num_experts"],
        moe_top_k=ffn["moe_top_k"], moe_ff=ffn["ffn_hidden_size"],
        router_scoring="softmax", norm="layernorm",
        clip_qkv=float(attn["clip_qkv"]), param_dtype=port["param_dtype"],
        dtype=port["compute_dtype"], moe_dispatch=port["moe_dispatch"])


def make_weights(spec: dict, seed: int, device) -> dict:
    """The port's tree (``init_params``' layout: one ``layers`` stack),
    drawn from ``seed`` with the port's init stds (1/sqrt(fan-in);
    embeddings 0.02) straight into the storage dtype; norm scales 1."""
    dt = getattr(torch, spec["port"]["param_dtype"])
    gen = W.generator(seed, device)
    d, v, h = spec["d_model"], spec["vocab_size"], spec["n_heads"]
    n, kv = spec["n_layers"], spec["attn_config"]["kv_n_heads"]
    hd = d // h
    ffn = spec["ffn_config"]
    e, ff = ffn["moe_num_experts"], ffn["ffn_hidden_size"]

    def draw(shape, std):
        return W.normal(gen, (n, *shape), std, dt, device)

    return {
        "embed": {"table": W.normal(gen, (v, d), 0.02, dt, device)},
        "unembed": {"table": W.normal(gen, (v, d), 0.02, dt, device)},
        "final_norm": {"scale": W.full((d,), 1.0, torch.float32, device)},
        "layers": {
            "attn": {"wq": draw((d, h, hd), 1 / math.sqrt(d)),
                     "wk": draw((d, kv, hd), 1 / math.sqrt(d)),
                     "wv": draw((d, kv, hd), 1 / math.sqrt(d)),
                     "wo": draw((h, hd, d), 1 / math.sqrt(h * hd))},
            "mlp": {"router": draw((d, e), 1 / math.sqrt(d)),
                    "w_gate": draw((e, d, ff), 1 / math.sqrt(d)),
                    "w_up": draw((e, d, ff), 1 / math.sqrt(d)),
                    "w_down": draw((e, ff, d), 1 / math.sqrt(ff))},
            "ln1": {"scale": W.full((n, d), 1.0, dt, device)},
            "ln2": {"scale": W.full((n, d), 1.0, dt, device)},
        },
    }


def smoke(spec: dict) -> dict:
    """The same family at a width the CPU tests can hold: two layers of
    four experts, top-2, GQA of 4 query and 2 KV heads, computed in
    float32 (the cache stays bfloat16), with a clamp of 1.5, which binds
    on about one q, k or v value in eight at this width."""
    return dict(spec, port=dict(spec["port"], compute_dtype="float32"),
                n_layers=2, d_model=64, n_heads=4, vocab_size=256,
                attn_config=dict(spec["attn_config"], kv_n_heads=2,
                                 clip_qkv=1.5),
                ffn_config=dict(spec["ffn_config"], ffn_hidden_size=128,
                                moe_num_experts=4, moe_top_k=2))
