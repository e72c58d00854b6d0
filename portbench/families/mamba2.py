"""The Mamba2 family: a configuration file read as the port's ``ModelConfig``,
and its weights in the port's tree.

The file keeps the keys of the published ``config.json`` (``d_model``,
``n_layer``, ``vocab_size``, ``ssm_cfg``, ...); the Mamba2 layer's own
sizes, which that file leaves to the layer's defaults, are under
``assumed``; how the port stores and computes is under ``port``.
"""

from __future__ import annotations

import math

import torch

from portbench import weights as W


def sizes(spec: dict) -> dict:
    a = spec["assumed"]
    d = spec["d_model"]
    d_inner = a["expand"] * d
    nheads = d_inner // a["headdim"]
    gs = a["ngroups"] * a["d_state"]
    pad = spec["pad_vocab_size_multiple"]
    return dict(
        d=d, layers=spec["n_layer"], d_inner=d_inner, nheads=nheads,
        headdim=a["headdim"], d_state=a["d_state"], ngroups=a["ngroups"],
        d_conv=a["d_conv"], conv_dim=d_inner + 2 * gs,
        proj=2 * d_inner + 2 * gs + nheads,
        vocab=-(-spec["vocab_size"] // pad) * pad, eps=spec["norm_epsilon"])


def prompt_vocab(spec: dict) -> int:
    """Token ids a prompt draws from: the tokenizer's, below the padding."""
    return spec["vocab_size"]


def port_config(spec: dict):
    from repro_torch.configs.base import ModelConfig

    s = sizes(spec)
    if s["d_conv"] != 4 or spec["attn_layer_idx"] or not spec["tie_embeddings"]:
        raise ValueError(f"{spec['name']}: the port's Mamba2 stack has d_conv 4, "
                         "no attention layers and tied embeddings")
    if s["eps"] != 1e-6 or spec["residual_in_fp32"]:
        raise ValueError(f"{spec['name']}: the port runs norm_epsilon 1e-6 and "
                         "a residual in the compute dtype")
    return ModelConfig(
        name=spec["name"], family="ssm", n_layers=s["layers"], d_model=s["d"],
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=s["vocab"], ssm=True,
        ssm_state=s["d_state"], ssm_expand=spec["assumed"]["expand"],
        ssm_headdim=s["headdim"], ssm_ngroups=s["ngroups"],
        tie_embeddings=True, param_dtype=spec["port"]["param_dtype"],
        dtype=spec["port"]["compute_dtype"])


def make_weights(spec: dict, seed: int, device) -> dict:
    """The port's tree (``init_params``' layout, stacked layers), drawn
    from ``seed`` with the port's init: matrices normal with std
    1/sqrt(fan-in) (embedding 0.02, conv 0.1), ``dt_bias`` the inverse
    softplus of a log-uniform step in [1e-3, 1e-1], ``A_log`` log 1..16,
    ``D`` and the norm scales 1, the conv bias 0."""
    s = sizes(spec)
    dt = getattr(torch, spec["port"]["param_dtype"])
    f32 = torch.float32
    gen = W.generator(seed, device)
    L, d, H = s["layers"], s["d"], s["nheads"]
    table = W.normal(gen, (s["vocab"], d), 0.02, dt, device)
    mamba = {
        "w_in": W.normal(gen, (L, d, s["proj"]), 1 / math.sqrt(d), dt, device),
        "conv_w": W.normal(gen, (L, s["d_conv"], s["conv_dim"]), 0.1, dt, device),
        "conv_b": W.full((L, s["conv_dim"]), 0.0, dt, device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device))
        .expand(L, H).to(dt).contiguous(),
        "D": W.full((L, H), 1.0, dt, device),
        "dt_bias": None,
        "norm_scale": W.full((L, s["d_inner"]), 1.0, dt, device),
        "w_out": W.normal(gen, (L, s["d_inner"], d), 1 / math.sqrt(s["d_inner"]),
                          dt, device),
    }
    u = W.uniform(gen, (L, H), math.log(1e-3), math.log(1e-1), device)
    mamba["dt_bias"] = torch.log(torch.expm1(torch.exp(u))).to(dt)
    return {"embed": {"table": table},
            "final_norm": {"scale": W.full((d,), 1.0, f32, device)},
            "layers": {"mamba": mamba,
                       "ln": {"scale": W.full((L, d), 1.0, dt, device)}}}


def smoke(spec: dict) -> dict:
    """The same family at a width the CPU tests can hold, computed in
    float32 (the conv state stays bfloat16)."""
    out = dict(spec, n_layer=2, d_model=64, vocab_size=250,
               port=dict(spec["port"], compute_dtype="float32"))
    out["assumed"] = dict(spec["assumed"], d_state=16, headdim=16)
    return out
