"""Architecture registry and input stand-ins for every (arch x shape)
cell (torch port of ``repro.configs.registry``).

``ARCHS``, ``get_arch``, ``smoke_config``, ``cell_runnable`` and
``input_specs`` as in the reference.  Where the reference's stand-ins are
``jax.ShapeDtypeStruct`` objects, the port's are tensors on the ``meta``
device (shape and dtype, no storage), or fake tensors when the caller
passes a device under its own ``FakeTensorMode``; ``input_specs`` never
allocates.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.deepseek_67b import CONFIG as deepseek_67b
from repro_torch.configs.deepseek_v3_671b import CONFIG as deepseek_v3_671b
from repro_torch.configs.dbrx_132b import CONFIG as dbrx_132b
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b
from repro_torch.configs.internvl2_26b import CONFIG as internvl2_26b
from repro_torch.configs.mamba2_2_7b import CONFIG as mamba2_2_7b
from repro_torch.configs.musicgen_medium import CONFIG as musicgen_medium
from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3_0_6b
from repro_torch.configs.qwen15_110b import CONFIG as qwen15_110b
from repro_torch.configs.zamba2_1_2b import CONFIG as zamba2_1_2b

__all__ = ["ARCHS", "SHAPES", "ShapeConfig", "get_arch", "smoke_config",
           "cell_runnable", "input_specs"]

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        musicgen_medium,
        qwen3_0_6b,
        deepseek_67b,
        qwen15_110b,
        granite_3_2b,
        deepseek_v3_671b,
        dbrx_132b,
        internvl2_26b,
        zamba2_1_2b,
        mamba2_2_7b,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable?  ``long_500k`` needs a
    sub-quadratic decode path: SSM/hybrid only."""
    if shape.name == "long_500k" and not cfg.ssm:
        return False, "pure full-attention arch: no sub-quadratic 500k path"
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    over: dict = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=256,
        q_chunk=32,
        kv_chunk=32,
        remat="none",
    )
    if cfg.mla:
        over.update(
            n_heads=4, n_kv_heads=4, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
        )
    elif not cfg.ssm:
        over.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4)
        if cfg.head_dim:
            over.update(head_dim=16)
    if cfg.moe:
        over.update(n_experts=4, moe_top_k=2, moe_ff=32)
        if cfg.first_k_dense:
            over.update(first_k_dense=1, n_layers=3)
    if cfg.ssm:
        over.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
        if cfg.attn_every:
            over.update(attn_every=2, n_heads=4, n_kv_heads=4, d_ff=128)
    if cfg.frontend != "none":
        over.update(frontend_tokens=8)
    return dataclasses.replace(cfg, **over)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, device="meta"):
    """Stand-ins for every model input of this cell: tensors on ``device``
    (``meta`` by default; under the caller's ``FakeTensorMode``, any
    device gives fake tensors).

    train/prefill: the training batch.  decode: ``tokens`` (one new token
    per row) and the ``cache`` (``init_cache`` at depth ``seq_len``, bf16).
    """
    from repro_torch.models.transformer import init_cache

    b, s = shape.global_batch, shape.seq_len

    def empty(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": empty((b, s), torch.int32),
                 "labels": empty((b, s), torch.int32),
                 "mask": empty((b, s), torch.float32)}
        if cfg.frontend != "none":
            batch["frontend_embeds"] = empty(
                (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
        return batch
    return {"tokens": empty((b, 1), torch.int32),
            "cache": init_cache(cfg, b, s, dtype=torch.bfloat16,
                                device=device)}
