"""Architecture registry (torch port of ``repro.configs.registry``).

``ARCHS``, ``get_arch`` and ``smoke_config`` as in the reference.  The
reference's ``input_specs`` and ``cell_runnable`` describe XLA dry-run
cells and are not ported here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
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

__all__ = ["ARCHS", "get_arch", "smoke_config"]

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
