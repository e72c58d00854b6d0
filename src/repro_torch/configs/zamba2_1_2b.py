"""zamba2-1.2b [hybrid]: Mamba2 stack + shared attention block every 6
layers (arXiv:2411.15242; LoRA adapters on the shared block are a
documented simplification — weights fully shared here)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=True,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    attn_every=6,
    mlp_kind="gelu",
)
