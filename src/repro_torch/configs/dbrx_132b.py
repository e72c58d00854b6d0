"""dbrx-132b [moe]: 16 experts top-4, fine-grained (hf:databricks/dbrx-base)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=True,
    n_experts=16,
    moe_top_k=4,
    moe_ff=10752,
    rope_theta=5e5,
    moe_dispatch="dropless",  # 16-way top-4 routing skews hard; exact cuts
)
