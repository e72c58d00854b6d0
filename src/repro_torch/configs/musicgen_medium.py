"""musicgen-medium [audio]: decoder-only over EnCodec tokens
(arXiv:2306.05284).  Text/audio conditioning frontend is a stub: the first
``frontend_tokens`` positions receive precomputed frame embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    mlp_kind="gelu",
    pos_emb="sinusoidal",
    frontend="frames",
    frontend_tokens=256,
)
