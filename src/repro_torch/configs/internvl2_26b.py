"""internvl2-26b [vlm]: InternLM2-20B backbone (arXiv:2404.16821).
InternViT frontend is a stub: patch embeddings arrive precomputed for the
first ``frontend_tokens`` positions."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    frontend="patches",
    frontend_tokens=256,
)
