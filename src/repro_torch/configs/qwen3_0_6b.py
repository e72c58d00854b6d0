"""qwen3-0.6b [dense]: qk-norm, GQA, head_dim 128, tied embeddings
(hf:Qwen/Qwen3-0.6B family traits)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    # serving: tiny model, cheap GQA cache -> deep slot pool; fanout 4
    # halves the top-k tournament rounds over the 151936-entry vocab
    # vs pairwise (see BENCH_serve.json / benchmarks/serve_decode.py)
    max_batch=16,
    queue_depth=64,
    fanout=4,
)
