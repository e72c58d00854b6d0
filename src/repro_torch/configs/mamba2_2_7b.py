"""mamba2-2.7b [ssm]: SSD, attention-free (arXiv:2405.21060).
The paper's merge technique does not apply inside the SSD recurrence
(DESIGN.md §6); serving/sampling and the data pipeline still use it."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    tie_embeddings=True,
)
