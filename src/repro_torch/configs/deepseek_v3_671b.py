"""deepseek-v3-671b [moe]: MLA + 1 shared + 256 routed top-8 experts,
sigmoid aux-free routing, first 3 layers dense (arXiv:2412.19437).
MTP head is a config option, off for the assigned shapes (matches public
inference configs).  Adam moments in bf16 as in the V3 report."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,          # dense (first_k_dense) layers
    vocab=129280,
    moe=True,
    n_experts=256,
    moe_top_k=8,
    n_shared_experts=1,
    first_k_dense=3,
    moe_ff=2048,
    router_scoring="sigmoid",
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    adam_dtype="bfloat16",
    param_dtype="bfloat16",
    moe_dispatch="dropless",  # 256 fine-grained experts: capacity slots
    #                           waste ~E/k x memory; exact cuts don't
    # serving: MLA cache (lock-step fallback path) — modest fixed batch
    max_batch=4,
    queue_depth=16,
)
