"""Model/run configuration (torch port of ``repro.configs.base``).

The port keeps its own copy of the reference's frozen dataclass, field for
field, so that one architecture name means the same model in both
packages.  Fields the port does not use yet (sharding layout, remat,
training knobs) are kept so the two stay comparable."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"  # swiglu | gelu
    pos_emb: str = "rope"  # rope | sinusoidal
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    moe_ff: int = 0  # routed-expert hidden width
    router_scoring: str = "softmax"  # softmax | sigmoid (V3 aux-free)
    capacity_factor: float = 1.25
    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM / hybrid
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    attn_every: int = 0  # hybrid: shared attention block every k layers
    # modality frontend (stub: precomputed embeddings come in as inputs)
    frontend: str = "none"  # none | patches | frames
    frontend_tokens: int = 0  # prefix length supplied as embeddings
    # numerics / perf knobs (§Perf iterates these)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # 'bfloat16' for the 671B config
    remat: str = "full"  # full | dots | none
    q_chunk: int = 2048
    kv_chunk: int = 1024
    causal_skip: bool = False
    flash_vjp: bool = False  # flash backward (recompute, no p residuals)
    moe_dispatch_groups: int = 1  # GShard-style local dispatch groups
    moe_dispatch: str = "capacity"  # capacity (fixed slots, drops) |
    #                                 dropless (exact-cut grouped GEMMs)
    use_merge_sort_dispatch: bool = True
    fanout: int = 0  # merge-sort/top-k fan-out (runs merged per pass);
    #                  0 = library defaults (mergesort.DEFAULT_FANOUT,
    #                  topk.TOURNAMENT_FANOUT)
    # serving (repro.serving): continuous-batching decode defaults.
    # max_batch is the KV pool's slot capacity (compiled batch dim of the
    # ragged decode step); queue_depth bounds waiting requests before
    # submit() applies back-pressure.  Per-arch overrides scale these
    # with KV-cache cost; launchers override with --max-batch.
    max_batch: int = 8
    queue_depth: int = 32
    layout: str = "tp"  # 'tp' (model axis = TP/EP) | 'fsdp' (model axis
    #                     joins the batch axes; weights gathered per layer —
    #                     the right mesh use for sub-4B models, see §Perf)
    # observability (repro.obs): '' = metrics off (record points compile
    # to nothing); a directory enables the JSONL sink there.  Launchers
    # override with --metrics-dir.
    metrics_dir: str = ""
    # training
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    adam_dtype: str = "float32"  # 'bfloat16' for the 671B config (as V3 did)
    grad_accum: int = 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers), for 6ND."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.ssm and self.attn_every == 0:  # pure SSM
            return emb + self.n_layers * self._mamba_params()
        if self.attn_every:  # hybrid: mamba stack + ONE shared attn block
            return (
                emb
                + self.n_layers * self._mamba_params()
                + self._attn_params()
                + 2 * self.d_model * self.d_ff  # shared block MLP (gelu)
            )
        per_layer = self._attn_params() + self._ffn_params()
        return emb + self.n_layers * per_layer

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.mla:
            qk_hd = self.qk_nope_head_dim + self.qk_rope_head_dim
            return (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * qk_hd
                + d * self.kv_lora_rank
                + d * self.qk_rope_head_dim
                + self.kv_lora_rank * self.n_heads * self.qk_nope_head_dim
                + self.kv_lora_rank * self.n_heads * self.v_head_dim
                + self.n_heads * self.v_head_dim * d
            )
        return d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe:
            ff = self.moe_ff or self.d_ff
            routed = self.n_experts * 3 * d * ff
            shared = self.n_shared_experts * 3 * d * ff
            return routed + shared + d * self.n_experts
        mult = 3 if self.mlp_kind == "swiglu" else 2
        return mult * d * self.d_ff

    def _mamba_params(self) -> int:
        d = self.d_model
        d_inner = self.ssm_expand * d
        nheads = d_inner // self.ssm_headdim
        proj_out = d_inner * 2 + 2 * self.ssm_ngroups * self.ssm_state + nheads
        return d * proj_out + d_inner * d

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        ff = self.moe_ff or self.d_ff
        act_ffn = (self.moe_top_k + self.n_shared_experts) * 3 * d * ff
        dense_ffn = 3 * d * self.d_ff if self.first_k_dense else 0
        moe_layers = self.n_layers - self.first_k_dense
        return (
            self.vocab * d * (1 if self.tie_embeddings else 2)
            + moe_layers * (self._attn_params() + act_ffn + d * self.n_experts)
            + self.first_k_dense * (self._attn_params() + dense_ffn)
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
