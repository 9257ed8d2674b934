"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16) vocab=50304; every MLP is MoE with
expert_d_ff=1024, no shared expert.  ~7B total, ~1.3B active.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe_1b_7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    mlp="swiglu", n_experts=64, top_k=8, expert_d_ff=1024,
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe_1b_7b_smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=512, mlp="swiglu",
        n_experts=8, top_k=2, expert_d_ff=96, dtype="float32",
        # smoke scale: dropless capacity so prefill/decode agree exactly
        # (random-init routers are unbalanced; cf=1.25 drops tokens)
        capacity_factor=4.0,
    )
