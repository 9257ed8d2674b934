"""Llama-4-Scout-17B-16E — 16-expert top-1 MoE + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048; each MoE layer routes
top-1 over 16 experts and always adds one shared expert.  "Early fusion"
multimodality is out of scope per the assignment (text backbone only).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4_scout_17b_a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    mlp="swiglu", rope_theta=500_000.0,
    n_experts=16, top_k=1, expert_d_ff=8192, n_shared_experts=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4_scout_smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, mlp="swiglu",
        n_experts=4, top_k=1, expert_d_ff=128, n_shared_experts=1,
        dtype="float32", capacity_factor=4.0,
    )
