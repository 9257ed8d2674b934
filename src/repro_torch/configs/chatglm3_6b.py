"""ChatGLM3-6B — GQA kv=2, 2d (half-rotary) RoPE, qkv bias [arXiv:2406.12793; hf].

d_ff=13696 is already the gated hidden width (SwiGLU).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3_6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    mlp="swiglu", rotary_pct=0.5, attn_bias=True,
    source="arXiv:2406.12793; hf:THUDM/chatglm3-6b",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chatglm3_6b_smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=512, mlp="swiglu", rotary_pct=0.5,
        attn_bias=True, dtype="float32",
    )
