"""Yi-6B — llama-architecture GQA decoder [arXiv:2403.04652; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi_6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    mlp="swiglu", rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi_6b_smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=512, mlp="swiglu", dtype="float32",
    )
