"""RecurrentGemma-2B — Griffin: RG-LRU + local attention 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
window 2048.  Pattern: (recurrent, recurrent, local-attn) repeating; 26
layers = 8 full triplets + a trailing (recurrent, recurrent).  Sub-
quadratic => runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    mlp="swiglu", pattern=("rglru", "rglru", "attn_local"),
    tail_pattern=("rglru", "rglru"), window=2048,
    rglru_width=2560, conv_width=4, rnn_heads=10,
    subquadratic=True,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_2b_smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, mlp="swiglu",
        pattern=("rglru", "rglru", "attn_local"), window=16,
        rglru_width=64, conv_width=4, rnn_heads=4,
        subquadratic=True, dtype="float32",
    )
