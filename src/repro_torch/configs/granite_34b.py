"""Granite-34B-Code — GPT-BigCode lineage, MQA (kv=1) [arXiv:2405.04324; hf].

Non-gated GELU MLP (d_ff = 4*d_model), attention biases.  The released
model uses learned absolute positions; we adapt to RoPE for the shared
decode path (hardware-adaptation note in DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite_34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    mlp="gelu", attn_bias=True,
    source="arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite_34b_smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab_size=512, mlp="gelu", attn_bias=True,
        dtype="float32",
    )
