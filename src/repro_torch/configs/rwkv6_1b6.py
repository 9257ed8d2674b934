"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536; 32 WKV heads of dim 64.
O(1)-state decode => runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1b6", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    mlp="rwkv_channel", pattern=("rwkv6",), rnn_heads=32,
    subquadratic=True,
    source="arXiv:2404.05892",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=224, vocab_size=512, mlp="rwkv_channel",
        pattern=("rwkv6",), rnn_heads=4,
        subquadratic=True, dtype="float32",
    )
