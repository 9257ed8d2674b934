"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447].

48L d_model=1280 16H (kv=16, i.e. full MHA) d_ff=5120 vocab=504 (cluster
targets).  Encoder-only: bidirectional attention, no KV cache, no decode
shapes.  The CNN waveform frontend is a STUB: input_specs deliver
precomputed frame embeddings (B, S, d_model).  LayerNorm + GELU per the
wav2vec2 lineage; no rotary (conv positional embeddings stubbed out).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert_xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    mlp="gelu", norm="layer", causal=False, rotary_pct=0.0,
    attn_bias=True, embedding_inputs=True,
    source="arXiv:2106.07447",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert_xlarge_smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=64, mlp="gelu", norm="layer",
        causal=False, rotary_pct=0.0, attn_bias=True,
        embedding_inputs=True, dtype="float32",
    )
