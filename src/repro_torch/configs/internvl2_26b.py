"""InternVL2-26B — InternViT frontend + InternLM2-20B backbone [arXiv:2404.16821; hf].

Assigned spec: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The ViT frontend is a STUB per assignment: input_specs deliver precomputed
patch embeddings (B, S, d_model); the backbone is the lowered/rooflined part.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    mlp="swiglu", rope_theta=1_000_000.0,
    embedding_inputs=True,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2_26b_smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, mlp="swiglu",
        embedding_inputs=True, dtype="float32",
    )
