"""Nemotron-4-340B — GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (kv=8) d_ff=73728 vocab=256000; partial rotary (50%).
The largest assigned cell: FSDP+TP+remat+microbatching gate (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron_4_340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    mlp="relu2", rotary_pct=0.5,
    source="arXiv:2402.16819",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron_4_340b_smoke", family="dense",
        n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
        d_ff=384, vocab_size=512, mlp="relu2", rotary_pct=0.5,
        dtype="float32",
    )
