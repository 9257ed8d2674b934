"""Modality frontends for [vlm]/[audio] archs — STUBS per the assignment.

The assigned internvl2 (ViT patch frontend) and hubert (waveform CNN
frontend) cells specify the transformer BACKBONE only; ``input_specs()``
delivers precomputed patch/frame embeddings of shape (B, S, d_model)
(``ModelConfig.embedding_inputs = True``), and the backbone consumes them
directly (the model skips the token embedding).

For runnable smoke tests and examples, ``fake_embeddings`` below
synthesises deterministic embeddings with the right statistics from a
``torch.Generator`` (on the device the tensors go to).
"""
from __future__ import annotations

import torch

from ..core.config import resolve_device


def fake_embeddings(generator, batch: int, seq: int, d_model: int,
                    dtype=torch.float32, device="cuda"):
    """Unit-variance stand-in for frontend outputs."""
    return torch.randn((batch, seq, d_model), generator=generator,
                       dtype=dtype, device=resolve_device(device))


def fake_frame_labels(generator, batch: int, seq: int, vocab: int,
                      device="cuda"):
    return torch.randint(0, vocab, (batch, seq), generator=generator,
                         device=resolve_device(device))
