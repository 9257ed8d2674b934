"""Architecture configuration schema + registry.

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``get_config(name)`` / ``--arch <id>`` select
them.  Each config also provides ``reduced()`` — the same family at
smoke-test scale — and ``input_specs(cfg, shape)`` returns ``meta``-device
tensors standing in for every model input of a workload shape (no device
allocation).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

# The four assigned LM workload shapes (global).
SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None     # default d_model // n_heads
    mlp: str = "swiglu"             # swiglu | gelu | relu2
    norm: str = "rms"               # rms | layer
    causal: bool = True             # False => encoder-only (no decode)
    rotary_pct: float = 1.0         # chatglm "2d" RoPE rotates half the dims
    rope_theta: float = 10000.0
    attn_bias: bool = False
    # hybrid / ssm layer pattern: one entry per layer in the repeating period
    # e.g. ("rglru", "rglru", "attn_local") for RecurrentGemma.  ("attn",) for
    # pure transformers; ("rwkv6",) for RWKV.
    pattern: tuple = ("attn",)
    # trailing layers that don't complete a period (recurrentgemma's final
    # (rglru, rglru)); they follow the periods
    tail_pattern: tuple = ()
    window: int = 0                 # local-attention window (attn_local)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # rwkv6 / rglru
    rnn_heads: int = 0
    rglru_width: int = 0            # recurrence width (d_model multiple)
    conv_width: int = 4
    # modality frontend: inputs are precomputed embeddings, not token ids
    embedding_inputs: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # sub-quadratic? (controls long_500k applicability)
    subquadratic: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return all(p == "rwkv6" for p in self.pattern)

    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.tail_pattern)
        if body % len(self.pattern):
            raise ValueError(f"{self.name}: {body} body layers not "
                             "divisible by pattern")
        return body // len(self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        def per_layer(kind):
            per = 0
            if kind in ("attn", "attn_local"):
                per += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
            elif kind == "rglru":
                w = self.rglru_width or d
                per += 2 * d * w + w * d + 2 * w * self.conv_width + 3 * w
            elif kind == "rwkv6":
                per += 4 * d * d + 2 * d * d // 16  # qkvg + lora decays
            if self.n_experts:
                per += self.n_experts * 3 * d * self.expert_d_ff
                per += self.n_shared_experts * 3 * d * self.d_ff
                per += d * self.n_experts
            else:
                mults = 3 if self.mlp == "swiglu" else 2
                per += mults * d * f
            return per + 2 * d  # + norms

        for kind in self.pattern:
            n += per_layer(kind) * self.n_periods
        for kind in self.tail_pattern:
            n += per_layer(kind)
        return n

    def active_param_count(self) -> int:
        """Active N per token (MoE: only routed top_k + shared experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() \
            - self.n_layers * self.n_experts * 3 * d * self.expert_d_ff
        active = self.n_layers * self.top_k * 3 * d * self.expert_d_ff
        return dense + active


def input_specs(cfg: ModelConfig, shape_name: str, *, batch_override=None,
                seq_override=None):
    """``meta`` tensors standing in for every model input of one cell
    (``batch_override`` / ``seq_override``: another global batch or
    sequence length, the cuts of a run on one card or on the CPU).

    train:   {tokens (B,S) i32, labels (B,S) i32}     [embedding_inputs:
              embeds (B,S,D) bf16 instead of tokens]
    prefill: {tokens (B,S)}
    decode:  {tokens (B,1), cache (per-layer KV / recurrent state),
              cache_len ()}
    """
    from ..models import api
    spec = SHAPES[shape_name]
    b = batch_override or spec["global_batch"]
    s = seq_override or spec["seq_len"]
    dt = torch.bfloat16

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def tokens(t):
        return (meta((b, t, cfg.d_model), dt) if cfg.embedding_inputs
                else meta((b, t), torch.int32))
    if spec["kind"] == "train":
        return dict(tokens=tokens(s), labels=meta((b, s), torch.int32))
    if spec["kind"] == "prefill":
        return dict(tokens=tokens(s))
    # decode: one new token against an s-long cache
    cache = api.init_cache(cfg, b, s, dtype=dt, device="meta")
    return dict(tokens=tokens(1), cache=cache,
                cache_len=meta((), torch.int32))


def runnable_cells(cfg: ModelConfig) -> list:
    """The (shape) cells this arch runs: no decode for an encoder, the
    500k-token decode only for a sub-quadratic arch."""
    cells = ["train_4k", "prefill_32k"]
    if cfg.causal:
        cells.append("decode_32k")
        if cfg.subquadratic:
            cells.append("long_500k")
    return cells


ARCH_IDS = [
    "internvl2_26b", "yi_6b", "granite_34b", "nemotron_4_340b",
    "chatglm3_6b", "hubert_xlarge", "olmoe_1b_7b", "llama4_scout_17b_a16e",
    "recurrentgemma_2b", "rwkv6_1b6",
]


def _module(name: str):
    return importlib.import_module(
        f"{__package__}.{name.replace('-', '_')}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
