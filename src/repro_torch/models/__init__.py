"""Assigned-architecture model stack, the port of ``repro.models``.

    layers.py       norms, RoPE, initialisers
    transformer.py  GQA attention: causal/bidir/local, KV cache, streaming
    mlp.py          swiglu / gelu / relu^2 / rwkv channel-mix
    moe.py          top-k expert routing with static capacity
    rglru.py        RecurrentGemma RG-LRU recurrent block
    rwkv6.py        RWKV-6 chunked WKV time-mix
    api.py          init/forward/loss (per-period remat)/prefill/decode
                    over any ModelConfig
    frontends.py    [vlm]/[audio] embedding stubs
    convert.py      the JAX package's trees <-> a port model's names

Plain PyTorch on any device: no custom kernel lies on this path (the JAX
package computes it in plain ``jnp`` too); on the card the attention
products' gradient is ``layers._BmmF32``'s.  The sharding hooks
(``layers.constrain``) and the model-axis helpers (``layers.Split``, each
layer's plan from its ``model_blocks``; ``column_input``, ``row_output``,
...) read :mod:`repro_torch.sharding`'s active rules: under a model axis
each layer computes its share.
``runmode.py`` (XLA cost calibration) needs no counterpart (the dry-run
counts every iteration of the port's Python loops).
"""
from . import (api, convert, frontends, layers, mlp, moe, rglru, rwkv6,
               transformer)

__all__ = ["api", "convert", "frontends", "layers", "mlp", "moe", "rglru",
           "rwkv6", "transformer"]
