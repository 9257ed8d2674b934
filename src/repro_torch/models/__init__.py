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
products' gradient is ``transformer._BmmF32``'s.  The sharding hooks
(``layers.constrain``) read :mod:`repro_torch.sharding`'s active rules;
``runmode.py`` (XLA cost calibration) has no counterpart yet (ROADMAP
Queue 1 item 6c, part 2).
"""
from . import (api, convert, frontends, layers, mlp, moe, rglru, rwkv6,
               transformer)

__all__ = ["api", "convert", "frontends", "layers", "mlp", "moe", "rglru",
           "rwkv6", "transformer"]
