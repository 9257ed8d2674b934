"""Carry the JAX package's parameter tree into the port's modules.

``from_reference(cfg, params)`` takes the tree of
``repro.models.api.init_params`` as numpy arrays (``jax.tree.map(
np.asarray, params)``; bfloat16 leaves come as ``ml_dtypes`` arrays) and
returns a :class:`~repro_torch.models.api.Model` with the same weights:

* ``blocks[str(j)]`` leaves carry a leading ``n_periods`` dim; period
  ``p`` goes to layer ``j + p * len(pattern)``; ``tail[str(j)]`` to the
  ``j``-th layer after the periods;
* a leaf goes to the module attribute of its name (``Attention``'s
  biases ``bq``/``bk``/``bv`` to ``wq.bias``/``wk.bias``/``wv.bias``);
  an ``nn.Linear`` takes the transpose (its weight is (out, in), the
  reference's (in, out)), an ``nn.Embedding`` and a plain parameter the
  array as it is.

Decode caches need no carry: both packages start them at zeros.  Nothing
here imports JAX: the caller converts the tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.config import resolve_device
from .api import Model


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _state(module: nn.Module, tree: dict, prefix: str, out: dict,
           period=None) -> None:
    """Add ``tree``'s leaves (row ``period`` of each, if given) to the
    state dict ``out`` under ``module``'s names."""
    names = getattr(module, "REF_NAMES", {})
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _state(getattr(module, key), leaf, f"{prefix}{key}.", out, period)
            continue
        arr = leaf if period is None else np.asarray(leaf)[period]
        target = names.get(key, key)
        obj = None if "." in target else getattr(module, target)
        if isinstance(obj, nn.Linear):
            out[f"{prefix}{target}.weight"] = _tensor(arr).T.contiguous()
        elif isinstance(obj, nn.Embedding):
            out[f"{prefix}{target}.weight"] = _tensor(arr)
        else:
            out[f"{prefix}{target}"] = _tensor(arr)


def carry(module: nn.Module, tree: dict) -> nn.Module:
    """Load one reference subtree (e.g. an ``attn_params`` dict) into
    ``module`` (built on any device, ``meta`` included); every parameter
    must be matched, shapes and all.  Returns the module, on the CPU."""
    sd = {}
    _state(module, tree, "", sd)
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def from_reference(cfg, params: dict, device="cuda") -> Model:
    """The port's model holding the reference tree ``params`` (numpy)."""
    dev = resolve_device(device)
    model = Model(cfg, device="meta")
    sd = {}
    p = len(cfg.pattern)
    for j in range(p):
        for period in range(cfg.n_periods):
            i = j + period * p
            _state(model.layers[i], params["blocks"][str(j)], f"layers.{i}.",
                   sd, period)
    for j in range(len(cfg.tail_pattern)):
        i = p * cfg.n_periods + j
        _state(model.layers[i], params["tail"][str(j)], f"layers.{i}.", sd)
    _state(model, {k: v for k, v in params.items()
                   if k not in ("blocks", "tail")}, "", sd)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev)
