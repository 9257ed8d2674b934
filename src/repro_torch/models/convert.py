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

The same mapping carries trees of the parameters' shape both ways:
:func:`state_from_reference` (e.g. an optimizer's moments,
:func:`opt_state_from_reference`) and :func:`to_reference` (e.g. the
port's gradients, for a comparison in the reference's layout).  Decode
caches need no carry: both packages start them at zeros.  Nothing here
imports JAX: the caller converts the tree.
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy (bfloat16 as float32: numpy has no bfloat16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _walk(module: nn.Module, tree: dict, prefix: str, path: tuple,
          period=None):
    """(reference path, period row or None, state-dict name, transposed)
    of every leaf of ``tree`` under ``module``."""
    names = getattr(module, "REF_NAMES", {})
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _walk(getattr(module, key), leaf, f"{prefix}{key}.",
                             path + (key,), period)
            continue
        target = names.get(key, key)
        obj = None if "." in target else getattr(module, target)
        if isinstance(obj, (nn.Linear, nn.Embedding)):
            yield (path + (key,), period, f"{prefix}{target}.weight",
                   isinstance(obj, nn.Linear))
        else:
            yield path + (key,), period, f"{prefix}{target}", False


def _pairs(cfg, tree: dict):
    """:func:`_walk` over a whole reference tree (parameters, or a tree of
    their shape such as gradients or moments): period ``p`` of
    ``blocks[str(j)]`` is layer ``j + p * len(pattern)``, ``tail[str(j)]``
    the ``j``-th layer after the periods."""
    model = Model(cfg, device="meta")
    p = len(cfg.pattern)
    for j in range(p):
        for period in range(cfg.n_periods):
            i = j + period * p
            yield from _walk(model.layers[i], tree["blocks"][str(j)],
                             f"layers.{i}.", ("blocks", str(j)), period)
    for j in range(len(cfg.tail_pattern)):
        i = p * cfg.n_periods + j
        yield from _walk(model.layers[i], tree["tail"][str(j)],
                         f"layers.{i}.", ("tail", str(j)))
    yield from _walk(model, {k: v for k, v in tree.items()
                             if k not in ("blocks", "tail")}, "", ())


def _skeleton(module: nn.Module, skip=()) -> dict:
    """The reference subtree of ``module`` as shapes: :func:`_walk`'s
    mapping read backwards (a Linear's weight transposed, ``REF_NAMES``
    inverted)."""
    ref_of = {v: k for k, v in getattr(module, "REF_NAMES", {}).items()}
    tree = {}
    for name, p in module.named_parameters(recurse=False):
        tree[ref_of.get(name, name)] = tuple(p.shape)
    for name, child in module.named_children():
        if name in skip:
            continue
        if isinstance(child, (nn.Linear, nn.Embedding)):
            shape = tuple(child.weight.shape)
            tree[name] = shape[::-1] if isinstance(child, nn.Linear) \
                else shape
            if getattr(child, "bias", None) is not None:
                tree[ref_of[f"{name}.bias"]] = tuple(child.bias.shape)
        else:
            tree[name] = _skeleton(child)
    return tree


def reference_shapes(cfg) -> dict:
    """The shapes of the reference's parameter tree of ``cfg``
    (``repro.models.api.init_params`` under ``jax.eval_shape``) as a
    nested dict of tuples, from the port's modules: ``blocks`` stacked
    over the periods, ``tail``, and the top-level leaves."""
    model = Model(cfg, device="meta")
    p = len(cfg.pattern)

    def stacked(tree):
        return {k: stacked(v) if isinstance(v, dict)
                else (cfg.n_periods,) + v for k, v in tree.items()}
    tree = {"blocks": {str(j): stacked(_skeleton(model.layers[j]))
                       for j in range(p)}}
    if cfg.tail_pattern:
        tree["tail"] = {str(j): _skeleton(model.layers[p * cfg.n_periods + j])
                        for j in range(len(cfg.tail_pattern))}
    tree.update(_skeleton(model, skip=("layers",)))
    return tree


def reference_leaves(cfg) -> dict:
    """{state-dict name of a ``cfg`` model: (reference path ``"a/b/c"``,
    the reference leaf's shape, whether that leaf is stacked over the
    periods, whether the port's tensor is its transpose)} -- what
    ``sharding.Rules`` reads a parameter's spec from."""
    tree = reference_shapes(cfg)
    return {name: ("/".join(path), _get(tree, path), period is not None,
                   transposed)
            for path, period, name, transposed in _pairs(cfg, tree)}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def state_from_reference(cfg, tree: dict) -> dict:
    """A reference-layout tree (numpy) as {state-dict name: CPU tensor}
    of a ``cfg`` model: a Linear's leaf transposed, a stacked leaf's
    row."""
    out = {}
    for path, period, name, transposed in _pairs(cfg, tree):
        arr = _get(tree, path)
        if period is not None:
            arr = np.asarray(arr)[period]
        t = _tensor(arr)
        out[name] = t.T.contiguous() if transposed else t
    return out


def to_reference(cfg, tensors: dict, like: dict) -> dict:
    """The inverse of :func:`state_from_reference`: {state-dict name:
    tensor} (e.g. the gradients) laid out as the reference tree ``like``
    (numpy; bfloat16 comes back as float32)."""
    out: dict = {}
    for path, period, name, transposed in _pairs(cfg, like):
        t = tensors[name]
        arr = _numpy(t.T if transposed else t)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if period is None:
            node[path[-1]] = arr
        else:
            if path[-1] not in node:
                node[path[-1]] = np.empty(
                    (cfg.n_periods,) + arr.shape, arr.dtype)
            node[path[-1]][period] = arr
    return out


def carry(module: nn.Module, tree: dict) -> nn.Module:
    """Load one reference subtree (e.g. an ``attn_params`` dict) into
    ``module`` (built on any device, ``meta`` included); every parameter
    must be matched, shapes and all.  Returns the module, on the CPU."""
    sd = {}
    for path, _, name, transposed in _walk(module, tree, "", ()):
        t = _tensor(_get(tree, path))
        sd[name] = t.T.contiguous() if transposed else t
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def from_reference(cfg, params: dict, device="cuda") -> Model:
    """The port's model holding the reference tree ``params`` (numpy)."""
    dev = resolve_device(device)
    model = Model(cfg, device="meta")
    model.load_state_dict(state_from_reference(cfg, params), strict=True,
                          assign=True)
    return model.to(dev)


def opt_state_from_reference(cfg, state, model: Model):
    """A reference ``AdamWState`` (its leaves as numpy:
    ``jax.tree.map(np.asarray, state)``) as the port's
    :class:`~repro_torch.train.optimizer.AdamWState` for ``model``: the
    moments by parameter name, through the leaf mapping of
    :func:`from_reference`, on the model's device in their own dtype."""
    from ..train.optimizer import AdamWState
    dev = next(model.parameters()).device

    def moments(tree):
        return {k: v.to(dev) for k, v in
                state_from_reference(cfg, tree).items()}
    return AdamWState(
        torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                     device=dev),
        moments(state.mu), moments(state.nu))
