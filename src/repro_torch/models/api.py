"""Unified model API over all assigned architectures.

    init_params(cfg, generator, device)   the model (:class:`Model`), random
    init_cache(cfg, batch, max_len)       decode state (KV / ring / recurrent)
    forward(cfg, model, tokens, ..)       logits, cache, MoE aux loss
    loss_fn(cfg, model, tokens, labels)   token cross-entropy (+ MoE aux),
                                          per-period remat for training
    prefill / decode_step                 serving entry points

Layers run in order: layer ``i < n_periods * len(pattern)`` is pattern
position ``i % len(pattern)`` of period ``i // len(pattern)``, and the
``tail_pattern`` layers (recurrentgemma's last 2) follow.  The decode
cache keeps the reference's layout -- per pattern position a dict of
tensors stacked over the periods (leading dim ``n_periods``), and
``cache["tail"]`` per tail layer -- and each layer writes its slice in
place.  ``cache_len`` is a Python int, so a decode step never waits for
the device.  The JAX package's parameter tree maps onto a model through
:func:`repro_torch.models.convert.from_reference`.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import sharding
from ..core.config import resolve_device
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import rwkv6 as RW
from . import transformer as T
from .mlp import MLP


def layer_kinds(cfg) -> list:
    """The mixer kind of every layer, in order."""
    return list(cfg.pattern) * cfg.n_periods + list(cfg.tail_pattern)


class Block(nn.Module):
    """One (mixer + ffn) block with pre-norms; ``mixer`` and ``ffn`` by
    the reference's names."""

    def __init__(self, cfg, kind: str, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm1 = L.Norm(cfg, cfg.d_model, device=device)
        self.norm2 = L.Norm(cfg, cfg.d_model, device=device)
        if kind in ("attn", "attn_local"):
            self.mixer = T.Attention(cfg, kind, device=device)
        elif kind == "rglru":
            self.mixer = RG.RGLRU(cfg, device=device)
        elif kind == "rwkv6":
            self.mixer = RW.RWKV6TimeMix(cfg, device=device)
        else:
            raise ValueError(kind)
        self.ffn = MOE.MoE(cfg, device=device) if cfg.n_experts \
            else MLP(cfg, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for m in (self.norm1, self.norm2, self.mixer, self.ffn):
            m.reset_parameters(generator)

    def forward(self, x, positions, cache=None, cache_len: int = 0):
        """Returns (x, aux or None); ``cache`` (this layer's) is written in
        place.  A sequence-parallel residual is gathered whole before each
        norm, and each sublayer returns its output in the residual's
        layout."""
        d = self.cfg.d_model
        h = self.norm1(L.whole_residual(x, d))
        if self.kind in ("attn", "attn_local"):
            mixed = self.mixer(h, positions, cache, cache_len)
        else:
            mixed = self.mixer(h, cache)
        x = x + mixed

        h2 = self.norm2(L.whole_residual(x, d))
        aux = None
        if self.cfg.n_experts:
            out, aux = self.ffn(h2)
        elif self.cfg.mlp == "rwkv_channel":
            if cache is None:
                shifted = torch.cat([torch.zeros_like(h2[:, :1]),
                                     h2[:, :-1]], dim=1)
            else:
                shifted = cache["shift_c"][:, None].to(h2.dtype)
            out = self.ffn(h2, shifted=shifted)
            if cache is not None:      # after the read: shifted may alias
                cache["shift_c"].copy_(h2[:, -1])
        else:
            out = self.ffn(h2)
        return L.constrain(x + out, "residual"), aux


class Model(nn.Module):
    """The whole stack: ``embed`` (absent for embedding inputs),
    ``layers`` in order, ``final_norm`` and ``head`` (absent when the
    embedding is tied)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.layers = nn.ModuleList(Block(cfg, kind, device=device)
                                    for kind in layer_kinds(cfg))
        self.final_norm = L.Norm(cfg, cfg.d_model, device=device)
        self.embed = None if cfg.embedding_inputs else nn.Embedding(
            cfg.vocab_size, cfg.d_model, device=device, dtype=dt)
        self.head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                              device=device, dtype=dt) \
            if not cfg.tie_embeddings or cfg.embedding_inputs else None

    def model_blocks(self, m: int) -> list:
        """The embedding and head, computed on their vocabulary blocks on a
        model axis that divides the vocabulary."""
        if m == 1 or self.cfg.vocab_size % m:
            return []
        return [f"{n}.weight" for n in ("embed", "head")
                if getattr(self, n) is not None]

    def _lookup(self, tokens):
        """The embedding of ``tokens`` in the residual's layout: on a
        split vocabulary each rank looks up the tokens of its block (the
        others masked to zero) and the rows are summed over the model axis
        (an ordered float32 sum: one term is nonzero)."""
        split = L.Split(self)
        if not split:
            return L.to_residual(self.embed(tokens))
        w = split.own("embed.weight")
        n = w.shape[0]
        idx = tokens.long() - split.ax.index * n
        inside = (idx >= 0) & (idx < n)
        part = F.embedding(idx.clamp(0, n - 1), w)
        part = torch.where(inside[..., None], part.float(), 0.0)
        return L.parts_to_residual(part, w.dtype)

    def _logits(self, x):
        """The logits of the final norm's output: on a split vocabulary
        this rank's block of them (``head``'s rows, or the tied
        embedding's)."""
        split = L.Split(self)
        if split:
            name = "head" if self.head is not None else "embed"
            return F.linear(L.column_input(x), split.own(f"{name}.weight"))
        if self.head is not None:
            return self.head(x)
        return x @ self.embed.weight.T

    @torch.no_grad()
    def reset_parameters(self, generator):
        for blk in self.layers:
            blk.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)
        if self.embed is not None:
            L.truncnorm_(self.embed.weight, 1.0, generator)
        if self.head is not None:
            L.dense_(self.head, generator)

    def layer_caches(self, cache) -> list:
        """Each layer's view of a decode cache (see the module docstring)."""
        p = len(self.cfg.pattern)
        n_body = p * self.cfg.n_periods
        out = []
        for i in range(len(self.layers)):
            if i < n_body:
                out.append({k: v[i // p] for k, v in cache[str(i % p)].items()})
            else:
                out.append(cache["tail"][str(i - n_body)])
        return out

    def segments(self) -> list:
        """The layers in the groups one remat checkpoint covers: each
        period's blocks, then each tail layer alone (the reference's
        scanned period body and its per-layer tail checkpoints)."""
        p = len(self.cfg.pattern)
        n_body = p * self.cfg.n_periods
        return [self.layers[i:i + p] for i in range(0, n_body, p)] \
            + [self.layers[i:i + 1] for i in range(n_body, len(self.layers))]

    @staticmethod
    def _run(blocks, x, positions, aux, caches=None, cache_len: int = 0):
        """``blocks`` in order; returns (x, aux + their aux losses)."""
        for j, blk in enumerate(blocks):
            x, a = blk(x, positions, None if caches is None else caches[j],
                       cache_len)
            if a is not None:
                aux = aux + a
        return x, aux

    def _run_gathered(self, gather, blocks, x, positions, aux):
        """:meth:`_run` with the blocks' parameters inside ``gather``
        (under remat this runs again in the backward: it gathers again)."""
        with gather(list(blocks)):
            return self._run(blocks, x, positions, aux)

    def forward(self, tokens, cache=None, cache_len: int = 0,
                remat: bool = False, gather=None):
        """tokens: (B, S) int or (B, S, D) embeddings.  Returns (logits,
        cache (updated in place) or None, aux loss).  ``remat`` (without
        a cache) recomputes each segment's activations in the backward
        instead of keeping them (``torch.utils.checkpoint``); the values
        and gradients are the same bits either way.  ``gather(modules)``
        (``sharding.ShardedModel.gathered``; without a cache) is a context
        in which the parameters of ``modules`` are whole: the pass enters
        it for the embedding's lookup (for the whole pass when the head is
        the embedding), for each segment (inside the checkpointed
        function), and for the final norm and head."""
        cfg = self.cfg
        if gather is not None and cache is not None:
            raise ValueError("a sharded decode step is "
                             "ShardedModel.decode_step")
        scope = gather or _whole
        tied = self.head is None and self.embed is not None
        with scope([self.embed] if tied else []):
            if cfg.embedding_inputs:
                x = L.to_residual(tokens.to(cfg.torch_dtype))
            else:
                with scope([] if tied else [self.embed]):
                    x = self._lookup(tokens)
            t = x.shape[1]
            positions = torch.arange(cache_len, cache_len + t,
                                     dtype=torch.int32, device=x.device)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            if cache is not None:
                x, aux = self._run(self.layers, x, positions, aux,
                                   self.layer_caches(cache), cache_len)
            else:
                for seg in self.segments():
                    run = functools.partial(self._run_gathered, scope, seg)
                    if remat:
                        # the blocks draw no random numbers: no RNG state
                        # to stash for the recomputation
                        x, aux = checkpoint(
                            run, x, positions, aux, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=sharding.recompute_context())
                    else:
                        x, aux = run(x, positions, aux)
            with scope([self.final_norm, self.head]):
                x = self.final_norm(L.whole_residual(x, cfg.d_model))
                logits = self._logits(x)
        return L.constrain(logits, "logits"), cache, aux


def _whole(modules):
    """The ``gather`` of a model that holds its parameters whole."""
    return contextlib.nullcontext()


def _check(cfg, model):
    if model.cfg != cfg:
        raise ValueError(f"model built for {model.cfg.name}, called with "
                         f"{cfg.name}")


# ---------------------------------------------------------------- params
def init_params(cfg, generator, device="cuda") -> Model:
    """A model of ``cfg`` with the reference's initialisers, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``)."""
    dev = resolve_device(device)
    model = Model(cfg, device="meta").to_empty(device=dev)
    model.reset_parameters(generator)
    return model


# ---------------------------------------------------------------- cache
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Decode state, stacked (n_periods, ...) per pattern position."""
    dev = resolve_device(device)

    def one(kind, lead=()):
        if kind in ("attn", "attn_local"):
            st = T.init_attn_cache(cfg, kind, batch, max_len, dtype, "meta")
        elif kind == "rglru":
            st = RG.init_rglru_state(cfg, batch, dtype, "meta")
        elif kind == "rwkv6":
            st = RW.init_rwkv_state(cfg, batch, dtype, "meta")
        else:
            raise ValueError(kind)
        return {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=dev)
                for k, v in st.items()}

    cache = {str(j): one(kind, (cfg.n_periods,))
             for j, kind in enumerate(cfg.pattern)}
    if cfg.tail_pattern:
        cache["tail"] = {str(j): one(kind)
                         for j, kind in enumerate(cfg.tail_pattern)}
    return cache


# --------------------------------------------------------------- forward
def forward(cfg, model, tokens, *, cache=None, cache_len: int = 0,
            remat: bool = False, gather=None):
    """tokens: (B, S) int or (B, S, D) embeddings.  Returns (logits,
    cache or None, aux_loss); a given cache is updated in place.
    ``remat``, ``gather``: see :meth:`Model.forward`."""
    _check(cfg, model)
    return model(tokens, cache=cache, cache_len=cache_len, remat=remat,
                 gather=gather)


def loss_fn(cfg, model, tokens, labels, *, remat: bool = True,
            gather=None):
    """Mean token cross-entropy + 0.01 x the MoE aux loss, and
    dict(ce=, aux=); differentiate it with ``loss.backward()``.  Logits
    split over the model axis (their vocabulary block) take the split
    log-sum-exp and the gold logit from the rank that owns it.  ``remat``
    checkpoints each period's blocks and each tail layer (the reference's
    per-period ``jax.checkpoint``); ``gather``: see
    :meth:`Model.forward`."""
    logits, _, aux = forward(cfg, model, tokens, remat=remat,
                             gather=gather)
    logits = logits.float()
    split = L.Split(model)
    if not split:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        # a vocabulary split over the model axis: no rank holds (B, S, V)
        ax, n = split.ax, logits.shape[-1]
        logz = sharding.split_logsumexp(logits, ax)
        lab = labels.long() - ax.index * n
        inside = (lab >= 0) & (lab < n)
        gold = torch.gather(logits, -1, lab.clamp(0, n - 1)[..., None])
        gold = sharding.sum_parts(torch.where(inside, gold[..., 0], 0.0),
                                  ax)
    ce = (logz - gold).mean()
    return ce + 0.01 * aux, dict(ce=ce, aux=aux)


# --------------------------------------------------------------- serving
@torch.no_grad()
def prefill(cfg, model, tokens):
    """Forward pass producing logits (no cache; decode fills its own).  A
    :class:`repro_torch.sharding.ShardedModel` runs under its rules: every
    rank passes the global batch and gets the global logits."""
    if isinstance(model, sharding.ShardedModel):
        _check(cfg, model)
        return model.prefill(tokens)
    return forward(cfg, model, tokens)[0]


@torch.no_grad()
def decode_step(cfg, model, tokens, cache, cache_len: int):
    """One-token decode against the cache.  tokens (B,1) or (B,1,D).
    Returns (logits, cache (updated in place), cache_len + 1).  A
    :class:`repro_torch.sharding.ShardedModel` takes a cache of blocks
    (its ``init_cache``) and runs under its rules: every rank passes the
    global batch and gets the global logits."""
    if isinstance(model, sharding.ShardedModel):
        _check(cfg, model)
        return model.decode_step(tokens, cache, cache_len), cache, \
            cache_len + 1
    logits, cache, _ = forward(cfg, model, tokens, cache=cache,
                               cache_len=cache_len)
    return logits, cache, cache_len + 1
