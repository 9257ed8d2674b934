"""Attention sublayer: GQA/MQA/MHA, causal/bidirectional/local, RoPE,
KV-cache prefill/decode, online-softmax KV-chunk streaming.

One implementation covers all seven attention-bearing assigned archs:
  * GQA with any kv<=heads (yi 4, nemotron/internvl 8, granite/rgemma MQA 1)
  * full causal, bidirectional (hubert), sliding-window (recurrentgemma)
  * partial rotary (nemotron/chatglm 0.5, hubert 0)
  * decode against a ring-buffered (local) or linear (global) KV cache

Query head ``kv * g + j`` reads KV head ``kv`` (``g`` = heads / KV heads).
Without a cache the softmax streams over 1,024-key chunks with a running
(max, denominator, accumulator) carry, so the (Tq, Tk) score matrix never
exists beyond (Tq, chunk); a decode step attends to its cache in one
shot.  The score and value products take their inputs in the residual
dtype and accumulate and return float32 (the reference's
``preferred_element_type``); on the card their gradient is
:class:`_BmmF32`'s, whose two backward products take the same form.
Masked scores are ``NEG_INF``, not ``-inf``.  The cache is written in
place.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import sharding
from ..core.config import on_card
from . import layers as L

NEG_INF = -1e30
KV_CHUNK = 1024


def _mm_f32(a, b):
    """a @ b (batched) in the inputs' dtype, float32 out with float32
    accumulation (``aten::bmm.dtype``: the card and ``meta`` only)."""
    return torch.bmm(a, b, out_dtype=torch.float32)


class _BmmF32(torch.autograd.Function):
    """:func:`_mm_f32` with a gradient (``aten::bmm.dtype`` has none): the
    two products of the backward take the float32 cotangent rounded to
    the inputs' dtype, accumulate in float32 as the forward does, and
    return the inputs' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_f32(g, b.transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm_f32(a.transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _bmm_f32(a, b):
    """a @ b (batched), float32 out with float32 accumulation; the inputs
    stay in their dtype where the device multiplies them so (the CPU
    upcasts them).  Only a product that autograd records goes through
    :class:`_BmmF32`: serving calls the op directly."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cpu" and not on_card(a):
        return torch.bmm(a.float(), b.float())
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _BmmF32.apply(a, b)
    return _mm_f32(a, b)


def _scores(qf, kch):
    """qf (B, KV, Tq*G, hd) x kch (B, C, KV, hd) -> (B, KV, Tq*G, C) f32."""
    b, kv, r, hd = qf.shape
    c = kch.shape[1]
    kt = kch.to(qf.dtype).permute(0, 2, 3, 1).reshape(b * kv, hd, c)
    return _bmm_f32(qf.reshape(b * kv, r, hd), kt).view(b, kv, r, c)


def _values(p, vch):
    """p (B, KV, Tq*G, C) x vch (B, C, KV, hd) -> (B, KV, Tq*G, hd) f32."""
    b, kv, r, c = p.shape
    hd = vch.shape[-1]
    vt = vch.permute(0, 2, 1, 3).reshape(b * kv, c, hd)
    return _bmm_f32(p.to(vch.dtype).reshape(b * kv, r, c), vt) \
        .view(b, kv, r, hd)


def _mask(q_pos, kv_pos, g: int, causal: bool, window: int):
    """Valid (query row, key) pairs, (Tq*G, C): rows are (t, j) of qf."""
    ok = kv_pos[None, :] >= 0
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
    return ok.repeat_interleave(g, dim=0)


def _sdpa_streamed(q, k, v, q_pos, kv_pos, *, causal: bool, window: int):
    """Online-softmax attention.

    q: (B, Tq, H, hd); k/v: (B, Tk, KV, hd); q_pos (Tq,), kv_pos (Tk,)
    absolute positions (kv_pos < 0 marks an invalid cache slot).
    Returns (B, Tq, H, hd) in q.dtype; accumulation in f32.
    """
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    # the scale rounded to q's dtype, as the reference multiplies
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    qf = (q * scale).reshape(b, tq, kv, g, hd)
    # Divisibility-aware head layout: KV heads over `model` when they
    # divide it, else the query time dim (the reference's site; decode,
    # tq = 1, falls through to replicated)
    dp = sharding.current_dp()
    qf = L.constrain_first_fit(qf, [
        sharding.P(dp, None, "model", None, None),
        sharding.P(dp, "model", None, None, None),
    ])
    # (B, Tq, KV, G, hd) -> (B, KV, Tq*G, hd)
    qf = qf.permute(0, 2, 1, 3, 4).reshape(b, kv, tq * g, hd)

    def finish(acc, l):
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.view(b, kv, tq, g, hd).permute(0, 2, 1, 3, 4) \
            .reshape(b, tq, h, hd).to(q.dtype)

    if tq == 1:
        # decode: single-shot attention over the cache
        s = _scores(qf, k)
        s = torch.where(_mask(q_pos, kv_pos, g, causal, window), s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        return finish(_values(p, v), p.sum(-1))

    nchunks = max(1, (tk + KV_CHUNK - 1) // KV_CHUNK)
    csize = (tk + nchunks - 1) // nchunks
    m = torch.full((b, kv, tq * g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, tq * g, hd), dtype=torch.float32,
                      device=q.device)
    # the reference's chunks; it pads the last one with invalid slots,
    # which add exp(NEG_INF - m) = 0 to a row with a valid key
    for c0 in range(0, tk, csize):
        kch, vch, pch = k[:, c0:c0 + csize], v[:, c0:c0 + csize], \
            kv_pos[c0:c0 + csize]
        s = _scores(qf, kch)
        s = torch.where(_mask(q_pos, pch, g, causal, window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + _values(pexp, vch)
        m = m_new
    return finish(acc, l)


class Attention(nn.Module):
    """The full attention sublayer (projections + RoPE + SDPA + out
    proj).  ``wq``/``wk``/``wv``/``wo`` are ``nn.Linear``; the reference's
    biases ``bq``/``bk``/``bv`` are the first three's ``bias``."""

    #: reference leaf -> this module's attribute (``convert``)
    REF_NAMES = {"bq": "wq.bias", "bk": "wk.bias", "bv": "wv.bias"}

    def __init__(self, cfg, kind: str, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.window = cfg.window if kind == "attn_local" else 0
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(device=device, dtype=cfg.torch_dtype)
        self.wq = nn.Linear(d, cfg.n_heads * hd, bias=cfg.attn_bias, **kw)
        self.wk = nn.Linear(d, cfg.n_kv_heads * hd, bias=cfg.attn_bias, **kw)
        self.wv = nn.Linear(d, cfg.n_kv_heads * hd, bias=cfg.attn_bias, **kw)
        self.wo = nn.Linear(cfg.n_heads * hd, d, bias=False, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for lin in (self.wq, self.wk, self.wv):
            L.dense_(lin, generator)
        L.dense_(self.wo, generator, scale=self.wo.weight.shape[1] ** -0.5)

    def forward(self, x, positions, cache=None, cache_len: int = 0):
        """x (B, T, D); positions: (T,) absolute positions of x's tokens.
        cache: None (training / prefill without cache) or dict(k=(B, S,
        KV, hd), v=...) to decode against, written in place at
        ``cache_len`` (the number of valid entries; a ring slot for a
        local window)."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        q = self.wq(x).view(b, t, cfg.n_heads, hd)
        k = self.wk(x).view(b, t, cfg.n_kv_heads, hd)
        v = self.wv(x).view(b, t, cfg.n_kv_heads, hd)
        tables = L.rope_tables(positions, hd, cfg.rotary_pct, cfg.rope_theta)
        q = L.apply_rope(q, tables)
        k = L.apply_rope(k, tables)

        if cache is None:
            out = _sdpa_streamed(q, k, v, positions, positions,
                                 causal=cfg.causal, window=self.window)
        else:
            s = cache["k"].shape[1]
            write_at = cache_len % s if self.window else cache_len
            if write_at + t > s:
                raise ValueError(f"{t} tokens at slot {write_at} overrun "
                                 f"a {s}-slot cache")
            cache["k"][:, write_at:write_at + t] = k
            cache["v"][:, write_at:write_at + t] = v
            slots = torch.arange(s, dtype=torch.int32, device=x.device)
            if self.window:
                # slot i holds the largest pos <= cache_len with pos % s == i
                kv_pos = cache_len - (cache_len - slots) % s
            else:
                kv_pos = torch.where(slots <= cache_len, slots, -1)
            out = _sdpa_streamed(q, cache["k"], cache["v"], positions,
                                 kv_pos, causal=cfg.causal,
                                 window=self.window)
        return L.constrain(self.wo(out.reshape(b, t, -1)), "residual")


def init_attn_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                    device):
    hd = cfg.resolved_head_dim
    s = min(cfg.window, max_len) if kind == "attn_local" else max_len
    shape = (batch, s, cfg.n_kv_heads, hd)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))
