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
``layers._BmmF32``'s, whose two backward products take the same form.
Masked scores are ``NEG_INF``, not ``-inf``.  The cache is written in
place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import sharding
from . import layers as L

NEG_INF = -1e30
KV_CHUNK = 1024


def _scores(qf, kch):
    """qf (B, KV, Tq*G, hd) x kch (B, C, KV, hd) -> (B, KV, Tq*G, C) f32."""
    b, kv, r, hd = qf.shape
    c = kch.shape[1]
    kt = kch.to(qf.dtype).permute(0, 2, 3, 1).reshape(b * kv, hd, c)
    return L.bmm_f32(qf.reshape(b * kv, r, hd), kt).view(b, kv, r, c)


def _values(p, vch):
    """p (B, KV, Tq*G, C) x vch (B, C, KV, hd) -> (B, KV, Tq*G, hd) f32."""
    b, kv, r, c = p.shape
    hd = vch.shape[-1]
    vt = vch.permute(0, 2, 1, 3).reshape(b * kv, c, hd)
    return L.bmm_f32(p.to(vch.dtype).reshape(b * kv, r, c), vt) \
        .view(b, kv, r, hd)


def _mask(q_pos, kv_pos, g: int, causal: bool, window: int):
    """Valid (query row, key) pairs, (Tq*G, C): rows are (t, j) of qf."""
    ok = kv_pos[None, :] >= 0
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
    return ok.repeat_interleave(g, dim=0)


def _sdpa_streamed(q, k, v, q_pos, kv_pos, *, causal: bool, window: int,
                   parts=None):
    """Online-softmax attention.

    q: (B, Tq, H, hd); k/v: (B, Tk, KV, hd); q_pos (Tq,), kv_pos (Tk,)
    absolute positions (kv_pos < 0 marks an invalid cache slot).
    Returns (B, Tq, H, hd) in q.dtype; accumulation in f32.  ``parts``
    (a decode step over a cache whose slots are split over that group):
    each rank's (max, denominator, accumulator) over its slots are
    combined in rank order before the division.
    """
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    # the scale rounded to q's dtype, as the reference multiplies
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    qf = (q * scale).reshape(b, tq, kv, g, hd)
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
        acc, l = _values(p, v), p.sum(-1)
        if parts is not None:
            acc, l = _combine(parts, m[..., 0], l, acc)
        return finish(acc, l)

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
    if parts is not None:
        acc, l = _combine(parts, m, l, acc)
    return finish(acc, l)


def _combine(ax, m, l, acc):
    """The (denominator, accumulator) over every rank's slots from each
    rank's (max, denominator, accumulator): rescaled to the ranks' max and
    added in rank order, the same bits on every rank.  A rank whose slots
    are all invalid holds max NEG_INF, and its rescale is exp(-1e30) = 0:
    the step's own slot is valid on its owner."""
    ms = sharding.stack_over(m, ax)
    ls = sharding.stack_over(l, ax)
    accs = sharding.stack_over(acc, ax)
    top = ms.amax(dim=0)
    l_out, acc_out = None, None
    for j in range(ax.size):
        a = torch.exp(ms[j] - top)
        lj, accj = ls[j] * a, accs[j] * a[..., None]
        l_out = lj if l_out is None else l_out + lj
        acc_out = accj if acc_out is None else acc_out + accj
    return acc_out, l_out


class Attention(nn.Module):
    """The full attention sublayer (projections + RoPE + SDPA + out
    proj).  ``wq``/``wk``/``wv``/``wo`` are ``nn.Linear``; the reference's
    biases ``bq``/``bk``/``bv`` are the first three's ``bias``.

    Under rules with a model axis (``sharding.model_group``) the layer
    runs the reference's first fit (after its KV-head repeat) on this
    rank: split heads (``wq``/``wk``/``wv`` column blocks, ``wo`` a row
    block and an ordered sum), else a block of query positions against
    the whole K/V (whole weights, their gradients summed over the axis),
    else the whole layer.  A decode step splits the heads where the KV
    heads divide the axis, else attends over this rank's slots of a
    sequence-split cache (``ShardedModel.decode_step``)."""

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

    def model_blocks(self, m: int) -> list:
        """The parameters this layer computes on as their model-axis
        blocks on an axis of ``m``: the head split's."""
        if not sharding.heads_split(self.cfg, m):
            return []
        names = ["wq.weight", "wo.weight"]
        if self.cfg.n_kv_heads % m == 0:
            names += ["wk.weight", "wv.weight"]
        return names

    def _specs(self):
        dp = sharding.current_dp()
        return [sharding.P(dp, None, "model", None, None),
                sharding.P(dp, "model", None, None, None)]

    def _proj(self, split, name: str, x):
        """The product ``name`` of ``x`` as (B, T, heads, hd): this rank's
        head block where the plan ``split`` names its weight, else all the
        heads."""
        lin = getattr(self, name)
        w, bias = lin.weight, lin.bias
        if f"{name}.weight" in split.blocks:
            w = split.own(f"{name}.weight")
            bias = None if bias is None else split.own(f"{name}.bias")
        y = F.linear(x, w, bias)
        return y.view(*x.shape[:2], -1, self.cfg.resolved_head_dim)

    def forward(self, x, positions, cache=None, cache_len: int = 0):
        """x (B, T, D); positions: (T,) absolute positions of x's tokens.
        cache: None (training / prefill without cache) or dict(k=(B, S,
        KV, hd), v=...) to decode against, written in place at
        ``cache_len`` (the number of valid entries; a ring slot for a
        local window)."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        split = L.Split(self)
        ax = split.ax
        if cache is not None:
            return self._decode(x, positions, cache, cache_len, split)
        r = 1 if ax is None else sharding.kv_repeat(cfg, ax.size)
        # Divisibility-aware head layout: KV heads (after the repeat) over
        # `model` when they divide it (the plan's head split), else the
        # query time dim
        spec = sharding.first_fit((b, t, kv * r, h // (kv * r), hd),
                                  self._specs())
        tables = L.rope_tables(positions, hd, cfg.rotary_pct, cfg.rope_theta)
        if split:
            xi = L.column_input(x)
            q = self._proj(split, "wq", xi)
            if "wk.weight" in split.blocks:
                k, v = self._proj(split, "wk", xi), self._proj(split, "wv", xi)
            else:
                # the repeat: whole K/V heads, this rank's block of their
                # r copies (the weights' gradients: the ranks' sum)
                n = kv * r // ax.size
                k, v = (F.linear(xi, sharding.sum_grad(lin.weight, ax),
                                 sharding.sum_grad(lin.bias, ax)
                                 if lin.bias is not None else None)
                        .view(b, t, kv, hd).repeat_interleave(r, dim=2)
                        .narrow(2, ax.index * n, n)
                        for lin in (self.wk, self.wv))
            q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
            out = _sdpa_streamed(q, k, v, positions, positions,
                                 causal=cfg.causal, window=self.window)
            return L.row_output(out.reshape(b, t, -1),
                                split.own("wo.weight", 1))
        if ax is not None and spec is not None:
            return self._query_block(x, positions, ax)
        q, k, v = (self._proj(split, n, x) for n in ("wq", "wk", "wv"))
        q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
        out = _sdpa_streamed(q, k, v, positions, positions,
                             causal=cfg.causal, window=self.window)
        return L.to_residual(self.wo(out.reshape(b, t, -1)))

    def _query_block(self, x, positions, ax):
        """The query-time split: this rank's block of positions against
        the whole K/V (its own keys gathered over the axis), the weights
        whole; the outputs gathered back over the positions."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        n = t // ax.size
        xl = sharding.take_block(x, ax, 1)
        pos = positions[ax.index * n:(ax.index + 1) * n]
        w = {k: sharding.sum_grad(getattr(self, k).weight, ax)
             for k in ("wq", "wk", "wv", "wo")}
        bias = {k: sharding.sum_grad(getattr(self, k).bias, ax)
                if getattr(self, k).bias is not None else None
                for k in ("wq", "wk", "wv")}
        q, k, v = (F.linear(xl, w[k], bias[k]).view(b, n, -1, hd)
                   for k in ("wq", "wk", "wv"))
        tables = L.rope_tables(pos, hd, cfg.rotary_pct, cfg.rope_theta)
        q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
        k = sharding.gather_scatter_grad(k, ax, 1)
        v = sharding.gather_scatter_grad(v, ax, 1)
        out = _sdpa_streamed(q, k, v, pos, positions, causal=cfg.causal,
                             window=self.window)
        y = F.linear(out.reshape(b, n, -1), w["wo"])
        return L.to_residual(sharding.gather_blocks(y, ax, 1))

    def _decode(self, x, positions, cache, cache_len: int, split):
        """Decode against ``cache`` (module docstring).  Under a model
        split (the plan ``split``): the heads where the KV heads divide
        the axis (this rank's heads of a whole cache by a narrow, the new
        entries gathered over the heads to be written); else every head on
        this rank's slots (``cache["slot0"]`` of ``cache["slots"]``, a
        sequence-split cache), the query gathered over the heads where
        ``wq`` is a block, the partial softmax combined over the axis, and
        ``wo`` on this rank's heads where it is a block."""
        cfg = self.cfg
        ax = split.ax
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        kc, vc = cache["k"], cache["v"]
        s_loc = kc.shape[1]
        s0, s = cache.get("slot0", 0), cache.get("slots", s_loc)
        write_at = cache_len % s if self.window else cache_len
        if write_at + t > s:
            raise ValueError(f"{t} tokens at slot {write_at} overrun "
                             f"a {s}-slot cache")
        slots = torch.arange(s0, s0 + s_loc, dtype=torch.int32,
                             device=x.device)
        if self.window:
            # slot i holds the largest pos <= cache_len with pos % s == i
            kv_pos = cache_len - (cache_len - slots) % s
        else:
            kv_pos = torch.where(slots <= cache_len, slots, -1)
        tables = L.rope_tables(positions, hd, cfg.rotary_pct, cfg.rope_theta)
        sharding.first_fit((b, t, kv, h // kv, hd), self._specs())
        if "wk.weight" in split.blocks:
            n = kv // ax.size
            q = L.apply_rope(self._proj(split, "wq", x), tables)
            k = L.apply_rope(self._proj(split, "wk", x), tables)
            v = self._proj(split, "wv", x)
            if kc.shape[2] != n:
                kc[:, write_at:write_at + t] = sharding.gather_blocks(k, ax, 2)
                vc[:, write_at:write_at + t] = sharding.gather_blocks(v, ax, 2)
                kc, vc = (c.narrow(2, ax.index * n, n) for c in (kc, vc))
            else:
                kc[:, write_at:write_at + t] = k
                vc[:, write_at:write_at + t] = v
            out = _sdpa_streamed(q, kc, vc, positions, kv_pos,
                                 causal=cfg.causal, window=self.window)
            return L.row_output(out.reshape(b, t, -1),
                                split.own("wo.weight", 1))
        q = self._proj(split, "wq", x)
        if "wq.weight" in split.blocks:
            q = sharding.gather_blocks(q, ax, 2)
        q = L.apply_rope(q, tables)
        k = L.apply_rope(self._proj(split, "wk", x), tables)
        v = self._proj(split, "wv", x)
        if s_loc == s:
            kc[:, write_at:write_at + t] = k
            vc[:, write_at:write_at + t] = v
        else:
            # the new entries on the rank that owns their slots
            for j in range(t):
                if s0 <= write_at + j < s0 + s_loc:
                    kc[:, write_at + j - s0] = k[:, j]
                    vc[:, write_at + j - s0] = v[:, j]
        out = _sdpa_streamed(q, kc, vc, positions, kv_pos,
                             causal=cfg.causal, window=self.window,
                             parts=ax if s_loc != s else None)
        if "wo.weight" in split.blocks:
            n = h // ax.size
            out = out.narrow(2, ax.index * n, n)
            return L.row_output(out.reshape(b, t, -1),
                                split.own("wo.weight", 1))
        return L.to_residual(self.wo(out.reshape(b, t, -1)))


def init_attn_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                    device):
    hd = cfg.resolved_head_dim
    s = min(cfg.window, max_len) if kind == "attn_local" else max_len
    shape = (batch, s, cfg.n_kv_heads, hd)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))
