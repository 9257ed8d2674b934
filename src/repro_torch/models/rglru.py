"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Block = (W_x input proj + short causal depthwise conv + RG-LRU) gated by a
GeLU branch (W_y), then W_out.  The RG-LRU recurrence:

    r_t = sigmoid(u_t @ W_a)                  recurrence gate
    i_t = sigmoid(u_t @ W_ix)                 input gate
    a_t = exp(-c * softplus(Lambda) * r_t)    data-dependent decay (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Without a state the linear recurrence runs as a log-depth scan (doubling
offsets) over 256-step chunks, with h carried from chunk to chunk, as the
reference chunks its associative scan; a decode step is one update of an
O(width) state.  The short conv keeps a (conv_width-1, W) tail as decode
state.  Both are written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import sharding
from . import layers as L

RGLRU_C = 8.0
SCAN_CHUNK = 256


class RGLRU(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru_width or d
        kw = dict(device=device, dtype=cfg.torch_dtype)
        self.w_x = nn.Linear(d, w, bias=False, **kw)
        self.w_y = nn.Linear(d, w, bias=False, **kw)
        self.w_a = nn.Linear(w, w, bias=False, **kw)
        self.w_ix = nn.Linear(w, w, bias=False, **kw)
        self.w_rnn_out = nn.Linear(w, d, bias=False, **kw)
        self.conv_w = nn.Parameter(torch.empty(cfg.conv_width, w, **kw))
        self.conv_b = nn.Parameter(torch.empty(w, **kw))
        self.lam = nn.Parameter(torch.empty(w, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        w = self.lam.shape[0]
        for lin in (self.w_x, self.w_y, self.w_a, self.w_ix):
            L.dense_(lin, generator)
        L.dense_(self.w_rnn_out, generator, scale=w ** -0.5)
        L.truncnorm_(self.conv_w, 0.5, generator)
        self.conv_b.zero_()
        # Lambda so that a = sigmoid(Lambda)^c is in ~[0.9, 0.999]
        self.lam.copy_(torch.linspace(2.0, 6.0, w, device=self.lam.device))

    def model_blocks(self, m: int) -> list:
        """The parameters computed on as their model-axis blocks: the
        width split's."""
        if m == 1 or self.lam.shape[0] % m:
            return []
        return ["w_x.weight", "w_y.weight", "w_a.weight", "w_ix.weight",
                "w_rnn_out.weight"]

    @staticmethod
    def _conv_causal(u, conv_w, conv_b, tail=None):
        """Depthwise causal conv, width cw.  tail: (B, cw-1, W) decode
        state.  Returns (out, new tail)."""
        cw = conv_w.shape[0]
        if tail is None:
            pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
        else:
            pad = tail.to(u.dtype)
        ext = torch.cat([pad, u], dim=1)                 # (B, T+cw-1, W)
        t = u.shape[1]
        out = sum(ext[:, i:i + t] * conv_w[i] for i in range(cw))
        new_tail = ext[:, -(cw - 1):] if cw > 1 else pad
        return out + conv_b, new_tail

    @staticmethod
    def _gates(u_in, u, w_a, w_ix, lam):
        """The decay and gated input from ``u_in`` (what the gates read:
        the whole width) and ``u`` (this rank's width)."""
        r = torch.sigmoid(F.linear(u_in, w_a))
        i = torch.sigmoid(F.linear(u_in, w_ix))
        log_a = -RGLRU_C * F.softplus(lam).float() * r.float()
        a = torch.exp(log_a)                              # (…, W) in (0, 1]
        gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) \
            * (i.float() * u.float())
        return a, gated

    def forward(self, x, state=None):
        """x: (B, T, D).  state: None (training) or dict(h=(B, W),
        conv=(B, cw-1, W)), updated in place (one step, T == 1).

        On a model axis that divides the width each rank runs its block
        of it: ``w_x`` / ``w_y`` columns, the conv and the scan on its
        channels, ``w_a`` / ``w_ix`` columns from the whole ``u``
        (gathered over the axis), ``w_rnn_out`` rows and an ordered sum;
        the decode state is its block (:func:`layers.state_block`)."""
        if state is not None and x.shape[1] != 1:
            raise ValueError("a recurrent state advances one token a call")
        split = L.Split(self)
        w = self.lam.shape[0]
        if split:
            xi = L.column_input(x)
            u = F.linear(xi, split.own("w_x.weight"))
            gate = F.gelu(F.linear(xi, split.own("w_y.weight")),
                          approximate="tanh")
            conv_w, conv_b = split.own("conv_w", 1), split.own("conv_b")
            w_a, w_ix = split.own("w_a.weight"), split.own("w_ix.weight")
            lam = split.own("lam")
        else:
            u = self.w_x(x)
            gate = F.gelu(self.w_y(x), approximate="tanh")
            conv_w, conv_b = self.conv_w, self.conv_b
            w_a, w_ix, lam = self.w_a.weight, self.w_ix.weight, self.lam
        tail = store_tail = None
        if state is not None:
            tail, store_tail = L.state_block(state["conv"], 2, w,
                                             bool(split))
        u, new_tail = self._conv_causal(u, conv_w, conv_b, tail)
        u_in = sharding.gather_scatter_grad(u, split.ax, 2) if split else u
        a, b = self._gates(u_in, u, w_a, w_ix, lam)       # (B, T, W) f32
        if state is None:
            h = chunked_scan(a, b)
        else:
            h_prev, store_h = L.state_block(state["h"], 1, w, bool(split))
            h = a[:, 0] * h_prev.float() + b[:, 0]
            store_h(h)
            store_tail(new_tail)
            h = h[:, None]
        h = L.constrain(h.to(x.dtype), "ffn")
        if split:
            return L.row_output(h * gate, split.own("w_rnn_out.weight", 1))
        return L.to_residual(self.w_rnn_out(h * gate))


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling
    offsets (log2 T steps of whole-tensor products)."""
    t = a.shape[1]
    d = 1
    while d < t:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def chunked_scan(a, b):
    """The recurrence over (B, T, W) in SCAN_CHUNK-step chunks, h carried
    between them (a length that is not a multiple runs as one chunk)."""
    t = a.shape[1]
    ck = min(SCAN_CHUNK, t)
    if t % ck:
        ck = t
    h0 = torch.zeros_like(a[:, 0])
    out = []
    for c0 in range(0, t, ck):
        ac, bc = a[:, c0:c0 + ck], b[:, c0:c0 + ck].clone()
        # fold the carried state into the chunk's first step
        bc[:, 0] += ac[:, 0] * h0
        hh = linear_scan(ac, bc)
        h0 = hh[:, -1]
        out.append(hh)
    return torch.cat(out, dim=1)


def init_rglru_state(cfg, batch: int, dtype, device):
    w = cfg.rglru_width or cfg.d_model
    return dict(h=torch.zeros((batch, w), dtype=dtype, device=device),
                conv=torch.zeros((batch, cfg.conv_width - 1, w),
                                 dtype=dtype, device=device))
