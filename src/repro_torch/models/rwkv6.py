"""RWKV-6 "Finch" time-mix (arXiv:2404.05892): attention-free token mixing
with data-dependent per-channel decay.

Per head (dim K = V = head_dim), with r/k/v/g projections of the
token-shift-interpolated input and a LoRA-produced decay w_t:

    w_t = exp(-exp(w0 + tanh(x_w @ A) @ B))          in (0, 1)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t              (K, V) state
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)          u = per-channel bonus

Without a state the recurrence runs CHUNKED: within a chunk of CHUNK
steps it unrolls into dense products (decay powers via cumulative
log-sums, clamped at -30 as in the reference: a documented
approximation), and S is carried between chunks; the sequence is padded
to a multiple of CHUNK with w = 1, k = v = r = 0.  Decode is the O(1)
single-step update of a float32 state, written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L

LORA_R = 64
CHUNK = 64
LOG_DECAY_FLOOR = -30.0


class RWKV6TimeMix(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        h = cfg.rnn_heads
        self.heads = h
        kw = dict(device=device, dtype=cfg.torch_dtype)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, nn.Linear(d, d, bias=False, **kw))
        self.lora_a_w = nn.Linear(d, LORA_R, bias=False, **kw)
        self.lora_b_w = nn.Linear(LORA_R, d, bias=False, **kw)
        self.w0 = nn.Parameter(torch.empty(d, device=device))
        self.u = nn.Parameter(torch.empty(h, d // h, device=device))
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, name, nn.Parameter(torch.empty(d, **kw)))
        self.ln_g = nn.Parameter(torch.empty(d, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        d = self.w0.shape[0]
        for name in ("wr", "wk", "wv", "wg", "lora_a_w", "lora_b_w"):
            L.dense_(getattr(self, name), generator)
        L.dense_(self.wo, generator, scale=d ** -0.5)
        self.w0.fill_(-5.0)                 # slow default decay
        self.u.zero_()                      # bonus
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            getattr(self, name).fill_(0.5)
        self.ln_g.fill_(1.0)                # per-head group norm

    def model_blocks(self, m: int) -> list:
        """The parameters computed on as their model-axis blocks: the head
        split's (``wr`` / ``wg`` and the per-head vectors are stored whole,
        and sliced)."""
        if m == 1 or self.heads % m:
            return []
        return ["wk.weight", "wv.weight", "wo.weight"]

    def forward(self, x, state=None):
        """x: (B, T, D).  state: None (training) or dict(s=(B, H, K, V),
        shift=(B, D)) for a one-token decode step, updated in place.

        On a model axis that divides the heads each rank runs its heads:
        ``wr`` / ``wk`` / ``wv`` / ``wg`` columns, the LoRA decay's output,
        ``w0``, ``u`` and ``ln_g`` sliced to them, the WKV recurrence and
        its state ``s`` on them, ``wo`` rows and an ordered sum."""
        b, t, d = x.shape
        split = L.Split(self)
        h = self.heads // split.ax.size if split else self.heads
        if state is None:
            prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
            s0 = x.new_zeros((b, h, d // self.heads, d // self.heads),
                             dtype=torch.float32)
        else:
            if t != 1:
                raise ValueError("a recurrent state advances one token a "
                                 "call")
            prev = state["shift"][:, None].to(x.dtype)
            s_blk, store_s = L.state_block(state["s"], 1, self.heads,
                                           bool(split))
            s0 = s_blk.float()
        xx = prev - x
        xr, xk, xv, xg = (x + xx * getattr(self, m)
                          for m in ("mu_r", "mu_k", "mu_v", "mu_g"))
        xw = x + xx * self.mu_w

        def cols(name, t):
            if not split:
                return getattr(self, name)(t)
            return F.linear(L.column_input(t), split.own(f"{name}.weight"))

        def own(name):
            return split.own(name) if split else getattr(self, name)

        r = _heads(cols("wr", xr), h).float()
        k = _heads(cols("wk", xk), h).float()
        v = _heads(cols("wv", xv), h).float()
        g = F.silu(cols("wg", xg))
        logit = own("w0") + cols("lora_b_w",
                                 torch.tanh(self.lora_a_w(xw))).float()
        w = _heads(torch.exp(-torch.exp(logit)), h)      # in (0, 1)
        u = own("u")

        if state is None:
            pad = (-t) % CHUNK
            if pad:
                # w = 1 (no decay), k = 0 (no writes), r = 0 (no reads)
                r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
                w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
            y = chunked_wkv(r, k, v, w, u, s0)[0][:, :t]
        else:
            r1, k1, v1, w1 = r[:, 0], k[:, 0], v[:, 0], w[:, 0]
            kv = k1[..., :, None] * v1[..., None, :]         # (B, H, K, V)
            y1 = torch.einsum("bhk,bhkv->bhv", r1,
                              s0 + u[None, :, :, None] * kv)
            store_s(w1[..., None] * s0 + kv)
            state["shift"].copy_(x[:, -1])
            y = y1[:, None]

        # per-head group norm then output gate (back in the residual dtype)
        y = L.rms_norm(y.reshape(b, t, h, -1),
                       own("ln_g").view(h, -1)).reshape(b, t, -1)
        if split:
            return L.row_output(y.to(x.dtype) * g, split.own("wo.weight", 1))
        return L.to_residual(self.wo(y.to(x.dtype) * g))


def _heads(x, h):
    b, t, d = x.shape
    return x.view(b, t, h, d // h)


def chunked_wkv(r, k, v, w, u, s0):
    """Chunked WKV recurrence.

    r,k,v,w: (B, T, H, K) float32 with w in (0,1] (decay), u: (H, K), s0:
    (B, H, K, V).  Returns (y (B, T, H, V), sT).  T must be a multiple of
    CHUNK (the caller pads).
    """
    t = r.shape[1]
    mask = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    # floors as tensors for torch.maximum, whose gradient splits a tie
    # in half as the reference's jnp.maximum does (clamp_min passes all
    # of it): a cumulative decay lands on -30 exactly where a channel
    # repeats one decay value
    tiny, floor = (torch.full((), c, dtype=w.dtype, device=w.device)
                   for c in (1e-12, LOG_DECAY_FLOOR))
    s = s0
    ys = []
    for c0 in range(0, t, CHUNK):
        rr, kk, vv, ww = (a[:, c0:c0 + CHUNK] for a in (r, k, v, w))
        logw = torch.log(torch.maximum(ww, tiny))
        cum = torch.cumsum(logw, dim=1)            # log prod_{<=i} w
        cum_excl = cum - logw                      # log prod_{<i}  w
        # clamp the *cumulative* decay: a channel that decays below e^-30
        # inside one chunk has washed out; clamping keeps the factored
        # exp(+/-cum) terms inside f32 range
        cum = torch.maximum(cum, floor)
        cum_excl = torch.maximum(cum_excl, floor)
        # inter-chunk: y_i += r_i diag(prod_{<i} w) S
        ri = rr * torch.exp(cum_excl)              # (B, C, H, K)
        y = torch.einsum("bihk,bhkv->bihv", ri, s)
        # intra-chunk (j < i): A[i,j] = sum_k ri[k] * (k_j exp(-cum_j))[k]
        kj = kk * torch.exp(-cum)
        att = torch.einsum("bihk,bjhk->bhij", ri, kj)
        att = torch.where(mask, att, 0.0)
        # bonus diagonal: y_i += (r_i . u . k_i) v_i
        diag = (rr * u * kk).sum(dim=-1)           # (B, C, H)
        y = y + torch.einsum("bhij,bjhv->bihv", att, vv) \
            + diag[..., None] * vv
        # state: S' = diag(prod w) S + sum_j diag(prod_{>j} w) k_j v_j
        k_dec = kk * torch.exp(cum[:, -1:] - cum)
        s = torch.exp(cum[:, -1])[..., None] * s \
            + torch.einsum("bjhk,bjhv->bhkv", k_dec, vv)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def init_rwkv_state(cfg, batch: int, dtype, device):
    d = cfg.d_model
    h = cfg.rnn_heads
    return dict(s=torch.zeros((batch, h, d // h, d // h),
                              dtype=torch.float32, device=device),
                shift=torch.zeros((batch, d), dtype=dtype, device=device),
                shift_c=torch.zeros((batch, d), dtype=dtype, device=device))
