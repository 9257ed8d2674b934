"""Dense MLP variants: SwiGLU, (non-gated) GELU, squared-ReLU, RWKV
channel-mix."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L


class MLP(nn.Module):
    """``cfg.mlp`` of width ``d_ff`` (default ``cfg.d_ff``).  Parameter
    names follow the reference's tree (``w_in``, ``w_gate``, ``w_out``,
    ``w_r``, ``mu_k``, ``mu_r``); the projections are ``nn.Linear``."""

    def __init__(self, cfg, d_ff: int | None = None, *, device=None):
        super().__init__()
        d = cfg.d_model
        f = d_ff or cfg.d_ff
        kw = dict(bias=False, device=device, dtype=cfg.torch_dtype)
        self.kind = cfg.mlp
        if self.kind not in ("swiglu", "gelu", "relu2", "rwkv_channel"):
            raise ValueError(cfg.mlp)
        self.w_in = nn.Linear(d, f, **kw)
        if self.kind == "swiglu":
            self.w_gate = nn.Linear(d, f, **kw)
        self.w_out = nn.Linear(f, d, **kw)
        if self.kind == "rwkv_channel":
            self.w_r = nn.Linear(d, d, **kw)
            self.mu_k = nn.Parameter(torch.empty(d, device=device,
                                                 dtype=cfg.torch_dtype))
            self.mu_r = nn.Parameter(torch.empty(d, device=device,
                                                 dtype=cfg.torch_dtype))

    @torch.no_grad()
    def reset_parameters(self, generator):
        f = self.w_out.weight.shape[1]
        L.dense_(self.w_in, generator)
        if self.kind == "swiglu":
            L.dense_(self.w_gate, generator)
        L.dense_(self.w_out, generator, scale=f ** -0.5)
        if self.kind == "rwkv_channel":
            L.dense_(self.w_r, generator)
            self.mu_k.fill_(0.5)
            self.mu_r.fill_(0.5)

    def forward(self, x, shifted=None):
        """x: (B, T, D).  ``shifted`` = token-shifted x (rwkv_channel
        only)."""
        if self.kind == "swiglu":
            h = F.silu(self.w_gate(x)) * self.w_in(x)
        elif self.kind == "gelu":
            h = F.gelu(self.w_in(x), approximate="tanh")
        elif self.kind == "relu2":
            h = torch.square(F.relu(self.w_in(x)))
        else:
            xx = shifted - x
            xk = x + xx * self.mu_k
            xr = x + xx * self.mu_r
            h = torch.square(F.relu(self.w_in(xk)))
            return L.constrain(torch.sigmoid(self.w_r(xr)) * self.w_out(h),
                               "residual")
        h = L.constrain(h, "ffn")
        return L.constrain(self.w_out(h), "residual")
