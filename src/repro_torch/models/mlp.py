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
    ``w_r``, ``mu_k``, ``mu_r``); the projections are ``nn.Linear``.

    On a model axis that divides ``d_ff`` each rank computes its block of
    the hidden width: ``w_in`` / ``w_gate`` columns, ``w_out`` rows and an
    ordered sum (the RWKV channel mix sums before its ``sigmoid(w_r)``
    gate, which every rank computes whole).  ``whole_output``: the sum
    stays whole on a sequence-parallel residual (the MoE's shared
    expert, added to the experts' whole output)."""

    def __init__(self, cfg, d_ff: int | None = None, *, device=None,
                 whole_output: bool = False):
        super().__init__()
        d = cfg.d_model
        f = d_ff or cfg.d_ff
        self.d_ff = f
        self.whole_output = whole_output
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

    def model_blocks(self, m: int) -> list:
        """The parameters computed on as their model-axis blocks."""
        if m == 1 or self.d_ff % m:
            return []
        return ["w_in.weight", "w_out.weight"] + (
            ["w_gate.weight"] if self.kind == "swiglu" else [])

    def forward(self, x, shifted=None):
        """x: (B, T, D).  ``shifted`` = token-shifted x (rwkv_channel
        only)."""
        split = L.Split(self)

        def cols(name, t):
            if not split:
                return getattr(self, name)(t)
            return F.linear(L.column_input(t), split.own(f"{name}.weight"))

        def out(h):
            if split:
                return L.row_output(h, split.own("w_out.weight", 1),
                                    whole=self.whole_output)
            y = self.w_out(h)
            return L.constrain(y, "residual") if self.whole_output \
                else L.to_residual(y)

        if self.kind == "swiglu":
            h = F.silu(cols("w_gate", x)) * cols("w_in", x)
        elif self.kind == "gelu":
            h = F.gelu(cols("w_in", x), approximate="tanh")
        elif self.kind == "relu2":
            h = torch.square(F.relu(cols("w_in", x)))
        else:
            xx = shifted - x
            xk = x + xx * self.mu_k
            xr = x + xx * self.mu_r
            h = torch.square(F.relu(cols("w_in", xk)))
            gate = L.to_residual(torch.sigmoid(self.w_r(xr)))
            return L.constrain(gate * out(h), "residual")
        h = L.constrain(h, "ffn")
        return out(h)
