"""Shared building blocks: norms, RoPE, initialisers, sharding hooks
(:func:`constrain` and :func:`constrain_first_fit`: ``x`` itself outside
``sharding.Rules.activate()``; see :mod:`repro_torch.sharding`).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import sharding

#: elements filled per float32 draw of :func:`truncnorm_` (bounds the
#: temporary when a bfloat16 tensor of billions of elements is filled)
INIT_CHUNK = 1 << 26


@torch.no_grad()
def truncnorm_(t: torch.Tensor, scale: float, generator) -> torch.Tensor:
    """Fill ``t`` in place with a normal truncated to [-2, 2] times
    ``scale``, drawn in float32 and cast to ``t``'s dtype."""
    flat = t.view(-1)
    for part in flat.split(INIT_CHUNK):
        draw = torch.empty(part.shape, dtype=torch.float32, device=t.device)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        part.copy_(draw.mul_(scale))
    return t


def dense_(linear: nn.Linear, generator, scale: float | None = None):
    """The reference's ``dense_init`` for an ``nn.Linear`` (weight laid
    out (out, in)): scale ``in ** -0.5`` unless given; a bias is zeroed."""
    d_in = linear.weight.shape[1]
    truncnorm_(linear.weight, d_in ** -0.5 if scale is None else scale,
               generator)
    if linear.bias is not None:
        with torch.no_grad():
            linear.bias.zero_()


# ---------------------------------------------------------------- norms
def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


class Norm(nn.Module):
    """RMS norm (``gamma``) or layer norm (``gamma``, ``beta``), float32
    parameters whatever the model's dtype."""

    def __init__(self, cfg, d: int, *, device=None):
        super().__init__()
        self.layer = cfg.norm == "layer"
        self.gamma = nn.Parameter(torch.empty(d, device=device))
        if self.layer:
            self.beta = nn.Parameter(torch.empty(d, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.gamma.fill_(1.0)
        if self.layer:
            self.beta.zero_()

    def forward(self, x):
        if self.layer:
            return layer_norm(x, self.gamma, self.beta)
        return rms_norm(x, self.gamma)


# ---------------------------------------------------------------- RoPE
def rope_tables(positions, head_dim: int, rotary_pct: float, theta: float,
                dtype=torch.float32):
    """cos/sin tables for the rotated fraction of head_dim.

    positions: (T,) int tensor (absolute).  Returns (T, rot/2) each, or
    None when rotary_pct == 0 (e.g. hubert's conv-positional stub).
    """
    rot = int(head_dim * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return None
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, tables):
    """x: (B, T, H, hd); tables from rope_tables (T-aligned).

    Rotates the first `rot` dims pairwise (interleaved convention: dim
    2i with 2i+1), passes the rest through — covers full (pct=1),
    half/'2d' (pct=0.5), none.
    """
    if tables is None:
        return x
    cos, sin = tables
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(yr.dtype)], dim=-1).to(x.dtype)


def constrain(x, spec_name: str):
    """The activation layout site ``spec_name`` of the active rules
    (:func:`repro_torch.sharding.constrain`): ``x`` itself outside
    ``Rules.activate()``."""
    return sharding.constrain(x, spec_name)


def constrain_first_fit(x, specs):
    """The first of ``specs`` that fits ``x`` on the active mesh
    (:func:`repro_torch.sharding.constrain_first_fit`): ``x`` itself
    outside ``Rules.activate()``."""
    return sharding.constrain_first_fit(x, specs)
