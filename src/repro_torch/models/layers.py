"""Shared building blocks: norms, RoPE, initialisers, sharding hooks
(:func:`constrain` and :func:`constrain_first_fit`: ``x`` itself outside
``sharding.Rules.activate()``; see :mod:`repro_torch.sharding`) and the
model-axis helpers the layers call at the reference's layout sites.

Under rules whose model axis is larger than 1, a layer that the rules
split computes its share on this rank: :class:`Split` is its plan (what
it splits, from the same ``model_blocks`` that
``sharding.ShardedModel.split`` reads) and takes the rank's block of a
parameter, :func:`state_block` that of a decode state,
:func:`column_input` marks the input of a column-split product (its
gradient is the model ranks' ordered sum), :func:`row_output` ends a
row-split product (float32 parts from :func:`linear_f32`, summed in rank
order, cast after the sum), :func:`to_residual` puts an output every
rank computed whole into the residual's layout, and
:func:`whole_residual` gathers a sequence-parallel residual (split on
``d_model``) before a norm.  Outside the rules each is the identity, or
the plain product, so one rank runs the code it always ran.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import sharding
from ..core.config import on_card

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


# ------------------------------------------- float32-out products
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


def bmm_f32(a, b):
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


def linear_f32(x, w):
    """``x @ w.T`` with float32 out and float32 accumulation: the parts of
    a row-split product, summed over the model axis before the cast (a
    part rounded to bfloat16 first would add error the whole product does
    not have)."""
    lead = x.shape[:-1]
    out = bmm_f32(x.reshape(1, -1, x.shape[-1]), w.t().unsqueeze(0))
    return out.view(*lead, w.shape[0])


# ------------------------------------------------------ the model axis
class Split:
    """What a layer computes over the model axis under the active rules,
    derived once from its ``model_blocks(m)``, the list
    ``sharding.ShardedModel.split`` is built from: ``ax``, the model-axis
    group (None outside the rules or on an axis of 1), and ``blocks``, the
    parameters the layer is handed as their model-axis blocks (a
    ``ShardedModel`` gathers them over the data axes only).  True where
    the layer computes its share; under a model split every layer's named
    blocks come from a ``ShardedModel`` (or a model built of them)."""

    def __init__(self, module):
        self.module = module
        self.ax = sharding.model_group()
        self.blocks = frozenset(module.model_blocks(self.ax.size)) \
            if self.ax is not None else frozenset()

    def __bool__(self):
        return bool(self.blocks)

    def own(self, name: str, dim: int = 0):
        """This rank's block along ``dim`` of the module's parameter
        ``name``: the parameter itself where the plan names it, else its
        slice of the whole tensor, whose gradient is gathered back
        (``sharding.take_block``).  A named block that arrives whole
        raises."""
        owner, _, leaf = name.rpartition(".")
        p = getattr(self.module.get_submodule(owner), leaf)
        if name not in self.blocks:
            return sharding.take_block(p, self.ax, dim)
        whole = _whole_size(self.module, name, dim)
        if whole is not None and p.shape[dim] * self.ax.size != whole:
            raise ValueError(f"{name} is computed on its model block but "
                             f"arrived as {tuple(p.shape)}: run the model "
                             f"as a sharding.ShardedModel")
        return p


def _whole_size(module, name: str, dim: int):
    """The whole size along ``dim`` of a ``Linear`` / ``Embedding``
    weight ``name`` of ``module`` (what its module was built with), else
    None."""
    owner, _, leaf = name.rpartition(".")
    mod = module.get_submodule(owner)
    if leaf != "weight":
        return None
    if isinstance(mod, nn.Linear):
        return (mod.out_features, mod.in_features)[dim]
    if isinstance(mod, nn.Embedding):
        return (mod.num_embeddings, mod.embedding_dim)[dim]
    return None


def column_input(x):
    """The input of a column-split product: ``x``, whose gradient is the
    ordered sum of the model ranks' parts."""
    return sharding.sum_grad(x, sharding.model_group())


def row_output(h, w, *, whole: bool = False):
    """``h @ w.T`` (``w``: this rank's ``(D, k)`` block of a row-split
    product) in the residual's layout: outside a model split the plain
    product; inside, float32 parts (float32 accumulation) that
    :func:`parts_to_residual` sums."""
    if sharding.model_group() is None:
        return constrain(F.linear(h, w), "residual")
    return parts_to_residual(linear_f32(h, w), h.dtype, whole=whole)


def parts_to_residual(part, dtype, *, whole: bool = False):
    """Every model rank's float32 part of a (B, T, D) sum, added over the
    model axis in rank order and cast to ``dtype`` after the sum: whole,
    or this rank's block of ``D`` on a sequence-parallel residual (a
    sum-scatter) unless ``whole``."""
    ax = sharding.model_group()
    sp = None if whole else sharding.sp_group(part.shape[-1])
    out = sharding.sum_scatter_parts(part, sp, part.dim() - 1) \
        if sp is not None else sharding.sum_parts(part, ax)
    return constrain(out.to(dtype), "residual")


def to_residual(y):
    """A sublayer's output that every model rank computed whole, in the
    residual's layout: this rank's block of ``d_model`` on a
    sequence-parallel residual, else ``y``."""
    sp = sharding.sp_group(y.shape[-1])
    if sp is not None:
        y = sharding.take_block(y, sp, y.dim() - 1)
    return constrain(y, "residual")


def whole_residual(x, d_model: int):
    """The residual whole on its ``d_model``: a sequence-parallel block
    gathered over the model axis (its gradient: the rank's slice, since
    every rank computes the same from the whole)."""
    return sharding.gather_blocks(x, sharding.sp_group(d_model),
                                  x.dim() - 1)


def state_block(t, dim: int, full: int, split: bool = True):
    """(this rank's block of a decode state ``t`` along ``dim``, a
    function that stores a new block) for a layer that computes on its
    block where ``split``: ``t`` and a copy where ``t`` is the block
    already (or the layer runs whole); else its slice, and the new blocks
    gathered over the model axis into the whole ``t``."""
    ax = sharding.model_group()
    if ax is None or not split or t.shape[dim] != full:
        return t, t.copy_
    n = full // ax.size

    def store(new):
        t.copy_(sharding.gather_blocks(new.to(t.dtype), ax, dim))
    return t.narrow(dim, ax.index * n, n), store
