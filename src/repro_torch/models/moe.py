"""Mixture-of-Experts MLP: top-k routing with static capacity.

Covers both assigned MoE shapes:
  * olmoe-1b-7b:  64 experts, top-8, no shared expert
  * llama4-scout: 16 experts, top-1, + always-on shared expert

Tokens are gathered into a static (E, C, D) dispatch buffer, two batched
products run the expert FFNs, and results gather back weighted by router
probabilities.  Overflowing tokens beyond capacity C = ceil(T*top_k/E *
cf) are dropped (their combine weight is 0) — the capacity-factor
contract.  Which tokens overflow follows the reference exactly: the
(token, choice) pairs are taken slot-major (all first choices, then all
second choices, ...) and stably sorted by expert, so an expert's first C
pairs in that order keep their slots.

Under ``sharding.Rules.activate()`` (a ``sharding.ShardedModel``'s step)
the routing stays global, as GSPMD keeps it in the reference: the
tokens are gathered over the data axes, so the capacity, the slot order,
the drops and the aux loss's means are the global batch's on every
rank, and each rank combines the outputs of its own rows.  The expert
products run split over the model axis when the rule splits the experts
(``Rules.expert_axis``): each model rank fills and runs the dispatch
buffer of its block of experts, and the outputs are gathered over the
model axis.  The input is the whole (gathered) residual on a
sequence-parallel mesh; the output goes back to its layout.
``dropped`` holds the last forward's count of dropped (token, choice)
pairs (a 0-d tensor on the device, global under a mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import sharding
from . import layers as L
from .mlp import MLP


def capacity(cfg, tokens: int) -> int:
    c = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


class MoE(nn.Module):
    """Router (float32 ``nn.Linear``), expert weights ``experts_in`` /
    ``experts_gate`` (E, D, F) and ``experts_out`` (E, F, D), and the
    ``shared`` expert as an :class:`MLP` of width ``d_ff *
    n_shared_experts``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
        kw = dict(device=device, dtype=cfg.torch_dtype)
        self.router = nn.Linear(d, e, bias=False, device=device,
                                dtype=torch.float32)
        self.experts_in = nn.Parameter(torch.empty(e, d, f, **kw))
        self.experts_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.experts_out = nn.Parameter(torch.empty(e, f, d, **kw))
        self.shared = (MLP(cfg, cfg.d_ff * cfg.n_shared_experts,
                           device=device, whole_output=True)
                       if cfg.n_shared_experts else None)

    def model_blocks(self, m: int) -> list:
        """The expert tensors, split over a model axis that divides the
        experts (``Rules.expert_axis``)."""
        if m == 1 or self.cfg.n_experts % m:
            return []
        return ["experts_in", "experts_gate", "experts_out"]

    @torch.no_grad()
    def reset_parameters(self, generator):
        d, f = self.cfg.d_model, self.cfg.expert_d_ff
        L.dense_(self.router, generator)
        L.truncnorm_(self.experts_in, d ** -0.5, generator)
        L.truncnorm_(self.experts_gate, d ** -0.5, generator)
        L.truncnorm_(self.experts_out, f ** -0.5, generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def forward(self, x):
        """x: (B, T, D) -> (out (B, T, D), aux_loss)."""
        cfg = self.cfg
        b, t, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        dev = x.device
        xf = x.reshape(b * t, d)
        # the global token order: the data ranks' rows, rank-major; this
        # rank combines tokens [r0, r1) and runs experts [e0, e1)
        ax_dp, ax_m, e0, e1 = sharding.moe_layout(cfg) or (None, None, 0, e)
        xg = sharding.gather_rows(xf, ax_dp)
        n_tok = xg.shape[0]
        r0 = 0 if ax_dp is None else ax_dp.index * b * t
        r1 = r0 + b * t
        c = capacity(cfg, n_tok)

        probs = F.softmax(self.router(xg.float()), dim=-1)     # (T, E)
        gate, idx = torch.topk(probs, k, dim=-1)               # (T, k)
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

        idx_flat = idx.T.reshape(-1)                     # (k*T,) slot-major
        # pairs per expert by an integer scatter-add: exact, and unlike
        # bincount it leaves the host free of a device sync
        counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
            0, idx_flat, torch.ones_like(idx_flat))

        # load-balancing aux loss (Switch): E * sum_e f_e * P_e
        me = probs.mean(dim=0)
        ce = counts.float() / (n_tok * k)
        aux = e * torch.sum(me * ce)

        # assignment -> capacity-slot mapping on small integer tensors,
        # then the data moves as two gathers
        order = torch.argsort(idx_flat, stable=True)     # expert-major
        rank_in_sorted = torch.empty_like(order)         # inverse perm
        rank_in_sorted[order] = torch.arange(k * n_tok, device=dev)
        starts = torch.cumsum(counts, 0) - counts
        pos_flat = rank_in_sorted - starts[idx_flat]
        keep = pos_flat < c
        self.dropped = (~keep).sum()
        pos_flat = torch.where(keep, pos_flat, 0)

        # slot grid: which token feeds (expert e, slot s); sentinel = n_tok
        tok_of = torch.arange(n_tok, device=dev).repeat(k)
        sorted_tok = tok_of[order]                       # (kT,)
        slots = torch.arange(c, device=dev)
        slot_src = starts[:, None] + slots[None, :]      # (E, C)
        slot_valid = (slots[None, :] < counts[:, None]) \
            & (slot_src < k * n_tok)
        token_of_slot = torch.where(
            slot_valid, sorted_tok[slot_src.clamp(0, k * n_tok - 1)], n_tok)

        # the model ranks each run their experts' part of what reads xg
        xe = sharding.sum_grad(xg, ax_m, "tokens")
        xf_pad = torch.cat([xe, xe.new_zeros(1, d)])
        buf = xf_pad[token_of_slot[e0:e1]]               # (E, C, D)
        buf = L.constrain(buf, "moe_buffer")
        split = L.Split(self)
        w_gate, w_in, w_out = (split.own(n) if split else getattr(self, n)
                               for n in ("experts_gate", "experts_in",
                                         "experts_out"))
        h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_in)
        h = L.constrain(h, "moe_hidden")
        out_buf = torch.bmm(h, w_out)                    # (E, C, D)
        out_buf = L.constrain(out_buf, "moe_buffer")
        out_buf = sharding.gather_blocks(out_buf, ax_m, 0, "tokens")

        # combine: per-token gather of its k expert outputs (own rows)
        slot_of = (idx * c + pos_flat.reshape(k, n_tok).T)[r0:r1]  # (T, k)
        picked = out_buf.reshape(e * c, d)[slot_of]      # (T, k, D)
        w = (gate * keep.reshape(k, n_tok).T)[r0:r1].float()
        yf = torch.einsum("tkd,tk->td", picked.float(), w)

        if self.shared is not None:
            yf = yf + self.shared(xf[None]).float()[0]
        return L.to_residual(yf.reshape(b, t, d).to(x.dtype)), aux
