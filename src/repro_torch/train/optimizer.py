"""AdamW with dtype-configurable moments, int8 gradient compression and
global-norm clipping (the port of ``repro.train.optimizer``).

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``; an ``nn.Module`` is taken as that
dict).  :meth:`AdamW.update` writes the new parameters and moments **in
place** -- a 12 GB model is never copied -- with the reference's float32
math in the reference's order, element by element: the values are those
of the reference's functional update.  The step counter and the
schedule's scalars stay on the parameters' device (a 0-d int32 tensor,
as in the reference), so an update makes no host sync, and every scalar
that divides or is divided is a 0-d tensor beside the data: PyTorch's
CUDA division by a Python number, and ``number / tensor`` anywhere,
multiply by a reciprocal instead, which can differ by an ulp.

Moments can be stored in bf16 (``moment_dtype``) with f32 math at update
time.  ``compress_int8`` / ``decompress_int8`` implement per-tensor-max
int8 quantisation with error feedback; :func:`compressed_psum` all-reduces
the int8 payload over a :class:`~repro_torch.launch.mesh.MeshAxis` with
one shared scale (an all_reduce MAX of one scalar first).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

#: elements of a parameter updated at once: bounds the float32
#: temporaries of an update (the 64000 x 4096 embedding of yi_6b would
#: otherwise take ~1 GB each).  The math is elementwise, so the split
#: does not change a bit.
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass
class AdamWState:
    """``step``: 0-d int32 tensor (updates done); ``mu`` / ``nu``: the
    moments by parameter name.  :meth:`AdamW.update` advances it in
    place."""
    step: torch.Tensor
    mu: dict
    nu: dict

    def tree(self) -> dict:
        """The state as a nested dict of tensors (a checkpoint's ``opt``)."""
        return {"step": self.step, "mu": self.mu, "nu": self.nu}

    def load_(self, tree: dict) -> None:
        """Copy a :meth:`tree`-shaped dict of tensors into this state."""
        with torch.no_grad():
            self.step.copy_(tree["step"])
            for name in self.mu:
                self.mu[name].copy_(tree["mu"][name])
                self.nu[name].copy_(tree["nu"][name])


def named(params) -> dict:
    """{name: tensor} of a module's parameters (or of anything with
    ``named_parameters``, e.g. a ``sharding.ShardedModel``'s blocks), or
    ``params`` itself."""
    if isinstance(params, nn.Module) or hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def _chunks(t: torch.Tensor):
    return t.view(-1).split(UPDATE_CHUNK)


def _c(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor beside ``x`` (a divisor: see the
    module docstring)."""
    return torch.full((), value, dtype=torch.float32, device=x.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str | None = None     # None => same as param dtype
    warmup: int = 100

    def _mdt(self, p):
        return getattr(torch, self.moment_dtype) if self.moment_dtype \
            else p.dtype

    def init(self, params) -> AdamWState:
        params = named(params)
        dev = next(iter(params.values())).device
        z = lambda p: torch.zeros(p.shape, dtype=self._mdt(p),
                                  device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          {k: z(p) for k, p in params.items()},
                          {k: z(p) for k, p in params.items()})

    def schedule(self, step):
        """The learning rate at ``step`` (a 0-d tensor): linear warm-up
        on the pre-increment step, float32."""
        s = step.to(torch.float32)
        warm = torch.clamp_max((s + 1.0) / _c(s, self.warmup), 1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params) -> AdamWState:
        """One AdamW step: ``params`` and the moments in place, the step
        counter advanced.  Returns ``state``."""
        params = named(params)
        lr = self.schedule(state.step)
        state.step.add_(1)
        t = state.step.to(torch.float32)
        c1 = 1.0 - torch.pow(_c(t, self.b1), t)
        c2 = 1.0 - torch.pow(_c(t, self.b2), t)
        for name, p in params.items():
            m, v = state.mu[name], state.nu[name]
            for pc, gc, mc, vc in zip(_chunks(p), _chunks(grads[name]),
                                      _chunks(m), _chunks(v)):
                g32 = gc.float()
                m32 = self.b1 * mc.float() + (1 - self.b1) * g32
                v32 = self.b2 * vc.float() + (1 - self.b2) * g32 * g32
                upd = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
                p32 = pc.float()
                upd = upd + self.weight_decay * p32
                pc.copy_(p32 - lr * upd)
                mc.copy_(m32)
                vc.copy_(v32)
        return state


# -------------------------------------------------- gradient compression
def compress_int8(g, err):
    """Quantise g + err to int8 with per-tensor max scaling.

    Returns (q, scale, new_err): decompress(q, scale) + new_err == g + err.
    """
    x = g.float() + err
    scale = torch.clamp_min(x.abs().max(), 1e-12) / _c(x, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.float() * scale
    return q, scale, new_err


def decompress_int8(q, scale):
    return q.float() * scale


def compressed_psum(g, err, ax):
    """All-reduce an int8-compressed gradient over ``ax`` (a
    :class:`~repro_torch.launch.mesh.MeshAxis`): the mean over its ranks,
    and this rank's new error-feedback residual.

    The scale must be SHARED across the group (a sum of int8 payloads
    quantised with different scales is not decodable): an all_reduce MAX
    of one scalar picks it, every rank quantises with it, the payload is
    summed as int32 (all_reduce SUM), and the caller carries ``new_err``
    to the next step.
    """
    from ..db.distributed import pmax, psum
    x = g.float() + err
    local = torch.clamp_min(x.abs().max(), 1e-12) / _c(x, 127.0)
    scale = pmax(local, ax)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.float() * scale
    total = psum(q.to(torch.int32), ax)
    return total.float() * scale / _c(x, ax.size), new_err


def sum_of_squares(tree) -> torch.Tensor:
    """The sum of squares of every leaf (a dict of tensors), in float32,
    summed leaf by leaf in the dict's order, a leaf's ``UPDATE_CHUNK``-
    element pieces in order (one piece below that: the float32 square of
    nemotron's 4.7e9-element embedding gradient would take 17.6 GB)."""
    total = None
    for g in tree.values():
        for gc in _chunks(g):
            sq = torch.sum(gc.float() ** 2)
            total = sq if total is None else total + sq
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of :func:`sum_of_squares`."""
    return torch.sqrt(sum_of_squares(tree))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, norm=None):
    """Scale every leaf in place to ``(g.float() * scale).to(g.dtype)``,
    scale = min(1, max_norm / norm), the norm :func:`global_norm`'s
    unless given (a sharded tree's global one).  Returns (tree, norm)."""
    n = global_norm(tree) if norm is None else norm
    scale = torch.clamp_max(_c(n, max_norm) / torch.clamp_min(n, 1e-12),
                            1.0)
    for g in tree.values():
        for gc in _chunks(g):
            gc.copy_(gc.float() * scale)
    return tree, n
