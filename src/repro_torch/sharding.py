"""Sharding rules over a mesh of ``torch.distributed`` ranks: pod = DP,
data = DP / FSDP, model = TP / EP (the port of ``repro.sharding``).

One rule table serves all ten architectures because every rule is
*divisibility-aware*: an axis that does not divide the dimension is
dropped (replicated) instead of failing -- yi-6b's 4 KV heads on a
16-way model axis fall back to replicated KV, granite's MQA likewise.
The tables (:attr:`Rules.PARAM_RULES`, :attr:`Rules.ACT_RULES`) and the
resolution (:meth:`Rules.param_spec`, :meth:`Rules.act_spec`,
:meth:`Rules.input_sharding`, :func:`constrain_first_fit`) are the
reference's, read against the reference's leaf paths and shapes, so the
two tables can be compared entry by entry.  A spec is a plain tuple, one
entry per dim: ``None``, an axis name, or a tuple of axis names (a
one-name tuple is written as the name, as ``PartitionSpec`` does).

Usage:

    rules = Rules(mesh, fsdp=True)
    model = ShardedModel(api.init_params(cfg, gen, dev), rules)
    opt_state = opt.init(model)                 # moments of the shards
    with rules.activate():
        metrics = make_train_step(cfg, opt)(model, opt_state, batch)

How a rule becomes placement, by hand on the collectives of
:mod:`repro_torch.db.distributed` (the reference leaves it to GSPMD):

* **Parameters and moments** live as this rank's block under their spec
  (:class:`NamedSharding`: FSDP over ``data`` on the ``dp`` dims, TP over
  ``model``, experts over ``model``).  :meth:`Rules.model_shardings` gives
  the spec of every parameter of a port ``Model``: the reference's spec
  of the same leaf (``models/convert.py``'s mapping) without the stacked
  period dim, reversed for an ``nn.Linear`` weight (``(out, in)``).
* **A step** (:class:`ShardedModel`, ``train/trainer.py``) runs the
  rank's rows of the batch (split over the data axes by
  ``input_sharding("tokens")``) one segment at a time: each segment's
  parameters are gathered whole just before it runs and dropped after,
  and when its backward ends each gradient is reduced to its block:
  summed over the data axes in rank order (all-to-all or all-gather,
  then an ordered float32 sum, so every replica holds the same bits),
  divided by the data-axis size.  A decode step gathers one layer's
  cache at a time (:func:`cache_shardings`).
  The model axis stores the parameters split; the ranks of one model
  row compute the dense layers whole, and split only the expert
  products (``models/moe.py``, whose routing is gathered over the data
  axes so that capacity and drops are the global batch's).
* :func:`constrain` / :func:`constrain_first_fit` mark the reference's
  layout sites.  They never change a value: outside :meth:`Rules.activate`
  they return ``x`` itself, inside it they resolve the spec (first fit
  included) and record it in :attr:`Rules.layouts`.  The hand placement
  holds every activation as the rank's rows, whole along the other dims,
  whatever the spec asks of the model axis.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import Sequence

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("rules",
                                                          default=None)

#: bytes this process received from its peers through the placement
#: collectives, by kind ("gather" for parameters, "grad_reduce" for
#: gradients, "tokens" for the MoE's activation exchanges, "norm",
#: "reshard"); :func:`reset_collective_bytes` clears it.
COLLECTIVE_BYTES: dict = {}


def reset_collective_bytes() -> None:
    COLLECTIVE_BYTES.clear()


def _count(kind: str, x: torch.Tensor, received_share: float) -> None:
    n = int(x.numel() * x.element_size() * received_share)
    COLLECTIVE_BYTES[kind] = COLLECTIVE_BYTES.get(kind, 0) + n


def P(*parts) -> tuple:
    """A spec (``PartitionSpec``): one entry per dim; a one-name tuple is
    written as the name."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Rules:
    """Sharding rule table bound to a mesh (anything with ``axis_names``
    and a ``shape`` dict; a :class:`~repro_torch.launch.mesh.Mesh` to
    place tensors)."""

    # parameter rules: leaf-name regex -> spec over the TRAILING dims.
    # 'dp' expands to the FSDP axis ('data') when fsdp=True, else None.
    PARAM_RULES = [
        (r"embed$",                ("model", "dp")),     # (V, D)
        (r"(wq|wk|wv|wqkv)$",      ("dp", "model")),     # (D, H*hd)
        (r"wo$",                   ("model", "dp")),     # (H*hd, D)
        (r"(w_in|w_gate)$",        ("dp", "model")),     # (D, F)
        (r"w_out$",                ("model", "dp")),     # (F, D)
        (r"(experts_in|experts_gate)$", ("model", "dp", None)),  # (E, D, F)
        (r"experts_out$",          ("model", None, "dp")),       # (E, F, D)
        (r"router$",               ("dp", None)),        # (D, E)
        (r"head$",                 ("dp", "model")),     # (D, V)
        (r"(w_a|w_ix|w_rg|w_x|w_y)$", ("dp", "model")),  # rglru dense (W, W)
        (r"w_rnn_out$",            ("model", "dp")),
        (r"(lora_a.*|lora_b.*)$",  (None, None)),
        (r".*",                    None),                # norms/bias/scalars
    ]

    ACT_RULES = {
        "residual":   lambda dp: P(dp, None, None),        # (B, S, D)
        "heads":      lambda dp: P(dp, None, "model", None),  # (B,S,H,hd)
        "kv_heads":   lambda dp: P(dp, None, "model", None),
        "ffn":        lambda dp: P(dp, None, "model"),     # (B, S, F)
        "logits":     lambda dp: P(dp, None, "model"),     # (B, S, V)
        "tokens":     lambda dp: P(dp, None),              # (B, S)
        "moe_buffer": lambda dp: P("model", None, None),   # (E, C, D)
        "moe_hidden": lambda dp: P("model", None, None),   # (E, C, F)
        "rnn_state":  lambda dp: P(dp, None),              # (B, W)
        "wkv_state":  lambda dp: P(dp, "model", None, None),  # (B,H,K,V)
    }

    def __init__(self, mesh, fsdp: bool = True, sp: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        # sp: the residual stream's d_model over the model axis (the
        # reference's sequence-parallel-style memory posture; a layout
        # statement here, see the module docstring)
        self.sp = sp
        self.dp = _dp_axes(mesh)
        #: the spec each constrain site resolved to last, by name
        #: (``"first_fit"`` for :func:`constrain_first_fit`)
        self.layouts: dict = {}

    # ------------------------------------------------------------ params
    def _resolve(self, axes, shape) -> tuple:
        """Map rule axes onto the trailing dims of `shape`, dropping axes
        that are absent from the mesh or do not divide the dim."""
        if axes is None:
            return P()
        spec = [None] * len(shape)
        trailing = shape[len(shape) - len(axes):] if len(shape) >= len(axes) \
            else shape
        offset = len(shape) - len(trailing)
        for i, ax in enumerate(axes[-len(trailing):] if len(shape) < len(axes)
                               else axes):
            dim = trailing[i]
            name = "data" if ax == "dp" else ax
            if ax == "dp" and not self.fsdp:
                continue
            if name is None or name not in self.mesh.axis_names:
                continue
            if dim % self.mesh.shape[name] != 0:
                continue
            spec[offset + i] = name
        return P(*spec)

    def param_spec(self, path: str, shape) -> tuple:
        """The spec of the reference's leaf ``path`` (``"blocks/0/mixer/
        wq"``) of shape ``shape`` (the reference's, stacked dim included)."""
        leaf = path.split("/")[-1]
        for pat, axes in self.PARAM_RULES:
            if re.fullmatch(pat, leaf):
                return self._resolve(axes, tuple(shape))
        return P()

    def params_tree(self, tree):
        """:class:`NamedSharding` of every leaf of a reference-layout
        nested dict (leaves: anything with a ``shape``)."""
        def visit(node, path):
            if isinstance(node, dict):
                return {k: visit(v, path + (str(k),)) for k, v in node.items()}
            rule = ("/".join(path), tuple(node.shape), False, False)
            return NamedSharding(self.mesh, self.spec_for(rule), rule)
        return visit(tree, ())

    def spec_for(self, rule, ndim: int = 0) -> tuple:
        """The spec of a tensor placed by ``rule``: (reference path,
        reference shape, stacked, transposed) -- the reference's spec,
        without the stacked period dim, reversed for a transposed leaf --
        or, for ``rule=None``, replicated over ``ndim`` dims."""
        if rule is None:
            return (None,) * ndim
        path, shape, stacked, transposed = rule
        spec = self.param_spec(path, shape)
        spec = spec + (None,) * (len(shape) - len(spec))
        if stacked:
            spec = spec[1:]
        return spec[::-1] if transposed else spec

    def model_shardings(self, cfg) -> dict:
        """{parameter name of a port ``Model`` of ``cfg``: its
        :class:`NamedSharding`} (the module docstring)."""
        from .models.convert import reference_leaves
        return {name: NamedSharding(self.mesh, self.spec_for(rule), rule)
                for name, rule in reference_leaves(cfg).items()}

    def expert_axis(self, cfg):
        """``"model"`` when the experts of ``cfg`` are split over the model
        axis (the rule keeps it: it divides ``n_experts``), else None."""
        shape = (cfg.n_experts, cfg.d_model, cfg.expert_d_ff)
        spec = self.param_spec("experts_in", shape)
        return "model" if spec and spec[0] == "model" else None

    # --------------------------------------------------------- activations
    def act_spec(self, name: str) -> tuple:
        if name == "residual" and self.sp:
            spec = P(self.dp, None, "model")
        else:
            spec = self.ACT_RULES[name](self.dp)
        # divisibility is the consumer's business for constraints; drop
        # axes not in the mesh
        parts = []
        for ax in spec:
            if isinstance(ax, tuple):
                kept = tuple(a for a in ax if a in self.mesh.axis_names)
                parts.append(kept if kept else None)
            elif ax is None or ax in self.mesh.axis_names:
                parts.append(ax)
            else:
                parts.append(None)
        return P(*parts)

    def input_sharding(self, name: str, shape) -> "NamedSharding":
        """The placement of an input of ``shape``: :meth:`act_spec` with
        every axis that does not divide its dim dropped."""
        spec = self.act_spec(name)
        parts = []
        for i, ax in enumerate(spec):
            if i >= len(shape):
                break
            size = math.prod(self.mesh.shape[a] for a in _entry_axes(ax))
            parts.append(ax if size and shape[i] % max(size, 1) == 0
                         else None)
        return NamedSharding(self.mesh, P(*parts))

    # ------------------------------------------------------------- context
    @contextlib.contextmanager
    def activate(self):
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)


def constrain(x, name: str):
    """The reference's activation layout site ``name``: ``x`` itself
    outside :meth:`Rules.activate`; inside, ``x`` unchanged with the
    resolved spec recorded in ``rules.layouts[name]``."""
    rules: Rules | None = _ACTIVE.get()
    if rules is None:
        return x
    rules.layouts[name] = rules.act_spec(name)
    return x


def _spec_fits(mesh, spec, shape) -> bool:
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            if a not in mesh.axis_names:
                return False
            size *= mesh.shape[a]
        if i >= len(shape) or shape[i] % size != 0:
            return False
    return True


def constrain_first_fit(x, specs: Sequence[tuple]):
    """The first spec whose named axes all exist and divide the logical
    tensor's dims -- the mechanism behind divisibility-aware attention
    sharding across GQA configs.  ``x`` is this rank's rows of a batch
    activation, so its logical batch is the data axes' size times its
    own.  ``x`` itself outside :meth:`Rules.activate`; inside, ``x``
    unchanged with the chosen spec (None if none fits) recorded in
    ``rules.layouts["first_fit"]``."""
    rules: Rules | None = _ACTIVE.get()
    if rules is None:
        return x
    n_dp = math.prod(rules.mesh.shape[a] for a in rules.dp)
    shape = (x.shape[0] * n_dp,) + tuple(x.shape[1:])
    rules.layouts["first_fit"] = next(
        (P(*s) for s in specs if _spec_fits(rules.mesh, s, shape)), None)
    return x


def current_rules() -> Rules | None:
    return _ACTIVE.get()


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint``: its recomputation
    in the backward sees the rules that were active in the forward.  The
    backward of CUDA tensors runs on autograd's device threads, where a
    context variable set in the caller's thread is not set."""
    rules = _ACTIVE.get()

    def fn():
        return contextlib.nullcontext(), (
            rules.activate() if rules is not None
            else contextlib.nullcontext())
    return fn


def current_dp() -> tuple:
    """The active data-parallel axes, e.g. ('pod', 'data'); () if
    inactive."""
    rules = _ACTIVE.get()
    return rules.dp if rules is not None else ()


# ----------------------------------------------------------- placement
def _group(mesh, axes: tuple):
    """The process group over ``axes`` (in mesh order: the row-major block
    order of a dim split over several axes)."""
    if tuple(a for a in mesh.axis_names if a in axes) != tuple(axes):
        raise ValueError(f"axes {axes} are not in mesh order "
                         f"{mesh.axis_names}")
    return mesh.axis(axes)


def _all_gather_dim(x, ax, dim: int, kind: str):
    """Tiled all-gather of ``x`` along ``dim`` over the group ``ax``."""
    from .db.distributed import all_gather
    front = torch.movedim(x, dim, 0).contiguous()
    out = all_gather(front, ax)
    _count(kind, out, (ax.size - 1) / ax.size)
    return torch.movedim(out, 0, dim).contiguous()


def sum_over(x, ax, kind: str):
    """Sum of every rank's ``x`` over the group ``ax`` in float32, added
    in rank order: the same bits on every rank (a backend's all_reduce
    order is its own)."""
    parts = _all_gather_dim(x.unsqueeze(0), ax, 0, kind)
    out = parts[0].float()
    for j in range(1, ax.size):
        out = out + parts[j].float()
    return out


def sum_scatter(x, ax, dim: int, kind: str):
    """This rank's block along ``dim`` of the sum over the group ``ax``
    (float32, added in rank order): the deterministic reduce-scatter."""
    from .db.distributed import _all_to_all_rows
    front = torch.movedim(x, dim, 0)
    n = ax.size
    blocks = front.reshape((n, front.shape[0] // n) + tuple(front.shape[1:]))
    recv = _all_to_all_rows(blocks, ax)
    _count(kind, recv, (n - 1) / n)
    out = recv[0].float()
    for j in range(1, n):
        out = out + recv[j].float()
    return torch.movedim(out, 0, dim).contiguous()


class NamedSharding:
    """A spec bound to a mesh: the block of a logical tensor each rank
    holds.  A dim split over axes ``(a, b)`` is cut into ``size(a) *
    size(b)`` equal blocks in row-major order of the rank's coordinates;
    ``rule`` (see :meth:`Rules.spec_for`) names what the spec was derived
    from, so :func:`repro_torch.train.elastic.reshard` can derive it again
    under another mesh."""

    def __init__(self, mesh, spec: tuple, rule=None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.rule = rule

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec})"

    @property
    def member(self) -> bool:
        """Whether this rank holds a block (a mesh may span part of the
        world: ``launch.mesh.Mesh(ranks=)``)."""
        return self.mesh.coords is not None

    def _dims(self, ndim: int, skip=()):
        """(dim, axes) of every split dim, ``skip``'s axes left whole."""
        spec = self.spec + (None,) * (ndim - len(self.spec))
        for i, entry in enumerate(spec):
            axes = tuple(a for a in _entry_axes(entry) if a not in skip)
            if axes and math.prod(self.mesh.shape[a] for a in axes) > 1:
                yield i, axes

    def block(self, shape, skip=()) -> tuple:
        """This rank's slices of a logical tensor of ``shape``."""
        out = [slice(None)] * len(shape)
        for i, axes in self._dims(len(shape), skip):
            n = math.prod(self.mesh.shape[a] for a in axes)
            if shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"split over {axes}")
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
            k = shape[i] // n
            out[i] = slice(idx * k, (idx + 1) * k)
        return tuple(out)

    def block_shape(self, shape) -> tuple:
        """The shape of this rank's block of a logical tensor of
        ``shape``."""
        return tuple(len(range(*s.indices(n))) for s, n in
                     zip(self.block(shape), shape))

    def local(self, full: torch.Tensor, skip=()):
        """This rank's block of ``full`` (a new tensor), None off the
        mesh."""
        if not self.member:
            return None
        return full[self.block(full.shape, skip)].clone()

    def gather(self, local: torch.Tensor, skip=(), kind: str = "gather"):
        """The logical tensor from every rank's block (a collective over
        the axes of each split dim, ``skip``'s axes left split)."""
        x = local
        for i, axes in self._dims(local.dim(), skip):
            x = _all_gather_dim(x, _group(self.mesh, axes), i, kind)
        return x

    def reduce(self, g: torch.Tensor, skip=()) -> torch.Tensor:
        """This rank's block of the mean over the data axes of every rank's
        full-shape ``g`` (float32): the own block of each dim split over a
        model-like axis (``g`` is that block already along ``skip``'s
        axes), then an ordered sum over the data axes (a reduce-scatter
        along a dim split over them, a plain sum over the rest), divided
        by their size.  The mean is the gradient of the
        global batch's mean loss only because every rank holds the same
        number of rows (:func:`place_batch` refuses a batch that does not
        split evenly)."""
        dp = _dp_axes(self.mesh)
        x = g[self.block(g.shape, skip=dp + tuple(skip))]
        reduced = set()
        for i, axes in self._dims(g.dim()):
            split = tuple(a for a in axes if a in dp)
            if split:
                x = sum_scatter(x, _group(self.mesh, split), i, "grad_reduce")
                reduced.update(split)
        rest = tuple(a for a in dp if a not in reduced
                     and self.mesh.shape[a] > 1)
        if rest:
            x = sum_over(x, _group(self.mesh, rest), "grad_reduce")
        n = math.prod(self.mesh.shape[a] for a in dp)
        return x.float().contiguous() / torch.full(
            (), n, dtype=torch.float32, device=x.device)

    def owns(self) -> bool:
        """Whether this rank counts its block in a global sum: its
        coordinate is 0 on every axis the spec does not split (one
        replica of each block)."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return self.member and all(self.mesh.coords[a] == 0
                                   for a in self.mesh.axis_names
                                   if a not in used)


class Sharded:
    """A logical tensor laid out by a :class:`NamedSharding`: ``local`` is
    this rank's block (None off the mesh), ``shape`` / ``dtype`` the
    logical tensor's."""

    def __init__(self, local, sharding: NamedSharding, shape, dtype):
        self.local = local
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype

    def full(self, kind: str = "gather") -> torch.Tensor | None:
        """The logical tensor (a collective over the mesh; None off it)."""
        if not self.sharding.member:
            return None
        return self.sharding.gather(self.local, kind=kind)


def place_batch(rules: Rules, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (tokens ``(B, S)`` or embeddings
    ``(B, S, D)``), split over the data axes by
    ``input_sharding("tokens" / "residual")``; the model axis keeps them
    whole.  Raises unless the rows split evenly over the data axes."""
    n = math.prod(rules.mesh.shape[a] for a in rules.dp)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over "
                         f"{n} data ranks (elastic.scale_batch)")
    name = "tokens" if x.dim() == 2 else "residual"
    return rules.input_sharding(name, x.shape).local(x, skip=("model",))


# ------------------------------------------- the MoE's exchanges (autograd)
class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over the data axes; each rank's loss adds
    up, so the gradient of a rank's rows is the ordered sum of every
    rank's (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_gather_dim(x, ax, 0, "tokens")

    @staticmethod
    def backward(ctx, g):
        return sum_scatter(g, ctx.ax, 0, "tokens").to(g.dtype), None


class _SumGrad(torch.autograd.Function):
    """Identity; the ranks of the model axis each compute part of what
    depends on ``x`` (their experts), so its gradient is their ordered
    sum."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.ax, "tokens").to(g.dtype), None


class _GatherBlocks(torch.autograd.Function):
    """All-gather along dim 0 over the model axis, whose ranks compute
    the same loss from the result: a block's gradient is its slice."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[0]
        return _all_gather_dim(x, ax, 0, "tokens")

    @staticmethod
    def backward(ctx, g):
        i = ctx.ax.index
        return g[i * ctx.n:(i + 1) * ctx.n].contiguous(), None


def moe_layout(cfg):
    """Where the active rules put an MoE layer's work, or None outside
    :meth:`Rules.activate`: (data-axis group or None, model group or
    None, first and last expert of this rank)."""
    rules = _ACTIVE.get()
    if rules is None:
        return None
    mesh = rules.mesh
    dp = tuple(a for a in rules.dp if mesh.shape[a] > 1)
    ax_dp = mesh.axis(dp) if dp else None
    e = cfg.n_experts
    if rules.expert_axis(cfg) and mesh.shape["model"] > 1:
        ax_m = mesh.axis("model")
        k = e // ax_m.size
        return ax_dp, ax_m, ax_m.index * k, (ax_m.index + 1) * k
    return ax_dp, None, 0, e


def gather_rows(x, ax):
    return x if ax is None else _GatherRows.apply(x, ax)


def sum_grad(x, ax):
    return x if ax is None else _SumGrad.apply(x, ax)


def gather_blocks(x, ax):
    return x if ax is None else _GatherBlocks.apply(x, ax)


# ------------------------------------------------------ a sharded model
def state_shardings(rules: Rules, cfg, with_opt: bool = True) -> dict:
    """The :class:`NamedSharding` tree of a ``cfg`` model's train state
    under ``rules``, matching :meth:`ShardedModel.tree` (what
    ``checkpoint.restore(shardings=)`` takes)."""
    ms = rules.model_shardings(cfg)
    out = {"params": ms}
    if with_opt:
        out["opt"] = {"step": NamedSharding(rules.mesh, ()),
                      "mu": ms, "nu": ms}
    return out


def cache_shardings(rules: Rules, cache):
    """The :class:`NamedSharding` of every leaf of a decode cache (the
    reference's ``launch.cells._cache_shardings``, read on the stacked
    layout of ``api.init_cache``): the batch (dim 1) over the data axes
    where they divide it; KV heads over ``model``, else the sequence;
    ``s``, ``h``, ``conv``, ``shift`` by the same divisibility tests.  The
    tail's unstacked leaves get the same dims as the stacked ones, as in
    the reference."""
    mesh, dp = rules.mesh, rules.dp

    def div(shape, i, ax):
        return ax in mesh.axis_names and shape[i] % mesh.shape[ax] == 0

    def spec_for(name, shape):
        n_dp = math.prod(mesh.shape[a] for a in dp)
        batch = dp if dp and len(shape) > 1 and shape[1] % n_dp == 0 \
            else None
        parts = [None, batch] + [None] * (len(shape) - 2)
        if name in ("k", "v") and len(shape) == 5 and div(shape, 3, "model"):
            parts[3] = "model"                      # (n, B, S, KV, hd)
        elif name in ("k", "v") and len(shape) == 5 \
                and div(shape, 2, "model"):
            parts[2] = "model"                      # sequence-sharded cache
        elif name == "s" and len(shape) == 5 and div(shape, 2, "model"):
            parts[2] = "model"                      # (n, B, H, K, V)
        elif name == "h" and len(shape) == 3 and div(shape, 2, "model"):
            parts[2] = "model"                      # (n, B, W)
        elif name == "conv" and len(shape) == 4 and div(shape, 3, "model"):
            parts[3] = "model"
        elif name in ("shift", "shift_c") and len(shape) == 3 \
                and div(shape, 2, "model"):
            parts[2] = "model"
        return NamedSharding(mesh, P(*parts[:len(shape)]))

    def visit(node, name=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        return spec_for(name, tuple(node.shape))
    return visit(cache)


def block_shapes(cfg, rules: Rules) -> dict:
    """{parameter name of a ``cfg`` model: (shape of this rank's block
    under ``rules``, dtype)}."""
    from .models.api import Model
    shardings = rules.model_shardings(cfg)
    return {name: (shardings[name].block_shape(p.shape), p.dtype)
            for name, p in Model(cfg, device="meta").named_parameters()}


class _GatherParams(torch.autograd.Function):
    """The whole tensors of some parameters from this rank's blocks; the
    backward reduces each one's gradient to its block
    (:meth:`NamedSharding.reduce`, float32; then the model's
    ``grad_convert``) into the model's ``pending`` gradients and passes
    nothing on: the blocks are not autograd leaves (``anchor``, a 0-d
    tensor that requires grad, makes the outputs require grad)."""

    @staticmethod
    def forward(ctx, sm, names, anchor, *blocks):
        ctx.sm, ctx.names = sm, names
        return tuple(sm.shardings[n].gather(b, skip=sm.split.get(n, ()))
                     for n, b in zip(names, blocks))

    @staticmethod
    def backward(ctx, *grads):
        sm = ctx.sm
        for n, g in zip(ctx.names, grads):
            if n in sm.pending:
                raise RuntimeError(f"{n}: two gradients in one backward")
            sm.pending[n] = sm._convert(n, sm.shardings[n].reduce(
                g, skip=sm.split.get(n, ())))
        return (None, None, None) + (None,) * len(grads)


class ShardedModel:
    """A port ``Model``'s parameters placed by ``rules``.

    ``params`` holds this rank's block of every parameter (what the
    optimizer updates and a checkpoint saves): the only copy this object
    keeps.  ``work`` is the model's module tree on ``meta``: the code
    that runs it, with no storage.  A step (``train/trainer.py``'s
    ``make_train_step``), :meth:`prefill` and :meth:`decode_step` run it
    one piece at a time inside :meth:`gathered`: each segment of
    ``Model.segments()`` gathers its parameters right before it runs and
    drops them after; the embedding is gathered for its lookup (for the
    whole pass where the head reads it too), the final norm and the head
    for the logits.  Under remat the recomputation gathers again, inside
    the checkpointed function.  When a segment's backward ends, each of
    its gradients is reduced to this rank's block (the ordered float32
    sum of :meth:`NamedSharding.reduce`), passed through ``grad_convert``
    where the step sets one (the step's dtype or accumulator: the float32
    sums never wait all together), and waits in ``pending`` for
    :meth:`take_grads`.  An expert tensor split over the model axis
    (``split``) is gathered over the data axes only: the rank's block of
    experts, which is all its MoE computes.  ``named_parameters`` yields
    the blocks, so ``AdamW.init(sharded)`` makes moments of their shape.

    Built from a whole model (``ShardedModel(model, rules)``: the model
    is moved to ``meta``, its parameters live on as the blocks) or from
    blocks alone (:meth:`from_blocks`, shapes from :func:`block_shapes`:
    a rank allocates its blocks and nothing else, the way a run at
    production scale starts)."""

    def __init__(self, model, rules: Rules):
        self._setup(model.cfg, rules)
        self.device = next(model.parameters()).device
        with torch.no_grad():
            self.params = {name: self.shardings[name].local(p)
                           for name, p in model.named_parameters()}
        model.to("meta")
        self.work = model
        self._index()

    @classmethod
    def from_blocks(cls, cfg, rules: Rules, blocks: dict) -> "ShardedModel":
        """A ``cfg`` model whose parameters are ``blocks`` ({name: this
        rank's block}, :meth:`block_shapes`), held as they are: no whole
        tensor is made anywhere."""
        from .models.api import Model
        self = cls.__new__(cls)
        self._setup(cfg, rules)
        self.work = Model(cfg, device="meta")
        self.params = dict(blocks)
        self._index()
        self.device = next(iter(self.params.values())).device
        return self

    def _setup(self, cfg, rules: Rules) -> None:
        from .models.api import Model
        self.cfg = cfg
        self.rules = rules
        self.shardings = rules.model_shardings(cfg)
        self.split = {}
        if rules.expert_axis(cfg) and rules.mesh.shape["model"] > 1:
            self.split = {n: ("model",) for n, sh in self.shardings.items()
                          if sh.rule[0].split("/")[-1].startswith("experts_")}
        self.shapes = {n: tuple(p.shape) for n, p in
                       Model(cfg, device="meta").named_parameters()}
        #: gradients reduced to their blocks, waiting for take_grads
        self.pending: dict = {}
        #: ``fn(name, float32 block gradient)`` applied as each one is
        #: reduced (None: kept in float32)
        self.grad_convert = None

    def _index(self) -> None:
        """Where each parameter of ``work`` sits: (module, attribute) by
        name, and the names under each module a pass gathers."""
        self._slot = {}
        for mname, mod in self.work.named_modules():
            for attr in mod._parameters:
                if mod._parameters[attr] is not None:
                    self._slot[f"{mname}.{attr}" if mname else attr] = \
                        (mod, attr)
        self._names = {}
        for mname, mod in self.work.named_modules():
            pre = f"{mname}." if mname else ""
            self._names[id(mod)] = [pre + n for n, _ in
                                    mod.named_parameters()]
        self._anchor = None

    def named_parameters(self):
        return iter(self.params.items())

    @contextlib.contextmanager
    def gathered(self, modules):
        """Inside, the parameters of ``modules`` (submodules of ``work``;
        None entries skipped) are the whole tensors gathered from the
        blocks (:class:`_GatherParams`); they are dropped on exit."""
        names = [n for m in modules if m is not None
                 for n in self._names[id(m)]]
        if not names:
            yield
            return
        if self._anchor is None or self._anchor.device != self.device:
            self._anchor = torch.zeros((), dtype=torch.float32,
                                       device=self.device,
                                       requires_grad=True)
        full = _GatherParams.apply(self, tuple(names), self._anchor,
                                   *(self.params[n] for n in names))
        slots = [self._slot[n] for n in names]
        kept = [mod._parameters[attr] for mod, attr in slots]
        for (mod, attr), t in zip(slots, full):
            mod._parameters[attr] = t
        try:
            yield
        finally:
            for (mod, attr), t in zip(slots, kept):
                mod._parameters[attr] = t

    def _convert(self, name: str, g: torch.Tensor):
        return g if self.grad_convert is None else self.grad_convert(name, g)

    def take_grads(self) -> dict:
        """{name: this rank's block of the global batch's gradient}
        (float32, or as ``grad_convert`` made it) from the last backward,
        which are cleared; a parameter that backward did not reach gets
        the reduced zeros."""
        out = {}
        for name in self.params:
            g = self.pending.pop(name, None)
            if g is None:
                sh, skip = self.shardings[name], self.split.get(name, ())
                full = sh.gather(torch.zeros_like(self.params[name]),
                                 skip=skip)
                g = self._convert(name, sh.reduce(full, skip=skip))
            out[name] = g
        self.pending.clear()
        return out

    @torch.no_grad()
    def gather_(self) -> None:
        """Give ``work`` real storage and fill it with the whole
        parameters (the experts only with this rank's model block: the
        other blocks are zero).  Not used by a step: for inspecting the
        whole model and for comparisons with it."""
        dp = _dp_axes(self.rules.mesh)
        if any(p.is_meta for p in self.work.parameters()):
            self.work.to_empty(device=self.device)
        for name, p in self.work.named_parameters():
            sh = self.shardings[name]
            skip = self.split.get(name, ())
            full = sh.gather(self.params[name], skip=skip)
            if skip:
                p.zero_()
                p[sh.block(p.shape, skip=dp)] = full
            else:
                p.copy_(full)

    def mean_over_dp(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank scalar over the data axes (an ordered
        float32 sum: every rank gets the same bits).  The mean of the
        ranks' mean losses is the global batch's only because every rank
        holds the same number of rows (:func:`place_batch`)."""
        mesh = self.rules.mesh
        dp = tuple(a for a in self.rules.dp if mesh.shape[a] > 1)
        if not dp:
            return x.float()
        ax = _group(mesh, dp)
        return sum_over(x.detach(), ax, "norm") / torch.full(
            (), ax.size, dtype=torch.float32, device=x.device)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the sum of squares of the global gradient: each block
        counted once (by its :meth:`NamedSharding.owns` replica), the
        ranks' float32 partial sums added in rank order over the whole
        mesh."""
        from .train.optimizer import sum_of_squares
        own = {k: g for k, g in grads.items() if self.shardings[k].owns()}
        dev = next(iter(grads.values())).device
        part = sum_of_squares(own) if own else \
            torch.zeros((), dtype=torch.float32, device=dev)
        mesh = self.rules.mesh
        return torch.sqrt(sum_over(part, mesh.axis(mesh.axis_names), "norm"))

    def tree(self, opt_state=None) -> dict:
        """The state as a tree of :class:`Sharded` leaves (a checkpoint's
        ``{"params": ..., "opt": ...}``)."""
        params = {n: Sharded(t, self.shardings[n],
                             self.shapes[n], t.dtype)
                  for n, t in self.params.items()}
        out = {"params": params}
        if opt_state is not None:
            step = opt_state.step
            rep = NamedSharding(self.rules.mesh, ())
            out["opt"] = {
                "step": Sharded(step, rep, (), step.dtype),
                "mu": {n: Sharded(t, self.shardings[n], self.shapes[n],
                                  t.dtype) for n, t in opt_state.mu.items()},
                "nu": {n: Sharded(t, self.shardings[n], self.shapes[n],
                                  t.dtype) for n, t in opt_state.nu.items()}}
        return out

    @torch.no_grad()
    def load_(self, tree: dict, opt_state=None) -> None:
        """Copy a :meth:`tree`-shaped tree of :class:`Sharded` leaves (this
        rank's blocks under the same rules) into the blocks and
        ``opt_state``."""
        for n, t in self.params.items():
            t.copy_(tree["params"][n].local)
        if opt_state is not None:
            opt_state.step.copy_(tree["opt"]["step"].local)
            for n in self.params:
                opt_state.mu[n].copy_(tree["opt"]["mu"][n].local)
                opt_state.nu[n].copy_(tree["opt"]["nu"][n].local)

    # ------------------------------------------------------------ serving
    def _rows(self, tokens: torch.Tensor):
        """(this rank's rows of a global batch, the data-axis group to
        gather results over, or None when every rank runs the whole
        batch: no data axis, or a batch the data axes do not split)."""
        mesh = self.rules.mesh
        dp = tuple(a for a in self.rules.dp if mesh.shape[a] > 1)
        n = math.prod(mesh.shape[a] for a in dp)
        if not dp or tokens.shape[0] % n:
            return tokens, None
        return place_batch(self.rules, tokens), _group(mesh, dp)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, whole: bool = True):
        """The global batch's logits (every rank gets them whole; with
        ``whole`` False, this rank's rows of them): each rank runs its
        rows under the rules, one segment's parameters gathered at a
        time, and the rows are gathered over the data axes."""
        with self.rules.activate():
            rows, ax = self._rows(tokens)
            logits = self.work(rows, gather=self.gathered)[0]
        if ax is None or not whole:
            return logits
        return _all_gather_dim(logits, ax, 0, "tokens")

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """This rank's blocks of a zero decode cache (``api.init_cache``'s
        layout) under :func:`cache_shardings`: a tree of
        :class:`Sharded`."""
        from .models import api
        full = api.init_cache(self.cfg, batch, max_len, dtype=dtype,
                              device="meta")

        def visit(node, sh):
            if isinstance(node, dict):
                return {k: visit(v, sh[k]) for k, v in node.items()}
            local = torch.zeros(sh.block_shape(node.shape), dtype=node.dtype,
                                device=self.device)
            return Sharded(local, sh, node.shape, node.dtype)
        return visit(full, cache_shardings(self.rules, full))

    @contextlib.contextmanager
    def _layer_cache(self, leaves: dict, period, ax):
        """One layer's cache, whole for this rank's rows, from the blocks
        of ``leaves`` ({name: :class:`Sharded`}, stacked over the periods
        unless ``period`` is None); on exit the layer's writes go back into
        this rank's blocks.  A leaf split over the data axes on its batch
        dim is gathered over the other axes only; any other leaf (the
        tail's, whose batch dim the reference's spec leaves whole) whole,
        its updated rows gathered back over the data axes."""
        dp = _dp_axes(self.rules.mesh)
        out, back = {}, []
        for k, leaf in leaves.items():
            spec = leaf.sharding.spec
            if period is not None:
                spec = spec[1:]
            sh = NamedSharding(self.rules.mesh, spec)
            block = leaf.local if period is None else leaf.local[period]
            spec = spec + (None,) * (block.dim() - len(spec))
            on_batch = set(_entry_axes(spec[0])) == set(dp) and not any(
                a in dp for e in spec[1:] for a in _entry_axes(e))
            if ax is None or on_batch:
                full = sh.gather(block, skip=dp if on_batch else ())
                out[k] = full
                back.append((block, sh, full, dp if on_batch else (), None))
            else:
                full = sh.gather(block)
                n = full.shape[0] // ax.size
                rows = full[ax.index * n:(ax.index + 1) * n].clone()
                out[k] = rows
                back.append((block, sh, rows, (), ax))
        yield out
        for block, sh, t, skip, rows_ax in back:
            if rows_ax is not None:
                t = _all_gather_dim(t, rows_ax, 0, "cache")
            block.copy_(t[sh.block(t.shape, skip=skip)])

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache, cache_len: int):
        """One-token decode of the global batch against a cache of blocks
        (:meth:`init_cache`): every layer gathers its parameters and its
        cache for this rank's rows, runs, and writes the new state back
        into the blocks.  Returns the global logits (every rank gets
        them whole); the cache is updated in place."""
        from .models import layers as L
        cfg, work = self.cfg, self.work
        tied = work.head is None and work.embed is not None
        p = len(cfg.pattern)
        n_body = p * cfg.n_periods
        with self.rules.activate():
            rows, ax = self._rows(tokens)
            with self.gathered([work.embed] if tied else []):
                if cfg.embedding_inputs:
                    x = rows.to(cfg.torch_dtype)
                else:
                    with self.gathered([] if tied else [work.embed]):
                        x = work.embed(rows)
                x = L.constrain(x, "residual")
                positions = torch.arange(cache_len, cache_len + x.shape[1],
                                         dtype=torch.int32, device=x.device)
                for i, blk in enumerate(work.layers):
                    if i < n_body:
                        leaves, period = cache[str(i % p)], i // p
                    else:
                        leaves, period = cache["tail"][str(i - n_body)], None
                    with self.gathered([blk]), \
                            self._layer_cache(leaves, period, ax) as c:
                        x, _ = blk(x, positions, c, cache_len)
                with self.gathered([work.final_norm, work.head]):
                    x = work.final_norm(x)
                    logits = work.head(x) if work.head is not None \
                        else x @ work.embed.weight.T
                logits = L.constrain(logits, "logits")
        if ax is not None:
            logits = _all_gather_dim(logits, ax, 0, "tokens")
        return logits
