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
  parameters are gathered just before it runs and dropped after, and
  when its backward ends each gradient is reduced to its block: summed
  over the data axes in rank order (all-to-all or all-gather, then an
  ordered float32 sum, so every replica holds the same bits), divided by
  the data-axis size.  A parameter the layers compute on as its
  model-axis block (:func:`model_blocks`: ``ShardedModel.split``) is
  gathered over the data axes only; the rest whole.
* **The model axis splits the compute** wherever the reference's rule
  table or first fit splits a dim over ``model`` (the layers' helpers in
  ``models/layers.py``): attention heads (``wq``/``wk``/``wv`` column
  blocks, ``wo`` row blocks; after the reference's transient KV-head
  repeat, :func:`kv_repeat`), else a block of query positions against
  the whole K/V; the MLP's ``d_ff``; the RG-LRU width; the RWKV heads;
  the vocabulary of the embedding, the head and the loss
  (:func:`split_logsumexp`); the experts (``models/moe.py``, whose
  routing is gathered over the data axes so that capacity and drops are
  the global batch's).  Where the axis does not divide the dim, that
  product runs whole on every rank.  A column-split product's input
  takes the ranks' ordered gradient sum (:func:`sum_grad`); a row-split
  product's float32 parts are summed in rank order (:func:`sum_parts`,
  or :func:`sum_scatter_parts` onto a sequence-parallel residual, which
  ``Rules(sp=True)`` holds split on ``d_model`` between sublayers and
  gathers before each norm): never a backend's all_reduce, so every rank
  of a model row holds the same bits and a rerun, remat on or off and a
  restore stay bit-equal.  These exchanges count as ``"tp"``.
* **A decode step** gathers one layer's parameters and cache for its
  rows; a cache block the model axis splits (KV heads, or the slots of a
  sequence-split cache, :func:`cache_shardings`; RWKV heads; the RG-LRU
  width) stays the rank's, which attends over it: a sequence split
  combines each rank's partial softmax in rank order, and the new entry
  is written by the rank that owns its slot.
* :func:`constrain` marks the reference's layout sites (``x`` unchanged,
  the spec recorded in :attr:`Rules.layouts` inside
  :meth:`Rules.activate`); :func:`first_fit` resolves and records the
  attention's first fit, which the layer then runs.
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
#: gradients, "tp" for the model axis's split compute, "tokens" for the
#: MoE's activation exchanges, "cache", "norm", "reshard");
#: :func:`reset_collective_bytes` clears it.
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
        # sp: the residual stream's d_model over the model axis between
        # sublayers (the reference's sequence-parallel-style memory
        # posture; the module docstring)
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


def first_fit(x, specs: Sequence[tuple]):
    """The first spec whose named axes all exist and divide the logical
    tensor's dims (None if none fits, or outside :meth:`Rules.activate`),
    recorded in ``rules.layouts["first_fit"]``: the mechanism behind
    divisibility-aware attention sharding across GQA configs, and the
    layout the attention then runs.  ``x`` (a tensor or a shape) is this
    rank's rows of a batch activation, so its logical batch is the data
    axes' size times its own."""
    rules: Rules | None = _ACTIVE.get()
    if rules is None:
        return None
    n_dp = math.prod(rules.mesh.shape[a] for a in rules.dp)
    shape = tuple(getattr(x, "shape", x))
    shape = (shape[0] * n_dp,) + shape[1:]
    spec = next((P(*s) for s in specs if _spec_fits(rules.mesh, s, shape)),
                None)
    rules.layouts["first_fit"] = spec
    return spec


def constrain_first_fit(x, specs: Sequence[tuple]):
    """:func:`first_fit` recorded for ``x``; returns ``x`` itself."""
    first_fit(x, specs)
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


def stack_over(x, ax, kind: str = "tp"):
    """Every rank's ``x`` over the group ``ax``, stacked in rank order on
    a new leading dim."""
    return _all_gather_dim(x.unsqueeze(0), ax, 0, kind)


def sum_over(x, ax, kind: str):
    """Sum of every rank's ``x`` over the group ``ax`` in float32, added
    in rank order: the same bits on every rank (a backend's all_reduce
    order is its own)."""
    parts = stack_over(x, ax, kind)
    out = parts[0].float()
    for j in range(1, ax.size):
        out = out + parts[j].float()
    return out


def tp_sum(x, ax):
    """:func:`sum_over` of the model axis's split compute (kind ``"tp"``):
    over more than two ranks, where a dim splits over them, each rank
    sums its block (:func:`sum_scatter`) and the blocks are gathered.
    The same additions in the same order, so the same bits, with
    2 (n - 1) / n of ``x`` received instead of n - 1 and no n float32
    copies held at once (on a model axis of 16, 1/8 of the bytes)."""
    n = ax.size
    dim = next((i for i, k in enumerate(x.shape) if k % n == 0), None) \
        if n > 2 else None
    if dim is None:
        return sum_over(x, ax, "tp")
    return _all_gather_dim(sum_scatter(x, ax, dim, "tp"), ax, dim, "tp")


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


# ---------------------------------- model-axis and MoE exchanges (autograd)
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
    """Identity forward, ordered sum backward: the ranks of ``ax`` each
    compute a distinct part of what depends on ``x`` (their experts, their
    columns of a product), so its gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, ax, kind):
        ctx.ax, ctx.kind = ax, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = tp_sum(g, ctx.ax) if ctx.kind == "tp" \
            else sum_over(g, ctx.ax, ctx.kind)
        return out.to(g.dtype), None, None


class _SumParts(torch.autograd.Function):
    """Ordered float32 sum forward (:func:`tp_sum`), identity backward:
    the partial outputs of a row-split product, each rank's part of a
    split sum.  Every rank gets the same bits."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.dtype = x.dtype
        return tp_sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _SumScatter(torch.autograd.Function):
    """This rank's block along ``dim`` of the ordered float32 sum
    (:func:`sum_scatter`) forward, all-gather backward: a row-split
    product's parts onto a sequence-parallel residual."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.dtype = ax, dim, x.dtype
        return sum_scatter(x, ax, dim, "tp")

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, ctx.ax, ctx.dim, "tp").to(ctx.dtype), \
            None, None


class _GatherScatterGrad(torch.autograd.Function):
    """All-gather along ``dim`` forward, sum-scatter backward: every rank
    feeds the whole tensor to its own part of the next product, so the
    gradient of a rank's block is the ordered sum of every rank's."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather_dim(x, ax, dim, "tp")

    @staticmethod
    def backward(ctx, g):
        return sum_scatter(g, ctx.ax, ctx.dim, "tp").to(g.dtype), None, None


class _GatherBlocks(torch.autograd.Function):
    """All-gather along ``dim`` over ``ax``, whose ranks compute the same
    loss from the result: a block's gradient is its slice."""

    @staticmethod
    def forward(ctx, x, ax, dim, kind):
        ctx.ax, ctx.n, ctx.dim = ax, x.shape[dim], dim
        return _all_gather_dim(x, ax, dim, kind)

    @staticmethod
    def backward(ctx, g):
        i = ctx.ax.index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, \
            None, None


class _TakeBlock(torch.autograd.Function):
    """This rank's block along ``dim`` forward (of a tensor every rank of
    ``ax`` holds whole), all-gather backward: each rank's block gradient
    is whole for its block, the others' come from their ranks."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        n = x.shape[dim] // ax.size
        return x.narrow(dim, ax.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, ctx.ax, ctx.dim, "tp"), None, None


def max_over(x, ax):
    """The elementwise max of every rank's ``x`` over ``ax`` (no
    gradient: the split log-sum-exp's shift)."""
    with torch.no_grad():
        return stack_over(x.detach(), ax).amax(dim=0)


def split_logsumexp(x, ax):
    """log-sum-exp over the last dim of a tensor whose last dim is split
    over ``ax`` (this rank's block ``x``, float32): the max over the
    ranks, then the ordered sum of every rank's exponentials.  The same
    bits on every rank."""
    m = max_over(x.amax(dim=-1), ax)
    part = torch.exp(x - m[..., None]).sum(dim=-1)
    return m + torch.log(sum_parts(part, ax))


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


def sum_grad(x, ax, kind: str = "tp"):
    return x if ax is None else _SumGrad.apply(x, ax, kind)


def sum_parts(x, ax):
    return x if ax is None else _SumParts.apply(x, ax)


def sum_scatter_parts(x, ax, dim: int):
    return x if ax is None else _SumScatter.apply(x, ax, dim)


def gather_scatter_grad(x, ax, dim: int):
    return x if ax is None else _GatherScatterGrad.apply(x, ax, dim)


def gather_blocks(x, ax, dim: int = 0, kind: str = "tp"):
    return x if ax is None else _GatherBlocks.apply(x, ax, dim, kind)


def take_block(x, ax, dim: int):
    return x if ax is None else _TakeBlock.apply(x, ax, dim)


# ------------------------------------------------ the model axis's plan
def model_group():
    """The model-axis group the active rules split a layer's work over:
    None outside :meth:`Rules.activate` or on a model axis of 1."""
    rules = _ACTIVE.get()
    if rules is None or rules.mesh.shape.get("model", 1) == 1:
        return None
    return rules.mesh.axis("model")


def sp_group(d_model: int):
    """The model-axis group when the active rules hold the residual
    stream split on ``d_model`` (``Rules(sp=True)``, an axis that divides
    it), else None."""
    ax = model_group()
    if ax is None or not _ACTIVE.get().sp or d_model % ax.size:
        return None
    return ax


def kv_repeat(cfg, m: int) -> int:
    """The reference's transient KV-head repeat of an uncached attention
    pass on a model axis of ``m``: where the KV heads do not divide the
    axis and the query heads do, the smallest ``r`` for which ``kv * r``
    divides both ``m`` and the query heads (1: no repeat)."""
    kv, h = cfg.n_kv_heads, cfg.n_heads
    if m > 1 and kv % m and h % m == 0:
        for r in range(2, h // kv + 1):
            if (kv * r) % m == 0 and h % (kv * r) == 0:
                return r
    return 1


def heads_split(cfg, m: int) -> bool:
    """Whether an uncached attention pass splits its heads over a model
    axis of ``m``: the first fit's KV-head spec, after the repeat."""
    return m > 1 and (cfg.n_kv_heads * kv_repeat(cfg, m)) % m == 0


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


def model_blocks(model, rules: Rules) -> list:
    """The names of the parameters of ``model`` (a port ``Model``) that its
    layers compute on as their model-axis blocks under ``rules``: what
    each module's ``model_blocks(m)`` names."""
    m = rules.mesh.shape.get("model", 1)
    if m == 1:
        return []
    out = []
    for mname, mod in model.named_modules():
        fn = getattr(mod, "model_blocks", None)
        if fn is not None:
            out += [f"{mname}.{n}" if mname else n for n in fn(m)]
    return out


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
        meta = Model(cfg, device="meta")
        self.split = {n: ("model",) for n in model_blocks(meta, rules)}
        for n in self.split:
            if "model" not in {a for e in self.shardings[n].spec
                               for a in _entry_axes(e)}:
                raise ValueError(f"{n} is computed on its model block but "
                                 f"stored as {self.shardings[n].spec}")
        self.shapes = {n: tuple(p.shape) for n, p in
                       meta.named_parameters()}
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
        parameters.  Not used by a step: for inspecting the whole model
        and for comparisons with it, outside the rules or on a model axis
        of 1 (under a model split a layer takes the parameters its plan
        names as blocks, :meth:`gathered`'s, ``layers.Split``)."""
        if any(p.is_meta for p in self.work.parameters()):
            self.work.to_empty(device=self.device)
        for name, p in self.work.named_parameters():
            p.copy_(self.shardings[name].gather(self.params[name]))

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
        ``whole`` False, this rank's block of them: its rows, and its
        vocabulary block where the model axis splits the vocabulary): each
        rank runs its rows under the rules, one segment's parameters
        gathered at a time, and the logits are gathered over the model
        axis, then the rows over the data axes."""
        with self.rules.activate():
            rows, ax = self._rows(tokens)
            logits = self.work(rows, gather=self.gathered)[0]
        if not whole:
            return logits
        logits = self._whole_vocab(logits)
        if ax is None:
            return logits
        return _all_gather_dim(logits, ax, 0, "tokens")

    def _whole_vocab(self, logits):
        """Logits whole on the vocabulary: a vocabulary block gathered over
        the model axis."""
        if not {"embed.weight", "head.weight"} & set(self.split):
            return logits
        return _all_gather_dim(logits, self.rules.mesh.axis("model"),
                               logits.dim() - 1, "tp")

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

    #: decode state a layer computes on as its model-axis block where the
    #: cache splits it (KV heads or slots, RWKV heads, RG-LRU width); the
    #: token shifts are read whole
    MODEL_LOCAL = ("k", "v", "s", "h", "conv")

    @contextlib.contextmanager
    def _layer_cache(self, leaves: dict, period, ax):
        """One layer's cache for this rank's rows from the blocks of
        ``leaves`` ({name: :class:`Sharded`}, stacked over the periods
        unless ``period`` is None); on exit the layer's writes go back into
        this rank's blocks.  A leaf the model axis splits (of
        :attr:`MODEL_LOCAL`) stays this rank's block there (a
        sequence-split ``k`` / ``v`` comes with ``"slot0"`` and
        ``"slots"``: its first slot and the whole count); the rest is
        gathered over the model axis.  A leaf split over the data axes on
        its batch dim is gathered over the other axes only; any other leaf
        (the tail's, whose batch dim the reference's spec leaves whole)
        whole, its updated rows gathered back over the data axes."""
        mesh = self.rules.mesh
        dp = _dp_axes(mesh)
        out, back = {}, []
        for k, leaf in leaves.items():
            spec = leaf.sharding.spec
            if period is not None:
                spec = spec[1:]
            sh = NamedSharding(mesh, spec)
            block = leaf.local if period is None else leaf.local[period]
            spec = spec + (None,) * (block.dim() - len(spec))
            on_batch = set(_entry_axes(spec[0])) == set(dp) and not any(
                a in dp for e in spec[1:] for a in _entry_axes(e))
            keep = ("model",) if k in self.MODEL_LOCAL else ()
            if keep and k in ("k", "v") and spec[1] == "model":
                n = block.shape[1]
                out["slot0"] = mesh.coords["model"] * n
                out["slots"] = n * mesh.shape["model"]
            if ax is None or on_batch:
                skip = (dp if on_batch else ()) + keep
                full = sh.gather(block, skip=skip)
                out[k] = full
                back.append((block, sh, full, skip, None))
            else:
                full = sh.gather(block, skip=keep)
                n = full.shape[0] // ax.size
                rows = full[ax.index * n:(ax.index + 1) * n].clone()
                out[k] = rows
                back.append((block, sh, rows, keep, ax))
        yield out
        for block, sh, t, skip, rows_ax in back:
            if rows_ax is not None:
                t = _all_gather_dim(t, rows_ax, 0, "cache")
            block.copy_(t[sh.block(t.shape, skip=skip)])

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache, cache_len: int):
        """One-token decode of the global batch against a cache of blocks
        (:meth:`init_cache`): every layer gathers its parameters and its
        cache for this rank's rows (a cache block the model axis splits
        stays this rank's: :meth:`_layer_cache`), runs, and writes the new
        state back into the blocks.  Returns the global logits (every rank
        gets them whole); the cache is updated in place."""
        from .models import layers as L
        cfg, work = self.cfg, self.work
        tied = work.head is None and work.embed is not None
        p = len(cfg.pattern)
        n_body = p * cfg.n_periods
        with self.rules.activate():
            rows, ax = self._rows(tokens)
            with self.gathered([work.embed] if tied else []):
                if cfg.embedding_inputs:
                    x = L.to_residual(rows.to(cfg.torch_dtype))
                else:
                    with self.gathered([] if tied else [work.embed]):
                        x = work._lookup(rows)
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
                    x = work.final_norm(L.whole_residual(x, cfg.d_model))
                    logits = work._logits(x)
                logits = self._whole_vocab(L.constrain(logits, "logits"))
        if ax is not None:
            logits = _all_gather_dim(logits, ax, 0, "tokens")
        return logits
