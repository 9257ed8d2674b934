"""Per-cell step builders: (arch x shape x mesh) -> a step, the stand-ins
of its inputs and their placement (the port of ``repro.launch.cells``).

A *cell* is one dry-run unit.  For LM archs:

    train_4k     full train step (fwd + bwd + clip + AdamW update), remat,
                 microbatch accumulation for the big configs
    prefill_32k  forward logits over the full sequence
    decode_32k   one-token decode step against a seq_len cache
    long_500k    one-token decode step against a 512k context
                 (sub-quadratic archs only)

plus the paper's own ``pgf_tpch`` cell (the distributed aggregate-query
step, ``db.distributed.make_query_step``).

Memory posture knobs per arch (:func:`arch_knobs`, the reference's): FSDP
always on; SP-style residual sharding (the residual stream held split on
``d_model`` over the model axis between sublayers) and bf16 Adam moments
for d_model >= 5120; bf16 gradient accumulation and accum=8 for the 340B
config.

A cell's ``args`` are ``meta`` stand-ins of what one rank's ``fn`` is
given: this rank's blocks of the parameters, optimizer state and decode
cache (``sharding.block_shapes``, ``sharding.cache_shardings``), the
global batch (every rank passes it: ``sharding.place_batch`` takes the
rank's rows), and the pgf cell's blocks of the tuple columns.
``in_shardings`` holds the :class:`~repro_torch.sharding.NamedSharding`
of every leaf, in the reference's layout (parameters by the port's
names).  :meth:`Cell.materialize` turns the stand-ins into tensors (fake
ones under the dry-run's ``FakeTensorMode``).  Building a cell needs only
the mesh's axis names, sizes and this rank's coordinates; ``fn`` runs its
collectives on the mesh's process groups.

The pgf cell's values are int32 (TPC-H quantities), where the
reference's stand-in is float32: the exact CF is a distribution over the
integer grid, and only integer values reach the ``logcf`` kernel
(``kernels/ops.py``'s guard); float32 values would send the 2^16-point
CF through the blocked loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import sharding
from ..configs import base as cfgs
from ..models import api
from ..sharding import NamedSharding, Rules
from ..train.optimizer import AdamW, AdamWState
from ..train.trainer import make_train_step


def arch_knobs(cfg) -> dict:
    big = cfg.d_model >= 5120
    huge = cfg.d_model >= 16384
    # microbatching caps the tokens a device holds at once (the
    # reference's memory gate: accum 4 for every family, 8 for the 340B)
    accum = 8 if huge else 4
    return dict(
        sp=big,
        accum=accum,
        moment_dtype="bfloat16" if big else None,
        accum_dtype=torch.bfloat16 if huge else torch.float32,
    )


@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable                     # fn(**args) on one rank
    args: dict                       # kwarg name -> stand-in tree
    in_shardings: dict               # same structure, NamedShardings

    def materialize(self, device, fill=None) -> dict:
        """``args`` as tensors on ``device``: ``torch.empty`` of each
        stand-in (fake under ``FakeTensorMode``), then ``fill(path,
        tensor)`` where given; non-tensor leaves as they are."""
        def visit(node, path):
            if isinstance(node, dict):
                return {k: visit(v, path + (k,)) for k, v in node.items()}
            if not isinstance(node, torch.Tensor):
                return node
            t = torch.empty(node.shape, dtype=node.dtype, device=device)
            if fill is not None:
                fill(path, t)
            return t
        return visit(self.args, ())


# ------------------------------------------------------------- shardings
def _batch_shardings(rules: Rules, args: dict) -> dict:
    out = {}
    for k, v in args.items():
        if k in ("tokens", "labels"):
            name = "tokens" if len(v.shape) == 2 else "residual"
            out[k] = rules.input_sharding(name, v.shape)
        else:
            out[k] = NamedSharding(rules.mesh, ())
    return out


_cache_shardings = sharding.cache_shardings


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _blocks(tree, shardings):
    """``meta`` stand-ins of this rank's blocks of a tree of stand-ins."""
    if isinstance(tree, dict):
        return {k: _blocks(v, shardings[k]) for k, v in tree.items()}
    return _meta(shardings.block_shape(tree.shape), tree.dtype)


def _sharded(blocks, shardings, full):
    """A tree of :class:`~repro_torch.sharding.Sharded` leaves."""
    if isinstance(blocks, dict):
        return {k: _sharded(blocks[k], shardings[k], full[k]) for k in blocks}
    return sharding.Sharded(blocks, shardings, full.shape, full.dtype)


# ------------------------------------------------------------------ cells
def calibration_pattern(cfg):
    """(repeating base pattern, trip count) for the calibration cost
    model.  Tail layers sit in the model's intercept (they appear in both
    calibration variants), so the two-point fit is exact."""
    return cfg.pattern, cfg.n_periods


def build_lm_cell(arch: str, shape_name: str, mesh, *, cfg=None,
                  accum: int | None = None, batch: int | None = None,
                  seq: int | None = None) -> Cell:
    """The (arch, shape) cell on ``mesh``; ``cfg`` replaces the arch's
    config (the calibration's depth cuts, reduced widths), ``accum`` its
    knob, ``batch`` and ``seq`` the shape's global batch and length
    (``configs.input_specs``' overrides: the card's and the CPU's
    cuts)."""
    base_cfg = cfgs.get_config(arch)
    if shape_name not in cfgs.runnable_cells(base_cfg):
        raise ValueError(f"{arch} skips {shape_name} "
                         "(configs.runnable_cells)")
    knobs = arch_knobs(base_cfg)
    if accum is not None:
        knobs["accum"] = accum
    cfg = cfg or base_cfg
    rules = Rules(mesh, fsdp=True, sp=knobs["sp"])
    spec = cfgs.SHAPES[shape_name]
    params_sh = rules.model_shardings(cfg)
    params = {name: _meta(shape, dtype) for name, (shape, dtype)
              in sharding.block_shapes(cfg, rules).items()}
    args = cfgs.input_specs(cfg, shape_name, batch_override=batch,
                            seq_override=seq)
    name = f"{arch}/{shape_name}"

    if spec["kind"] == "train":
        opt = AdamW(moment_dtype=knobs["moment_dtype"])
        step = make_train_step(cfg, opt, accum=knobs["accum"], remat=True,
                               accum_dtype=knobs["accum_dtype"])
        moments = {n: _meta(p.shape, opt._mdt(p)) for n, p in params.items()}
        opt_args = {"step": _meta((), torch.int32), "mu": moments,
                    "nu": dict(moments)}
        opt_sh = {"step": NamedSharding(mesh, ()), "mu": params_sh,
                  "nu": params_sh}

        def fn(params, opt_state, tokens, labels):
            model = sharding.ShardedModel.from_blocks(cfg, rules, params)
            state = AdamWState(opt_state["step"], opt_state["mu"],
                               opt_state["nu"])
            with rules.activate():
                return step(model, state, dict(tokens=tokens, labels=labels))

        in_sh = dict(params=params_sh, opt_state=opt_sh,
                     **_batch_shardings(rules, args))
        return Cell(name, fn, dict(params=params, opt_state=opt_args, **args),
                    in_sh)

    if spec["kind"] == "prefill":
        def fn(params, tokens):
            # this rank's rows of the logits, as the reference's output
            # stays sharded over the data axes
            model = sharding.ShardedModel.from_blocks(cfg, rules, params)
            with rules.activate():
                return model.prefill(tokens, whole=False)

        in_sh = dict(params=params_sh, **_batch_shardings(rules, args))
        return Cell(name, fn, dict(params=params, **args), in_sh)

    # decode: one new token against the cache, written at its last
    # position (the cache holds seq_len - 1 tokens; the port's cache_len
    # is a Python int)
    cache = args["cache"]
    cache_sh = _cache_shardings(rules, cache)
    cache_len = (seq or spec["seq_len"]) - 1

    def fn(params, tokens, cache, cache_len):
        model = sharding.ShardedModel.from_blocks(cfg, rules, params)
        placed = _sharded(cache, cache_sh, args["cache"])
        with rules.activate():
            return api.decode_step(cfg, model, tokens, placed, cache_len)[0]

    in_sh = dict(params=params_sh,
                 tokens=rules.input_sharding(
                     "tokens" if len(args["tokens"].shape) == 2
                     else "residual", args["tokens"].shape),
                 cache=cache_sh,
                 cache_len=NamedSharding(mesh, ()))
    return Cell(name, fn, dict(params=params, tokens=args["tokens"],
                               cache=_blocks(cache, cache_sh),
                               cache_len=cache_len), in_sh)


def build_pgf_cell(mesh, reduced: bool = False,
                   n_tuples: int | None = None) -> Cell:
    """The distributed aggregate-query step; ``n_tuples`` (global)
    replaces the config's (the calibration's and the card's cuts)."""
    from ..configs import pgf_tpch
    from ..db import distributed as dist
    qc = pgf_tpch.reduced() if reduced else pgf_tpch.CONFIG
    step = dist.make_query_step(mesh, max_groups=qc.max_groups,
                                num_freq=qc.num_freq, orders=qc.orders,
                                local=True)
    full = dist.input_specs(n_tuples=n_tuples or qc.n_tuples)
    full["values"] = _meta(full["values"].shape, torch.int32)
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    sh = NamedSharding(mesh, sharding.P(axes))
    in_sh = {k: sh for k in full}

    def fn(**kw):
        return step(**kw)

    return Cell("pgf_tpch/query", fn, _blocks(full, in_sh), in_sh)


def build_cell(arch: str, shape_name: str, mesh, **kw) -> Cell:
    if arch == "pgf_tpch":
        return build_pgf_cell(mesh, **kw)
    return build_lm_cell(arch, shape_name, mesh, **kw)


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch, shape) pair + the pgf cell."""
    cells = []
    for arch in cfgs.ARCH_IDS:
        cfg = cfgs.get_config(arch)
        for s in cfgs.runnable_cells(cfg):
            cells.append((arch, s))
    cells.append(("pgf_tpch", "query"))
    return cells

