"""Batched parameter sweeps: the port's counterpart of the reference's
``QueryService(sweep_mode="vmap")``.

The reference maps one traced plan graph over N parameter points with
``jax.vmap``.  The port's executor is eager, with data-dependent shapes
(``torch.unique`` group ids, join sizes) and host syncs, so it cannot be
vmapped.  It batches the relation instead, and the sweep point becomes
an extra group key:

* The lowest node that reads a parameter joins its input with the N-row
  table of points (:func:`repro_torch.db.operators.general_join`; the
  pair (row r, point j) is row ``r * N + j``).  For a Select the join
  condition is the predicate at each point; for a Map every pair joins
  and the column is computed at each point.  A predicate or column
  function is called once a point with that point's 0-d values, as a
  sequential submit calls it, so dtype promotion is the same.
* Everything above runs on the joined relation, which carries the point
  index in the reserved column :data:`POINT`.  An aggregation groups by
  (group, point): group g of point j is id ``g * N + j``, and each point
  keeps the first ``max_groups`` distinct key codes of its own rows, as
  a run at that point alone does.  So one pass over N x rows accumulates
  every point's states through ``core/uda.py``, and the grouped kernels
  (``group_cumulant_sums``, ``group_logcf``) run where the
  ``kernels/ops.py`` guards allow.
* A node that reads no parameter, and everything below the join, runs
  once, as ``jax.vmap`` leaves values that do not depend on the batch
  unbatched.  A ReweightGreater whose threshold is a :class:`Param` over
  such an input accumulates once and compares every point's threshold
  with the same group states.
* The result is split per point (:func:`unstack`): every leaf gains a
  leading N axis, as the scan sweep's do.

The fold order differs from a run at one point (a block of the canonical
loop now holds several points' rows, and a one-group pass becomes a
grouped one), so a batched sweep is held to the scan sweep within a
tolerance, as the reference holds its vmap sweep to ~1 ulp.

A parameter can enter only through a Select predicate, a Map column or a
ReweightGreater threshold; a plan whose parameter sits elsewhere, or
feeds the build side of an FKJoin (whose keys the point join would
duplicate), is refused by :func:`check_plan` with a ``ValueError`` that
names the construct.  Predicates and column functions must work row by
row, as those of the TPC-H families do.

On a mesh the point join runs on each rank's row block (the swept blocks,
rank after rank, are the global r * N + j order), a pass's group codes
merge over the data ranks point by point (one gather), and a ShuffleJoin
sends N points' probe rows through buckets of N times one point's rows;
the result is mesh=None's, bit for bit.  The co-partitioned pipeline
(CoPartitionedJoin, Repartition into a PartitionedAgg) is refused: its
owners place rows by canonical chunk position, which a swept row's
points share.
"""
from __future__ import annotations

import dataclasses

import torch

from . import operators as ops
from .table import Table

#: reserved column (and result entry) holding a swept row's point index
POINT = "\x00point"


class Points:
    """The N parameter points of one batched launch: ``batch`` maps each
    parameter name to a length-N tensor (dtype and device kept)."""

    def __init__(self, batch: dict):
        self.batch = batch
        self.n = int(next(iter(batch.values())).shape[0])

    def env(self, j: int) -> dict:
        """Point j's values, as the 0-d tensors a submit at it passes."""
        return {k: v[j] for k, v in self.batch.items()}

    def per_group(self, num_groups: int) -> dict:
        """Each parameter at every swept group id g * N + j."""
        return {k: v.repeat(num_groups) for k, v in self.batch.items()}

    def table(self, like: Table) -> Table:
        """The N-row table of points (p = 1) on ``like``'s device."""
        dev = like.device
        return Table({POINT: torch.arange(self.n, device=dev)},
                     torch.ones((self.n,), dtype=like.prob.dtype,
                                device=dev),
                     torch.ones((self.n,), dtype=torch.bool, device=dev))


def is_swept(t: Table) -> bool:
    return POINT in t.columns


def _point_view(t: Table, n: int, j: int) -> Table:
    """Point j's rows of a swept table, as strided views."""
    cut = lambda v: v.view(-1, n)[:, j]
    return Table({k: cut(v) for k, v in t.columns.items() if k != POINT},
                 cut(t.prob), cut(t.valid), t.part)


def per_point(t: Table, points: Points, fn):
    """``fn(table, env)`` at every point, laid out as the swept rows are:
    on an unswept table the (rows, N) result of each point's call on the
    whole table, on a swept one each point's call on its own rows."""
    n = points.n
    if is_swept(t):
        cols = [fn(_point_view(t, n, j), points.env(j)) for j in range(n)]
    else:
        cols = [fn(t, points.env(j)) for j in range(n)]
    return torch.stack(cols, dim=1).reshape(-1)


def point_join(t: Table, points: Points, keep, mask=None) -> Table:
    """``t`` joined with the points, the pair (r, j) at row r * N + j and
    valid where ``mask`` (laid out likewise) holds; only the columns in
    ``keep`` (None: all) ride along, plus :data:`POINT`."""
    if keep is not None:
        t = t.select_columns([k for k in t.columns if k in keep])
    if mask is None:
        def cond(left, right, ii, jj):
            return torch.ones_like(ii, dtype=torch.bool)
    else:
        def cond(left, right, ii, jj):
            return mask
    return ops.general_join(t, points.table(t), cond, [POINT]).with_part(
        t.part)


def _first_codes(codes, max_groups: int, big: int):
    """Each row's ``max_groups`` smallest distinct codes, padded with
    ``big`` (:func:`operators.merge_group_codes` row by row)."""
    s = torch.sort(codes, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.sort(torch.where(dup, torch.full_like(s, big), s),
                   dim=1).values[:, :max_groups].contiguous()
    if s.shape[1] < max_groups:
        s = torch.cat([s, s.new_full((s.shape[0], max_groups - s.shape[1]),
                                     big)], dim=1)
    return s


def group_ids(t: Table, keys, max_groups: int, n: int, ax=None):
    """Group ids of a swept table: (ids, group_valid) over ``max_groups *
    n`` groups, point j's group g at g * n + j.  Each point's groups are
    the ``max_groups`` smallest distinct live key codes of its rows (over
    every rank of ``ax``, a row-partitioned table's data axes: each rank's
    smallest, one gather, one merge), and its rows map to them as
    :func:`operators.group_ids` maps a run at that point alone (a code
    past the table and a dead row go to the last group)."""
    code, big = ops.live_key_codes(t, list(keys))
    per = code.view(-1, n).T.contiguous()     # (points, rows)
    table = _first_codes(per, max_groups, big)
    if ax is not None:
        from .distributed import all_gather
        gathered = all_gather(table[None], ax)    # (ranks, points, groups)
        table = _first_codes(gathered.transpose(0, 1).reshape(n, -1),
                             max_groups, big)
    slot = torch.clamp(torch.searchsorted(table, per), max=max_groups - 1)
    slot = torch.where(per == big, torch.full_like(slot, max_groups - 1),
                       slot)
    point = torch.arange(n, device=code.device)[:, None]
    return (slot * n + point).T.reshape(-1), (table != big).T.reshape(-1)


def expand(x, n: int):
    """An unswept group-level tensor at every point (g -> g * n + j)."""
    return x.repeat_interleave(n, dim=0)


def expand_state(st, n: int):
    return type(st)(*(expand(x, n) for x in st))


def mark(out, n: int):
    """Tag a swept pass's output (a Table or a result dict) with the point
    of each group."""
    cap = out.capacity if isinstance(out, Table) else out["valid"].shape[0]
    dev = out.device if isinstance(out, Table) else out["valid"].device
    point = torch.arange(cap, device=dev) % n
    if isinstance(out, Table):
        return out.with_column(POINT, point)
    return {**out, POINT: point}


def _split(x, n: int):
    return x.reshape((-1, n) + tuple(x.shape[1:])).transpose(0, 1) \
        .contiguous()


def _split_runs(runs: dict, n: int) -> dict:
    """A MinMax run dict: ``run_*`` over (group, kappa) slots, groups
    g * n + j -> (n, groups * kappa), run_group back to g."""
    out = {}
    groups = runs["p_empty"].shape[0]
    for k, v in runs.items():
        if k.startswith("run_"):
            if k == "run_group":
                v = torch.div(v, n, rounding_mode="floor")
            v = v.reshape(groups // n, n, -1).transpose(0, 1)
            out[k] = v.reshape(n, -1)
        else:
            out[k] = _split(v, n)
    return out


def unstack(out, n: int):
    """The result of a swept run (every parameterized plan's is: its
    parameters reach the root through swept relations), every leaf with a
    leading point axis; point j's slice is its result."""
    if isinstance(out, Table):
        return Table({k: _split(v, n) for k, v in out.columns.items()
                      if k != POINT},
                     _split(out.prob, n), _split(out.valid, n), out.part)
    return _unstack_tree({k: v for k, v in out.items() if k != POINT}, n)


def _unstack_tree(x, n: int):
    if isinstance(x, dict):
        if "run_group" in x:
            return _split_runs(x, n)
        return {k: _unstack_tree(v, n) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [_unstack_tree(v, n) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return _split(x, n)


def check_plan(root) -> None:
    """Refuse, with a ``ValueError`` naming the construct, a plan family
    the point join cannot batch: a :class:`Param` or
    :class:`Parameterized` anywhere but a Select predicate, a Map column or
    a ReweightGreater threshold, and a parameter on the build (right) side
    of an FKJoin."""
    from . import plans as L
    legal = {(L.Select, "pred"), (L.Map, "fn"),
             (L.ReweightGreater, "threshold")}

    def walk(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, L.Node):
                walk(v)
            elif isinstance(v, (L.Param, L.Parameterized)) \
                    and (type(node), f.name) not in legal:
                raise ValueError(
                    f"sweep_mode='vmap' cannot batch "
                    f"{type(node).__name__}.{f.name} = {v!r}: a sweep "
                    "point enters a plan only through a Select predicate, "
                    "a Map column or a ReweightGreater threshold")
        if isinstance(node, L.FKJoin) and L.plan_params(node.right):
            raise ValueError(
                f"sweep_mode='vmap' cannot batch the FKJoin on "
                f"{node.left_key} = {node.right_key}: its build (right) "
                f"side reads the sweep parameters "
                f"{sorted(L.plan_params(node.right))}, and joining it with "
                "the points would repeat its keys")

    walk(root)
