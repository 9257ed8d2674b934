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
* A join whose build side is swept matches probe row r with build key k
  at point j: both sides are keyed by (key, point) (:func:`fk_join`),
  and a probe side not yet swept is joined with the points first (pair
  (r, j) at row r * N + j, as the point join lays it out).  So a family
  may sweep a dimension table (TPC-H Q3's SEGMENT on ``customer``) and
  nest (Q3's DATE on ``orders``, the build side of ``lineitem``'s join).
* The result is split per point (:func:`unstack`): every leaf gains a
  leading N axis, as the scan sweep's do.

The fold order differs from a run at one point (a block of the canonical
loop now holds several points' rows, and a one-group pass becomes a
grouped one), so a batched sweep is held to the scan sweep within a
tolerance, as the reference holds its vmap sweep to ~1 ulp.  With
``with_report`` the run's :class:`~repro_torch.db.report.ExecutionReport`
is stacked: every count is point j's at index j (a pass's lost group
codes, its states' NaNs, an exchange leg's overflow, demand and
capacity), ``tail_mass`` is (N, groups), and a part of the plan the
points share files its one count at every point.

A parameter can enter only through a Select predicate, a Map column or a
ReweightGreater threshold; a plan whose parameter sits elsewhere (a
``Project.max_groups``, a ``GroupAgg.kappa``) is refused by
:func:`check_plan` with a ``ValueError`` that names the construct, as the
reference's ``plan_params`` never looks there.  Predicates and column
functions must work row by row, as those of the TPC-H families do.

On a mesh the point join runs on each rank's row block (the swept blocks,
rank after rank, are the global r * N + j order), and a pass's group
codes merge over the data ranks point by point (one gather).  Every
exchange (ShuffleJoin, CoPartitionedJoin, Repartition) holds each point's
rows to one point's bucket: a row's bucket is (owner, point), so a point
overflows, drops rows and is NaN-poisoned as a run at it alone would be.
A row's owner is ``hash(key) % n_shards`` as unswept, so every point of
a group meets at one owner, which places the row at its canonical chunk
position in the swept relation (the position mesh=None's batched pass
gives it).  The result is mesh=None's, bit for bit.
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


def _point_tables(code, point, n: int, max_groups: int, big: int):
    """(n, max_groups): each point's ``max_groups`` smallest distinct live
    codes, padded with ``big``, for rows in any order (``point`` gives
    each row's): a sort of the distinct (point, code rank) pairs."""
    uniq = torch.unique(code)
    width = uniq.shape[0]
    pairs = torch.unique(point * width + torch.searchsorted(uniq, code))
    p = torch.div(pairs, width, rounding_mode="floor")
    c = uniq[pairs - p * width]
    dev = code.device
    first = torch.searchsorted(pairs, torch.arange(n, device=dev) * width)
    pos = torch.arange(pairs.shape[0], device=dev) - first[p]
    keep = (pos < max_groups) & (c != big)
    table = code.new_full((n * max_groups + 1,), big)
    table[torch.where(keep, p * max_groups + pos,
                      torch.full_like(pos, n * max_groups))] = c
    return table[:-1].view(n, max_groups)


def _point_search(table, code, point):
    """``torch.searchsorted(table[point[i]], code[i])`` for every row i:
    the (point, code rank) pairs of the table rows are one sorted
    sequence."""
    n, mg = table.shape
    uniq = torch.unique(table)
    width = uniq.shape[0] + 1
    flat = (torch.arange(n, device=code.device)[:, None] * width
            + torch.searchsorted(uniq, table)).reshape(-1)
    pos = torch.searchsorted(flat, point * width
                             + torch.searchsorted(uniq, code))
    return pos - point * mg


def group_ids(t: Table, keys, max_groups: int, n: int, ax=None,
              laid_out: bool = True, count_lost: bool = False):
    """Group ids of a swept table: (ids, group_valid, lost) over
    ``max_groups * n`` groups, point j's group g at g * n + j.  Each
    point's groups are the ``max_groups`` smallest distinct live key codes
    of its rows (over every rank of ``ax``: each rank's smallest, one
    gather, one merge), and its rows map to them as
    :func:`operators.group_ids` maps a run at that point alone (a code
    past the table and a dead row go to the last group).  ``laid_out``:
    the rows are in the point join's r * n + j order; else (an owner's
    received rows) each row's point is read from :data:`POINT`.  With
    ``count_lost``, ``lost`` is each point's (n,) count of this rank's
    live rows whose code was dropped past ``max_groups``; else None."""
    code, big = ops.live_key_codes(t, list(keys))
    if laid_out:
        code = code.view(-1, n).T.contiguous()    # (points, rows)
        table = _first_codes(code, max_groups, big)
    else:
        point = t[POINT]
        table = _point_tables(code, point, n, max_groups, big)
    if ax is not None:
        from .distributed import all_gather
        gathered = all_gather(table[None], ax)    # (ranks, points, groups)
        table = _first_codes(gathered.transpose(0, 1).reshape(n, -1),
                             max_groups, big)
    if laid_out:
        slot = torch.searchsorted(table, code)
        point = torch.arange(n, device=code.device)[:, None]
    else:
        slot = _point_search(table, code, point)
    slot = torch.clamp(slot, max=max_groups - 1)
    slot = torch.where(code == big, torch.full_like(slot, max_groups - 1),
                       slot)
    ids = slot * n + point
    lost = None
    if count_lost:
        kept = table.reshape(-1)[point * max_groups + slot]
        dropped = ((code != big) & (kept != code)).to(torch.int64)
        lost = (dropped.sum(1) if laid_out else torch.zeros(
            n, dtype=torch.int64, device=code.device).scatter_add_(
                0, point, dropped)).to(torch.int32)
    if laid_out:
        ids = ids.T.reshape(-1)
    return ids, (table != big).T.reshape(-1), lost


def nan_count(state, n: int):
    """Each point's (n,) int32 NaN count of a swept UDA state (groups
    g * n + j), as :func:`repro_torch.db.report.nan_count` counts one
    run's."""
    total = None
    for leaf in state:
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            c = torch.isnan(leaf).reshape(leaf.shape[0] // n, n, -1) \
                .sum((0, 2))
            total = c if total is None else total + c
    return total.to(torch.int32)


def point_codes(t: Table, key: str, n: int):
    """Each swept row's (key, point) code: the int32 key, then the
    point."""
    return t[key].to(torch.int32).to(torch.int64) * n + t[POINT]


def fk_join(left: Table, right: Table, left_key: str, right_key: str,
            right_cols, n: int) -> Table:
    """:func:`operators.fk_join` of two swept relations point by point:
    probe row (r, j) matches the build row of key k at point j.  The
    build keys must be unique among each point's valid rows."""
    rk = point_codes(right, right_key, n)
    live = rk[right.valid]
    if torch.unique(live).shape[0] != live.shape[0]:
        raise ValueError(
            f"fk_join build side has duplicate valid keys in {right_key!r} "
            "at one sweep point; the many-to-one join contract needs the "
            "right key unique among each point's valid rows")
    return ops.join_on_codes(left, right, point_codes(left, left_key, n),
                             rk, list(right_cols))


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


def split_points(x, n: int):
    """A swept group-level tensor (groups g * n + j) as (n, groups)."""
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
            out[k] = split_points(v, n)
    return out


def unstack(out, n: int):
    """The result of a swept run (every parameterized plan's is: its
    parameters reach the root through swept relations), every leaf with a
    leading point axis; point j's slice is its result."""
    if isinstance(out, Table):
        return Table({k: split_points(v, n) for k, v in out.columns.items()
                      if k != POINT},
                     split_points(out.prob, n), split_points(out.valid, n),
                     out.part)
    return _unstack_tree({k: v for k, v in out.items() if k != POINT}, n)


def _unstack_tree(x, n: int):
    if isinstance(x, dict):
        if "run_group" in x:
            return _split_runs(x, n)
        return {k: _unstack_tree(v, n) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [_unstack_tree(v, n) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return split_points(x, n)


def check_plan(root) -> None:
    """Refuse, with a ``ValueError`` naming the construct, a plan family
    whose :class:`Param` or :class:`Parameterized` sits anywhere but a
    Select predicate, a Map column or a ReweightGreater threshold (where
    the reference's ``plan_params`` never looks)."""
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

    walk(root)
