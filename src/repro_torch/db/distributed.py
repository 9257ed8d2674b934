"""Multi-rank query execution over ``torch.distributed`` (port of
``repro.db.distributed``): the collectives of the segment-UDA protocol of
:mod:`repro_torch.core.uda` and of the sharded relational executor.

The paper scales by streaming partitions through per-core UDAs and merging
(Glade's Accumulate / Merge).  The JAX package runs that inside one
``shard_map``; the port runs one process per rank, each holding a
:class:`repro_torch.launch.mesh.Mesh`, and every helper here takes the
:class:`~repro_torch.launch.mesh.MeshAxis` (process group) it reduces
over.  The collectives map as

    psum / pmax          all_reduce(SUM) / all_reduce(MAX)
    tiled all_gather     all_gather_into_tensor (dim 0; other dims are
                         transposed to the front and back)
    all_to_all           all_to_all_single on the (n_shards, capacity)
                         bucket layout
    psum_scatter         reduce_scatter_tensor (dim 0)
    axis_index           the rank's coordinate in the mesh (no collective)

Bit-equality with the single-device compile rests on two merges only:
:func:`allgather_merge` gathers every canonical chunk state in rank-major
order (the global chunk order under the contiguous row partition) and runs
the one :func:`repro_torch.core.uda.tree_fold`, and
:func:`partitioned_merge` sums each group's owner state with exact zeros
from every other rank.  No state whose bits matter is merged by a float
sum across ranks (a backend's all_reduce order is its own); the psum of
``UDA.reduce_data`` / :func:`make_uda_step` / ``sharded_logcf`` is held to
tolerance only, as in the JAX package.

The sharded executor (``db/plans.py``) uses:

    gather_table        broadcast a row-partitioned Table: one gather per
                        column; rank-major order is the global row order
    shuffle_by_key      static-shape exchange: row i goes to rank
                        ``key % n_shards`` through send buckets of fixed
                        capacity, with overflow accounting
    shuffle_fk_join     ShuffleJoin: build rows and probe keys to their
                        key's owner, matched there, responses shuffled home
                        into the probe rows' positions
    copartitioned_fk_join / repartition_by_key
                        the exchanges of the co-partitioned pipeline:
                        matched rows stay at their owner with their
                        canonical chunk id and row offset
    group_ids_sharded   per-rank code tables, one gather, one merge
    group_key_columns_sharded   per-rank segment max + one pmax
    allgather_merge / gather_chunk_states / partitioned_merge   the Merges

The collectives run on the tensors where they live: the gloo of PyTorch
2.11 and 2.13 takes CUDA tensors for all five ops, as NCCL does.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as tdist

from ..core import uda
from ..testing import faults
from . import operators as ops
from . import physical as phys
from . import sweep
from .sweep import POINT
from .table import Table

#: Counts of the collective exchanges and merges of this process, keyed by
#: kind ("shuffle", "shuffle_back", "gather_table", "merge_psum",
#: "merge_gather", "gather_chunks"); one per executed call, so
#: tests can assert structural properties (a co-partitioned pipeline
#: issues no "shuffle_back").  Each rank counts its own.
COLLECTIVE_COUNTS: dict = {}

# PyTorch 2.13 renames the two tensor collectives (same signatures).
_all_gather_tensor = getattr(tdist, "all_gather_single",
                             tdist.all_gather_into_tensor)
_reduce_scatter_tensor = getattr(tdist, "reduce_scatter_single",
                                 tdist.reduce_scatter_tensor)


def reset_collective_counts() -> None:
    COLLECTIVE_COUNTS.clear()


def _count(kind: str) -> None:
    COLLECTIVE_COUNTS[kind] = COLLECTIVE_COUNTS.get(kind, 0) + 1


def _reduce(x, ax, op):
    work = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = work.clone().contiguous()
    tdist.all_reduce(out, op=op, group=ax.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def psum(x, ax):
    """all_reduce(SUM) over ``ax`` (a new tensor)."""
    return _reduce(x, ax, tdist.ReduceOp.SUM)


def pmax(x, ax):
    """all_reduce(MAX) over ``ax`` (exact: bit-equal on every backend)."""
    return _reduce(x, ax, tdist.ReduceOp.MAX)


def all_gather(x, ax):
    """Tiled gather along dim 0: rank-major concatenation of every rank's
    ``x`` (equal shapes)."""
    x = x.contiguous()
    out = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_tensor(out, x, group=ax.group)
    return out


def all_gather_last(x, ax):
    """Tiled gather along the last dim (the model axis's frequency
    windows): moved to the front, gathered, moved back."""
    front = torch.movedim(x, -1, 0)
    return torch.movedim(all_gather(front, ax), 0, -1).contiguous()


def reduce_scatter(x, ax):
    """psum_scatter along dim 0 (dim 0 divisible by the group size)."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]))
    _reduce_scatter_tensor(out, x, group=ax.group)
    return out


def _all_to_all_rows(x, ax):
    """The exchange of the (n_shards, capacity) bucket layout: bucket j of
    this rank goes to rank j, which receives it as its bucket of this
    rank."""
    x = x.contiguous()
    work = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = torch.empty_like(work)
    tdist.all_to_all_single(out, work, group=ax.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def map_state(fn, state):
    """Apply ``fn`` to every tensor field of a UDA state (a NamedTuple)."""
    return type(state)(*(fn(x) for x in state))


def data_rank(ax) -> int:
    """This rank's row-major index over the data axes (the order of the
    contiguous row partition): a mesh coordinate, no collective."""
    return 0 if ax is None else ax.index


def _data_axes(mesh, data_axes: Sequence[str]) -> tuple:
    return tuple(a for a in ("pod",) + tuple(data_axes)
                 if a in mesh.axis_names)


def _model_axis(mesh, model_axis: str | None) -> str | None:
    return (model_axis if model_axis and model_axis in mesh.axis_names
            and mesh.shape[model_axis] > 1 else None)


# ------------------------------------------------- the generic UDA step
def make_uda_step(mesh, uda_factory: Callable[[int, int], dict], *,
                  max_groups: int, data_axes: Sequence[str] = ("data",),
                  model_axis: str | None = "model", block: int = 8192,
                  post=None, local: bool = False):
    """A distributed Accumulate / Merge / Finalize step on ``mesh``.

    ``uda_factory(model_size, model_rank) -> {name: UDA}`` (model_rank 0
    without a model axis), so CF UDAs can bind their frequency window.
    The step takes the GLOBAL (probs, values, gids) columns (values may be
    a dict of per-UDA columns; call :func:`pad_for` first), accumulates
    this rank's contiguous block, merges with
    :func:`repro_torch.core.uda.reduce_collective` (a psum over the data
    axes: held to tolerance, not bit-equal) and returns the finalized
    results, or ``post(udas, states)``.  With ``local`` the step takes this
    rank's block of each column (the contiguous row partition:
    ``shard_columns``) instead of the global columns."""
    names = _data_axes(mesh, data_axes)
    ax = mesh.axis(names) if names else None
    model = _model_axis(mesh, model_axis)
    max_ = mesh.axis(model) if model else None
    model_size = mesh.shape[model] if model else 1
    model_rank = mesh.coords[model] if model else 0

    def step(probs, values, gids):
        shards = ax.size if ax is not None and not local else 1
        n = probs.shape[0] // shards
        sl = slice(data_rank(ax) * n, (data_rank(ax) + 1) * n) \
            if shards > 1 else slice(None)
        cut: dict = {}
        if isinstance(values, dict):
            vals = {k: None if v is None
                    else cut.setdefault(id(v), v[sl].to(mesh.device))
                    for k, v in values.items()}
        else:
            vals = None if values is None else values[sl].to(mesh.device)
        udas = uda_factory(model_size, model_rank)
        states = uda.accumulate(udas, probs[sl].to(mesh.device), vals,
                                gids[sl].to(mesh.device),
                                max_groups=max_groups, block=block)
        states = uda.reduce_collective(udas, states, ax, max_)
        if post is not None:
            return post(udas, states)
        return uda.finalize(udas, states)

    return step


def pad_for(mesh, probs, values, gids, *, max_groups: int,
            data_axes: Sequence[str] = ("data",)):
    """Zero-pad tuple columns so the data-shard count divides them (p = 0
    pads contribute nothing to any UDA; they land in the overflow
    group)."""
    shards = 1
    for a in _data_axes(mesh, data_axes):
        shards *= mesh.shape[a]
    pad = (-probs.shape[0]) % shards
    if pad == 0:
        return probs, values, gids

    def z(v, fill=0):
        return torch.cat([v, v.new_full((pad,), fill)])
    probs = z(probs)
    gids = z(gids, max_groups - 1)
    if isinstance(values, dict):
        # Pad each distinct source column once so aggregates sharing a
        # column keep sharing it (uda.accumulate dedups by identity).
        padded: dict = {}
        values = {k: None if v is None else padded.setdefault(id(v), z(v))
                  for k, v in values.items()}
    elif values is not None:
        values = z(values)
    return probs, values, gids


def make_query_step(mesh, *, max_groups: int = 1024, num_freq: int = 4096,
                    orders: int = 8, data_axes: Sequence[str] = ("data",),
                    model_axis: str | None = "model", local: bool = False):
    """The canonical distributed aggregate step: per-group confidence,
    Normal terms, cumulant sums and the exact global distribution
    (``num_freq`` coefficients, its frequencies split over the model
    axis).  Returns (confidence, normal terms, cumulant terms, coeffs).
    ``local``: see :func:`make_uda_step`."""
    model = _model_axis(mesh, model_axis)
    model_size = mesh.shape[model] if model else 1
    if num_freq % model_size:
        raise ValueError(f"num_freq {num_freq} must divide over the model "
                         f"axis ({model_size})")
    f_loc = num_freq // model_size

    def factory(size, rank):
        cf = uda.SumCF(num_freq, freq_lo=rank * f_loc, freq_cnt=f_loc)
        cf.scalar = True          # the global distribution: one group
        return dict(conf=uda.AtLeastOne(), normal=uda.SumNormal(),
                    cum=uda.SumCumulants(orders), cf=cf)

    def post(udas, states):
        confidence = udas["conf"].finalize(states["conf"])
        coeffs = udas["cf"].finalize(states["cf"])[0]
        return (confidence, states["normal"].terms, states["cum"].terms,
                coeffs)

    return make_uda_step(mesh, factory, max_groups=max_groups,
                         data_axes=data_axes, model_axis=model_axis,
                         post=post, local=local)


# ----------------------------------------------------- sharded frontend
def gather_table(t: Table, ax) -> Table:
    """Broadcast a row-partitioned Table: one tiled gather per column plus
    p and valid.  Under the contiguous row partition rank-major order is
    the global row order, so the gathered table is the unsharded one."""
    _count("gather_table")
    return Table({k: all_gather(v, ax) for k, v in t.columns.items()},
                 all_gather(t.prob, ax), all_gather(t.valid, ax),
                 phys.Replicated())


def shuffle_by_key(keys, cols: dict, ax, *, n_shards: int, capacity: int,
                   valid=None, points=None, n_points: int = 1):
    """Static-shape shuffle exchange: row i goes to rank ``keys[i] %
    n_shards`` through ``n_shards`` send buckets of ``capacity`` rows
    (``operators.bucket_slots``; ok-rows past a bucket's capacity are
    dropped but counted) and one all_to_all per column.  With ``points``
    (a batched sweep's point of each row, of ``n_points``) every owner's
    bucket is ``n_points`` buckets of ``capacity`` rows, one a point, so
    each point's rows are held to one point's capacity; the overflow is
    then each point's (n_points,) count.

    Returns ``(recv, recv_mask, slot, sent, overflow)``: ``recv`` {name:
    (n_shards * capacity,) tensor} (bucket j holds sender j's rows for
    this rank, in the sender's row order; empty slots zero), the occupancy
    mask, this rank's send slots and sent mask (to route responses home:
    :func:`shuffle_back` + ``operators.take_from_buckets``) and the local
    overflow count."""
    _count("shuffle")
    faults.on_exchange()
    ok = torch.ones(keys.shape, dtype=torch.bool, device=keys.device) \
        if valid is None else valid
    dest = torch.remainder(keys.to(torch.int32), n_shards)
    n_points = n_points if points is not None else 1
    if points is not None:
        dest = dest.to(torch.int64) * n_points + points
    slot, sent, overflow = ops.bucket_slots(dest, ok, n_shards * n_points,
                                            capacity)
    if points is not None:
        overflow = _point_counts(ok & ~sent, points, n_points)
    size = n_shards * n_points * capacity
    inv = ops.bucket_fill_index(slot, size)
    send = ops.scatter_to_buckets(cols, slot, size, inv=inv)
    mask = inv < keys.shape[0]          # slot filled by a sent row
    recv = {k: _all_to_all_rows(v, ax) for k, v in send.items()}
    return recv, _all_to_all_rows(mask, ax), slot, sent, overflow


def shuffle_back(cols: dict, ax) -> dict:
    """Responses home: the inverse exchange of :func:`shuffle_by_key`
    (all_to_all is an involution on the bucket layout), each response
    landing in the send slot its request came from."""
    _count("shuffle_back")
    return {k: _all_to_all_rows(v, ax) for k, v in cols.items()}


# Internal exchange fields ride the same bucket dicts as the carried user
# columns; the "\x00" prefix keeps them out of any legal column namespace.
_KEY, _PROB = "\x00key", "\x00prob"
#: the row offset inside its canonical chunk, shipped beside
#: ``physical.CHUNK_COL`` by the co-partitioned exchanges.
ROW_COL = "\x00row"


def _check_exchange_cols(what: str, cols) -> None:
    bad = [c for c in cols if c.startswith("\x00")]
    if bad:
        raise ValueError(f"{what} may not start with '\\x00' (reserved "
                         f"for exchange fields): {bad}")


def _point_counts(flags, points, n_points: int):
    """Each point's (n_points,) count of the rows where ``flags`` holds."""
    return torch.zeros((n_points,), dtype=torch.int64,
                       device=flags.device).scatter_add_(
        0, points, flags.to(torch.int64))


def _points(t: Table):
    """A swept relation's point column (None unswept)."""
    return t.columns.get(POINT)


def _send_demand(keys, valid, n_shards: int, points=None,
                 n_points: int = 1):
    """Peak per-owner send demand of this rank: the most valid rows it
    routes to one owner (with ``points``, each point's).  Its max over
    ranks is the bucket capacity that makes the exchange overflow-free
    (the retry controller's target, ``ExecutionReport.exchange_demand``)."""
    dest = torch.remainder(keys.to(torch.int32), n_shards).to(torch.int64)
    n_points = n_points if points is not None else 1
    if points is not None:
        dest = dest * n_points + points
    cnt = torch.zeros((n_shards * n_points,), dtype=torch.int64,
                      device=keys.device)
    cnt.scatter_add_(0, dest, valid.to(torch.int64))
    peak = cnt.view(n_shards, n_points).amax(0)
    return peak if points is not None else peak[0]


def _record_leg(report, label: str, leg: str, ax, overflow, keys, valid,
                n_shards: int, capacity: int, points=None,
                n_points: int = 1) -> None:
    """File one exchange leg into the ReportBuilder (two more collectives
    per leg, so only when a report was asked for)."""
    if report is None:
        return
    report.exchange_leg(label, leg, psum(overflow.to(torch.int64), ax),
                        pmax(_send_demand(keys, valid, n_shards, points,
                                          n_points), ax),
                        capacity)


def _exchange_build(right: Table, right_key: str, right_cols, ax,
                    n_shards: int, build_bucket: int, n_points: int = 1):
    """Shuffle the build side's valid rows to their ``right_key %
    n_shards`` owner (a swept build side's with their point, each point's
    rows held to one point's bucket).  Returns (the owner's bucket Table,
    local overflow)."""
    points = _points(right)
    bcols = {_KEY: right[right_key].to(torch.int32), _PROB: right.prob}
    for c in right_cols:
        bcols[c] = right[c]
    if points is not None:
        bcols[POINT] = points
    brecv, bmask, _, _, b_over = shuffle_by_key(
        bcols[_KEY], bcols, ax, n_shards=n_shards, capacity=build_bucket,
        valid=right.valid, points=points, n_points=n_points)
    carried = list(right_cols) + ([POINT] if points is not None else [])
    return Table({right_key: brecv[_KEY], **{c: brecv[c] for c in carried}},
                 brecv[_PROB], bmask, phys.HashPartitioned(right_key)), b_over


def _chunk_place(capacity: int, ax, chunk_size: int, num_chunks: int):
    """(canonical chunk id, row offset in the chunk) of each local row;
    shard-alignment padding rows are invalid and never shipped."""
    row = data_rank(ax) * capacity + torch.arange(
        capacity, dtype=torch.int64, device=ax.device)
    cid = torch.clamp(row // chunk_size, 0, num_chunks - 1)
    return cid.to(torch.int32), (row - cid * chunk_size).to(torch.int32)


def _poison(prob, over, points=None):
    """NaN the probabilities when any exchange leg overflowed (``over`` is
    the psum'd drop count: every rank agrees); a batched sweep's per-point
    ``over`` poisons the rows of the points that overflowed."""
    if over.dim():
        over = over[points]
    return torch.where(over > 0, torch.full_like(prob, float("nan")), prob)


def _match(probe: Table, build: Table, left_key: str, right_key: str,
           right_cols, n_points: int) -> Table:
    """The owner's many-to-one match: by key, or by (key, point) when the
    build side is swept (the probe side then is too)."""
    if _points(build) is not None:
        return sweep.fk_join(probe, build, left_key, right_key, right_cols,
                             n_points)
    return ops.fk_join(probe, build, left_key, right_key, right_cols)


def shuffle_fk_join(left: Table, right: Table, left_key: str,
                    right_key: str, right_cols: Sequence[str], ax, *,
                    n_shards: int, build_bucket: int, probe_bucket: int,
                    report=None, label: str = "",
                    n_points: int = 1) -> Table:
    """The ShuffleJoin executor: build rows to their key's owner, probe
    keys to the same owners as requests (p = 1), one local
    ``operators.fk_join`` there, and the responses back into the probe
    rows' positions, so the output keeps the LEFT side's row layout and is
    the gathered join bit for bit (same matches, same products, zeros on a
    miss).  Overflow on either exchange NaN-poisons the output
    probabilities (every rank agrees through one psum); the
    ``ExecutionReport`` records it per leg.  Swept sides (a batched sweep
    of ``n_points``) exchange each point's rows through its own buckets
    and match by (key, point)."""
    right_cols = list(right_cols)
    hit = "\x00hit"
    _check_exchange_cols("shuffle_fk_join right_cols", right_cols)
    build, b_over = _exchange_build(right, right_key, right_cols, ax,
                                    n_shards, build_bucket, n_points)
    lkey = left[left_key].to(torch.int32)
    points = _points(left)
    req_cols = {_KEY: lkey} if points is None else {_KEY: lkey,
                                                    POINT: points}
    preq, pmask, slot, sent, p_over = shuffle_by_key(
        lkey, req_cols, ax, n_shards=n_shards, capacity=probe_bucket,
        valid=left.valid, points=points, n_points=n_points)
    req = Table({left_key: preq[_KEY],
                 **({} if points is None else {POINT: preq[POINT]})},
                torch.ones(pmask.shape, dtype=left.prob.dtype,
                           device=pmask.device), pmask)
    matched = _match(req, build, left_key, right_key, right_cols, n_points)
    resp = {_PROB: matched.prob, hit: matched.valid}
    for c in right_cols:
        resp[c] = matched[c]
    got = ops.take_from_buckets(shuffle_back(resp, ax), slot, sent)
    _record_leg(report, label, "build", ax, b_over, right[right_key],
                right.valid, n_shards, build_bucket, _points(right),
                n_points)
    _record_leg(report, label, "probe", ax, p_over, lkey, left.valid,
                n_shards, probe_bucket, points, n_points)
    over = psum((b_over + p_over).to(torch.int64), ax)
    cols = dict(left.columns)
    for c in right_cols:
        cols[c] = got[c]
    return Table(cols, _poison(left.prob * got[_PROB], over, points),
                 left.valid & got[hit], left.part)


def _ship_rows(t: Table, key: str, carry_cols, ax, *, n_shards: int,
               bucket: int, chunk_size: int, num_chunks: int,
               n_points: int = 1):
    """Ship a row-partitioned relation's valid rows to their ``key %
    n_shards`` owner with (key, p, canonical chunk id, row offset,
    carry_cols, and a swept row's point, each point held to its own
    bucket).  Received rows keep the global row order restricted to the
    owner (sender-major, in-sender order; point-major within a sender when
    swept)."""
    cid, off = _chunk_place(t.capacity, ax, chunk_size, num_chunks)
    cols = {_KEY: t[key], _PROB: t.prob, phys.CHUNK_COL: cid, ROW_COL: off}
    for c in carry_cols:
        cols[c] = t[c]
    points = _points(t)
    if points is not None:
        cols[POINT] = points
    kcol = t[key].to(torch.int32)        # routing only; column ships as-is
    recv, mask, _, _, over = shuffle_by_key(
        kcol, cols, ax, n_shards=n_shards, capacity=bucket, valid=t.valid,
        points=points, n_points=n_points)
    return recv, mask, over, kcol


def copartitioned_fk_join(left: Table, right: Table, left_key: str,
                          right_key: str, right_cols: Sequence[str],
                          carry_cols: Sequence[str], ax, *, n_shards: int,
                          build_bucket: int, probe_bucket: int,
                          chunk_size: int, num_chunks: int, report=None,
                          label: str = "", n_points: int = 1) -> Table:
    """The CoPartitionedJoin executor: the two exchanges of
    :func:`shuffle_fk_join`, but probe rows ship (key, p, chunk id, row
    offset, ``carry_cols``) and matched rows STAY at their ``left_key %
    n_shards`` owner (no ``shuffle_back``), so a GROUP BY on the join key
    aggregates in place.  The output is ``HashPartitioned(left_key)`` in
    the exchange's bucket layout; overflow NaN-poisons it as in
    :func:`shuffle_fk_join`.  A swept probe side (a batched sweep) ships
    its rows at their canonical positions in the swept relation
    (``chunk_size`` is the swept chunk's) with their point."""
    right_cols, carry_cols = list(right_cols), list(carry_cols)
    _check_exchange_cols("copartitioned_fk_join columns",
                         right_cols + carry_cols)
    build, b_over = _exchange_build(right, right_key, right_cols, ax,
                                    n_shards, build_bucket, n_points)
    precv, pmask, p_over, lkey = _ship_rows(
        left, left_key, carry_cols, ax, n_shards=n_shards,
        bucket=probe_bucket, chunk_size=chunk_size, num_chunks=num_chunks,
        n_points=n_points)
    points = _points(left)
    shipped = list(carry_cols) + ([POINT] if points is not None else [])
    probe = Table({left_key: precv[_KEY],
                   **{c: precv[c] for c in (phys.CHUNK_COL, ROW_COL)},
                   **{c: precv[c] for c in shipped}},
                  precv[_PROB], pmask, phys.HashPartitioned(left_key))
    out = _match(probe, build, left_key, right_key, right_cols, n_points)
    _record_leg(report, label, "build", ax, b_over, right[right_key],
                right.valid, n_shards, build_bucket, _points(right),
                n_points)
    _record_leg(report, label, "probe", ax, p_over, lkey, left.valid,
                n_shards, probe_bucket, points, n_points)
    over = psum((b_over + p_over).to(torch.int64), ax)
    return out.with_prob(_poison(out.prob, over, _points(out)))


def repartition_by_key(t: Table, key: str, carry_cols: Sequence[str], ax,
                       *, n_shards: int, bucket: int, chunk_size: int,
                       num_chunks: int, report=None, label: str = "",
                       n_points: int = 1) -> Table:
    """The Repartition executor: hash-exchange a row-partitioned relation
    to its ``key % n_shards`` owners (the no-join feed of a
    PartitionedAgg), with the layout and overflow contract of
    :func:`copartitioned_fk_join` (a swept relation's too)."""
    carry_cols = list(carry_cols)
    _check_exchange_cols("repartition_by_key carry_cols", carry_cols)
    recv, mask, over, kcol = _ship_rows(
        t, key, carry_cols, ax, n_shards=n_shards, bucket=bucket,
        chunk_size=chunk_size, num_chunks=num_chunks, n_points=n_points)
    points = _points(t)
    _record_leg(report, label, "repart", ax, over, kcol, t.valid, n_shards,
                bucket, points, n_points)
    over = psum(over.to(torch.int64), ax)
    if points is not None:
        carry_cols.append(POINT)
    return Table({key: recv[_KEY],
                  **{c: recv[c] for c in (phys.CHUNK_COL, ROW_COL)},
                  **{c: recv[c] for c in carry_cols}},
                 _poison(recv[_PROB], over, recv.get(POINT)), mask,
                 phys.HashPartitioned(key))


def group_ids_sharded(table: Table, keys: Sequence[str], max_groups: int,
                      ax):
    """Two-phase group-id assignment over a row-partitioned table: per-rank
    code table (the ``max_groups`` smallest live codes), one gather, one
    merge, then the local ids against the merged table.  The result is
    ``operators.group_ids`` of the whole table, bit for bit."""
    code_live, big = ops.live_key_codes(table, list(keys))
    local = ops.merge_group_codes(code_live, max_groups)
    merged = ops.merge_group_codes(all_gather(local, ax), max_groups)
    return ops.codes_to_ids(code_live, merged), merged, merged != big


def group_key_columns_sharded(table: Table, keys: Sequence[str], ids,
                              max_groups: int, ax) -> dict:
    """Per-group key representatives over a row-partitioned table: local
    segment max, then one pmax (exact, so bit-equal to the replicated
    reduction)."""
    cols = ops.group_key_columns(table, keys, ids, max_groups)
    return {k: pmax(v, ax) for k, v in cols.items()}


def chunk_columns(probs, values: dict, ids, cid, off, valid, *,
                  chunk_size: int, num_chunks: int, max_groups: int):
    """The canonical chunk columns of an owner's received rows: each valid
    row at its global position ``cid * chunk_size + off``, every other
    position a p = 0 row of the fill group.  The owner then runs the SAME
    chunked accumulate as the single-device compile, with its own groups'
    tuples at their own positions, so every owned group's chunk state is
    the single-device state bit for bit (a per-call CUDA ``index_add``
    sums a group's rows of one block as a unit, so positions matter)."""
    n = num_chunks * chunk_size
    pos = torch.where(valid, cid.to(torch.int64) * chunk_size
                      + off.to(torch.int64),
                      torch.full_like(cid, n, dtype=torch.int64))

    def place(x, fill):
        buf = x.new_full((n + 1,), fill)
        buf.scatter_(0, pos, x)
        return buf[:n]
    placed: dict = {}
    vals = {k: None if v is None else placed.setdefault(id(v), place(v, 0))
            for k, v in values.items()}
    return place(probs, 0), vals, place(ids, max_groups - 1)


def _stack_gather(states: list, ax):
    """Gather a list of same-shaped UDA states from every rank: one
    gather per field of the stacked states; returns the rank-major list."""
    fields = [all_gather(torch.stack(xs), ax) for xs in zip(*states)]
    kind = type(states[0])
    return [kind(*(f[i] for f in fields)) for i in range(fields[0].shape[0])]


class _Add:
    """The additive merge of one state field (``tree_fold``'s protocol)."""

    @staticmethod
    def merge(a, b):
        return a + b


_ADD = _Add()


def allgather_merge(udas: dict, parts: list, ax, num_chunks: int,
                    shards: int) -> dict:
    """The Merge of a row-partitioned pass: gather every rank's
    per-canonical-chunk states and fold all ``num_chunks`` of them with
    :func:`repro_torch.core.uda.tree_fold`, identically on every rank.

    ``parts`` is this rank's list of chunk-slot state dicts (its
    contiguous run of slots; slots past the grid hold init states).
    Rank-major order is the global chunk order, so the fold consumes the
    single-device leaves in the single-device tree: the same bits for any
    rank count.  When every rank's run is an aligned power-of-two subtree
    (a power-of-two rank count dividing a power-of-two grid) each rank
    folds its run first and one state per rank is gathered."""
    local = len(parts)
    aligned = (shards * local == num_chunks
               and local & (local - 1) == 0 and shards & (shards - 1) == 0)
    leaves = shards if aligned else num_chunks
    out = {}
    for name, u in udas.items():
        mine = [p[name] for p in parts]
        if aligned:
            mine = [uda.tree_fold(u, mine)]
        if not u.additive:
            out[name] = uda.tree_fold(u, _stack_gather(mine, ax)[:leaves])
            continue
        # An additive merge adds field by field, so each field gathers and
        # folds alone (the same tree, the same bits) and only one field's
        # gathered states are alive at a time.
        fields = []
        for xs in zip(*mine):
            g = all_gather(torch.stack(xs), ax)
            fields.append(uda.tree_fold(_ADD, list(g[:leaves])))
            del g
        out[name] = type(mine[0])(*fields)
    return out


def gather_chunk_states(udas: dict, parts: list, ax) -> list:
    """Gather per-chunk states without folding them (the streamed
    executor's per-wave collective): the rank-major list of chunk-state
    dicts, the same on every rank."""
    _count("gather_chunks")
    out: list = []
    for name in udas:
        states = _stack_gather([p[name] for p in parts], ax)
        if not out:
            out = [dict() for _ in states]
        for d, st in zip(out, states):
            d[name] = st
    return out


def _scatter_sum_gather(state, ax, n_shards: int):
    """psum as reduce-scatter + gather: each rank sums only its
    1/n_shards stripe of the group axis.  Bit-equal to the single-device
    state because every group is exact zeros on every rank but its owner:
    x + 0 + ... + 0 = x in any order."""
    def leaf(x):
        g = x.shape[0]
        pad = (-g) % n_shards
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        y = all_gather(reduce_scatter(x, ax), ax)
        return y[:g] if pad else y
    return map_state(leaf, state)


def partitioned_merge(udas: dict, parts: list, ax,
                      n_shards: int | None = None) -> dict:
    """The Merge of a hash-partitioned pass (PartitionedAgg): ``parts`` is
    this owner's list of ALL canonical chunk states, nonzero only for the
    groups it owns (a group's tuples live wholly at its ``key %
    n_shards`` owner).  The owner folds the chunks with the one
    :func:`repro_torch.core.uda.tree_fold`, which for its groups is the
    single-device fold; then additive states take one reduce-scatter +
    gather (x + exact zeros) and MinMax one gather + merge fold
    (``merge(init, x)`` is x bit for bit).  Needs every group wholly at one
    owner, which holds while the key cardinality fits ``max_groups``."""
    out = {}
    for name, u in udas.items():
        folded = uda.tree_fold(u, [p[name] for p in parts])
        _count("merge_psum" if u.additive else "merge_gather")
        if u.additive and n_shards is not None and n_shards > 1:
            out[name] = _scatter_sum_gather(folded, ax, n_shards)
        else:
            out[name] = u.reduce_data(folded, ax)
    return out


def shard_columns(mesh, arrays, data_axes: Sequence[str] = ("data",)):
    """This rank's row block of each column (host arrays or tensors): the
    rows split over the data axes (``pod`` first, then ``data_axes``) in
    row-major order of the rank's coordinates, as the reference's tuple
    sharding lays them out; each block on the mesh's device."""
    names = _data_axes(mesh, data_axes)
    ax = mesh.axis(names) if names else None
    shards = ax.size if ax is not None else 1
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % shards:
            raise ValueError(f"{t.shape[0]} rows do not split over "
                             f"{shards} data shards (pad_for)")
        n = t.shape[0] // shards
        r = data_rank(ax)
        out.append(t[r * n:(r + 1) * n].to(mesh.device))
    return tuple(out)


def input_specs(*, n_tuples: int, dtype=torch.float32) -> dict:
    """Shape / dtype stand-ins (``meta`` tensors) for the distributed query
    step's inputs."""
    def meta(dt):
        return torch.empty((n_tuples,), dtype=dt, device="meta")
    return dict(probs=meta(dtype), values=meta(dtype),
                gids=meta(torch.int32))
