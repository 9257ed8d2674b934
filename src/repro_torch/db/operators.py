"""Probabilistic relational operators (paper §IV-F / Table I; port of
``repro.db.operators``), the part the resident TPC-H path runs.

    I    R -> R^p                Table.from_columns(prob=...)
    II   sigma_C (deterministic) `select`: valid &= C
    III  sigma_{A theta B}       `reweight`: p *= P(theta)
    IV   R join_C S              `fk_join` (many-to-one)
    V    pi_A                    `project`: GROUP BY + AtLeastOne UDA
    VI   GROUP BY + PGF UDAs     `group_*` (AtLeastOne, Normal, cumulants,
                                 exact CF, MIN/MAX)

Grouping uses a fixed ``max_groups``: live key codes are packed into one
int64 code, the ``max_groups`` smallest distinct codes form the group
table, and dead or overflowing rows land in the last (fill) bucket.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from ..core import uda
from .table import Table

BIG = torch.iinfo(torch.int64).max


# --------------------------------------------------------------- grouping
def check_nonneg_keys(table: Table, keys: Sequence[str]) -> None:
    """Reject negative key values in valid rows: the positional packing
    of :func:`encode_keys` assumes nonnegative keys."""
    for k in keys:
        if bool(torch.any(table.valid & (table[k] < 0))):
            raise ValueError(
                f"group key column {k!r} contains negative values in valid "
                "rows; group-id codes assume nonnegative keys (the "
                "positional packing of encode_keys) — shift or re-encode "
                "the column first")


def encode_keys(table: Table, keys: Sequence[str],
                multipliers: Sequence[int] | None = None):
    """Combine key columns into one sortable int64 code; multipliers[i]
    must exceed the range of keys[i+1:] (default 2**20 each)."""
    code = torch.zeros((table.capacity,), dtype=torch.int64,
                       device=table.device)
    for i, k in enumerate(keys):
        m = multipliers[i] if multipliers else (1 << 20)
        code = code * m + table[k].to(torch.int64)
    return code


def live_key_codes(table: Table, keys: Sequence[str]):
    """Per-row key codes with dead rows pushed to the ``big`` sentinel.
    Returns (code_live, big)."""
    check_nonneg_keys(table, keys)
    code = encode_keys(table, keys)
    return torch.where(table.valid, code, torch.full_like(code, BIG)), BIG


def merge_group_codes(codes, max_groups: int):
    """The ``max_groups`` smallest distinct codes, padded with the
    sentinel (``jnp.unique(size=max_groups, fill_value=big)``)."""
    uniq = torch.unique(codes, sorted=True)[:max_groups]
    if uniq.shape[0] < max_groups:
        uniq = torch.cat([uniq, uniq.new_full(
            (max_groups - uniq.shape[0],), BIG)])
    return uniq


def codes_to_ids(code_live, group_codes):
    """Row codes -> group ids in [0, max_groups) against a merged code
    table; dead rows go to the last (fill) bucket explicitly."""
    last = group_codes.shape[0] - 1
    ids = torch.clamp(torch.searchsorted(group_codes, code_live), 0, last)
    return torch.where(code_live == BIG, torch.full_like(ids, last), ids)


def group_ids(table: Table, keys: Sequence[str], max_groups: int):
    """Assign each valid row a group id in [0, max_groups).  Returns
    (ids, group_codes, group_valid)."""
    code_live, big = live_key_codes(table, keys)
    uniq = merge_group_codes(code_live, max_groups)
    return codes_to_ids(code_live, uniq), uniq, uniq != big


def group_key_columns(table: Table, keys: Sequence[str], ids,
                      max_groups: int):
    """Representative value of each key column per group: the segment max
    over valid writers, with the max identity (integer min, -inf, False)
    for rows that are invalid and for groups with no valid writer."""
    check_nonneg_keys(table, keys)
    out = {}
    for k in keys:
        col = table[k]
        work = col.to(torch.uint8) if col.dtype == torch.bool else col
        if work.is_floating_point():
            ident = -math.inf
        else:
            ident = 0 if col.dtype == torch.bool else torch.iinfo(
                work.dtype).min
        src = torch.where(table.valid, work, torch.full_like(work, ident))
        red = torch.full((max_groups,), ident, dtype=work.dtype,
                         device=work.device)
        red = red.scatter_reduce(0, ids, src, "amax", include_self=True)
        out[k] = red.to(torch.bool) if col.dtype == torch.bool else red
    return out


# -------------------------------------------------------------- selection
def select(table: Table, pred: Callable[[Table], torch.Tensor]) -> Table:
    """sigma_C, deterministic condition (Table I row II)."""
    return table.with_valid(table.valid & pred(table))


def reweight(table: Table, p_cond) -> Table:
    """sigma with probabilistic condition (Table I row III): p *= P(cond)."""
    return table.with_prob(table.prob * p_cond)


# -------------------------------------------------------------- projection
def project(table: Table, keys: Sequence[str], max_groups: int) -> Table:
    """pi_A (Table I row V): GROUP BY keys + AtLeastOne UDA."""
    ids, _, gvalid = group_ids(table, keys, max_groups)
    u = uda.AtLeastOne()
    st = uda.accumulate({"a": u}, table.masked_prob(), None, ids,
                        max_groups=max_groups)["a"]
    cols = group_key_columns(table, keys, ids, max_groups)
    return Table(cols, u.finalize(st), gvalid)


# -------------------------------------------------------------------- joins
def check_unique_fk_keys(right: Table, right_key: str) -> None:
    """Reject duplicate valid build-side keys in :func:`fk_join` (a
    duplicate would silently drop one world's probability mass)."""
    live = right[right_key][right.valid]
    if torch.unique(live).shape[0] != live.shape[0]:
        raise ValueError(
            f"fk_join build side has duplicate valid keys in {right_key!r}; "
            "the many-to-one join contract needs the right key unique among "
            "valid rows (deduplicate or Project the build side first)")


def fk_join(left: Table, right: Table, left_key: str, right_key: str,
            right_cols: Sequence[str], suffix: str = "") -> Table:
    """Many-to-one equijoin (fact -> dimension), Table I row IV.

    Output capacity = left capacity; p = p_l * p_r.  The lookup is a sort
    of the int32 build keys plus searchsorted.  Dead output rows (a miss
    or an invalid left row) carry p = 0 and zero-filled right columns."""
    check_unique_fk_keys(right, right_key)
    return join_on_codes(left, right, left[left_key].to(torch.int32),
                         right[right_key].to(torch.int32), right_cols,
                         suffix)


def join_on_codes(left: Table, right: Table, lk, rk,
                  right_cols: Sequence[str], suffix: str = "") -> Table:
    """:func:`fk_join` on given integer codes of one dtype (``rk`` unique
    among the valid build rows): the key columns cast to int32, or a
    batched sweep's (key, point) codes."""
    rk = torch.where(right.valid, rk,
                     torch.full_like(rk, torch.iinfo(rk.dtype).max))
    order = torch.argsort(rk, stable=True)
    rk_sorted = rk[order]
    lk = lk.contiguous()
    pos = torch.clamp(torch.searchsorted(rk_sorted, lk), 0,
                      right.capacity - 1)
    src = order[pos]
    valid = left.valid & (rk_sorted[pos] == lk)
    cols = dict(left.columns)
    for c in right_cols:
        fetched = right[c][src]
        cols[c + suffix] = torch.where(valid, fetched,
                                       torch.zeros_like(fetched))
    prob = torch.where(valid, left.prob * right.prob[src],
                       torch.zeros_like(left.prob))
    return Table(cols, prob, valid, left.part)


def general_join(left: Table, right: Table,
                 cond: Callable[[Table, Table, torch.Tensor, torch.Tensor],
                                torch.Tensor],
                 right_cols: Sequence[str], suffix: str = "") -> Table:
    """Nested-loop theta-join for small relations: capacity |L| x |R|,
    the pair (i, j) at row i * |R| + j; p = p_l * p_r (Table I row IV).

    ``cond(left, right, i_idx, j_idx)`` -> bool over the flattened pair
    grid (int64 indices); pairs that fail it, or have an invalid side,
    are invalid rows."""
    nl, nr = left.capacity, right.capacity
    ii = torch.arange(nl, device=left.device).repeat_interleave(nr)
    jj = torch.arange(nr, device=left.device).repeat(nl)
    cols = {k: v[ii] for k, v in left.columns.items()}
    for c in right_cols:
        cols[c + suffix] = right[c][jj]
    ok = cond(left, right, ii, jj)
    prob = left.prob[ii] * right.prob[jj]
    valid = left.valid[ii] & right.valid[jj] & ok
    return Table(cols, prob, valid)


# ------------------------------------------- shuffle-exchange bucket math
def bucket_slots(dest, ok, n_shards: int, capacity: int):
    """Static-shape send-bucket slot assignment for a shuffle exchange.

    Row i with ``ok[i]`` goes to bucket ``dest[i]`` (in [0, n_shards)) at
    its rank among earlier ok-rows of the same destination; ranks at or
    past ``capacity`` overflow and are dropped (but counted).  Rows with
    ``ok[i]`` False are parked in a phantom bucket and never sent.

    Returns ``(slot, sent, overflow_count)``: ``slot[i]`` indexes the flat
    (n_shards * capacity,) send buffer, and equals the buffer size exactly
    for unsent rows; ``sent = ok & fits``; ``overflow_count`` = ok rows
    dropped for capacity.  Integer math on stable sorts, no host sync."""
    n = dest.shape[0]
    dev = dest.device
    d = torch.where(ok, dest.to(torch.int64),
                    torch.full((n,), n_shards, dtype=torch.int64,
                               device=dev))
    order = torch.sort(d, stable=True).indices
    ds = d[order]
    # rank within its destination run = sorted position - run start
    starts = torch.searchsorted(ds, torch.arange(n_shards + 1, device=dev))
    rank_sorted = torch.arange(n, device=dev) - starts[
        torch.clamp(ds, 0, n_shards)]
    rank = torch.empty((n,), dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    sent = ok & (rank < capacity)
    slot = torch.where(sent, d * capacity + rank,
                       torch.full_like(d, n_shards * capacity))
    overflow = torch.sum(ok & ~sent)
    return slot.to(torch.int32), sent, overflow


def bucket_fill_index(slot, size: int):
    """Inverse of a bucket slot assignment: ``inv[s]`` = the row filling
    buffer slot s, or ``n`` (the zero-pad row) for empty slots.  Sent rows
    occupy distinct slots, so one int32 scatter builds it (unsent rows all
    land in one extra slot, cut off)."""
    n = slot.shape[0]
    inv = torch.full((size + 1,), n, dtype=torch.int32, device=slot.device)
    inv.scatter_(0, slot.to(torch.int64),
                 torch.arange(n, dtype=torch.int32, device=slot.device))
    return inv[:size]


def scatter_to_buckets(cols: dict, slot, size: int, inv=None) -> dict:
    """Place rows into the flat (size,) send buffer at ``slot`` (unsent
    rows carry slot == size and are dropped); empty slots are zero.  One
    shared :func:`bucket_fill_index` and a gather per column from a
    zero-padded copy."""
    if inv is None:
        inv = bucket_fill_index(slot, size)
    idx = inv.to(torch.int64)
    out = {}
    for k, v in cols.items():
        pad = torch.cat([v, v.new_zeros((1,) + v.shape[1:])])
        out[k] = pad[idx]
    return out


def take_from_buckets(cols: dict, slot, sent) -> dict:
    """Inverse of :func:`scatter_to_buckets` for response routing: read
    each row's bucket slot back (zero / False for unsent rows)."""
    out = {}
    for k, v in cols.items():
        safe = v[torch.clamp(slot.to(torch.int64), 0, v.shape[0] - 1)]
        out[k] = torch.where(sent, safe, torch.zeros_like(safe))
    return out

# ------------------------------------------------- grouped aggregation UDAs
def group_atleastone(table: Table, ids, max_groups: int):
    """Per-group confidence 1 - prod(1-p) — the 'group confidence' query
    mode."""
    u = uda.AtLeastOne()
    st = uda.accumulate({"a": u}, table.masked_prob(), None, ids,
                        max_groups=max_groups)["a"]
    return u.finalize(st)


def group_normal_terms(table: Table, values, ids, max_groups: int):
    """Per-group (mean, var) of the probabilistic SUM (paper §V-C.3 Normal,
    with the variance erratum fixed: var = sum v^2 p (1-p))."""
    u = uda.SumNormal()
    st = uda.accumulate({"n": u}, table.masked_prob(), values, ids,
                        max_groups=max_groups)["n"]
    return u.finalize(st)


def group_cumulant_terms(table: Table, values, ids, max_groups: int,
                         orders: int = 8):
    """Per-group cumulant partial sums (G, orders) for the moment method."""
    st = uda.accumulate({"c": uda.SumCumulants(orders)}, table.masked_prob(),
                        values, ids, max_groups=max_groups)["c"]
    return st.terms


def group_logcf(table: Table, values, ids, max_groups: int, num_freq: int,
                block: int = 512):
    """Per-group summed log CF -> (G, F) log_abs and angle (exact SUM/COUNT
    per group), via the canonical loop of core/uda.py (the grouped CF
    kernel where the ``kernels/ops.py`` guards allow it)."""
    st = uda.accumulate({"cf": uda.SumCF(num_freq)}, table.masked_prob(),
                        values, ids, max_groups=max_groups, block=block)["cf"]
    return st.log_abs, st.angle


def group_logcf_finalize(la, an):
    """(G, F) log CF -> (G, F) coefficient rows via one batched FFT."""
    return uda.SumCF(la.shape[-1]).finalize(uda.CFState(la, an))


def minmax_runs(u: uda.MinMax, state: uda.MinMaxState) -> dict:
    """Flatten a grouped MinMax state into the per-run dict consumed by the
    query modes: (run_group, run_value, run_mass, run_valid) over the
    G*kappa buffer grid, plus per-group p_empty, the truncation p_tail and
    the §V-B.2 tail mass."""
    values, mass, p_tail = u.finalize(state)
    g, k = values.shape
    finite = torch.isfinite(values)
    return dict(run_group=torch.repeat_interleave(
                    torch.arange(g, device=values.device), k),
                run_value=values.reshape(-1),
                run_mass=torch.where(finite, mass, 0.0).reshape(-1),
                run_valid=finite.reshape(-1),
                p_empty=u.p_empty(state), p_tail=p_tail,
                tail_mass=u.tail_mass(state))


def group_minmax(table: Table, values, ids, max_groups: int,
                 sign: float = 1.0, kappa: int | None = None):
    """Grouped MIN (sign=+1) / MAX (sign=-1) masses via the MinMax UDA
    (paper §V-B.1):

        P(agg = v_j) = prod_{v_l better than v_j} Q_l * (1 - Q_j),
        Q_l = prod_{tuples at v_l} (1 - p).

    ``kappa`` bounds the per-group support kept (default: exact up to 128
    distinct values; overflow mass is reported in ``p_tail``, §V-B.2).
    Returns the flattened run dict of :func:`minmax_runs`."""
    if kappa is None:
        kappa = min(table.capacity, 128)
    u = uda.MinMax(kappa=kappa, sign=sign)
    st = uda.accumulate({"m": u}, table.masked_prob(), values, ids,
                        max_groups=max_groups)["m"]
    return minmax_runs(u, st)


# --------------------------------------------- scalar comparison epilogues
def normal_greater(mu, var, threshold):
    """P(N(mu, var) > threshold), vectorised over groups (§VII-D epilogue)."""
    sigma = torch.sqrt(torch.clamp(var, min=1e-30))
    z = (threshold - mu) / sigma
    return 0.5 * torch.special.erfc(z / math.sqrt(2.0))


def cf_greater(la, an, threshold):
    """Exact P(S > t) from per-group log CF rows (G, F)."""
    coeffs = group_logcf_finalize(la, an)
    idx = torch.arange(la.shape[-1], device=la.device)
    mask = idx[None, :] > torch.as_tensor(threshold,
                                          device=la.device)[:, None]
    return torch.sum(coeffs * mask, dim=-1)
