"""Grouped segment-UDA subsystem (port of ``repro.core.uda``): the one
implementation of every probabilistic aggregate on the slice's path, as
Glade's Initialize / Accumulate / Merge / Finalize (paper §VI-A):

    init(max_groups, dtype, device) -> state, tensors leading with (G, ...)
    update(state, p, v, g)          -> state   (one tuple block)
    merge(a, b)                     -> state   (elementwise add)
    finalize(state)                 -> per-group results

Registered here: ``AtLeastOne`` (P(group non-empty)), ``SumNormal``
((mean, variance) terms), ``SumCumulants`` (sum v^j kappa_j(p)),
``SumCF`` (exact SUM/COUNT log characteristic function) and ``MinMax``
(top-kappa (value, survival) lists for MIN / MAX).

:func:`accumulate` is the canonical loop: MinMax consumes the whole
column at once; eligible CF / cumulant accumulations go to the kernels of
:mod:`repro_torch.kernels` under the dispatch guards of ``kernels/ops.py``
(on a CUDA tensor the CUDA kernel, on a CPU tensor its plain version), and
every other UDA runs a blocked Python loop over tuple blocks with the JAX
package's block sizing.
:func:`accumulate_chunked` folds per-canonical-chunk states in the one
fixed :func:`tree_fold` tree.  Every reduction runs in a fixed order, so a
chunk's state is the same bits on every run.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .approx import MAX_ORDER, _bernoulli_cumulant_polys
from .config import default_float, resolve_device

# The canonical tiling constants: rows of a block of the canonical loop
# (BLOCK), whose working set is bounded to ~2^23 elements so the (block, F)
# phase tile stays bounded regardless of distribution width; the floor of
# 64 keeps even num_freq ~ 2^20 tiles within budget.
BLOCK = 8192
_BLOCK_FLOOR = 64
_ELEM_BUDGET = 1 << 23
_INT32_MIN = torch.iinfo(torch.int32).min
_INT32_MAX = torch.iinfo(torch.int32).max


def _tiny(dtype) -> float:
    """Log-underflow guard."""
    return 1e-30 if dtype == torch.float32 else 1e-300


def _index_add(acc, ids, data):
    """acc with data's rows added at ids (a new tensor), in a fixed order
    on every device: ``index_add`` runs under PyTorch's deterministic mode
    (its CUDA float kernel otherwise adds with atomics in run-dependent
    order)."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return acc.index_add(0, ids, data)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def segment_sum(data, ids, num_segments: int):
    """Rows of ``data`` summed per segment id, deterministically."""
    return _index_add(torch.zeros((num_segments,) + tuple(data.shape[1:]),
                                  dtype=data.dtype, device=data.device),
                      ids, data)


def _scatter_add(acc, g, contrib):
    """acc[g] += contrib with the G == 1 (scalar) fast path."""
    if acc.shape[0] == 1:
        return acc + torch.sum(contrib, dim=0, keepdim=True)
    return _index_add(acc, g, contrib)


def _merge_fields(a, b):
    return type(a)(*(x + y for x, y in zip(a, b)))


def masked_probs(probs, mask):
    """A masked-out tuple is exactly a p = 0 tuple for every UDA."""
    if mask is None:
        return probs
    return torch.where(mask, probs, torch.zeros_like(probs))


# ======================================================================
# protocol
# ======================================================================
class UDA:
    """Base grouped UDA: additive merge, per-row working-set width 1."""

    #: streaming UDAs accumulate block by block in the canonical loop;
    #: non-streaming ones (MinMax) consume the full column at once.
    streaming: bool = True
    #: additive states merge by elementwise addition (a psum across
    #: ranks); MinMax is not additive and gather-folds instead.
    additive: bool = True
    #: a scalar UDA ignores group ids and keeps one global group (the
    #: exact global CF of ``db.distributed.make_query_step``).
    scalar: bool = False

    def init(self, max_groups: int, dtype=None, device="cuda"):
        raise NotImplementedError

    def update(self, state, probs, values, gids):
        """Fold one block of (already masked) tuples into the state."""
        raise NotImplementedError

    def accumulate_full(self, state, probs, values, gids, max_groups):
        """Whole-column accumulate (non-streaming UDAs, and the kernels'
        route for the cumulant and CF UDAs)."""
        raise NotImplementedError

    def merge(self, a, b):
        return _merge_fields(a, b)

    def reduce_data(self, state, ax):
        """Merge across the tuple-sharding ranks ``ax`` (a
        :class:`~repro_torch.launch.mesh.MeshAxis`, None for none): one
        psum per field.  A float all_reduce adds in the backend's order,
        so this is held to tolerance; the plan executor's bit-equal merges
        are in :mod:`repro_torch.db.distributed`."""
        if ax is None:
            return state
        from ..db import distributed as dist
        return dist.map_state(lambda x: dist.psum(x, ax), state)

    def reduce_model(self, state, ax):
        """Reconcile model-axis replicas (tuples are replicated there):
        their mean."""
        from ..db import distributed as dist
        return dist.map_state(lambda x: dist.psum(x, ax) / ax.size, state)

    def finalize(self, state):
        raise NotImplementedError

    def row_budget(self) -> int:
        return 1


# ======================================================================
# AtLeastOne — group confidence (§VI row V)
# ======================================================================
class AtLeastOneState(NamedTuple):
    log_none: torch.Tensor       # (G,) sum log(1-p) over accumulated tuples


class AtLeastOne(UDA):
    """P(at least one tuple present) per group: 1 - prod(1 - p)."""

    def init(self, max_groups, dtype=None, device="cuda"):
        return AtLeastOneState(torch.zeros(
            (max_groups,), dtype=dtype or default_float(),
            device=resolve_device(device)))

    def update(self, state, probs, values, gids):
        return AtLeastOneState(
            _scatter_add(state.log_none, gids, torch.log1p(-probs)))

    def finalize(self, state):
        return 1.0 - torch.exp(state.log_none)


# ======================================================================
# SumNormal — (mean, variance) terms (§V-C.3, with the variance erratum fix)
# ======================================================================
class NormalState(NamedTuple):
    terms: torch.Tensor          # (G, 2) = (sum v p, sum v^2 p (1-p))


class SumNormal(UDA):
    def init(self, max_groups, dtype=None, device="cuda"):
        return NormalState(torch.zeros(
            (max_groups, 2), dtype=dtype or default_float(),
            device=resolve_device(device)))

    def update(self, state, probs, values, gids):
        mu_t = values * probs
        var_t = values * values * probs * (1.0 - probs)
        return NormalState(_scatter_add(state.terms, gids,
                                        torch.stack([mu_t, var_t], dim=-1)))

    def finalize(self, state):
        return state.terms[:, 0], state.terms[:, 1]


# ======================================================================
# SumCumulants — moment terms for the Lindsay gamma mixture (§V-C.3)
# ======================================================================
class CumulantState(NamedTuple):
    terms: torch.Tensor          # (G, orders) partial cumulant sums


class SumCumulants(UDA):
    """s_j[g] = sum_{i in g} v_i^j kappa_j(p_i), j = 1..orders."""

    def __init__(self, orders: int = 8):
        if not 1 <= orders <= MAX_ORDER:
            raise ValueError(f"orders must be in [1, {MAX_ORDER}]")
        self.orders = int(orders)

    def init(self, max_groups, dtype=None, device="cuda"):
        return CumulantState(torch.zeros(
            (max_groups, self.orders), dtype=dtype or default_float(),
            device=resolve_device(device)))

    def update(self, state, probs, values, gids):
        dtype, dev = probs.dtype, probs.device
        table = torch.as_tensor(
            np.asarray(_bernoulli_cumulant_polys()[1:self.orders + 1,
                                                   :self.orders + 1]),
            dtype=dtype, device=dev)
        powers = probs[None, :] ** torch.arange(
            self.orders + 1, dtype=dtype, device=dev)[:, None]
        kappas = table @ powers                         # (orders, B)
        vpow = values[None, :] ** torch.arange(
            1, self.orders + 1, dtype=dtype, device=dev)[:, None]
        return CumulantState(_scatter_add(state.terms, gids,
                                          (kappas * vpow).T))

    def accumulate_full(self, state, probs, values, gids, max_groups,
                        operands=None):
        """Whole-column accumulate through the scalar (max_groups == 1) or
        grouped cumulant kernel."""
        from ..kernels import cumulants, group_cumulants
        if max_groups == 1:
            sums = cumulants.cumulant_sums(probs, values, orders=self.orders)
            return CumulantState(state.terms + sums[None])
        if gids is None:
            gids = torch.zeros(probs.shape, dtype=torch.int64,
                               device=probs.device)
        sums = group_cumulants.group_cumulant_sums(
            probs, values, gids, num_groups=max_groups, orders=self.orders,
            operands=operands)
        return CumulantState(state.terms + sums)

    def finalize(self, state):
        return state.terms

    def row_budget(self) -> int:
        return self.orders + 1


# ======================================================================
# SumCF — exact SUM/COUNT via the log characteristic function (§V-A/C)
# ======================================================================
class CFState(NamedTuple):
    log_abs: torch.Tensor        # (G, F_loc)
    angle: torch.Tensor          # (G, F_loc)


class SumCF(UDA):
    """log Q(w^k) = sum_i log((1-p_i) + p_i w^{k v_i}), w = e^{2 pi i / N}.

    ``num_freq`` (= max_sum + 1) is the static distribution capacity;
    ``freq_cnt`` frequencies starting at ``freq_lo`` are accumulated (the
    planner's frequency slabs).  ``half``: the window lies in the k <= N/2
    columns that the scalar logcf kernel computes before it mirrors (a
    model rank's share of a one-group pass; the planner gathers the half
    and mirrors it)."""

    def __init__(self, num_freq: int, freq_lo: int = 0,
                 freq_cnt: int | None = None, half: bool = False):
        self.num_freq = int(num_freq)
        self.freq_lo = int(freq_lo)
        self.freq_cnt = (int(freq_cnt) if freq_cnt is not None
                         else self.num_freq)
        self.half = bool(half)

    def init(self, max_groups, dtype=None, device="cuda"):
        shape = (max_groups, self.freq_cnt)
        dtype = dtype or default_float()
        device = resolve_device(device)
        return CFState(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))

    def accumulate_full(self, state, probs, values, gids, max_groups,
                        operands=None):
        """Whole-column accumulate through the scalar or grouped CF kernel;
        requires integer-valued ``values``."""
        from ..kernels import group_cf, pb_cf
        if max_groups == 1 and self.half:
            la, an = pb_cf.logcf(probs, values, num_freq=self.num_freq,
                                 freq_lo=self.freq_lo,
                                 freq_cnt=self.freq_cnt)
            return CFState(state.log_abs + la[None], state.angle + an[None])
        if max_groups == 1 and self.freq_lo == 0 \
                and self.freq_cnt == self.num_freq:
            la, an = pb_cf.logcf(probs, values, num_freq=self.num_freq)
            return CFState(state.log_abs + la[None], state.angle + an[None])
        if gids is None:
            gids = torch.zeros(probs.shape, dtype=torch.int64,
                               device=probs.device)
        la, an = group_cf.group_logcf(probs, values, gids,
                                      num_groups=max_groups,
                                      num_freq=self.num_freq,
                                      freq_lo=self.freq_lo,
                                      freq_cnt=self.freq_cnt,
                                      operands=operands)
        return CFState(state.log_abs + la, state.angle + an)

    def update(self, state, probs, values, gids):
        dtype = probs.dtype
        k = self.freq_lo + torch.arange(self.freq_cnt, dtype=dtype,
                                        device=probs.device)
        # (B, F_loc) phase tile; mod num_freq keeps theta exact at large k*v.
        phase = torch.remainder(values[:, None] * k[None, :], self.num_freq)
        theta = (2.0 * math.pi / self.num_freq) * phase
        q = 1.0 - probs[:, None]
        re = q + probs[:, None] * torch.cos(theta)
        im = probs[:, None] * torch.sin(theta)
        la = 0.5 * torch.log(torch.clamp(re * re + im * im, min=_tiny(dtype)))
        an = torch.atan2(im, re)
        return CFState(_scatter_add(state.log_abs, gids, la),
                       _scatter_add(state.angle, gids, an))

    def reduce_model(self, state, ax):
        """The model ranks' frequency windows, gathered along the last
        axis in rank order (each column is computed on its own, so the
        full-width state is the unsplit one bit for bit)."""
        from ..db import distributed as dist
        return CFState(dist.all_gather_last(state.log_abs, ax),
                       dist.all_gather_last(state.angle, ax))

    def finalize(self, state):
        """(G, F) summed log CF -> (G, F) coefficient rows, one batched FFT."""
        mag = torch.exp(state.log_abs)
        q = torch.complex(mag * torch.cos(state.angle),
                          mag * torch.sin(state.angle))
        coeffs = torch.fft.fft(q, dim=-1).real / state.log_abs.shape[-1]
        return torch.clamp(coeffs, min=0.0)

    def row_budget(self) -> int:
        return self.freq_cnt


def CountCF(capacity: int) -> SumCF:
    """COUNT = SUM of T_COUNT-translated all-ones values (§IV-F step 1)."""
    return SumCF(capacity + 1)


# ======================================================================
# MinMax — grouped top-kappa (value, survival) lists (§V-B, §VII-C)
# ======================================================================
class MinMaxState(NamedTuple):
    values: torch.Tensor         # (G, kappa) sign-folded, sorted, pad +inf
    log_none: torch.Tensor       # (G, kappa) sum log(1-p) of tuples at value
    tail_log_none: torch.Tensor  # (G,) log prod(1-p) over *evicted* values
    total_log_none: torch.Tensor  # (G,) log prod(1-p) over all tuples seen


def _kept_log_none(state: MinMaxState):
    """log_none of the kept (finite) values, 0 at the +inf padding."""
    return torch.where(torch.isfinite(state.values), state.log_none, 0.0)


class MinMax(UDA):
    """The paper's ordered (value, AtLeastOne) list with capacity kappa, as
    fixed-shape (G, kappa) buffers: a sorted top-kappa buffer per group,
    merged by a bitonic network + run folding.  ``sign`` = +1 for MIN
    (keep smallest), -1 for MAX (values stored negated so the merge logic
    is shared).  Not additive: partial states fold with :meth:`merge`."""

    streaming = False
    additive = False

    def __init__(self, kappa: int = 64, sign: float = 1.0):
        self.kappa = int(kappa)
        self.sign = float(sign)

    def init(self, max_groups, dtype=None, device="cuda"):
        dtype = dtype or default_float()
        device = resolve_device(device)
        return MinMaxState(
            torch.full((max_groups, self.kappa), math.inf, dtype=dtype,
                       device=device),
            torch.zeros((max_groups, self.kappa), dtype=dtype, device=device),
            torch.zeros((max_groups,), dtype=dtype, device=device),
            torch.zeros((max_groups,), dtype=dtype, device=device))

    def accumulate_full(self, state, probs, values, gids, max_groups):
        """``state=None`` means "fresh init" (the canonical loop's hint):
        the constructed chunk buffer is returned directly."""
        dtype = probs.dtype if state is None else state.values.dtype
        dev = probs.device
        p = probs.to(dtype)
        v = values.to(dtype) * self.sign
        v = torch.where(p > 0, v, math.inf)    # masked / p=0 never matter
        logq = torch.log1p(-p)
        n = p.shape[0]
        gids = gids.to(torch.int64)
        # Rows ordered by (group, folded value): a stable sort by value,
        # then a stable sort by group — the permutation of the JAX
        # package's stable two-key sort.
        order = torch.sort(v, stable=True).indices
        order = order[torch.sort(gids[order], stable=True).indices]
        gs, vs, lqs = gids[order], v[order], logq[order]

        # Fold duplicate (group, value) runs.
        head = torch.ones((n,), dtype=torch.bool, device=dev)
        head[1:] = (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1])
        seg = torch.cumsum(head, 0) - 1
        run_idx = torch.arange(n, device=dev)
        exists = run_idx < seg[-1] + 1
        run_lq = segment_sum(lqs, seg, n)
        # Segment min / max; empty segments keep the JAX package's values
        # (+inf for the min, the int32 minimum, then clipped, for the max).
        run_v = torch.full((n,), math.inf, dtype=dtype, device=dev) \
            .scatter_reduce(0, seg, vs, "amin", include_self=False)
        run_g = torch.full((n,), _INT32_MIN, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, seg, gs, "amax", include_self=False)
        run_g = torch.where(exists, torch.clamp(run_g, 0, max_groups - 1),
                            max_groups - 1)

        # Rank of each run within its group = run index - group's first run.
        grp_first = torch.full((max_groups,), _INT32_MAX, dtype=torch.int64,
                               device=dev).scatter_reduce(
            0, run_g, torch.where(exists, run_idx, n), "amin",
            include_self=False)
        rank = run_idx - grp_first[run_g]

        finite = torch.isfinite(run_v)
        keep = exists & finite & (rank < self.kappa)
        chunk_v = torch.full((max_groups, self.kappa), math.inf, dtype=dtype,
                             device=dev)
        chunk_v[run_g[keep], rank[keep]] = run_v[keep]
        # Kept (group, rank) slots are distinct, so a masked put is the
        # JAX package's scatter-add onto zeros.
        chunk_lq = torch.zeros((max_groups, self.kappa), dtype=dtype,
                               device=dev)
        chunk_lq[run_g[keep], rank[keep]] = run_lq[keep]
        evicted = exists & finite & (rank >= self.kappa)
        chunk_tail = segment_sum(torch.where(evicted, run_lq, 0.0), run_g,
                                 max_groups)
        chunk_total = segment_sum(logq, gids, max_groups)
        chunk = MinMaxState(chunk_v, chunk_lq, chunk_tail, chunk_total)
        # merge(init, x) == x bitwise, so a fresh state needs no merge.
        return chunk if state is None else self.merge(state, chunk)

    def merge(self, a: MinMaxState, b: MinMaxState) -> MinMaxState:
        """Bitonic two-way merge + run fold + top-k truncation: both inputs
        keep their rows sorted (the state invariant), so ascending(a) ++
        descending(b) is bitonic and log2(2k) compare-exchange stages
        finish the merge.  A value present in both inputs lands in two
        adjacent slots; the run fold collapses each equal-value run into
        its head slot (log_none sums) BEFORE the top-k truncation, so
        duplicates never compete for the kappa capacity."""
        k = self.kappa
        pw = 1 << (k - 1).bit_length()       # bitonic needs a 2^m half
        v = torch.cat([F.pad(a.values, (0, pw - k), value=math.inf),
                       torch.flip(F.pad(b.values, (0, pw - k),
                                        value=math.inf), (1,))], dim=1)
        lq = torch.cat([F.pad(a.log_none, (0, pw - k)),
                        torch.flip(F.pad(b.log_none, (0, pw - k)), (1,))],
                       dim=1)
        g = v.shape[0]
        s = pw
        while s >= 1:
            vr = v.reshape(g, -1, 2, s)
            lr = lq.reshape(g, -1, 2, s)
            swap = vr[:, :, 0] > vr[:, :, 1]
            v = torch.stack([torch.where(swap, vr[:, :, 1], vr[:, :, 0]),
                             torch.where(swap, vr[:, :, 0], vr[:, :, 1])],
                            dim=2).reshape(g, -1)
            lq = torch.stack([torch.where(swap, lr[:, :, 1], lr[:, :, 0]),
                              torch.where(swap, lr[:, :, 0], lr[:, :, 1])],
                             dim=2).reshape(g, -1)
            s //= 2
        # Run fold: both inputs hold DISTINCT values, so an equal-value run
        # spans at most two slots and its log_none total is one pairwise
        # add; heads then compact to their run index with a batched binary
        # search + gather.  (Empty +inf slots form one trailing run with
        # log_none 0, so any fold of it is exact.)
        w = v.shape[1]
        finite = torch.isfinite(v)
        dup = torch.zeros_like(finite)
        dup[:, 1:] = v[:, 1:] == v[:, :-1]
        head = ~dup
        absorb = torch.zeros_like(dup)
        absorb[:, :-1] = dup[:, 1:]
        lq_next = torch.zeros_like(lq)
        lq_next[:, :-1] = lq[:, 1:]
        tot = lq + torch.where(absorb, lq_next, 0.0)
        run = torch.cumsum(head, dim=1) - 1          # run index per slot
        evicted = torch.where(head & finite & (run >= k), tot, 0.0)
        # Branchless batched lower_bound over the k kept output slots:
        # src[g, j] = head slot of run j (first position with run >= j).
        idx = torch.arange(k, device=v.device)
        pos = torch.full((g, k), -1, dtype=torch.int64, device=v.device)
        step = w
        while step > 1:
            step //= 2
            cand = torch.clamp(pos + step, max=w - 1)
            less = torch.gather(run, 1, cand) < idx[None, :]
            pos = torch.where(less, cand, pos)
        src = torch.clamp(pos + 1, 0, w - 1)         # head slot of run j
        ok = idx[None, :] <= run[:, -1:]             # run j exists
        v = torch.where(ok, torch.gather(v, 1, src), math.inf)
        lq = torch.where(ok, torch.gather(tot, 1, src), 0.0)
        return MinMaxState(v, lq,
                           a.tail_log_none + b.tail_log_none + evicted.sum(1),
                           a.total_log_none + b.total_log_none)

    def reduce_data(self, state: MinMaxState, ax) -> MinMaxState:
        """Gather every rank's state and fold them with :meth:`merge` in
        rank order (exact for a state held wholly by one rank:
        ``merge(init, x)`` is x bit for bit)."""
        if ax is None:
            return state
        from ..db import distributed as dist
        parts = dist._stack_gather([state], ax)
        out = parts[0]
        for part in parts[1:]:
            out = self.merge(out, part)
        return out

    def reduce_model(self, state: MinMaxState, ax) -> MinMaxState:
        return state        # tuples are replicated over the model axis

    def finalize(self, state: MinMaxState):
        """P(agg = v_j) = prod_{v_l better} Q_l * (1 - Q_j)  (§V-B.1), with
        Q_l = prod over tuples at value v_l of (1 - p).  Returns per-group
        (values, masses, p_tail): values un-folded (true MAX values for
        sign = -1); p_tail = P(aggregate beyond the kept support) — evicted
        values or the empty world."""
        finite = torch.isfinite(state.values)
        lq = _kept_log_none(state)
        prefix = torch.zeros_like(lq)
        prefix[:, 1:] = torch.cumsum(lq, dim=1)[:, :-1]
        mass = torch.exp(prefix) * (1.0 - torch.exp(lq)) * finite
        p_tail = torch.exp(torch.sum(lq, dim=1))
        return state.values * self.sign, mass, p_tail

    def p_empty(self, state: MinMaxState):
        """Exact P(aggregate undefined) = prod over all tuples of (1-p)."""
        return torch.exp(state.total_log_none)

    def tail_mass(self, state: MinMaxState):
        """Per-group §V-B.2 truncation mass: the probability that the exact
        aggregate lies STRICTLY beyond the kept kappa-support,

            prod_kept Q_j * (1 - prod_evicted (1-p)),

        exactly 0 when kappa covered every distinct value."""
        kept = torch.sum(_kept_log_none(state), dim=1)
        return torch.exp(kept) * -torch.expm1(state.tail_log_none)


# ======================================================================
# registry
# ======================================================================
REGISTRY = {
    "atleastone": AtLeastOne,
    "normal": SumNormal,
    "cumulants": SumCumulants,
    "cf": SumCF,
    "count_cf": CountCF,
    "min": lambda **kw: MinMax(sign=1.0, **kw),
    "max": lambda **kw: MinMax(sign=-1.0, **kw),
}


def make(name: str, **kwargs) -> UDA:
    return REGISTRY[name](**kwargs)


# ======================================================================
# the canonical accumulation loop
# ======================================================================
def _block_size(udas, block: int, n: int) -> int:
    budget = max([1] + [u.row_budget() for u in udas.values()])
    bsz = max(_BLOCK_FLOOR, min(block, _ELEM_BUDGET // max(1, budget)))
    # Never pad past the column: a short column runs as one right-sized
    # block; the floor keeps bsz positive for empty columns.
    return min(bsz, max(_BLOCK_FLOOR, -(-n // _BLOCK_FLOOR) * _BLOCK_FLOOR))


def _integral(t) -> bool:
    """Does this source column carry exact integers (CF-kernel-eligible)?"""
    return not (t.is_floating_point() or t.is_complex())


def _kernel_eligible(u: UDA, probs, values_integral: bool) -> bool:
    """CF / cumulant accumulations go to the kernels under the guards of
    kernels/ops.py alone (f32, enough tuples; for CF integer values and a
    frequency grid within the exact phase) — on any device."""
    from ..kernels import ops as kops
    if isinstance(u, SumCF):
        return kops.cf_eligible(probs, u.num_freq, values_integral)
    return isinstance(u, SumCumulants) and kops.cumulant_eligible(probs)


def logcf_runs(num_freq: int, chunk_probs, values) -> bool:
    """Does a one-group SumCF over chunks like ``chunk_probs`` with these
    values run the logcf kernel (or, on the CPU, its plain version)?"""
    return _kernel_eligible(SumCF(num_freq), chunk_probs,
                            values is None or _integral(values))


def _pad(x, pad: int, value=0):
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,), value)])


def accumulate(udas, probs, values=None, gids=None, *, max_groups: int = 1,
               states=None, block: int = BLOCK, cf_operands=None):
    """Accumulate every UDA in ``udas`` ({name: UDA}) over one column of
    tuples.

    probs:   (n,) tuple probabilities, already masked (invalid rows p = 0).
    values:  (n,) tensor shared by all UDAs, or {name: (n,) tensor}; None
             means all-ones (COUNT).
    gids:    (n,) int group ids in [0, max_groups); None = all group 0.
    states:  optional prior states to continue from (default: init).
    cf_operands: optional {name: operands} pre-sorted grouped-CF kernel
             columns (see :func:`cf_chunk_operands`).

    Returns {name: state}.
    """
    dtype, dev = probs.dtype, probs.device
    n = probs.shape[0]
    gids_full = (torch.zeros((n,), dtype=torch.int64, device=dev)
                 if gids is None else gids)
    if not isinstance(values, dict):
        values = {name: values for name in udas}
    # One cast per distinct source column (keyed on the caller's object);
    # the pre-cast source rides along for the CF kernels, which take
    # integer columns directly.
    ones = None
    casts: dict = {}
    val_arrays, val_index, val_integral, val_sources = [], {}, [], []
    for name in udas:
        v = values.get(name)
        if v is None:
            if ones is None:
                ones = torch.ones((n,), dtype=dtype, device=dev)
            v = src = ones
            integral = True        # COUNT: all-ones
        else:
            if id(v) not in casts:
                casts[id(v)] = (v.to(dtype), _integral(v), v)
            v, integral, src = casts[id(v)]
        for i, existing in enumerate(val_arrays):
            if existing is v:
                val_index[name] = i
                break
        else:
            val_index[name] = len(val_arrays)
            val_arrays.append(v)
            val_integral.append(integral)
            val_sources.append(src)

    states = dict(states or {})
    fresh = {name for name in udas if name not in states}
    for name in fresh:
        # A fresh non-streaming state stays unmaterialised: accumulate_full
        # receives None and skips the no-op merge with the init buffer.
        if udas[name].streaming:
            states[name] = udas[name].init(
                1 if udas[name].scalar else max_groups, dtype, dev)

    scan_udas = {}
    for name, u in udas.items():
        i = val_index[name]
        if not u.streaming:
            states[name] = u.accumulate_full(
                None if name in fresh else states[name], probs,
                val_arrays[i], gids_full, max_groups)
        elif _kernel_eligible(u, probs, val_integral[i]):
            # CF kernels take the pre-cast (integer) source; the cumulant
            # kernels compute float value powers and take the cast column.
            vals = val_sources[i] if isinstance(u, SumCF) else val_arrays[i]
            states[name] = u.accumulate_full(
                states[name], probs, vals,
                None if max_groups == 1 or u.scalar else gids_full,
                1 if u.scalar else max_groups,
                operands=cf_operands.get(name) if cf_operands else None)
        else:
            scan_udas[name] = u
    if not scan_udas:
        return states

    bsz = _block_size(scan_udas, block, n)
    pad = -(-n // bsz) * bsz - n
    p = _pad(probs, pad).view(-1, bsz)           # p = 0: no contribution
    g = _pad(gids_full, pad, max_groups - 1).view(-1, bsz)
    vs = [_pad(v, pad).view(-1, bsz) for v in val_arrays]
    g0 = torch.zeros_like(g[0]) if any(
        u.scalar for u in scan_udas.values()) else None
    for b in range(p.shape[0]):
        for name, u in scan_udas.items():
            states[name] = u.update(states[name], p[b],
                                    vs[val_index[name]][b],
                                    g0 if u.scalar else g[b])
    return states


def merge(udas, a, b):
    """Merge two state dicts UDA-wise (any merge tree gives the same
    result up to rounding; :func:`tree_fold` fixes the tree)."""
    return {name: u.merge(a[name], b[name]) for name, u in udas.items()}


def tree_fold(u: UDA, parts):
    """Fold partial states with ``u.merge`` in the one canonical tree
    shape: a balanced pairwise tree over the largest power-of-two prefix,
    then a sequential left fold of the tail leaves.  The tree depends only
    on the leaf count."""
    parts = list(parts)
    if not parts:
        raise ValueError("tree_fold needs at least one partial state")
    base_len = 1 << (len(parts).bit_length() - 1)   # largest pow2 <= len
    base, tail = parts[:base_len], parts[base_len:]
    while len(base) > 1:
        base = [u.merge(base[i], base[i + 1])
                for i in range(0, len(base), 2)]
    out = base[0]
    for t in tail:
        out = u.merge(out, t)
    return out


def accumulate_chunk_states(udas, probs, values=None, gids=None, *,
                            max_groups: int = 1, num_chunks: int = 8,
                            block: int = BLOCK, cf_operands=None) -> list:
    """Per-canonical-chunk partial states: the column is split into
    ``num_chunks`` contiguous equal chunks (zero-padded with p = 0 rows to
    a chunk multiple) and each chunk runs :func:`accumulate` alone.
    ``cf_operands``: optional {name: [per-chunk operands]}."""
    n = probs.shape[0]
    csz = -(-n // num_chunks)
    pad = csz * num_chunks - n
    probs = _pad(probs, pad)
    if gids is not None:
        gids = _pad(gids, pad, max_groups - 1)
    if not isinstance(values, dict):
        values = {name: values for name in udas}
    # Pad each distinct source column once so aggregates sharing a column
    # keep sharing it (accumulate dedups value columns by identity).
    cols: dict = {}
    cache: dict = {}
    for name in udas:
        v = values.get(name)
        if v is None:
            cols[name] = None
            continue
        if id(v) not in cache:
            cache[id(v)] = _pad(v, pad)
        cols[name] = cache[id(v)]
    parts = []
    for i in range(num_chunks):
        sl = slice(i * csz, (i + 1) * csz)
        ccache: dict = {}
        vals_i = {name: None if c is None else ccache.setdefault(id(c), c[sl])
                  for name, c in cols.items()}
        ops_i = ({name: per_chunk[i]
                  for name, per_chunk in cf_operands.items()}
                 if cf_operands else None)
        parts.append(accumulate(udas, probs[sl], vals_i,
                                None if gids is None else gids[sl],
                                max_groups=max_groups, block=block,
                                cf_operands=ops_i))
    return parts


class ChunkStateAccumulator:
    """Cross-wave chunk-state collection: the out-of-core entry point of
    the canonical chunk contract.

    The streamed executor (``db/plans.py``) computes per-canonical-chunk
    states one WAVE at a time (:func:`accumulate_chunk_states` over the
    wave's slab).  This accumulator files each wave's states under their
    global canonical chunk ids, drops padding slots (ids at or past
    ``num_chunks``: the wave schedule's tail, whose states are
    identities), and runs the ONE :func:`tree_fold` over exactly the
    ``num_chunks`` canonical leaves.  Each chunk's state depends on that
    chunk's rows alone and the fold tree on the leaf count alone, so the
    result is the same bits as :func:`accumulate_chunked` on the resident
    table, for any wave schedule.

    The fold advances as the chunks arrive in order (waves stream in chunk
    order): the pairwise tree over the largest power-of-two prefix is
    built as a stack of subtree roots, each merge taking the same two
    operands in the same order as :func:`tree_fold`, and the tail leaves
    fold into it one by one.  So a pass holds O(log num_chunks) chunk
    states between waves, not one per chunk."""

    def __init__(self, udas: dict, num_chunks: int):
        self.udas = udas
        self.num_chunks = num_chunks
        self._base = 1 << (num_chunks.bit_length() - 1)  # pow2 prefix
        self._pending: dict = {}     # filed, not yet folded: id -> states
        self._next = 0               # the next chunk id the fold takes
        self._stack: list = []       # (subtree height, states) of the base

    def _merge(self, a: dict, b: dict) -> dict:
        return {name: u.merge(a[name], b[name])
                for name, u in self.udas.items()}

    @property
    def filed(self) -> int:
        """Canonical chunks collected so far (folded or pending): a
        retried wave must bring only chunks not yet filed."""
        return self._next + len(self._pending)

    def add_wave(self, chunk_ids, parts: list) -> None:
        """File one wave's per-chunk state dicts under their global
        canonical chunk ids (parallel lists).  Waves partition the chunk
        slots, so filing a chunk twice is an error of the caller."""
        for g, st in zip(chunk_ids, parts):
            if g < self.num_chunks:
                if g < self._next or g in self._pending:
                    raise RuntimeError(f"canonical chunk {g} filed twice")
                self._pending[g] = st
        while self._next in self._pending:
            st = self._pending.pop(self._next)
            if self._next < self._base:
                height = 0
                while self._stack and self._stack[-1][0] == height:
                    st = self._merge(self._stack.pop()[1], st)
                    height += 1
                self._stack.append((height, st))
            else:                   # tail leaf: out = merge(out, leaf)
                self._stack[0] = (self._stack[0][0],
                                  self._merge(self._stack[0][1], st))
            self._next += 1

    def fold(self) -> dict:
        """The canonical fold over all collected chunks (after the last
        wave)."""
        if self._next < self.num_chunks:
            missing = [g for g in range(self._next, self.num_chunks)
                       if g not in self._pending]
            raise RuntimeError(f"canonical chunks never streamed: {missing}")
        return self._stack[0][1]


def accumulate_chunked(udas, probs, values=None, gids=None, *,
                       max_groups: int = 1, num_chunks: int = 8,
                       block: int = BLOCK, cf_operands=None):
    """Canonical chunk-grid Accumulate + :func:`tree_fold` Merge."""
    if num_chunks <= 1:
        ops_0 = ({name: per_chunk[0]
                  for name, per_chunk in cf_operands.items()}
                 if cf_operands else None)
        return accumulate(udas, probs, values, gids, max_groups=max_groups,
                          block=block, cf_operands=ops_0)
    parts = accumulate_chunk_states(udas, probs, values, gids,
                                    max_groups=max_groups,
                                    num_chunks=num_chunks, block=block,
                                    cf_operands=cf_operands)
    return {name: tree_fold(u, [p[name] for p in parts])
            for name, u in udas.items()}


def cf_chunk_operands(num_freq: int, probs, values, gids, *,
                      max_groups: int, num_chunks: int):
    """Pre-sorted per-chunk grouped-CF kernel operands for an exact-CF
    aggregation, or None when the kernel would not be dispatched.  The
    planner calls this once per aggregation pass and threads the result
    through every frequency slab, so the argsort and the group tables
    (with their one host sync per chunk) are built once."""
    from ..kernels import group_cf
    n = probs.shape[0]
    if n % num_chunks:
        return None            # planner columns divide the grid exactly
    csz = n // num_chunks
    if values is None:
        vals = torch.ones((n,), dtype=probs.dtype, device=probs.device)
        integral = True        # COUNT: all-ones
    else:
        vals = values
        integral = _integral(vals)
    if not _kernel_eligible(SumCF(num_freq), probs[:csz], integral):
        return None
    g = (torch.zeros((n,), dtype=torch.int64, device=probs.device)
         if gids is None else gids)
    return [group_cf.presort_operands(probs[i * csz:(i + 1) * csz],
                                      vals[i * csz:(i + 1) * csz],
                                      g[i * csz:(i + 1) * csz], num_freq,
                                      max_groups)
            for i in range(num_chunks)]


def reduce_collective(udas, states, data_ax, model_ax=None):
    """The distributed Merge: :meth:`UDA.reduce_data` over the
    tuple-sharding ranks, then :meth:`UDA.reduce_model` over the model
    ranks (MeshAxis handles, None to skip)."""
    out = {}
    for name, u in udas.items():
        st = u.reduce_data(states[name], data_ax)
        if model_ax is not None:
            st = u.reduce_model(st, model_ax)
        out[name] = st
    return out


def finalize(udas, states):
    return {name: u.finalize(states[name]) for name, u in udas.items()}
