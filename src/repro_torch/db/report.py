"""Structured run diagnostics (port of ``repro.db.report``): the
:class:`ExecutionReport` returned beside the result of every
``compile_plan(..., with_report=True)`` run.

Every detection signal of a run leaves it here, so callers (and the
escalating retry controller :func:`repro_torch.db.plans.run_plan`) can
diagnose a run instead of squinting at NaNs:

    exchange_overflow   per exchange leg: rows dropped for static bucket
                        capacity
    exchange_demand     per exchange leg: the observed peak per-(sender,
                        owner) send demand
    exchange_capacity   per exchange leg: the static bucket capacity
                        (the three exchange fields fill on mesh compiles,
                        whose exchanges record them, the same on every
                        rank)
    group_overflow      per aggregation pass: live rows whose group code
                        was dropped past ``max_groups``
    tail_mass           per MIN/MAX aggregate: the per-group §V-B.2
                        truncation mass, exactly 0 when ``kappa`` covers
                        every distinct value
    state_nan           per aggregate state: NaN count in the FOLDED UDA
                        state (MinMax +inf padding and the -inf of p = 1
                        tuples are not NaN and are not counted)
    waves               streamed runs: completed and total waves and
                        transfer-fault retries (host ints); the retry
                        controller adds ``attempts``

The values are tensors on the run's device (``waves`` holds host ints),
so collecting them adds no host sync to a run; :meth:`ExecutionReport.
issues` and the other readers copy every value to the host in one
transfer.

A parameter sweep with ``with_report=True`` returns one *stacked*
report (``points`` = N): every value gains a leading N axis, point j's
at index j (counts shaped (N,), ``tail_mass`` (N, groups)), as the
reference's stacked pytree does; ``final_params`` is not stacked and
stays empty.  The readers refuse a stacked report rather than reduce
over its points: :meth:`ExecutionReport.point` gives point j's report.
"""
from __future__ import annotations

import dataclasses

import torch

#: report fields (all dicts: label -> scalar or per-group tensor).
FIELDS = ("exchange_overflow", "exchange_demand", "exchange_capacity",
           "group_overflow", "tail_mass", "state_nan", "waves")
#: the fields read back as counts; tail_mass is read as its maximum.
_COUNTS = ("exchange_overflow", "exchange_demand", "exchange_capacity",
           "group_overflow", "state_nan")


@dataclasses.dataclass
class ExecutionReport:
    """Diagnostics of one run (see module docstring)."""
    exchange_overflow: dict = dataclasses.field(default_factory=dict)
    exchange_demand: dict = dataclasses.field(default_factory=dict)
    exchange_capacity: dict = dataclasses.field(default_factory=dict)
    group_overflow: dict = dataclasses.field(default_factory=dict)
    tail_mass: dict = dataclasses.field(default_factory=dict)
    state_nan: dict = dataclasses.field(default_factory=dict)
    waves: dict = dataclasses.field(default_factory=dict)
    #: set by the retry controller on the returned report: the compile
    #: overrides of the final attempt ({"shuffle_slack",
    #: "shuffle_bucket_floor", "stream_wave_chunks", "kappa_scale",
    #: "groups_scale"}).
    final_params: dict = dataclasses.field(default_factory=dict)
    #: a sweep's stacked report: the number of points (every value has a
    #: leading axis of that length); None for the report of one run
    points: int | None = None

    def point(self, j: int) -> "ExecutionReport":
        """Point j's report of a stacked sweep report (each value's index
        j), which the readers below take."""
        if self.points is None:
            raise ValueError("point() reads a stacked sweep report; this "
                             "is the report of one run")
        return ExecutionReport(**{f: {k: v[j] for k, v in
                                      getattr(self, f).items()}
                                  for f in FIELDS})

    def host_values(self) -> dict:
        """Every device value on the host, in one device->host copy:
        {field: {label: int}} for the counts and {"tail_mass": {label:
        max per-group mass as a float}}."""
        if self.points is not None:
            raise ValueError(
                f"a stacked sweep report holds {self.points} points' "
                "diagnostics; read one point's with report.point(j) "
                "instead of reducing over the points")
        keys, vals = [], []
        for f in _COUNTS + ("tail_mass",):
            for k, v in getattr(self, f).items():
                t = torch.as_tensor(v)
                if f == "tail_mass":
                    t = t.max() if t.numel() else t.new_zeros(())
                keys.append((f, k))
                vals.append(t.reshape(()).to(torch.float64))
        out = {f: {} for f in _COUNTS + ("tail_mass",)}
        if not vals:
            return out
        dev = next((v.device for v in vals if v.device.type != "cpu"),
                   torch.device("cpu"))
        host = torch.stack([v.to(dev) for v in vals]).tolist()
        for (f, k), x in zip(keys, host):
            out[f][k] = x if f == "tail_mass" else int(x)
        return out

    def issues(self, tail_tol: float = 0.0) -> dict:
        """Concrete problem summary: {} when the run is trustworthy.  Keys:

        * ``"overflow"``: {exchange leg: rows dropped} (> 0 only)
        * ``"group_overflow"``: {pass: live rows whose group was lost}
        * ``"tail"``: {aggregate: max per-group truncation mass}, only
          entries above ``tail_tol``
        * ``"nan"``: {state: NaN count}, reported only when no exchange
          overflowed (without one, the NaN came in with the data and no
          escalation can remove it)
        """
        h = self.host_values()
        out: dict = {}
        over = {k: v for k, v in h["exchange_overflow"].items() if v > 0}
        if over:
            out["overflow"] = over
        gover = {k: v for k, v in h["group_overflow"].items() if v > 0}
        if gover:
            out["group_overflow"] = gover
        tails = {k: t for k, t in h["tail_mass"].items() if t > tail_tol}
        if tails:
            out["tail"] = tails
        if not over:
            nans = {k: v for k, v in h["state_nan"].items() if v > 0}
            if nans:
                out["nan"] = nans
        return out

    def ok(self, tail_tol: float = 0.0) -> bool:
        return not self.issues(tail_tol)

    def overflow_total(self) -> int:
        return sum(self.host_values()["exchange_overflow"].values())

    def max_tail_mass(self) -> float:
        """Largest per-group §V-B.2 truncation mass over every MIN/MAX
        aggregate of the run (0.0 when none ran or none truncated)."""
        return max(self.host_values()["tail_mass"].values(), default=0.0)

    def describe(self, tail_tol: float = 0.0) -> str:
        iss = self.issues(tail_tol)
        if not iss:
            return "clean"
        return "; ".join(f"{k}: {v}" for k, v in sorted(iss.items()))


@dataclasses.dataclass
class ServingStats:
    """Per-request counters of one :class:`repro_torch.db.serving.
    QueryService` (host ints).

    ``cache_hits`` / ``cache_misses`` count whether a request's FIRST
    plan lookup was served from the plan cache; ``batched_points`` sums
    the parameter points of sweeps (each sweep is one request);
    ``retry_attempts`` counts escalation attempts beyond each request's
    first.
    """
    requests: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    batched_requests: int = 0
    batched_points: int = 0
    retry_attempts: int = 0

    def record(self, hit: bool, points: int = 1, attempts: int = 1) -> None:
        self.requests += 1
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if points > 1:
            self.batched_requests += 1
            self.batched_points += points
        self.retry_attempts += max(0, attempts - 1)

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / max(1, self.requests)

    def as_dict(self) -> dict:
        return dict(requests=self.requests, cache_hits=self.cache_hits,
                    cache_misses=self.cache_misses,
                    batched_requests=self.batched_requests,
                    batched_points=self.batched_points,
                    retry_attempts=self.retry_attempts,
                    hit_rate=round(self.hit_rate, 4))


def nan_count(state):
    """Total NaN count over the floating fields of a UDA state (a
    NamedTuple of tensors), as an int32 tensor on the state's device.  NaN,
    not non-finite, is the poison signal: MinMax pads values with +inf and
    AtLeastOne reaches log1p(-1) = -inf for p = 1 tuples."""
    leaves = [x for x in state if isinstance(x, torch.Tensor)]
    total = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    for leaf in leaves:
        if leaf.is_floating_point():
            total = total + torch.isnan(leaf).sum().to(torch.int32)
    return total


class ReportBuilder:
    """Collector behind one run: the executor calls the record methods as
    the plan executes and :meth:`build` returns the
    :class:`ExecutionReport`.  Labels come from per-kind counters in
    execution order, so a plan's report labels are the same on every run
    (and the same as the JAX package's)."""

    def __init__(self, points: int | None = None):
        self._counters: dict = {}
        self._points = points
        self._report = ExecutionReport(points=points)

    def _per_point(self, x, dtype=torch.int32):
        """A count of a batched sweep's run at every point: a 0-d count
        (a part of the plan the points share) repeated, an (N,) count
        kept."""
        x = torch.as_tensor(x).to(dtype)
        if self._points is None or x.dim() == 1:
            return x
        return x.expand(self._points).contiguous()

    def _next(self, kind: str) -> str:
        i = self._counters.get(kind, 0)
        self._counters[kind] = i + 1
        return f"{kind}[{i}]"

    # ------------------------------------------------------- exchanges
    def begin_exchange(self, kind: str) -> str:
        """Label one exchange operator (shuffle_join / copart_join /
        repartition); its legs record under ``label.leg``."""
        return self._next(kind)

    def exchange_leg(self, label: str, leg: str, overflow, demand,
                     capacity: int) -> None:
        key = f"{label}.{leg}"
        self._report.exchange_overflow[key] = self._per_point(overflow)
        self._report.exchange_demand[key] = self._per_point(demand)
        self._report.exchange_capacity[key] = self._per_point(
            torch.tensor(capacity))

    # ---------------------------------------------- aggregation passes
    def begin_agg(self, kind: str) -> str:
        return self._next(f"agg:{kind}")

    def group_overflow(self, label: str, count) -> None:
        self._report.group_overflow[label] = self._per_point(count)

    def tail(self, name: str, per_group, per_point: bool = False) -> None:
        """``per_group``: (groups,), or with ``per_point`` a batched
        sweep's (N, groups)."""
        if self._points is not None and not per_point:
            per_group = per_group.expand(
                (self._points,) + tuple(per_group.shape)).contiguous()
        self._report.tail_mass[name] = per_group

    def state_nan(self, name: str, count) -> None:
        self._report.state_nan[name] = self._per_point(count)

    # ------------------------------------------------------- streaming
    def set_waves(self, completed: int, total: int, retries: int) -> None:
        self._report.waves.update(completed=completed, total=total,
                                  retries=retries)

    # ------------------------------------------------- forked collection
    def fork(self) -> "ReportBuilder":
        """A child builder whose label counters CONTINUE from this one,
        for a plan part collected apart; :meth:`absorb` merges its report
        back."""
        child = ReportBuilder(self._points)
        child._counters = dict(self._counters)
        return child

    def absorb(self, report: ExecutionReport) -> None:
        """Merge a report produced by a forked builder."""
        for f in FIELDS:
            getattr(self._report, f).update(getattr(report, f))

    def build(self) -> ExecutionReport:
        return self._report
