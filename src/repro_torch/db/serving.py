"""The query-serving layer (port of ``repro.db.serving``): a bounded
structural plan cache and parameter sweeps over one catalogue -- the front
end that turns the engine from a script into a server.

A deployment answers many queries against one catalogue.  The JAX package
caches ``jax.jit`` executables, so a hit there skips the trace and the
compile.  The port compiles nothing, but its ``compile_plan`` closure does
host work on every call: it pads every table, lowers the plan (on a mesh
the exchange sizing reads the key columns' histograms back to the host)
and copies a HostTable, or a mesh rank's row block, to the device.  The
port's counterpart of the executable is therefore a *binding*
(``compiled.bind(tables)``): the plan lowered and placed once for the
service's catalogue, whose runner only executes.

:class:`PlanCache` keys entries structurally -- :func:`repro_torch.db.
plans.plan_key` (node structure, predicate bytecode, captured constants)
plus the mesh fingerprint plus every lowering option -- in a bounded LRU;
an entry holds its plan, its compiled function and its binding, and an
eviction drops the binding.  A hit runs the same binding, so hit results
are bit-identical to the cold run by construction.  A binding is valid
only for the table objects it was bound to (the lowering read their sizes
and key histograms): replacing a catalogue table re-binds, it never
serves a stale plan.  The device copies a binding makes are shared by the
entries of one service (:class:`repro_torch.db.plans.Placement`), so
sixteen entries over a HostTable catalogue hold one device copy of it.

:class:`QueryService` is the request loop: ``submit`` a logical plan
(optionally under a :class:`~repro_torch.db.plans.RetryPolicy`; the
service remembers each plan's converged ``final_params``, so a resubmit
starts at the healed point and hits the cache in one attempt), or
``sweep`` a parameterized family over N points.  Two batching modes, as
in the reference.  The default, ``sweep_mode="scan"``, runs every point
through the family's one binding with that point's scalars, in order, so
point i is bit-equal to a sequential submit at point i.  ``"vmap"`` runs
the points as one batched pass through the same binding
(:mod:`repro_torch.db.sweep`: the point is an extra group key, joined in
at the parameterized predicate), in launches of at most
``batch_row_budget`` batched rows (:func:`repro_torch.db.cost.
sweep_chunk_points`); its fold order differs, so it is held to the scan
sweep within a tolerance (the reference's vmap: ~1 ulp).
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from . import cost as C
from . import physical as phys
from . import sweep as S
from .plans import (LRUCache, Node, Placement, Scan, compile_plan,
                    mesh_fingerprint, plan_key, plan_params, run_plan)
from .report import FIELDS, ExecutionReport, ServingStats
from .table import Table


def cache_key(root: Node, mesh=None, opts: dict | None = None) -> tuple:
    """The plan cache's full key: plan structure + mesh identity + every
    lowering option (frozen structurally, so option values like a
    CostModel dataclass key by content).  The reference's ``jit``
    component has no counterpart: the port traces nothing."""
    frozen = tuple(sorted((k, phys.structural_key(v))
                          for k, v in (opts or {}).items()))
    return ("serve", plan_key(root), mesh_fingerprint(mesh), frozen)


def _scan_names(root: Node) -> tuple:
    """Base tables a logical plan reads (for sweep residency sizing)."""
    names: set = set()

    def walk(n):
        if isinstance(n, Scan):
            names.add(n.name)
        for f in ("child", "left", "right"):
            c = getattr(n, f, None)
            if isinstance(c, Node):
                walk(c)

    walk(root)
    return tuple(sorted(names))


def _same_tables(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(a[k] is b[k] for k in a)


class _Entry:
    """One cached plan: the plan itself (pinned, so any identity key
    inside its cache key stays unique while the entry lives), its compiled
    function, and the binding of that function to a catalogue (the runner
    and the table objects it was bound to)."""
    __slots__ = ("root", "fn", "placement", "runner", "bound",
                 "__weakref__")

    def __init__(self, root: Node, fn, placement: Placement):
        self.root = root
        self.fn = fn
        self.placement = placement
        self.runner = None
        self.bound = None

    def bind(self, tables: Dict[str, Table]):
        """The runner for ``tables``: the held binding when the catalogue
        holds the same table objects, else a new binding."""
        if self.bound is None or not _same_tables(self.bound, tables):
            self.drop()
            self.runner = self.fn.bind(tables, self.placement)
            self.bound = dict(tables)
        return self.runner

    def call(self, tables: Dict[str, Table], params: dict | None = None):
        return self.bind(tables)(params)

    def drop(self) -> None:
        self.runner = self.bound = None

    def drop_if_stale(self, tables: Dict[str, Table]) -> None:
        if self.bound is not None and not _same_tables(self.bound, tables):
            self.drop()


class PlanCache:
    """Bounded LRU of bound plans, keyed structurally.

    A hit returns the same entry, whose binding runs without lowering or
    copying -- results bit-identical to the cold run by construction.
    Evictions drop the evicted entry's binding, so the population of
    bindings stays bounded.  ``placement`` holds the device copies every
    entry's binding shares."""

    def __init__(self, capacity: int = 16):
        self._lru = LRUCache(capacity, on_evict=_Entry.drop)
        self.placement = Placement()

    def entry(self, root: Node, mesh=None, **opts) -> tuple:
        """-> (cache entry, was it a hit)."""
        key = cache_key(root, mesh, opts)
        e = self._lru.get(key)
        if e is not None:
            return e, True
        e = _Entry(root, compile_plan(root, mesh, **opts), self.placement)
        self._lru.put(key, e)
        return e, False

    def compile(self, root: Node, mesh=None, **opts):
        """:func:`repro_torch.db.plans.run_plan`-compatible compiler hook:
        ``(tables, params) -> result`` through the entry of THIS attempt's
        exact (plan, lowering params), bound to ``tables`` at its first
        call.  Each escalation attempt keys its own entry, so retries never
        poison or duplicate the base entry, and a later submit at the
        converged ``final_params`` hits the final attempt's entry."""
        return self.entry(root, mesh, **opts)[0].call

    @property
    def hits(self) -> int:
        return self._lru.hits

    @property
    def misses(self) -> int:
        return self._lru.misses

    def info(self) -> dict:
        return self._lru.info()

    def drop_stale(self, tables: Dict[str, Table]) -> None:
        """Drop every binding made for other table objects than
        ``tables``', so a replaced table and its copies are freed now,
        not when each entry is next submitted."""
        for e in self._lru.values():
            e.drop_if_stale(tables)

    def clear(self) -> None:
        self._lru.clear()
        self.placement.clear()


def _tree_join(trees: list, join=torch.stack):
    """Join equal-structured results (dicts, tuples, NamedTuples, Tables
    of tensors, ExecutionReports) leaf by leaf: stacked along a new
    leading axis, or with ``join=torch.cat`` concatenated along the
    leading one.  Reports join field by field into a stacked report (its
    ``points`` set); ``final_params`` is not a leaf, as in the reference's
    report pytree, and stays empty."""
    first = trees[0]
    if isinstance(first, ExecutionReport):
        points = len(trees) if join is torch.stack \
            else sum(t.points for t in trees)
        return ExecutionReport(**{f: _tree_join([getattr(t, f)
                                                 for t in trees], join)
                                  for f in FIELDS}, points=points)
    if isinstance(first, Table):
        return Table({k: join([t.columns[k] for t in trees])
                      for k in first.columns},
                     join([t.prob for t in trees]),
                     join([t.valid for t in trees]), first.part)
    if isinstance(first, dict):
        return {k: _tree_join([t[k] for t in trees], join) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_join(list(xs), join)
                             for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_join(list(xs), join) for xs in zip(*trees))
    return join(trees)


class QueryService:
    """The serving loop over one catalogue (name -> Table or HostTable)
    and one mesh (this rank's :class:`~repro_torch.launch.mesh.Mesh`, or
    None).

    ``capacity`` bounds the plan cache; ``policy`` is the default
    self-healing :class:`~repro_torch.db.plans.RetryPolicy` (None = no
    retry loop); ``sweep_mode`` is ``'scan'`` (bit-equal to sequential
    submits, the default) or ``'vmap'`` (one batched pass, held to scan
    within a tolerance; see the module docstring); ``batch_row_budget``
    caps a ``'vmap'`` sweep's batched rows, splitting it into launches
    (:func:`repro_torch.db.cost.sweep_chunk_points`; a scan sweep holds
    one point's rows at a time and ignores it).  Remaining keywords become
    default ``compile_plan`` options of every request (e.g.
    ``device="cpu"``).  Replacing a table in ``self.tables`` re-binds the
    plans that run next and frees the bindings made for the old table at
    the next request.
    """

    def __init__(self, tables: Dict[str, Table], mesh=None, *,
                 capacity: int = 16, policy=None,
                 batch_row_budget: int | None = None,
                 sweep_mode: str = "scan", **default_opts):
        if sweep_mode not in ("scan", "vmap"):
            raise ValueError(f"sweep_mode must be 'scan' or 'vmap', "
                             f"got {sweep_mode!r}")
        self.tables = tables
        self.mesh = mesh
        self.cache = PlanCache(capacity)
        self.policy = policy
        self.batch_row_budget = batch_row_budget
        self.sweep_mode = sweep_mode
        self.default_opts = default_opts
        self.stats = ServingStats()
        #: cache key -> (plan, remembered run_plan escalation overrides),
        #: so a resubmit of a healed plan starts AT its final_params.
        #: Bounded like the plan cache; the plan is pinned so that any
        #: identity component of its key stays unique while it lives.
        self._healed = LRUCache(capacity)

    def _merged(self, opts: dict) -> dict:
        return {**self.default_opts, **opts}

    # ------------------------------------------------------------ submit
    def submit(self, root: Node, params: dict | None = None, *,
               policy=None, **opts):
        """Run one query: ``-> (result, info)``.

        ``info`` holds ``hit`` (was the first plan lookup served from the
        cache), ``seconds`` (host clock; the device may still be running),
        ``attempts`` and -- when a retry policy ran -- the final
        :class:`~repro_torch.db.report.ExecutionReport` under ``report``.
        Hits are bit-identical to the cold run (the same binding);
        resubmits of a healed plan replay the remembered ``final_params``
        and hit the final attempt's entry in one clean attempt.
        """
        merged = self._merged(opts)
        policy = policy if policy is not None else self.policy
        t0 = time.perf_counter()
        h0 = self.cache.hits
        self.cache.drop_stale(self.tables)
        if policy is not None:
            key = cache_key(root, self.mesh, merged)
            healed = self._healed.get(key, (root, {}))[1]
            out, report = run_plan(root, self.tables, self.mesh,
                                   policy=policy, params=params,
                                   compiler=self.cache.compile,
                                   **{**merged, **healed})
            self._healed.put(key, (root, {
                k: v for k, v in report.final_params.items()
                if v is not None
                and not (k in ("kappa_scale", "groups_scale") and v == 1)}))
            attempts = int(report.waves.get("attempts", 1))
            hit = self.cache.hits > h0
            self.stats.record(hit=hit, attempts=attempts)
            return out, dict(hit=hit, attempts=attempts,
                             seconds=time.perf_counter() - t0,
                             report=report)
        entry, hit = self.cache.entry(root, self.mesh, **merged)
        out = entry.call(self.tables, params)
        self.stats.record(hit=hit)
        return out, dict(hit=hit, attempts=1,
                         seconds=time.perf_counter() - t0)

    # ------------------------------------------------------------- sweep
    def sweep(self, root: Node, param_batch: Dict[str, torch.Tensor],
              **opts):
        """Run a parameterized plan family over N parameter points:
        ``-> (batched result, info)``.

        ``param_batch`` maps each of the plan's :class:`~repro_torch.db.
        plans.Param` names to a length-N vector (taken as it is by
        ``torch.as_tensor``: its dtype and device are kept); the result
        gains a leading N axis on every leaf.  Under ``sweep_mode=
        "scan"`` point i runs the family's one binding with ``{name:
        batch[name][i]}`` -- the 0-d tensors a sequential ``submit`` of
        that point passes -- so it is bit-equal to that submit, for any N.
        Under ``"vmap"`` the points run through the same binding as
        batched passes of at most ``batch_row_budget`` rows
        (``info["chunk"]`` points each, ``info["launches"]`` of them),
        within a tolerance of the scan sweep (on a mesh, mesh=None's vmap
        bits, through any exchange the lowering picks, the co-partitioned
        pipeline included).  Parameters may sit on either side of a join
        (TPC-H Q3's SEGMENT on ``customer``, DATE on ``orders`` and
        ``lineitem``).  With ``with_report=True`` either mode returns
        ``(result, report)``: a stacked :class:`~repro_torch.db.report.
        ExecutionReport` whose every value gains the leading N axis too
        (``report.point(j)`` is point j's; a scan sweep's is bit-equal to
        the submit's report at that point, a vmap sweep's counts equal
        it).  Refused, as by the reference: a streamed plan
        (``device_row_budget``: ``NotImplementedError``) and, under
        ``"vmap"``, a :class:`~repro_torch.db.plans.Param` outside a
        Select predicate, a Map column or a ReweightGreater threshold
        (``ValueError`` naming the construct, :func:`repro_torch.db.sweep.
        check_plan`).  Every further sweep of the family, of any size, is
        a cache hit.  ``info`` holds ``hit``, ``points`` and ``seconds``.
        """
        merged = self._merged(opts)
        if merged.get("device_row_budget") is not None:
            raise NotImplementedError(
                "parameter sweeps keep the catalogue resident: a streamed "
                "plan (device_row_budget) would re-stream its table for "
                "every point; drop device_row_budget for swept families")
        if self.sweep_mode == "vmap":
            S.check_plan(root)
        names = sorted(plan_params(root))
        if not names:
            raise ValueError("sweep() needs a parameterized plan (no "
                             "Param holes found — use submit())")
        batch = {k: torch.as_tensor(v) for k, v in param_batch.items()}
        sizes = {k: v.shape[0] if v.dim() == 1 else -1
                 for k, v in batch.items()}
        if (sorted(batch) != names or len(set(sizes.values())) != 1
                or min(sizes.values()) < 1):
            raise ValueError(
                f"param_batch must map exactly {names} to equal-length "
                f"vectors, got "
                f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
        n = next(iter(sizes.values()))
        t0 = time.perf_counter()
        self.cache.drop_stale(self.tables)
        entry, hit = self.cache.entry(root, self.mesh, **merged)
        runner = entry.bind(self.tables)
        if self.sweep_mode == "scan":
            out = _tree_join([runner({k: v[i] for k, v in batch.items()})
                              for i in range(n)])
            self.stats.record(hit=hit, points=n)
            return out, dict(hit=hit, points=n,
                             seconds=time.perf_counter() - t0)
        chunk = C.sweep_chunk_points(self._per_point_rows(root),
                                     self.batch_row_budget, n)
        outs = [runner.sweep({k: v[lo:lo + chunk] for k, v in batch.items()})
                for lo in range(0, n, chunk)]
        out = outs[0] if len(outs) == 1 else _tree_join(outs, torch.cat)
        self.stats.record(hit=hit, points=n)
        return out, dict(hit=hit, points=n, chunk=chunk,
                         launches=len(outs),
                         seconds=time.perf_counter() - t0)

    def _per_point_rows(self, root: Node) -> float:
        """Residency one sweep point adds: the referenced base tables'
        column elements (the reference's measure; the point join carries
        only the columns the plan reads above it, so this overcounts)."""
        total = 0.0
        for name in _scan_names(root):
            t = self.tables.get(name)
            if t is not None:
                total += t.capacity * (len(t.columns) + 2)
        return total
