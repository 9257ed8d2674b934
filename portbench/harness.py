"""One run of one cell: set-up, the measured window, the reference check,
the metrics.  ``run.py`` is the command; this module holds the run.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (its ``file``) and a traffic mix
(``portbench/traffic/<traffic>.json``); its per-layer metrics are readers
``portbench/metrics/<metric>.py`` and its correctness limits
``portbench/limits/<cell>.json``, all found by name.  What runs depends on
the configuration's ``execution.kind`` and the traffic's ``kind``:

* ``service`` + ``streams``: every query through ``QueryService.submit``
  (resident tables, the warm plan cache);
* ``streamed`` + ``streams``: each query family compiled and bound once in
  set-up (``compile_plan(..., device_row_budget=...)``) over pinned
  ``HostTable`` catalogue entries; the window calls the bindings;
* ``service`` + ``sweep``: ``QueryService(sweep_mode="vmap").sweep`` with
  a report.

The window starts after every family has run once, ends at the end of
the stream or sweep in flight once ``seconds`` have passed (a traced
run's once ``TRACE_SECONDS`` have), and each answer is timed from its
submission to its result with the card synchronised.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import torch

from . import compare, datagen, queries, results, roofline
from . import trace as T
from . import traffic as TR

#: top-level module names that may not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a traced run's window: reading the profiler's trace takes ~4-6 s a
#: second of traced work on the card, and a run has 360 s in all
TRACE_SECONDS = 12.0


class Manifest:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = self.root / "portbench" / "traffic" / f"{name}.json"
        return json.loads(path.read_text())

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"]
                if cell in m["workloads"]]

    def metric(self, name: str):
        path = self.root / "portbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_table(t: dict):
    from repro_torch.db.table import Table
    return Table(dict(t["columns"]), t["prob"], t["valid"])


def pinned(t: dict) -> dict:
    """A table's tensors copied once into pinned host memory."""
    def pin(x):
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x)
        return out
    return {"columns": {k: pin(v) for k, v in t["columns"].items()},
            "prob": pin(t["prob"]), "valid": pin(t["valid"])}


def on_device(tables: dict, dev) -> dict:
    return {n: {"columns": {k: v.to(dev) for k, v in t["columns"].items()},
                "prob": t["prob"].to(dev), "valid": t["valid"].to(dev)}
            for n, t in tables.items()}


class Service:
    """Queries and sweeps through one ``QueryService`` over resident
    tables."""

    def __init__(self, cfg, traffic, tables, dev):
        from repro_torch.db.serving import QueryService
        opts = {} if dev.type == "cuda" else {"device": "cpu"}
        mode = "vmap" if traffic["kind"] == "sweep" else "scan"
        self.cfg, self.dev = cfg, dev
        self.with_report = bool(traffic.get("with_report"))
        self.svc = QueryService(
            {n: program_table(t) for n, t in tables.items()},
            capacity=int(cfg["execution"].get("capacity", 16)),
            sweep_mode=mode, **opts)
        self.roots = {f: queries.FAMILIES[f].plan(cfg)
                      for f in TR.families(traffic)}

    def query(self, fam: str, subst: dict):
        f = queries.FAMILIES[fam]
        out, _ = self.svc.submit(self.roots[fam], f.params(subst),
                                 **f.opts(self.cfg))
        return f.post(out, self.cfg)

    def sweep(self, fam: str, points: list) -> tuple:
        """(result, per-point bool tensor: the report shows lost groups
        or a NaN state)."""
        batch = queries.sweep_batch(fam, points, self.dev)
        out, _ = self.svc.sweep(self.roots[fam], batch,
                                with_report=self.with_report)
        bad = torch.zeros((len(points),), dtype=torch.bool, device=self.dev)
        if self.with_report:
            out, rep = out
            for field in (rep.group_overflow, rep.state_nan,
                          rep.exchange_overflow):
                for v in field.values():
                    bad |= v.to(self.dev) > 0
        return out, bad


class Streamed:
    """Each family compiled and bound once over a catalogue whose
    ``host_tables`` are pinned HostTables; the window calls the bindings."""

    def __init__(self, cfg, traffic, tables, dev):
        from repro_torch.db.plans import compile_plan
        from repro_torch.db.table import HostTable
        ex = cfg["execution"]
        cat = {}
        for name, t in tables.items():
            if name in ex["host_tables"]:
                cat[name] = HostTable(
                    {k: v.numpy() for k, v in t["columns"].items()},
                    t["prob"].numpy(), t["valid"].numpy())
            else:
                cat[name] = program_table(t)
        self.cfg = cfg
        self.runners = {}
        for fam in TR.families(traffic):
            f = queries.FAMILIES[fam]
            fn = compile_plan(f.plan(cfg), device=dev,
                              device_row_budget=int(cfg["device_row_budget"]),
                              **{**ex["compile"], **f.opts(cfg)})
            self.runners[fam] = fn.bind(cat)

    def query(self, fam: str, subst: dict):
        f = queries.FAMILIES[fam]
        return f.post(self.runners[fam](f.params(subst)), self.cfg)


def host_tables(cfg: dict, tables: dict, dev) -> dict:
    """The configuration's host-resident tables moved to pinned memory
    (the device copies are freed)."""
    names = cfg["execution"].get("host_tables", ())
    if dev.type != "cuda":
        return tables
    out = dict(tables)
    for n in names:
        out[n] = pinned(tables[n])
    return out


class Window:
    """The measured window's counts."""

    def __init__(self):
        self.attempted = self.failed = self.done = 0
        self.latencies: list = []
        self.seconds = 0.0


def _annotate(on: bool, name: str):
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


def run_unit(driver, unit, kind: str, win: Window, keeper, dev,
             mark: bool, log) -> None:
    """Run one stream (each query in turn) or one sweep, timing each
    answer; an answer that raises, or (a sweep point) whose report shows
    lost groups or NaN states, counts as failed."""
    items = [unit] if kind == "sweep" else unit
    for fam, arg in items:
        n = len(arg) if kind == "sweep" else 1
        t0 = time.perf_counter()
        out, n_bad = None, n
        with _annotate(mark, T.QUERY + fam):
            try:
                if kind == "sweep":
                    out, bad = driver.sweep(fam, arg)
                    sync(dev)
                    n_bad = int(bad.sum())
                else:
                    out = driver.query(fam, arg)
                    sync(dev)
                    n_bad = 0
            except Exception:          # a failed answer counts; go on
                print(f"{fam} {arg} failed:\n" + traceback.format_exc(),
                      file=log)
        win.latencies.append(time.perf_counter() - t0)
        win.attempted += n
        win.failed += n_bad
        win.done += n - n_bad
        if out is not None:
            (keeper.keep_sweep if kind == "sweep" else keeper.keep)(
                fam, arg, out)


def p95(xs: list) -> float:
    """The 95th percentile of every value (linear between order
    statistics, as ``statistics.quantiles(method="inclusive")``)."""
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=20, method="inclusive")[18]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             *, device="cuda", t_start: float | None = None, log=None,
             config: dict | None = None, limits: dict | None = None):
    """Run one cell; returns (result dict, numbers compared).  ``config``
    and ``limits`` replace the manifest's (the CPU tests' small
    sizes)."""
    log = log or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest(root)
    cell = man.cell(workload)
    cfg = config or man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    kind = traffic["kind"]
    if trace:
        seconds = min(seconds, TRACE_SECONDS)

    # ------------------------------------------------------------ set-up
    tables = datagen.generate(cfg, seed, dev)
    tables = host_tables(cfg, tables, dev)
    driver = (Streamed if cfg["execution"]["kind"] == "streamed"
              else Service)(cfg, traffic, tables, dev)
    fams = TR.families(traffic)
    g = TR.rng(seed, TR.SAMPLE)
    size = int(traffic["compare"]["sample_groups"])
    keeper = results.Keeper({f: results.sample_slots(
        queries.FAMILIES[f].groups(cfg), size, g, dev) for f in fams})
    warm = Window()
    warm_units = TR.units(traffic, seed, TR.WARMUP)
    run_unit(driver, next(warm_units), kind, warm, results.Keeper(
        keeper.samples), dev, False, log)
    if warm.failed:
        raise RuntimeError("the warm-up failed: no result")
    metrics_pl = [(m, man.metric(m["name"])) for m in man.per_layer(workload)]
    targets = [mod.INSTRUMENT for _, mod in metrics_pl
               if getattr(mod, "INSTRUMENT", None)] if trace else []
    from repro_torch.db import plans
    gc.collect()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    plans.reset_stream_stats()

    # ------------------------------------------------------------ window
    win = Window()
    work = TR.units(traffic, seed, TR.WORK)
    holder = {"trace": None}
    instrument = roofline.Instrument(targets)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(T.capture(holder))
            stack.enter_context(instrument)
            stack.enter_context(torch.profiler.record_function(T.WINDOW))
        while True:
            run_unit(driver, next(work), kind, win, keeper, dev, trace, log)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        win.seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stream_stats = plans.stream_stats()
    calls = instrument.calls()

    # -------------------------------------------------- reference check
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_tables = on_device(tables, dev)
    chosen = TR.choose_compared(keeper.kept, traffic, seed)
    nums = compare.numbers(keeper.kept, chosen, ref_tables, cfg)
    lost = nums.pop("lost")
    if kind == "streams":
        win.failed += lost
        win.done -= lost
    lims = compare.load_limits(man.root, workload) if limits is None \
        else limits
    correct, checked = compare.checks(nums, lims)
    correct = correct and win.failed == 0

    # ---------------------------------------------------------- metrics
    e2e = {"setup_s": setup_s,
           "peak_device_gb": peak / 1e9,
           "queries_per_s": win.done / win.seconds,
           "points_per_s": win.done / win.seconds,
           "query_ms_p95": 1e3 * p95(win.latencies)}
    units = {m["name"]: m["unit"] for m in man.bench["end_to_end"]
             + man.bench["per_layer"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": win.attempted,
            "failed": win.failed}
    if not trace:
        # a metric split by cell kind (``queries_per_s.streamed``) reads
        # the quantity its name starts with
        line["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                                       "unit": m["unit"]}
                           for m in man.end_to_end(workload)}
    else:
        tr = holder["trace"]
        ctx = {"trace": tr, "calls": calls, "stream_stats": stream_stats,
               "window_s": win.seconds}
        line["metrics"] = {}
        for m, mod in metrics_pl:
            v = mod.read(ctx)
            if v is not None:
                line["metrics"][m["name"]] = {"value": v,
                                              "unit": units[m["name"]]}
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s()
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_by_query()}
    line["device"] = info
    line["checks"] = checked
    print(f"cell {workload} seed {seed}: {win.attempted} attempted, "
          f"{win.failed} failed, window {win.seconds:.3f} s, set-up "
          f"{setup_s:.3f} s, {len(chosen)} answers compared; card "
          f"{power_limit() if dev.type == 'cuda' else 'cpu'}", file=log)
    return line, nums


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
