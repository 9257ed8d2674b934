"""Dry-run of the cells on the production meshes: trace one rank's step
of every (arch x shape x mesh) cell without a card, and record its memory,
FLOPs, bytes and collectives (the port of ``repro.launch.dryrun``).

Runs as its own process (it starts a process group of its own):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR

**How it traces.**  A fake process group (backend ``"fake"``,
``FakeStore``) of 256 or 512 ranks holds ``make_production_mesh``; rank
0's step runs on ``FakeTensorMode`` tensors, which carry shapes, dtypes
and devices and no data, so a step of nemotron_4_340b traces on a laptop.
The collectives return at once.  ``FakeTensorMode`` cannot run a CUDA
backward on a host without a card, so the fake tensors sit on the CPU and
``core.config.dry_run()`` makes them compute as tensors on the card
(``--device cuda``, the default: the card's code paths, e.g. the bf16
attention products with float32 out); ``--device cpu`` traces the CPU's
paths, which a real CPU run can be held to.  The kernel wrappers record
each launch with its bound's FLOPs and bytes instead of making it
(``kernels/build.py`` ``FAKE_COSTS``).

**What it records**, per cell and mesh, in one JSON each:

* memory a device: ``arguments`` (this rank's blocks of the parameters,
  optimizer state and cache, and the batch), ``outputs``, ``temp_peak``
  (the most bytes the step's own allocations held at once: live storages,
  :class:`LiveBytes`) and ``peak`` (arguments + temp_peak), beside the
  H100's 80 GB;
* ``flops``: ``torch.utils.flop_counter``'s count (its formulas, applied
  by :class:`LiveBytes`) plus each kernel's own (``kernel_flops``);
* ``bytes``: the sum of every operation's input and output bytes, plus
  each kernel's.  The port runs eagerly, one kernel an operation, so to
  first order this is its HBM traffic (no fusion keeps a value on chip);
* collectives: ``sharding.COLLECTIVE_BYTES`` by kind (the bytes this rank
  received), ``db.distributed.COLLECTIVE_COUNTS``, and every c10d
  operation's calls and operand bytes (its tensors that it does not
  write: what the reference's HLO parse counts);
* the roofline terms on H100 SXM constants (below) and the dominant one,
  and the model's FLOPs a device (6 N T / chips for a train step, 2 N T
  for a forward; N active for an MoE).

**Calibration.**  XLA counts a ``lax.scan`` body once, so the reference
lowers unrolled variants (``repro.models.runmode``) and extrapolates.
The port's periods and microbatches are Python loops: every iteration
runs and is counted, so ``runmode`` has no counterpart here.
:func:`calibrate` still fits the reference's linear model (1 and 2
periods at full widths; accumulation steps too) for use where a
full-depth trace is too slow; on the port it equals the full trace, and
peak memory always comes from the full-depth trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# --- H100 SXM constants (per card) -------------------------------------
PEAK_FLOPS = 989e12          # bf16 dense
HBM_BW = 3.35e12             # bytes/s
NET_BW = 50e9                # bytes/s a card leaving its 8-GPU node (one
#                              400 Gb/s NDR port a GPU)
NVLINK_BW = 450e9            # bytes/s a direction inside the node (noted)
HBM_BYTES = 80e9             # device memory


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes(TorchDispatchMode):
    """The storages that operations make inside the mode: ``live`` bytes
    now, their ``peak``; ``accessed``, the bytes every operation reads and
    writes (its tensor inputs and outputs; views and collectives
    excluded); ``flops``, FlopCounterMode's count (its formulas,
    :func:`op_flops`); ``collectives``, {c10d op: [calls, operand bytes]}
    (the tensors it reads and does not write; an in-place one's own).  A
    storage first seen as an operation's input (made before the mode) is
    never counted, nor is a tensor on ``meta`` (a ``ShardedModel``'s
    working model: code without storage).

    FlopCounterMode itself is not used: its module tracker hooks the
    recomputation of ``torch.utils.checkpoint``, which then keeps every
    segment's saved tensors to the end of the backward (remat's memory is
    lost: a yi_6b layer's 13.7 GB at 2 x 4096 tokens)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self.flops = 0
        self.collectives: dict = {}
        self._seen: dict = {}

    def _note(self, t: torch.Tensor, count: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes() if count else 0

        def freed(_, key=key, n=n):
            self.live -= n
            self._seen.pop(key, None)
        self._seen[key] = weakref.ref(st, freed)
        if n:
            self.live += n
            self.peak = max(self.peak, self.live)

    def _operands(self, func, args, kwargs) -> int:
        read, written = 0, 0
        for a, v in zip(func._schema.arguments, args):
            n = sum(_nbytes(t) for t in tree_leaves(v)
                    if isinstance(t, torch.Tensor))
            if a.alias_info is not None and a.alias_info.is_write:
                written += n
            else:
                read += n
        return read or written

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor) and not t.is_meta]
        for t in ins:
            self._note(t, False)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and not t.is_meta]
        if not ins and not outs:
            return out
        if func.namespace == "c10d":
            rec = self.collectives.setdefault(func.__name__, [0, 0])
            rec[0] += 1
            rec[1] += self._operands(func, args, kwargs)
        elif not func.is_view:
            self.accessed += sum(_nbytes(t) for t in ins + outs)
            self.flops += op_flops(func, args, kwargs, out)
        for t in outs:
            self._note(t, True)
        return out


def op_flops(func, args, kwargs, out) -> int:
    """FLOPs of one operation by ``torch.utils.flop_counter``'s formulas
    (0 for an operation it has none for); ``aten.bmm.dtype`` (the
    attention's float32-out product, whose third argument the stock bmm
    formula would take for the output shape) as 2 b m k n."""
    from torch.utils import flop_counter as fc
    packet = func.overloadpacket
    if packet is torch.ops.aten.bmm:
        b, m, k = args[0].shape
        return 2 * b * m * k * args[1].shape[2]
    formula = fc.flop_registry.get(packet)
    if formula is None:
        return 0
    return int(formula(*args, **kwargs, out_val=out))


# ------------------------------------------------------------- the world
def init_world(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0 (any earlier default group is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: tuple, names: tuple | None = None):
    """A mesh of ``shape`` over a fake world of its size (CPU device)."""
    from . import mesh as M
    init_world(math.prod(shape))
    names = names or (("pod", "data", "model") if len(shape) == 3
                      else ("data", "model"))
    return M.make_mesh(shape, names, backend="fake", device="cpu")


# ------------------------------------------------------------- a trace
def _size(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def trace(cell, device: str = "cuda") -> dict:
    """One run of ``cell.fn`` on rank 0 of the current (fake) world under
    ``FakeTensorMode``, on fake tensors of its stand-ins: the
    measurements of the module docstring, without the roofline."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .. import sharding
    from ..core import config
    from ..db import distributed as dist
    from ..kernels import build, ops
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    sharding.reset_collective_bytes()
    dist.reset_collective_counts()
    build.reset_fake_costs()
    ops.reset_launches()
    with mode, config.dry_run(card=device == "cuda"):
        args = cell.materialize("cpu")
        arg_bytes = _size(args)
        t0 = time.perf_counter()
        with LiveBytes() as live:
            out = cell.fn(**args)
        seconds = time.perf_counter() - t0
        out_bytes = _size(out)
    kernels = {k: dict(v) for k, v in build.FAKE_COSTS.items()}
    return dict(
        cell=cell.name, trace_seconds=seconds,
        memory=dict(arguments=arg_bytes, outputs=out_bytes,
                    temp_peak=live.peak, peak=arg_bytes + live.peak,
                    device_bytes=HBM_BYTES),
        flops_counted=live.flops,
        kernel_flops=sum(v["flops"] for v in kernels.values()),
        bytes_ops=live.accessed,
        kernel_bytes=sum(v["bytes"] for v in kernels.values()),
        kernels=kernels, launches=ops.launches(),
        collectives=dict(
            bytes=dict(sharding.COLLECTIVE_BYTES),
            counts=dict(dist.COLLECTIVE_COUNTS),
            ops={k: dict(calls=v[0], operand_bytes=v[1])
                 for k, v in live.collectives.items()},
            operand_bytes=sum(v[1] for v in live.collectives.values())))


def costs(result: dict) -> dict:
    """The cost vector of a trace: flops, bytes, collective operand bytes
    and, as ``recv/<kind>``, the bytes received by kind."""
    return dict(flops=result["flops_counted"] + result["kernel_flops"],
                bytes=result["bytes_ops"] + result["kernel_bytes"],
                coll=result["collectives"]["operand_bytes"],
                **{f"recv/{k}": v for k, v in
                   result["collectives"]["bytes"].items()})


def roofline_terms(cost: dict, chips: int) -> dict:
    t_compute = cost["flops"] / PEAK_FLOPS
    t_memory = cost["bytes"] / HBM_BW
    t_collective = cost["coll"] / NET_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return dict(t_compute=t_compute, t_memory=t_memory,
                t_collective=t_collective,
                t_collective_nvlink=cost["coll"] / NVLINK_BW,
                dominant=dominant, flops=cost["flops"], bytes=cost["bytes"],
                collective_bytes=cost["coll"], chips=chips)


def model_flops(cfg, shape_name: str, batch: int | None = None) -> float:
    """6 N T (train) or 2 N T (a forward), N active, T the step's global
    tokens (a decode step: one a row)."""
    from ..configs import base as cfgs
    spec = cfgs.SHAPES[shape_name]
    b = batch or spec["global_batch"]
    t = b * (1 if spec["kind"] == "decode" else spec["seq_len"])
    return (6 if spec["kind"] == "train" else 2) \
        * cfg.active_param_count() * t


# ------------------------------------------------------------ calibration
def _affine(one_trip, two_trips, extra: float) -> dict:
    """cost(1 trip) + extra * per-trip slope, component-wise (clamped at
    the one-trip floor: slope noise must not extrapolate below reality)."""
    return {n: max(one_trip.get(n, 0) + extra * (two_trips.get(n, 0)
                                                  - one_trip.get(n, 0)), 0.0)
            for n in sorted(set(one_trip) | set(two_trips))}


def _cell_costs(build, device) -> dict:
    return costs(trace(build(), device))


def calibrate(arch: str, shape: str, mesh, *, cfg=None, batch=None,
              seq=None, n_tuples=None, reduced: bool = False,
              device: str = "cuda") -> dict:
    """The per-device cost vector from traces of 1 and 2 periods at full
    widths (and, for a train step, 1 and 2 accumulation steps), on the
    reference's linear model cost = outside + trips * body (+ the accum
    axis); the pgf cell from 1 and 2 blocks of its loop a data rank.  The
    port's accum=1 step keeps its gradients in the parameters' dtype and
    skips the accumulators, so where the knob's accum exceeds 2 the
    accumulation points are 2 and 4."""
    from ..configs import base as cfgs
    from . import cells as C
    if arch == "pgf_tpch":
        from ..configs import pgf_tpch
        qc = pgf_tpch.reduced() if reduced else pgf_tpch.CONFIG
        shards = math.prod(mesh.shape[a] for a in ("pod", "data")
                           if a in mesh.axis_names)
        block = 8192                     # uda.accumulate's blocked loop
        u1 = _cell_costs(lambda: C.build_pgf_cell(
            mesh, reduced=reduced, n_tuples=shards * block), device)
        u2 = _cell_costs(lambda: C.build_pgf_cell(
            mesh, reduced=reduced, n_tuples=2 * shards * block), device)
        return _affine(u1, u2, (n_tuples or qc.n_tuples)
                       / (shards * block) - 1.0)

    cfg = cfg or cfgs.get_config(arch)
    base_pat, trips = C.calibration_pattern(cfg)
    a = C.arch_knobs(cfgs.get_config(arch))["accum"]
    train = cfgs.SHAPES[shape]["kind"] == "train"
    a0, a1 = (1, 2) if a <= 2 else (2, 4)

    def mk(k):
        return dataclasses.replace(
            cfg, n_layers=k * len(base_pat) + len(cfg.tail_pattern),
            pattern=base_pat)

    def at(k, acc):
        return _cell_costs(lambda: C.build_lm_cell(
            arch, shape, mesh, cfg=mk(k), accum=acc if train else None,
            batch=batch, seq=seq), device)
    if not train:
        return _affine(at(1, None), at(2, None), trips - 1.0)
    u11, u12 = at(1, a0), at(2, a0)
    corrected = _affine(u11, u12, trips - 1.0)
    if a != a0:
        u21, u22 = at(1, a1), at(2, a1)
        steps = (a - a0) / (a1 - a0)
        for k in corrected:
            d1 = u21.get(k, 0) - u11.get(k, 0)
            d2 = (u22.get(k, 0) - u12.get(k, 0)) - d1
            corrected[k] += steps * d1 + steps * (trips - 1) * d2
    return corrected


# ---------------------------------------------------------------- a cell
def _mesh_tag(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def run_cell(arch: str, shape: str, mesh, *, device: str = "cuda",
             batch: int | None = None, accum: int | None = None,
             layers: int | None = None, seq: int | None = None,
             n_tuples: int | None = None, reduced: bool = False,
             full: bool = True) -> dict:
    """Trace one cell on ``mesh`` (in the current fake world) and add its
    roofline; ``reduced`` takes the arch's reduced config, ``layers``
    cuts its depth (phase 12's configuration), ``batch``, ``seq``,
    ``accum``, ``n_tuples`` as the cell builders take them.  Without
    ``full``, :func:`calibrate`'s costs replace the full-depth trace (no
    memory; the roofline from the calibration)."""
    from ..configs import base as cfgs
    from . import cells as C
    chips = math.prod(mesh.shape.values())
    t0 = time.perf_counter()
    cfg = None
    if arch == "pgf_tpch":
        cell = C.build_pgf_cell(mesh, reduced=reduced, n_tuples=n_tuples)
    else:
        cfg = lm_config(arch, reduced, layers)
        cell = C.build_lm_cell(arch, shape, mesh, cfg=cfg, accum=accum,
                               batch=batch, seq=seq)
    if full:
        result = trace(cell, device)
    else:
        result = dict(cell=cell.name, memory=None, launches={})
    result.update(mesh=_mesh_tag(mesh), chips=chips, device=device,
                  settings=dict(batch=batch, accum=accum, layers=layers,
                                seq=seq, n_tuples=n_tuples, reduced=reduced))
    if full:
        result["roofline"] = roofline_terms(costs(result), chips)
    else:
        corr = calibrate(arch, shape, mesh, cfg=cfg, batch=batch, seq=seq,
                         n_tuples=n_tuples, reduced=reduced, device=device)
        result["calibrated"] = corr
        result["roofline"] = roofline_terms(corr, chips)
        result["collectives"] = dict(bytes={
            k[5:]: v for k, v in corr.items() if k.startswith("recv/")})
    if cfg is not None and not seq:
        result["model_flops_per_device"] = model_flops(cfg, shape,
                                                       batch) / chips
    result["seconds"] = time.perf_counter() - t0
    return result


def lm_config(arch: str, reduced: bool = False, layers: int | None = None):
    """The arch's config (reduced, cut to ``layers``)."""
    from ..configs import base as cfgs
    cfg = cfgs.get_reduced(arch) if reduced else cfgs.get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def summary(res: dict) -> str:
    """One line of a cell's result."""
    m, r = res["memory"], res["roofline"]
    coll = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                     sorted(res["collectives"]["bytes"].items())) or "none"
    model = res.get("model_flops_per_device")
    mem = (f"peak {m['peak'] / 1e9:.2f} GB/device of "
           f"{m['device_bytes'] / 1e9:.0f} (args {m['arguments'] / 1e9:.2f}"
           f", temp {m['temp_peak'] / 1e9:.2f})") if m else \
        "calibrated from 1 and 2 periods (no full-depth trace: no peak)"
    return (f"{mem}; flops {r['flops']:.4e}"
            + (f" (6NT or 2NT/chips {model:.4e})" if model else "")
            + f"; bytes {r['bytes']:.4e}; received GB by kind: {coll}; "
            f"collective operands {r['collective_bytes'] / 1e9:.3f} GB; "
            f"t_c {r['t_compute']:.3e}s t_m {r['t_memory']:.3e}s t_x "
            f"{r['t_collective']:.3e}s dom {r['dominant']}; launches "
            + str({k: v for k, v in res["launches"].items() if v}))


def table(directory) -> str:
    """The markdown table of a directory of artifacts (``--out``): a row a
    cell, and for each mesh the peak a device (GB, against 80), the
    dominant roofline term with its seconds, the FLOPs over the model's
    (6 N T or 2 N T over the chips), and the bytes a device received
    through the model axis's exchanges (``tp``, GB)."""
    import glob
    rows: dict = {}
    meshes: list = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            res = json.load(f)
        if res["mesh"] not in meshes:
            meshes.append(res["mesh"])
        if "error" in res:
            rows.setdefault(res["cell"], {})[res["mesh"]] = \
                "failed | - | - | -"
            continue
        r = res["roofline"]
        model = res.get("model_flops_per_device")
        ratio = f"{r['flops'] / model:.2f}x" if model else "-"
        peak = f"{res['memory']['peak'] / 1e9:.1f}" if res["memory"] \
            else "not traced"
        tp = res["collectives"]["bytes"].get("tp", 0) / 1e9
        rows.setdefault(res["cell"], {})[res["mesh"]] = (
            f"{peak} | {r['dominant']} "
            f"{r['t_' + r['dominant']]:.3g} s | {ratio} | {tp:.3g}")
    meshes.sort(key=len)
    head = "| cell | " + " | ".join(
        f"{m}: peak GB | dominant | FLOPs / model's | tp GB"
        for m in meshes) + " |"
    out = [head, "|---" * (1 + 4 * len(meshes)) + "|"]
    from .cells import all_cells
    order = {f"{a}/{s}": i for i, (a, s) in enumerate(all_cells())}
    for cell in sorted(rows, key=lambda c: order.get(c, len(order))):
        out.append(f"| {cell} | " + " | ".join(
            rows[cell].get(m, "- | - | - | -") for m in meshes) + " |")
    return "\n".join(out)


def _shape_arg(s: str) -> tuple:
    return tuple(int(x) for x in s.split("x"))


_MESHES: dict = {}


def _task(task: tuple) -> tuple:
    """One (mesh shape, arch, shape, settings, out dir) of :func:`main`:
    (tag, ok, line).  Each process keeps one fake world (and mesh) a
    mesh shape."""
    shape, arch, cell_shape, kw, out = task
    if shape not in _MESHES:
        _MESHES.clear()
        _MESHES[shape] = make_mesh(shape)
    mesh = _MESHES[shape]
    tag = f"{arch}/{cell_shape}@{_mesh_tag(mesh)}"
    try:
        res = run_cell(arch, cell_shape, mesh, **kw)
        ok, line = True, f"OK ({res['seconds']:.1f} s) {summary(res)}"
    except Exception as e:
        res = dict(cell=f"{arch}/{cell_shape}", mesh=_mesh_tag(mesh),
                   error=str(e), traceback=traceback.format_exc())
        ok, line = False, f"FAIL: {type(e).__name__}: {e}"
    if out:
        os.makedirs(out, exist_ok=True)
        fname = f"{arch}_{cell_shape}_{_mesh_tag(mesh)}.json"
        with open(os.path.join(out, fname), "w") as f:
            json.dump(res, f, indent=1, default=str)
    return tag, ok, line


def _weight(task: tuple) -> float:
    """A task's rough trace time (its layers x microbatches), for putting
    the longest first."""
    _, arch, cell_shape, kw, _ = task
    if arch == "pgf_tpch":
        return 50.0
    from ..configs import base as cfgs
    from . import cells as C
    cfg = cfgs.get_config(arch)
    n = kw.get("layers") or cfg.n_layers
    if cfgs.SHAPES[cell_shape]["kind"] == "train":
        n *= 3 * (kw.get("accum") or C.arch_knobs(cfg)["accum"])
    return float(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch/shape list")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (or PODxDATAxMODEL) in place of the "
                    "production meshes")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--n-tuples", type=int, default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs")
    ap.add_argument("--calibrate-only", default="",
                    help="comma-separated arch/shape cells given the "
                    "calibration's costs alone (no full-depth trace)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes tracing cells side by side")
    ap.add_argument("--out", default=None, help="artifact directory")
    ap.add_argument("--table", default=None, metavar="DIR",
                    help="print the markdown table of DIR's artifacts")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.table))
        return 0

    from . import cells as C
    if args.all:
        todo = C.all_cells()
    elif args.cells:
        todo = [tuple(c.split("/")) for c in args.cells.split(",")]
    else:
        todo = [(args.arch, args.shape or "query")]
    if args.mesh:
        meshes = [_shape_arg(args.mesh)]
    elif args.both_meshes or args.all:
        meshes = [(16, 16), (2, 16, 16)]
    else:
        meshes = [(2, 16, 16) if args.multi_pod else (16, 16)]
    kw = dict(device=args.device, batch=args.batch, accum=args.accum,
              layers=args.layers, seq=args.seq, n_tuples=args.n_tuples,
              reduced=args.reduced)
    only = set(filter(None, args.calibrate_only.split(",")))
    tasks = [(shape, arch, cell_shape,
              dict(kw, full=f"{arch}/{cell_shape}" not in only), args.out)
             for shape in meshes for arch, cell_shape in todo]
    failures = 0
    t0 = time.perf_counter()
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        tasks.sort(key=_weight, reverse=True)
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=mp.get_context("spawn"),
                max_tasks_per_child=None) as pool:
            results = pool.map(_task, tasks)
            for tag, ok, line in results:
                failures += not ok
                print(f"[dryrun] {tag} {line}", flush=True)
    else:
        for task in tasks:
            tag, ok, line = _task(task)
            failures += not ok
            print(f"[dryrun] {tag} {line}", flush=True)
    print(f"[dryrun] {len(tasks)} cells, {failures} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
