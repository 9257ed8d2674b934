"""The dry-run (``repro_torch.launch.dryrun``) against real runs, CPU.

* **Fake against real.**  One spawn of 4 gloo ranks runs reduced cells
  for real on a (2, 2) mesh -- yi_6b ``train_4k`` (accum 2), olmoe_1b_7b
  ``train_4k`` (accum 2: its experts over the model axis, routing over
  the data axes), yi_6b ``prefill_32k``, recurrentgemma_2b and yi_6b
  ``decode_32k``, each at ``BATCH`` rows of ``SEQ`` tokens, and the
  reduced ``pgf_tpch/query`` -- and records, on rank 0, the bytes
  received by kind (``sharding.COLLECTIVE_BYTES``), the FLOPs and the
  peak live bytes of the step (``LiveBytes``).  The dry-run of the same
  cells on a fake world of 4 (``--device cpu``: the CPU's code paths), in
  a subprocess, must equal all three exactly.  Each cell runs ``RUNS``
  times and the lowest peak counts: gloo's worker thread can hold a
  collective's input a moment after the call returns (2 of 2,000
  ``all_gather`` calls on an idle host, more on a loaded one), which the
  fake backend never does; the FLOPs and bytes of the runs are equal.
* **Calibration.**  ``calibrate`` (1 and 2 periods, accum 2 and 4) on a
  4-period reduced yi_6b, train and prefill, equals the full-depth
  trace's FLOPs, bytes and collective bytes exactly.
* **Kernels.**  Each kernel wrapper, given fake tensors inside the
  dry-run, records one launch with its bound's FLOPs and bytes (PERF.md
  section 6's formulas, written out here) at two shapes, and launches
  nothing; a fake tensor on the card outside the dry-run raises at the
  launch.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.testing.ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ = 8, 16
RUNS = 4
CELLS = [("yi_6b", "train_4k", 2), ("olmoe_1b_7b", "train_4k", 2),
         ("yi_6b", "prefill_32k", None), ("recurrentgemma_2b", "decode_32k",
                                          None),
         ("yi_6b", "decode_32k", None), ("pgf_tpch", "query", None)]


def _key(arch, shape):
    return f"{arch}/{shape}"


def _build(arch, shape, accum, mesh):
    from repro_torch.launch import cells as LC
    if arch == "pgf_tpch":
        return LC.build_pgf_cell(mesh, reduced=True)
    return LC.build_lm_cell(arch, shape, mesh, cfg=C.get_reduced(arch),
                            accum=accum, batch=BATCH, seq=SEQ)


def _fill(arch, mesh):
    """Seeded values for a cell's arguments on this rank: the blocks of
    a seeded model, zero optimizer state and cache, random tokens, the
    rank's rows of seeded tuple columns."""
    from repro_torch import sharding
    from repro_torch.models import api
    blocks = None
    if arch != "pgf_tpch":
        cfg = C.get_reduced(arch)
        model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        sm = sharding.ShardedModel(model, sharding.Rules(mesh))
        blocks = sm.params
    rng = np.random.default_rng(0)
    shards = mesh.shape["data"]
    r = mesh.coords["data"]

    def fill(path, t):
        with torch.no_grad():
            if path[0] == "params":
                t.copy_(blocks[path[1]])
            elif path[0] in ("tokens", "labels"):
                t.copy_(torch.from_numpy(rng.integers(
                    0, 50, tuple(t.shape)).astype(np.int64)))
            elif path[0] in ("probs", "values", "gids"):
                n = t.shape[0]
                full = {"probs": rng.random(n * shards),
                        "values": rng.integers(1, 8, n * shards),
                        "gids": rng.integers(0, 64, n * shards)}[path[0]]
                t.copy_(torch.from_numpy(full[r * n:(r + 1) * n]))
            else:
                t.zero_()
    return fill


def _rank():
    import torch.distributed as tdist
    from repro_torch import sharding
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), backend="gloo",
                     device="cpu")
    out = {}
    for arch, shape, accum in CELLS:
        cell = _build(arch, shape, accum, mesh)
        args = cell.materialize("cpu", fill=_fill(arch, mesh))
        runs = []
        for _ in range(RUNS):
            tdist.barrier()
            sharding.reset_collective_bytes()
            with LiveBytes() as live:
                cell.fn(**args)
            runs.append(dict(bytes=dict(sharding.COLLECTIVE_BYTES),
                             flops=live.flops, peak=live.peak))
        assert all(r["flops"] == runs[0]["flops"]
                   and r["bytes"] == runs[0]["bytes"] for r in runs)
        out[_key(arch, shape)] = dict(runs[0], peak=min(r["peak"]
                                                        for r in runs))
    return out


def _dry(args: list, out_dir) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *args, "--out", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return {p.name: json.loads(p.read_text())
            for p in pathlib.Path(out_dir).glob("*.json")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks and the dry-runs side by side."""
    from concurrent.futures import ThreadPoolExecutor
    base = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(run_ranks, _rank, 4, backend="gloo",
                            device="cpu", store_dir=base / "store",
                            timeout=300)
        # one dry-run process for every cell (--accum reaches only the
        # train cells, --batch / --seq only the LM cells)
        dry = _dry(["--reduced", "--mesh", "2x2", "--device", "cpu",
                    "--cells", ",".join(_key(a, s) for a, s, _ in CELLS),
                    "--accum", "2", "--batch", str(BATCH), "--seq",
                    str(SEQ)], base / "dry")
        real = ranks.result()
    return real, dry


def _dry_result(dry, arch, shape):
    return dry[f"{arch}_{shape}_2x2.json"]


@pytest.mark.parametrize("arch,shape,accum", CELLS)
def test_dryrun_equals_real_run(runs, arch, shape, accum):
    real, dry = runs
    got = _dry_result(dry, arch, shape)
    want = real[0][_key(arch, shape)]
    assert got["collectives"]["bytes"] == want["bytes"]
    assert got["flops_counted"] == want["flops"]
    assert got["memory"]["temp_peak"] == want["peak"]


def test_real_ranks_agree(runs):
    """Every rank of the real run moved the same bytes by kind."""
    real, _ = runs
    for r in real[1:]:
        for k in r:
            assert r[k]["bytes"] == real[0][k]["bytes"], k


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_calibrate_equals_full_trace(tmp_path, shape):
    script = f"""
import dataclasses, json
from repro_torch import configs as C
from repro_torch.launch import dryrun as D, cells as LC
mesh = D.make_mesh((2, 2))
cfg = dataclasses.replace(C.get_reduced("yi_6b"), n_layers=4)
full = D.costs(D.trace(LC.build_lm_cell("yi_6b", "{shape}", mesh, cfg=cfg,
                                        batch={BATCH}, seq={SEQ})))
cal = D.calibrate("yi_6b", "{shape}", mesh, cfg=cfg, batch={BATCH},
                  seq={SEQ})
print(json.dumps([full, cal]))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    full, cal = json.loads(run.stdout.strip().splitlines()[-1])
    assert full["flops"] > 0 and full["coll"] > 0
    assert cal == {k: float(v) for k, v in full.items()}


# ------------------------------------------------------------- kernels
def _fake_costs(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import config
    from repro_torch.kernels import build, ops
    build.reset_fake_costs()
    ops.reset_launches()
    with FakeTensorMode(), config.dry_run(card=True):
        fn()
    return {k: dict(v) for k, v in build.FAKE_COSTS.items()}, \
        {k: v for k, v in ops.launches().items() if v}


def _ops_cum(orders):
    return orders * orders + 4 * orders - 1


KERNEL_CASES = [
    # logcf: live pairs x computed frequencies x 11; n * 8 + 2 * 4 * out
    ("logcf", dict(n=1000, num_freq=256, cnt=None),
     1000 * 129 * 11, 1000 * 8 + 2 * 256 * 4),
    ("logcf", dict(n=5000, num_freq=4096, cnt=1024),
     5000 * 1024 * 11, 5000 * 8 + 2 * 1024 * 4),
    # group_logcf: n x window x 11; n * 12 + 2 * G * window * 4
    ("group_logcf", dict(n=3000, groups=7, num_freq=512, lo=64, cnt=128),
     3000 * 128 * 11, 3000 * 12 + 2 * 7 * 128 * 4),
    ("group_logcf", dict(n=800, groups=1, num_freq=64, lo=0, cnt=64),
     800 * 64 * 11, 800 * 12 + 2 * 64 * 4),
    # cumulant_sums: n (O^2 + 4 O - 1); n * 8 + O * 4
    ("cumulant_sums", dict(n=4096, orders=8),
     4096 * _ops_cum(8), 4096 * 8 + 8 * 4),
    ("cumulant_sums", dict(n=10000, orders=3),
     10000 * _ops_cum(3), 10000 * 8 + 3 * 4),
    # group_cumulant_sums, both routes: n (O^2 + 4 O - 1); n * 16 + G O 4
    ("group_cumulant_sums", dict(n=2048, groups=4, orders=8),
     2048 * _ops_cum(8), 2048 * 16 + 4 * 8 * 4),
    ("group_cumulant_sums", dict(n=5000, groups=300, orders=6),
     5000 * _ops_cum(6), 5000 * 16 + 300 * 6 * 4),
    # polymul: 2 na nb; 4 (2 na + 2 nb - 1)
    ("polymul", dict(na=300, nb=500), 2 * 300 * 500, 4 * (600 + 1000 - 1)),
    ("polymul", dict(na=4000, nb=129), 2 * 4000 * 129,
     4 * (8000 + 258 - 1)),
]


def _call(name, kw):
    from repro_torch.kernels import (cumulants, group_cf, group_cumulants,
                                     pb_cf, polymul)
    if name == "polymul":
        return polymul.polymul(torch.empty(kw["na"]), torch.empty(kw["nb"]))
    n = kw["n"]
    p = torch.empty(n)
    if name == "logcf":
        return pb_cf.logcf(p, torch.empty(n, dtype=torch.int32),
                           num_freq=kw["num_freq"],
                           freq_cnt=kw["cnt"])
    if name == "group_logcf":
        return group_cf.group_logcf(
            p, torch.empty(n, dtype=torch.int32),
            torch.empty(n, dtype=torch.int64), num_groups=kw["groups"],
            num_freq=kw["num_freq"], freq_lo=kw["lo"], freq_cnt=kw["cnt"])
    if name == "cumulant_sums":
        return cumulants.cumulant_sums(p, torch.empty(n),
                                       orders=kw["orders"])
    return group_cumulants.group_cumulant_sums(
        p, torch.empty(n), torch.empty(n, dtype=torch.int64),
        num_groups=kw["groups"], orders=kw["orders"])


@pytest.mark.parametrize("name,kw,flops,nbytes", KERNEL_CASES)
def test_kernel_fake_cost(name, kw, flops, nbytes):
    costs, launches = _fake_costs(lambda: _call(name, kw))
    assert costs == {name: dict(launches=1, flops=flops, bytes=nbytes)}
    assert launches == {name: 1}


@pytest.mark.parametrize("name", ["logcf", "polymul", "cumulant_sums"])
def test_fake_card_tensor_outside_dry_run_raises(name):
    """A fake tensor on the card (FakeTensorMode makes one on any host)
    reaching a launch outside the dry-run raises; it never builds or
    calls the library."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import cumulants, pb_cf, polymul
    with FakeTensorMode():
        p = torch.empty(1024, device="cuda")
        with pytest.raises(RuntimeError, match="outside the dry-run"):
            if name == "logcf":
                pb_cf.logcf(p, torch.empty(1024, dtype=torch.int32,
                                           device="cuda"), num_freq=256)
            elif name == "polymul":
                polymul.polymul(p, torch.empty(300, device="cuda"))
            else:
                cumulants.cumulant_sums(p, torch.empty(1024, device="cuda"))
