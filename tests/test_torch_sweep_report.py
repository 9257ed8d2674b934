"""Parameter sweeps with ``with_report=True`` (``QueryService.sweep``):
the result and a stacked :class:`repro_torch.db.report.ExecutionReport`,
every value of which gains the leading N axis, as the reference's stacked
report pytree does.

* The scan sweep's report at point i is the report of a sequential
  ``submit(..., with_report=True)`` at point i, bit for bit.
* Both modes' reports agree with the reference's ``QueryService.sweep(...,
  with_report=True)`` (jitted, as its own tests run it): every count
  equal, ``tail_mass`` within ``VMAP_RTOL``; the results within
  ``VMAP_RTOL`` (float64).
* The vmap sweep's counts equal the scan sweep's point by point (a pass's
  lost group codes, the NaNs of its states), ``tail_mass`` within the
  leaf bounds of test_torch_sweep_vmap.py, in float64 and float32.
* The readers refuse a stacked report instead of reducing over its
  points; ``report.point(j)`` is point j's.

Sizes: test_torch_sweep_vmap.py's ``SMALL`` (2,400 lineitem rows), 4-8
points.  The mesh cases (counts per point on two gloo ranks, a forced
overflow) run in that file's one spawn."""
import numpy as np
import pytest
import torch

from repro_torch.db import plans as TP
from repro_torch.db import tpch
from repro_torch.db.serving import QueryService
from test_torch_sweep_vmap import (CPU, CUMULANT_RTOL_F32, SMALL, VMAP_RTOL,
                                   VMAP_RTOL_F32, _close, _families, _flat,
                                   _port_only, _report, _tables)

pytestmark = pytest.mark.serving

#: families both packages build (test_torch_sweep_vmap.py's ``_families``)
REFERENCE_FAMILIES = ("q1", "q18", "max", "q3")


@pytest.fixture(scope="module")
def jax_db():
    from repro.db import tpch as jtpch
    return jtpch.generate(**SMALL)


@pytest.fixture(scope="module")
def arrays(jax_db):
    return {name: dict(columns={k: np.asarray(v)
                                for k, v in t.columns.items()},
                       prob=np.asarray(t.prob), valid=np.asarray(t.valid))
            for name, t in jax_db.tables().items()}


def _bit_equal_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k, x in fa.items():
        assert x.dtype == fb[k].dtype and torch.equal(x, fb[k]), k


@pytest.mark.parametrize("family", ("q1", "max", "overflow", "q3",
                                    "reweight"))
def test_scan_report_bit_equal_to_submits(arrays, family):
    """Point i of the scan sweep, report included, is the sequential
    submit's at point i, bit for bit; the stacked report keeps every
    label and gains the N axis on every value."""
    tables = _tables(arrays)
    fam, batch = _port_only(4, torch.float64)[family]
    svc = QueryService(tables, **CPU)
    (out, rep), info = svc.sweep(fam, batch, with_report=True)
    assert rep.points == 4 and rep.final_params == {}
    for i in range(4):
        (seq, srep), _ = svc.submit(fam, {k: v[i] for k, v in batch.items()},
                                    with_report=True)
        _bit_equal_trees({k: v[i] for k, v in _flat(out).items()},
                         _flat(seq))
        _bit_equal_trees({k: v[i] for k, v in _flat(_report(rep)).items()},
                         _flat(_report(srep)))
        _bit_equal_trees(_report(rep.point(i)), _report(srep))


@pytest.mark.parametrize("mode", ("scan", "vmap"))
@pytest.mark.parametrize("family", REFERENCE_FAMILIES)
def test_report_matches_reference(jax_db, arrays, family, mode):
    """Float64, 6 points: both modes of the port against the reference's
    sweep in the same mode, result and report."""
    import jax.numpy as jnp
    from repro.db import plans as JP
    from repro.db import tpch as jtpch
    from repro.db.serving import QueryService as JQueryService
    fam, batch = _families(TP, tpch, torch, 6, dtype=torch.float64)[family]
    jfam, jbatch = _families(JP, jtpch, jnp, 6)[family]
    (got, rep), _ = QueryService(_tables(arrays), sweep_mode=mode,
                                 **CPU).sweep(fam, batch, with_report=True)
    (want, jrep), _ = JQueryService(jax_db.tables(), sweep_mode=mode).sweep(
        jfam, jbatch, with_report=True)
    assert rep.points == 6
    _close(got, want, VMAP_RTOL)
    _close(_report(rep), _report(jrep), VMAP_RTOL)
    assert rep.group_overflow and rep.state_nan
    if family == "max":
        assert next(iter(rep.tail_mass.values())).shape == (6, 4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("family", ("q1", "max", "overflow", "q3",
                                    "reweight", "project"))
def test_vmap_report_equals_scan(arrays, family, dtype):
    """8 points: the vmap sweep's report against the scan sweep's, count
    by count and point by point ("overflow" loses group codes at every
    point, each point its own count); results within the leaf bounds."""
    tables = _tables(arrays, prob_dtype=dtype)
    fam, batch = _port_only(8, dtype)[family]
    (scan, srep), _ = QueryService(tables, **CPU).sweep(fam, batch,
                                                        with_report=True)
    (vmap, vrep), info = QueryService(tables, sweep_mode="vmap",
                                      **CPU).sweep(fam, batch,
                                                   with_report=True)
    assert info["launches"] == 1 and vrep.points == srep.points == 8
    rtol = VMAP_RTOL if dtype == torch.float64 else VMAP_RTOL_F32
    cumulant_rtol = None if dtype == torch.float64 else CUMULANT_RTOL_F32
    _close(_report(vrep), _report(srep), rtol)
    _close(vmap, scan, rtol, cumulant_rtol)
    if family == "overflow":
        lost = next(iter(vrep.group_overflow.values()))
        assert (lost > 0).all() and len(set(lost.tolist())) > 1


def test_vmap_report_chunked_equals_one_launch(arrays):
    """A ``batch_row_budget`` of 3 points' rows: 3 launches whose reports
    concatenate into the one launch's."""
    tables = _tables(arrays)
    fam, batch = _port_only(8, torch.float64)["overflow"]
    (one, rep), _ = QueryService(tables, sweep_mode="vmap", **CPU).sweep(
        fam, batch, with_report=True)
    svc = QueryService(tables, sweep_mode="vmap", **CPU)
    svc.batch_row_budget = int(3 * svc._per_point_rows(fam))
    (cut, crep), info = svc.sweep(fam, batch, with_report=True)
    assert info["launches"] == 3 and crep.points == 8
    _close(cut, one, VMAP_RTOL)
    _bit_equal_trees(_report(crep), _report(rep))


@pytest.mark.parametrize("mode", ("scan", "vmap"))
def test_stacked_report_readers(arrays, mode):
    """The readers refuse a stacked report (they would reduce over the
    points); ``point(j)`` gives point j's report, whose readers work and
    match a submit's at that point."""
    tables = _tables(arrays)
    fam, batch = _port_only(4, torch.float64)["overflow"]
    (_, rep), _ = QueryService(tables, sweep_mode=mode, **CPU).sweep(
        fam, batch, with_report=True)
    for reader in (rep.host_values, rep.issues, rep.describe, rep.ok,
                   rep.overflow_total, rep.max_tail_mass):
        with pytest.raises(ValueError, match=r"point\(j\)"):
            reader()
    svc = QueryService(tables, **CPU)
    for j in range(4):
        (_, srep), _ = svc.submit(fam, {k: v[j] for k, v in batch.items()},
                                  with_report=True)
        assert rep.point(j).issues() == srep.issues()
        assert "group_overflow" in rep.point(j).issues()
    with pytest.raises(ValueError, match="one run"):
        srep.point(0)
