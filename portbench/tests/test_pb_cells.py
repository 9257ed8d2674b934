"""Each cell's traffic against the reference at a tiny size on the CPU
(the program's plain routes): correct under the cell's limits; the
control (the reference in bfloat16 in the program's place) and the
planted faults come out not correct."""
import pytest
import torch

from portbench import calibrate, compare, faults, harness
from portbench import traffic as TR
from portbench.tests.tiny import ROOT, WORKLOADS, run_tiny, tiny_config


def _limits(workload):
    return compare.load_limits(ROOT, workload)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_correct_on_cpu(workload):
    line, nums = run_tiny(workload, seed=2**31 + 7)
    assert line["failed"] == 0 and line["attempted"] > 0
    assert nums["keys"] == 0
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(workload):
    man = harness.Manifest(ROOT)
    cfg = tiny_config(man.cell(workload)["config"])
    nums = calibrate.control_readings(ROOT, workload, 11, torch.device("cpu"),
                                      config=cfg)
    ok, checked = compare.checks(nums, _limits(workload))
    assert not ok
    failing = [n for n, c in checked.items() if c["value"] > c["limit"]]
    assert failing, checked


def _reaches(fault, workload):
    fams = faults.REACHES.get(fault)
    if fams is None:
        return True
    man = harness.Manifest(ROOT)
    traffic = man.traffic(man.cell(workload)["traffic"])
    return bool(set(fams) & set(TR.families(traffic)))


@pytest.mark.parametrize("workload,fault", [
    pytest.param(w, f, id=f"{f}-{w}") for f in faults.FAULTS
    for w in WORKLOADS if _reaches(f, w)])
def test_planted_fault_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        line, _ = run_tiny(workload, seed=3)
    assert not line["correct"], line["checks"]
