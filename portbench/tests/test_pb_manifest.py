"""``BENCHMARK.json`` against the benchmark's contract: names, units,
keys, and every file a name leads to."""
import json
import re

import pytest

from portbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {"queries_per_s", "queries_per_s.streamed", "query_ms_p95",
       "points_per_s", "peak_device_gb", "setup_s"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert len(cells) == len(BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == E2E
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        got = {n for n, m in e2e.items() if cell in m.get("workloads",
                                                          cells)}
        assert "setup_s" in got and len(got) >= 2


def test_per_layer_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["workloads"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_cuts(cfg):
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert sorted(body["reduced"]) == sorted(cfg["reduced"])
    assert set(body["source_values"]) == set(cfg["reduced"])
