"""Helpers of the benchmark's tests: the configurations at a tiny size
and one run of a cell there."""
import pathlib

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: group capacities of the tiny tables
TINY_GROUPS = {"q3": 4096, "q18": 3000, "q20": 2048, "q20_project": 64}


def tiny_config(config: str) -> dict:
    """A configuration's file at 3,000 orders (every width and shape
    kept), its streamed budget cut to 2,000 rows."""
    cfg = harness.Manifest(ROOT).config(config)
    cfg.update(n_orders=3000, n_parts=400, n_suppliers=50, n_customers=300)
    cfg["groups"] = dict(TINY_GROUPS)
    if cfg["execution"]["kind"] == "streamed":
        cfg["device_row_budget"] = 2000
        cfg["execution"]["compile"] = {"canonical_chunks": 8,
                                       "stream_wave_chunks": 2}
    return cfg


def run_tiny(workload: str, seed: int = 5, seconds: float = 0.0,
             device: str = "cpu", limits=None):
    """(result line, numbers) of one run of ``workload`` at the tiny
    size: the window holds one stream or sweep."""
    man = harness.Manifest(ROOT)
    cfg = tiny_config(man.cell(workload)["config"])
    return harness.run_cell(ROOT, workload, seed, seconds, False,
                            device=device, config=cfg, limits=limits)


WORKLOADS = [w["name"] for w in harness.Manifest(ROOT).bench["workloads"]]
