"""The readings that a cell's correctness limits are set from, in one
process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults <name,...> --fault-seeds 4,5,6] \\
        --seconds <s> --out <file.json>

For each of ``--seeds`` it runs the cell as the benchmark does (the same
set-up, a window of ``--seconds``, the same reference check) and keeps
every number compared: the program's readings.  For each of
``--control-seeds`` it puts the control in the program's place: the
reference computed in bfloat16, the precision below the configuration's
float32, on the answers a run compares first (per family, the first ones
the seed's traffic draws) at the cell's own sizes.  The output holds
both readings of every number and a proposed limit: above the largest
program reading, below the smallest control reading, nearer the latter
(lower^0.4 * upper^0.6), where the control reads 3 times the program or
more; a number that reads 0 on every seed of both is exact (limit 0).
With ``--faults`` it also runs the cell, as the benchmark does, on each
of ``--fault-seeds`` with each named fault of ``faults.py`` planted under
the timed path, and keeps those readings.  The benchmark's own runs never
run the control or a fault.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root and the program in place of this file's folder,
    # whose modules would shadow the standard library's (trace)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def control_readings(root, workload: str, seed: int, dev,
                     config: dict | None = None) -> dict:
    import torch
    from portbench import compare, datagen, harness, queries, results
    from portbench import traffic as TR
    man = harness.Manifest(root)
    cell = man.cell(workload)
    cfg = config or man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    tables = datagen.generate(cfg, seed, dev)
    g = TR.rng(seed, TR.SAMPLE)
    size = int(traffic["compare"]["sample_groups"])
    samples = {f: results.sample_slots(queries.FAMILIES[f].groups(cfg),
                                       size, g, dev)
               for f in TR.families(traffic)}
    per = traffic["compare"].get("per_family",
                                 traffic["compare"].get("points"))
    kept, counts = [], {}
    for unit in TR.units(traffic, seed, TR.WORK):
        items = [(unit[0], p) for p in unit[1]] \
            if traffic["kind"] == "sweep" else unit
        for fam, s in items:
            if counts.get(fam, 0) < per:
                counts[fam] = counts.get(fam, 0) + 1
                kept.append((fam, s, {"sample": samples[fam]}))
        if all(counts.get(f, 0) >= per for f in samples):
            break
    nums = compare.numbers(kept, list(range(len(kept))), tables, cfg,
                           answers=compare.control_answer(
                               tables, cfg, torch.bfloat16))
    nums.pop("lost")
    return nums


def propose(program: list, control: list) -> dict:
    out = {}
    for name in sorted(set().union(*program)):
        lower = max(r[name] for r in program)
        ups = [r[name] for r in control if name in r]
        upper = min(ups) if ups else None
        if name == "keys" or (lower == 0 and upper == 0):
            limit = 0
        elif upper is not None and upper >= 3 * lower and lower > 0:
            limit = lower ** 0.4 * upper ** 0.6
        else:
            limit = None
        out[name] = {"lower": lower, "upper": upper, "limit": limit}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch
    from portbench import faults, harness
    dev = torch.device("cuda", 0)
    program, runs, control = [], [], []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        line, nums = harness.run_cell(ROOT, args.workload, seed,
                                      args.seconds, False, limits={},
                                      t_start=t0)
        program.append(nums)
        runs.append({"seed": seed, "nums": nums, "metrics": line["metrics"],
                     "attempted": line["attempted"],
                     "failed": line["failed"],
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(runs[-1]), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        control.append(control_readings(ROOT, args.workload, seed, dev))
        print(json.dumps({"control_seed": seed, "nums": control[-1]}),
              flush=True)
    planted = {}
    for name in [f for f in args.faults.split(",") if f]:
        for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
            with faults.FAULTS[name]():
                line, nums = harness.run_cell(ROOT, args.workload, seed,
                                              args.seconds, False,
                                              limits={})
            planted.setdefault(name, []).append({"seed": seed,
                                                 "nums": nums})
            print(json.dumps({"fault": name, "seed": seed, "nums": nums}),
                  flush=True)
    out = {"workload": args.workload, "card": harness.power_limit(),
           "runs": runs, "control": control, "faults": planted,
           "proposal": propose(program, control) if program else {}}
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out["proposal"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
