"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints the run's result as one JSON line,
the last of standard output, and each number compared with its limit as
the last lines of standard error.  Exits with another code than 0, and
prints no result, without a CUDA card (or with fewer than the cell asks
for), without the program beside the benchmark, or when JAX or the JAX
package was loaded by the time the window closed.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root in place of this file's folder, whose modules would
# shadow the standard library's (trace)
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402


def _since_process_start() -> float:
    """Seconds between this process's creation and the first line of this
    file (Linux: /proc/self/stat's start time), 0 where unreadable."""
    try:
        start = int(open("/proc/self/stat").read().rsplit(")", 1)[1]
                    .split()[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(open("/proc/uptime").read().split()[0])
        return max(0.0, uptime - start - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    from portbench import harness
    cell = harness.Manifest(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, _ = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace),
                               t_start=T_START - _since_process_start())
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measured process: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} value {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
