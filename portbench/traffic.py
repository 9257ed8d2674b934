"""The one general generator of the benchmark's traffic: it reads a traffic
file (``portbench/traffic/<name>.json``) and draws its work from the seed.

A traffic file is data only:

    {"kind": "streams",                    # closed loop, one client
     "stream": {"order": "permutation" | "fixed", "queries": [family...]},
     "params": {family: {param: {"int": [lo, hi]}}},
     "compare": {"per_family": K, "sample_groups": S}}

draws stream after stream: each a list of (family, substitution
parameters), its queries in a seeded permutation (or as listed), each
parameter uniform over its inclusive range;

    {"kind": "sweep", "family": name,
     "grid": {param: {"choose": k, "int": [lo, hi]}},
     "with_report": true,
     "compare": {"points": K, "sample_groups": S}}

draws sweep after sweep: for each parameter k distinct values, and the
points are their product, the first parameter major.

Every stream or sweep is a unit of work: a run's window ends at the end
of the unit in flight.
"""
from __future__ import annotations

import itertools

import numpy as np

#: the streams of the generator's draws, one SeedSequence each
WORK, WARMUP, SAMPLE, COMPARE = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def draw(spec: dict, g: np.random.Generator) -> int:
    """A parameter uniform over its inclusive range ``{"int": [lo, hi]}``."""
    lo, hi = spec["int"]
    return int(g.integers(lo, hi + 1))


def _subst(traffic: dict, family: str, g) -> dict:
    return {k: draw(v, g) for k, v in traffic["params"].get(family,
                                                            {}).items()}


def _stream(traffic: dict, g) -> list:
    qs = list(traffic["stream"]["queries"])
    if traffic["stream"].get("order", "fixed") == "permutation":
        qs = [qs[i] for i in g.permutation(len(qs))]
    return [(f, _subst(traffic, f, g)) for f in qs]


def _choose(spec: dict, g) -> list:
    lo, hi = spec["int"]
    return sorted(int(x) for x in g.choice(np.arange(lo, hi + 1),
                                          spec["choose"], replace=False))


def _sweep(traffic: dict, g) -> tuple:
    grid = traffic["grid"]
    names = list(grid)
    values = [_choose(grid[k], g) for k in names]
    return traffic["family"], [dict(zip(names, combo))
                               for combo in itertools.product(*values)]


def units(traffic: dict, seed: int, stream: int = WORK):
    """The endless sequence of units a run's window consumes: streams
    (lists of (family, subst)) or sweeps ((family, points))."""
    g = rng(seed, stream)
    make = _stream if traffic["kind"] == "streams" else _sweep
    while True:
        yield make(traffic, g)


def families(traffic: dict) -> list:
    if traffic["kind"] == "streams":
        return list(dict.fromkeys(traffic["stream"]["queries"]))
    return [traffic["family"]]


def choose_compared(kept: list, traffic: dict, seed: int) -> list:
    """Indices into a run's answers (``kept``: (family, subst, digest))
    that the reference checks: for each family, up to ``per_family``
    (streams) or ``points`` (sweeps) answers, drawn from the seed."""
    g = rng(seed, COMPARE)
    per = traffic["compare"].get("per_family", traffic["compare"].get(
        "points"))
    chosen = []
    for fam in families(traffic):
        idx = [i for i, k in enumerate(kept) if k[0] == fam]
        take = g.permutation(len(idx))[:per]
        chosen += sorted(idx[i] for i in take)
    return sorted(chosen)
