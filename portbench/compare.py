"""How ``correct`` is decided: the answers the window produced, against
the reference recomputed from the same tables.

For each compared answer the reference (``reference.tpch.answer``, float64
on the device) gives the number of valid groups, each key's sum over them
and every leaf at the family's sample of slots.  The numbers compared:

``keys``      exact: answers whose valid-group count or key sums differ,
              plus sampled slots whose validity differs or, valid on both
              sides, whose key differs.  Limit 0.
``<family>``  the largest error of a mean, variance or cumulant sum over
              the family's compared answers, at slots valid on both sides,
              over the sum of the absolute values of its terms (the scale
              its rounding lives on).
``<family>.prob``  the largest absolute error of a probability there:
              confidence, an exact distribution (every bin), a tail mass,
              a projected probability.

A family has the numbers of the leaves its answers carry; each number is
held to its own limit, so a probability is never judged against a limit
set from relative errors of moments.

Each number is held to the limit in ``portbench/limits/<workload>.json``,
set from the program's readings on a dozen seeds and the control's
(``portbench/calibrate.py``).
"""
from __future__ import annotations

import json
import math
import pathlib

import torch

from . import results
from .reference import tpch as ref

_TINY = 1e-30


def answer_error(got: dict, want: dict) -> tuple:
    """(key mismatches, {kind: largest float error}) of one answer, kind
    ``moments`` (relative) or ``prob`` (absolute); ``got`` a host digest,
    ``want`` a reference answer (host)."""
    miss = int(int(got["n_valid"]) != want["n_valid"])
    miss += sum(int(int(got["keysum"][k]) != v)
                for k, v in want["keysum"].items())
    gl, wl = got["leaves"], want["leaves"]
    gv, wv = gl["valid"].bool(), wl["valid"][0].bool()
    miss += int((gv != wv).sum())
    both = gv & wv
    worst: dict = {}
    for name, (w, scale) in wl.items():
        if name == "valid":
            continue
        g = gl[name]
        if name.startswith("key."):
            miss += int((both & (g != w)).sum())
            continue
        kind = "prob" if name.startswith("prob.") else "moments"
        g, w = g.double(), w.double()
        err = (g - w).abs()
        if scale is not None:
            err = err / scale.double().clamp(min=_TINY)
        err = torch.where(torch.isnan(g), math.inf, err)
        err = err.reshape(err.shape[0], -1)[both]
        worst[kind] = max(worst.get(kind, 0.0),
                          float(err.max()) if err.numel() else 0.0)
    return miss, worst


def numbers(kept: list, chosen: list, tables: dict, cfg: dict,
            answers=None) -> dict:
    """{"keys": mismatches, family (moments) and family.prob: largest
    error, "lost": answers with live rows past a group capacity} over the
    chosen answers of ``kept``
    ((family, subst, digest)); ``answers(family, subst, sample)``
    replaces the program's digests (the control)."""
    out = {"keys": 0, "lost": 0}
    cache: dict = {}
    samples = {}
    for i in chosen:
        fam, subst, dig = kept[i]
        key = (fam, tuple(sorted(subst.items())))
        sample = samples.setdefault(fam, dig["sample"])
        if key not in cache:
            want = ref.answer(fam, tables, cfg, subst, torch.float64,
                              sample.to(_device(tables)))
            cache[key] = results.to_host(want)
        want = cache[key]
        got = results.to_host(dig if answers is None
                              else answers(fam, subst, sample))
        miss, worst = answer_error(got, want)
        out["keys"] += miss
        out["lost"] += int(want["lost"] > 0)
        for kind, err in worst.items():
            name = fam if kind == "moments" else f"{fam}.{kind}"
            out[name] = max(out.get(name, 0.0), err)
    return out


def control_answer(tables: dict, cfg: dict, dt):
    """The control: the reference put in the program's place, computed in
    ``dt`` (bfloat16 for the port's float32), as a digest."""
    def answer(fam, subst, sample):
        a = ref.answer(fam, tables, cfg, subst, dt,
                       sample.to(_device(tables)))
        return dict(n_valid=a["n_valid"], keysum=a["keysum"],
                    leaves={k: v for k, (v, _) in a["leaves"].items()})
    return answer


def _device(tables: dict):
    return tables["lineitem"]["prob"].device


def load_limits(root: pathlib.Path, workload: str) -> dict:
    path = root / "portbench" / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text())[
        "numbers"].items()}


def checks(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or below its
    limit; a number without a limit, or a limit without a number, is not
    correct."""
    out = {}
    ok = True
    for name in sorted(set(nums) | set(limits)):
        if name == "lost":
            continue
        v, lim = nums.get(name), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not v <= lim:
            ok = False
    return ok, out
