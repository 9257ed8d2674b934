"""What the benchmark keeps of each answer of the measured window.

``flatten`` turns a query's result (the dict of a GroupAgg, or the Table
of a Project) into named leaves with the group slot as their leading axis:
``valid``, ``key.<column>``, ``mean.<name>`` / ``var.<name>`` (a SUM's
Normal), ``cum.<name>`` (cumulant sums), ``prob.<name>`` (confidence,
exact distributions, tail masses, projected probabilities).

``Keeper.keep`` runs after an answer has been timed: it keeps, on the
device, the number of valid groups, each key's sum over them, and every
leaf at the family's sample of slots, drawn from the seed once.  That is
what the comparison with the reference reads after the window.
"""
from __future__ import annotations

import numpy as np
import torch


def flatten(out) -> dict:
    if hasattr(out, "columns") and hasattr(out, "prob"):     # a Table
        flat = {"valid": out.valid, "prob.p": out.prob}
        flat.update({f"key.{k}": v for k, v in out.columns.items()})
        return flat
    flat = {}
    for name, v in out.items():
        if name == "valid":
            flat["valid"] = v
        elif name == "keys":
            flat.update({f"key.{k}": c for k, c in v.items()})
        elif isinstance(v, tuple):
            flat[f"mean.{name}"], flat[f"var.{name}"] = v
        elif "cumulants" in name:
            flat[f"cum.{name}"] = v
        else:
            flat[f"prob.{name}"] = v
    return flat


def sample_slots(groups: int, size: int, rng: np.random.Generator,
                 device) -> torch.Tensor:
    """Sorted slot indices: every slot, or ``size`` drawn without
    replacement."""
    if groups <= size:
        idx = np.arange(groups)
    else:
        idx = np.sort(rng.choice(groups, size, replace=False))
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def digest(flat: dict, sample: torch.Tensor) -> dict:
    """Counts over every slot, leaves at ``sample`` (device tensors)."""
    valid = flat["valid"]
    keys = {k[4:]: (v * valid).sum() for k, v in flat.items()
            if k.startswith("key.")}
    return dict(n_valid=valid.sum(), keysum=keys, sample=sample,
                leaves={k: v[sample] for k, v in flat.items()})


def to_host(d):
    """A digest (or any nest of tensors) with every tensor on the host."""
    if isinstance(d, torch.Tensor):
        return d.cpu()
    if isinstance(d, dict):
        return {k: to_host(v) for k, v in d.items()}
    if isinstance(d, (tuple, list)):
        return type(d)(to_host(v) for v in d)
    return d


class Keeper:
    """The answers of one run, as digests: ``kept`` lists (family,
    substitution parameters, digest) in the order they were answered."""

    def __init__(self, samples: dict):
        self.samples = samples            # family -> sorted slot indices
        self.kept: list = []              # (family, subst, digest)

    def keep(self, family: str, subst: dict, out) -> None:
        self.kept.append((family, subst,
                          digest(flatten(out), self.samples[family])))

    def keep_sweep(self, family: str, points: list, out) -> None:
        """Point j of a sweep's result is the answer at ``points[j]``."""
        flat = flatten(out)
        for j, s in enumerate(points):
            self.kept.append((family, s, digest(
                {k: v[j] for k, v in flat.items()}, self.samples[family])))
