"""Columnar probabilistic tables (paper Definition 3; port of
``repro.db.table``).

A probabilistic table is a fixed-capacity struct of tensors:

    columns: dict[str, (capacity,) tensor]  single-valued attributes
    prob:    (capacity,) float              the p column (tuple probability)
    valid:   (capacity,) bool               row liveness mask

Relational operators never shrink a table: selection flips ``valid`` bits
and joins have static output capacities, as in the JAX package, so every
chunk grid and group capacity matches the reference.  ``part`` is the
physical planner's partitioning marker.  Tensors are updated functionally
(no operator writes into a table it was given).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.config import default_float, resolve_device


@dataclasses.dataclass
class Table:
    columns: Dict[str, torch.Tensor]
    prob: torch.Tensor
    valid: torch.Tensor
    #: partitioning metadata (see repro_torch.db.physical).
    part: object = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_columns(cls, columns: Dict[str, torch.Tensor],
                     prob: torch.Tensor | None = None,
                     valid: torch.Tensor | None = None) -> "Table":
        first = next(iter(columns.values()))
        n, dev = first.shape[0], first.device
        for k, v in columns.items():
            if v.shape[0] != n:
                raise ValueError(f"column {k} length mismatch")
        if prob is None:  # deterministic relation: gamma-embedding, p = 1
            prob = torch.ones((n,), dtype=default_float(), device=dev)
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
        return cls(dict(columns), prob, valid)

    @classmethod
    def from_numpy(cls, columns: dict, prob=None, valid=None,
                   device="cuda") -> "Table":
        """Host numpy arrays -> a Table on ``device`` (dtypes kept: integer
        columns stay integer, probabilities keep their float width)."""
        dev = resolve_device(device)
        put = lambda a: torch.from_numpy(np.array(a)).to(dev)
        return cls.from_columns({k: put(v) for k, v in columns.items()},
                                None if prob is None else put(prob),
                                None if valid is None else put(valid))

    # -- properties ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.prob.shape[0]

    @property
    def device(self) -> torch.device:
        return self.prob.device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    # -- functional updates --------------------------------------------------
    def with_valid(self, valid) -> "Table":
        return Table(self.columns, self.prob, valid, self.part)

    def with_prob(self, prob) -> "Table":
        return Table(self.columns, prob, self.valid, self.part)

    def with_part(self, part) -> "Table":
        """Retag the partitioning metadata (rows untouched)."""
        return Table(self.columns, self.prob, self.valid, part)

    def with_column(self, name: str, values) -> "Table":
        cols = dict(self.columns)
        cols[name] = values
        return Table(cols, self.prob, self.valid, self.part)

    def select_columns(self, names) -> "Table":
        return Table({k: self.columns[k] for k in names}, self.prob,
                     self.valid, self.part)

    def masked_prob(self) -> torch.Tensor:
        """p with invalid rows zeroed — the UDA-facing view (a dead tuple is
        indistinguishable from a p = 0 tuple for every aggregate)."""
        return torch.where(self.valid, self.prob,
                           torch.zeros((), dtype=self.prob.dtype,
                                       device=self.prob.device))

    def pad_to(self, capacity: int) -> "Table":
        """Append invalid p = 0 rows (zero-filled columns) up to
        ``capacity``."""
        n = self.capacity
        if capacity < n:
            raise ValueError(f"pad_to({capacity}) below capacity {n}")
        if capacity == n:
            return self
        pad = capacity - n
        z = lambda v: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
        return Table({k: z(v) for k, v in self.columns.items()},
                     z(self.prob), z(self.valid), self.part)

    def pad_to_multiple(self, multiple: int) -> "Table":
        """Pad with invalid p = 0 rows so ``multiple`` divides the capacity
        — the plan compiler's canonical chunk grid."""
        return self.pad_to(-(-self.capacity // multiple) * multiple)


def concat(a: Table, b: Table) -> Table:
    keys = sorted(a.columns)
    if keys != sorted(b.columns):
        raise ValueError("concat needs tables with the same columns")
    cols = {k: torch.cat([a.columns[k], b.columns[k]]) for k in keys}
    return Table(cols, torch.cat([a.prob, b.prob]),
                 torch.cat([a.valid, b.valid]), a.part)
