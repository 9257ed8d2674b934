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

:class:`HostTable` is the out-of-core twin: numpy (or ``np.memmap``)
columns on the host, cut into canonical-chunk-aligned slabs that the
streamed executor of ``db/plans.py`` ships to the device one wave at a
time.
"""
from __future__ import annotations

import dataclasses
import json
import os
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

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def to_pandas_like(self) -> dict:
        """The valid rows as numpy arrays, the probabilities under "p"."""
        mask = self.valid.cpu().numpy()
        out = {k: v.cpu().numpy()[mask] for k, v in self.columns.items()}
        out["p"] = self.prob.cpu().numpy()[mask]
        return out

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


def _cut(a, start: int, rows: int, out=None):
    """Copy rows ``[start, start + rows)`` of host array ``a`` into a
    contiguous buffer, zero-filling past the stored length (the virtual
    pad and the wave schedule's tail: pad rows are invalid with p = 0, so
    zeros are exactly padding).  With ``out`` (a numpy array, for the
    streamed executor the view of a pinned buffer) the copy lands there
    through ``np.copyto``, with no allocation."""
    stop = min(start + rows, a.shape[0])
    got = max(0, stop - start)
    if out is None:
        if got == rows:
            return np.ascontiguousarray(a[start:stop])
        buf = np.zeros((rows,) + a.shape[1:], a.dtype)
        if got:
            buf[:got] = a[start:stop]
        return buf
    if got:
        np.copyto(out[:got], a[start:stop])
    if got < rows:
        out[got:rows] = 0
    return out


class HostTable:
    """Host-resident probabilistic table: the out-of-core twin of
    :class:`Table`.

    Columns, prob and valid are host ``numpy`` arrays (or ``np.memmap``
    views of on-disk column files, see :meth:`save` / :meth:`open`) and
    never reach the device whole: the streamed executor ships one
    canonical-chunk-aligned slab of rows per wave (:meth:`wave_slab`) and
    folds the per-chunk UDA states across waves, so the device holds two
    slabs plus the group-level state, whatever the table's size.

    Padding is VIRTUAL: :meth:`pad_to` records extra capacity instead of
    copying (``capacity``, the slab cutters and :meth:`to_table` present
    the padded view, reading the invalid p = 0 pad rows as zeros), so a
    memory-mapped table is padded to the chunk grid without touching the
    disk.  It mirrors the read-only surface the planner needs
    (``columns`` / ``prob`` / ``valid`` / ``capacity``).
    """

    def __init__(self, columns, prob=None, valid=None, part=None, pad=0):
        # keep ndarray instances as they are (np.asarray would strip the
        # np.memmap subclass of disk-backed columns); coerce the rest
        asarr = lambda v: v if isinstance(v, np.ndarray) else np.asarray(v)
        self.columns = {k: asarr(v) for k, v in columns.items()}
        if self.columns:
            n = next(iter(self.columns.values())).shape[0]
        elif prob is None:
            raise ValueError("a HostTable without columns needs prob")
        else:       # column-pruned to nothing (pure COUNT): p/valid only
            n = np.asarray(prob).shape[0]
        for k, v in self.columns.items():
            if v.shape[0] != n:
                raise ValueError(f"column {k} length mismatch")
        self.prob = (np.ones((n,), np.float32) if prob is None
                     else asarr(prob))
        self.valid = (np.ones((n,), bool) if valid is None
                      else asarr(valid))
        self.part = part
        self._pad = int(pad)
        self._chunk_multiple = 0

    @classmethod
    def from_table(cls, t: Table) -> "HostTable":
        """Pull a (device) Table to host memory."""
        host = lambda x: x.detach().cpu().numpy()
        return cls({k: host(v) for k, v in t.columns.items()},
                   host(t.prob), host(t.valid), t.part)

    @property
    def capacity(self) -> int:
        """Logical row count: stored rows plus the virtual pad."""
        return self.prob.shape[0] + self._pad

    @property
    def stored_rows(self) -> int:
        """Physically stored rows (what :meth:`save` writes to disk)."""
        return self.prob.shape[0]

    def __getitem__(self, name: str):
        return self.columns[name]

    def pad_to(self, capacity: int) -> "HostTable":
        n = self.capacity
        if capacity < n:
            raise ValueError(f"pad_to({capacity}) below capacity {n}")
        if capacity == n:
            return self
        return HostTable(self.columns, self.prob, self.valid, self.part,
                         pad=self._pad + (capacity - n))

    def pad_to_multiple(self, multiple: int) -> "HostTable":
        """Virtual chunk-grid padding; a table already padded to this
        grid is returned as it is (the multiple is cached)."""
        if self._chunk_multiple == multiple:
            return self
        out = self.pad_to(-(-self.capacity // multiple) * multiple)
        out._chunk_multiple = multiple
        return out

    def select_columns(self, names) -> "HostTable":
        """Pruned view sharing the same arrays (the lowered
        ``StreamedScan.columns`` demand set: waves cut only these)."""
        out = HostTable({k: self.columns[k] for k in names}, self.prob,
                        self.valid, self.part, pad=self._pad)
        out._chunk_multiple = self._chunk_multiple
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist to ``path/`` in the JAX package's layout: one ``.npy``
        file per column plus ``prob.npy`` / ``valid.npy`` and a
        ``manifest.json`` mapping column names to files.  Only stored rows
        reach the disk; the virtual padding is recorded in the manifest."""
        os.makedirs(path, exist_ok=True)
        files = {k: f"col{i}.npy" for i, k in enumerate(sorted(self.columns))}
        for k, fname in files.items():
            np.save(os.path.join(path, fname), np.asarray(self.columns[k]),
                    allow_pickle=False)
        np.save(os.path.join(path, "prob.npy"), np.asarray(self.prob),
                allow_pickle=False)
        np.save(os.path.join(path, "valid.npy"), np.asarray(self.valid),
                allow_pickle=False)
        manifest = {"version": 1, "capacity": int(self.capacity),
                    "stored_rows": int(self.stored_rows),
                    "columns": files, "prob": "prob.npy",
                    "valid": "valid.npy"}
        with open(os.path.join(path, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)

    @classmethod
    def open(cls, path: str, mmap_mode: str | None = "r") -> "HostTable":
        """Open a :meth:`save` directory with every array backed by
        ``np.memmap``: slabs then read only the touched row ranges of the
        touched columns.  ``mmap_mode=None`` loads into RAM instead."""
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        load = lambda f: np.load(os.path.join(path, f), mmap_mode=mmap_mode,
                                 allow_pickle=False)
        cols = {k: load(f) for k, f in manifest["columns"].items()}
        return cls(cols, load(manifest["prob"]), load(manifest["valid"]),
                   pad=manifest["capacity"] - manifest["stored_rows"])

    # -- slab cutters --------------------------------------------------------
    def alloc_slab(self, rows: int, device="cuda") -> Table:
        """Uninitialised slab buffers with this table's dtypes, the
        ping-pong targets of ``wave_slab(out=)``: pinned host tensors when
        the slabs ship to a CUDA ``device`` (so the copy can run
        asynchronously), plain CPU tensors when ``device`` is the CPU."""
        pin = resolve_device(device).type == "cuda"
        mk = lambda a: torch.empty((rows,) + a.shape[1:],
                                   dtype=_torch_dtype(a.dtype),
                                   pin_memory=pin)
        return Table({k: mk(v) for k, v in self.columns.items()},
                     mk(self.prob), mk(self.valid), self.part)

    def slab(self, start: int, rows: int) -> Table:
        """Rows [start, start + rows) as a Table of CPU tensors,
        zero-padded with invalid p = 0 rows past the stored rows."""
        return self.wave_slab((start,), rows)

    def wave_slab(self, starts, rows: int, out: Table | None = None) -> Table:
        """One wave's slab: the concatenation of the runs ``[start, start
        + rows)`` for each start in ``starts`` (one run per shard, in
        shard order; on one device a single run).  Runs past the stored
        rows read as invalid p = 0 zeros.  With ``out`` (an
        :meth:`alloc_slab` buffer of ``len(starts) * rows`` rows) the runs
        are copied into its tensors through their numpy views and ``out``
        is returned; without, a Table of new CPU tensors."""
        def cut(a, buf):
            if buf is None:
                if len(starts) == 1:
                    return torch.from_numpy(_cut(a, starts[0], rows))
                buf = torch.empty((len(starts) * rows,) + a.shape[1:],
                                  dtype=_torch_dtype(a.dtype))
            view = buf.numpy()
            for i, s in enumerate(starts):
                _cut(a, s, rows, out=view[i * rows:(i + 1) * rows])
            return buf
        if out is None:
            return Table({k: cut(v, None) for k, v in self.columns.items()},
                         cut(self.prob, None), cut(self.valid, None),
                         self.part)
        return Table({k: cut(v, out.columns[k])
                      for k, v in self.columns.items()},
                     cut(self.prob, out.prob), cut(self.valid, out.valid),
                     self.part)

    def slabs(self, rows: int):
        """Iterate the whole table as ``ceil(capacity / rows)`` fixed-size
        slabs (the last one zero-padded)."""
        for start in range(0, self.capacity, rows):
            yield start, self.slab(start, rows)

    def to_table(self, device="cuda") -> Table:
        """Full materialisation on ``device``; virtual pad rows become
        invalid p = 0 zeros."""
        dev = resolve_device(device)

        def full(a):
            a = np.array(a)
            if self._pad:
                a = np.concatenate(
                    [a, np.zeros((self._pad,) + a.shape[1:], a.dtype)])
            return torch.from_numpy(a).to(dev)
        return Table({k: full(v) for k, v in self.columns.items()},
                     full(self.prob), full(self.valid), self.part)


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (through a zero-size array)."""
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def concat(a: Table, b: Table) -> Table:
    keys = sorted(a.columns)
    if keys != sorted(b.columns):
        raise ValueError("concat needs tables with the same columns")
    cols = {k: torch.cat([a.columns[k], b.columns[k]]) for k in keys}
    return Table(cols, torch.cat([a.prob, b.prob]),
                 torch.cat([a.valid, b.valid]), a.part)
