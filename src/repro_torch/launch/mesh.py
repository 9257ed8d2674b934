"""A device mesh over ``torch.distributed`` ranks (the port of
``repro.compat.make_mesh`` and ``repro.launch.mesh``).

The JAX package runs a sharded plan as one ``shard_map`` over a
``jax.sharding.Mesh``.  The port runs one process per rank instead, and a
:class:`Mesh` tells each process where it sits: the axis names, the size
of each axis, this rank's coordinate on each, the device it computes on,
and one process group for every tuple of axes (a :class:`MeshAxis`), over
which :mod:`repro_torch.db.distributed` runs its collectives.  Ranks are
laid out row-major over the axes, as ``jax.make_mesh`` lays out devices.

The groups are built with ``dist.new_group(ranks, backend=...)``, so the
backend is explicit: gloo ranks that share one card keep gloo for their
CUDA tensors (``init_device_mesh`` would pick the backend from the device
type).

A mesh may span part of the world (``ranks=``, as
``train.elastic.degrade_mesh`` builds one from the surviving ranks):
every process still builds it (group creation is collective), and a
process outside it has ``coords`` None and no groups.  The reference's
production meshes (``make_production_mesh``: 16 x 16 ``("data",
"model")``, or 2 x 16 x 16 with ``"pod"``) need a world of 256 / 512
ranks; ``make_host_mesh`` fits a small (data, model) mesh to the world.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch
import torch.distributed as dist

from ..core.config import resolve_device


class MeshAxis:
    """The process group of one tuple of mesh axes, as this rank sees it:
    the ranks that share every other coordinate.  ``index`` is this rank's
    row-major position over ``names`` (the order of the contiguous row
    partition), ``size`` the group's rank count."""

    def __init__(self, names: tuple, group, size: int, index: int,
                 device: torch.device):
        self.names = names
        self.group = group
        self.size = size
        self.index = index
        self.device = device

    def __repr__(self):
        return (f"MeshAxis({self.names}, size={self.size}, "
                f"index={self.index})")


class Mesh:
    """This rank's view of a mesh of ``prod(shape)`` ranks: ``axis_names``,
    ``shape[axis]``, ``coords[axis]``, ``device``, ``backend``, and
    :meth:`axis` for the process group of any tuple of axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 backend: str | None = None, device="cuda",
                 ranks: Sequence[int] | None = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh needs an initialised default process group "
                "(torch.distributed.init_process_group)")
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "must pair up, with distinct names")
        world = dist.get_world_size()
        ranks = tuple(range(world)) if ranks is None \
            else tuple(int(r) for r in ranks)
        if math.prod(shape) != len(ranks):
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"ranks; it was given {len(ranks)} (the "
                             f"process group has {world})")
        if len(set(ranks)) != len(ranks) \
                or not all(0 <= r < world for r in ranks):
            raise ValueError(f"mesh ranks {ranks} must be distinct ranks "
                             f"of the {world}-rank process group")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.ranks = ranks
        self.rank = dist.get_rank()
        self.backend = backend or dist.get_backend()
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        self.device = dev
        self.coords = None
        if self.rank in ranks:
            coords, r = [], ranks.index(self.rank)
            for s in reversed(shape):
                coords.append(r % s)
                r //= s
            self.coords = dict(zip(names, reversed(coords)))
        # Every rank must create every group, in the same order.
        self._axes: dict = {}
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                self._axes[sub] = self._build(sub, shape)

    def _build(self, sub: tuple, shape: tuple) -> MeshAxis:
        names = self.axis_names
        free = [names.index(a) for a in sub]
        fixed = [i for i in range(len(names)) if i not in free]
        mine = None
        for fix in itertools.product(*(range(shape[i]) for i in fixed)):
            ranks = []
            for var in itertools.product(*(range(shape[i]) for i in free)):
                c = [0] * len(names)
                for i, v in zip(fixed, fix):
                    c[i] = v
                for i, v in zip(free, var):
                    c[i] = v
                ranks.append(self.ranks[self._linear(c, shape)])
            group = dist.new_group(ranks, backend=self.backend)
            if self.rank in ranks:
                mine = (group, ranks)
        if mine is None:                 # this process is off the mesh
            return None
        group, ranks = mine
        return MeshAxis(sub, group, len(ranks), ranks.index(self.rank),
                        self.device)

    @staticmethod
    def _linear(coords, shape) -> int:
        r = 0
        for c, s in zip(coords, shape):
            r = r * s + c
        return r

    def axis(self, names) -> MeshAxis:
        """The process group over ``names`` (an axis name or a tuple of
        them, in mesh order); None on a process off the mesh."""
        if isinstance(names, str):
            names = (names,)
        names = tuple(a for a in self.axis_names if a in tuple(names))
        if not names:
            raise ValueError("an axis tuple needs at least one mesh axis")
        return self._axes[names]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              backend: str | None = None, device="cuda",
              ranks: Sequence[int] | None = None) -> Mesh:
    """A :class:`Mesh` over the existing default process group (or over
    ``ranks`` of it).  ``backend`` defaults to the default group's;
    ``device`` to the card (``cuda:<rank % cards>``), which raises on a
    host without one."""
    return Mesh(shape, axis_names, backend=backend, device=device,
                ranks=ranks)


def make_production_mesh(*, multi_pod: bool = False,
                         backend: str | None = None, device="cuda") -> Mesh:
    """The reference's production mesh: 16 x 16 ``("data", "model")``, or
    2 x 16 x 16 ``("pod", "data", "model")`` with ``multi_pod``.  Raises
    unless the process group has 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return Mesh(shape, axes, backend=backend, device=device)


def host_mesh_shape(n: int, data: int | None = None,
                    model: int | None = None) -> tuple:
    """(data, model) of :func:`make_host_mesh` over ``n`` ranks: as given,
    or (when either is None) model the largest power of two <= min(4, n)
    that divides n, and data the rest."""
    if data is None or model is None:
        model = 1
        while model * 2 <= min(4, n) and n % (model * 2) == 0:
            model *= 2
        data = n // model
    return data, model


def make_host_mesh(data: int | None = None, model: int | None = None, *,
                   backend: str | None = None, device="cuda") -> Mesh:
    """A small ``("data", "model")`` mesh over every rank of the process
    group (:func:`host_mesh_shape`) -- tests and examples."""
    shape = host_mesh_shape(dist.get_world_size(), data, model)
    return Mesh(shape, ("data", "model"), backend=backend, device=device)
