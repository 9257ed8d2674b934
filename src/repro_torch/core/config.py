"""Numeric and device configuration of the port.

``default_float()`` is float32 unless ``enable_x64()`` was called, as in the
JAX package with x64 off; float32 is also the only dtype the CUDA kernels
take.  ``resolve_device`` turns an entry point's ``device=`` into a
``torch.device``: the card is the default, and asking for it on a host
without one raises instead of falling back to the CPU.  :func:`dry_run`
is the one place where something on the CPU computes as if on the card:
the dry-run's fake tensors, which hold no data.
:func:`settle_cpu_math` runs once when the package is imported.
"""
from __future__ import annotations

import contextlib

import torch

_X64 = {"on": False}
_DRY_RUN = {"on": False, "card": False}


def enable_x64() -> None:
    """Make float64 the port's default float (tables, UDA states)."""
    _X64["on"] = True


def x64_enabled() -> bool:
    return _X64["on"]


def default_float() -> torch.dtype:
    return torch.float64 if _X64["on"] else torch.float32


def default_complex() -> torch.dtype:
    return torch.complex128 if _X64["on"] else torch.complex64


def default_int() -> torch.dtype:
    return torch.int64 if _X64["on"] else torch.int32


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point allocates on; raises when it asks for a
    CUDA card that this host does not have."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


@contextlib.contextmanager
def dry_run(card: bool = True):
    """The dry-run's trace (``launch/dryrun.py``).  Inside, a kernel
    wrapper given a ``FakeTensor`` records its launch (count, FLOPs and
    bytes; ``kernels/build.py`` ``faked``) instead of making it, and, with
    ``card``, a ``FakeTensor`` on the CPU computes as a tensor on the card
    (:func:`on_card`): ``FakeTensorMode`` cannot run a CUDA backward on a
    host without a card.  A real tensor is never affected, so no real run
    carries on without a card through this."""
    prev = dict(_DRY_RUN)
    _DRY_RUN.update(on=True, card=card)
    try:
        yield
    finally:
        _DRY_RUN.update(prev)


def in_dry_run() -> bool:
    return _DRY_RUN["on"]


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (shape, dtype and device, no
    data)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def on_card(t) -> bool:
    """Whether ``t`` computes as a tensor on the card: it is on one, or it
    is a CPU ``FakeTensor`` standing in for one inside
    ``dry_run(card=True)``."""
    if t.device.type == "cuda":
        return True
    return _DRY_RUN["on"] and _DRY_RUN["card"] and t.device.type == "cpu" \
        and is_fake(t)


def settle_cpu_math() -> None:
    """Call each vectorised CPU math function the plain versions use once,
    on this thread alone (8 elements stay below the intra-op grain).  The
    first such call of a process initialises the vector math library;
    when that first call was split over the intra-op threads, one thread's
    share of a ``torch.cos`` came back with relative errors up to 1.5e-4
    (PyTorch 2.13 on the CPU, after other tests had started the thread
    pool): the plain logcf's intermittent test failure."""
    x = torch.full((8,), 0.5)
    for fn in (torch.cos, torch.sin, torch.log, torch.log1p, torch.exp,
               torch.expm1):
        fn(x)
    torch.atan2(x, x)
