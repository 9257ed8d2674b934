"""Faults planted under the timed path, to show that ``correct`` catches
them.  Each is a context manager that patches the program where an
answer is produced and restores it on exit:

``answer_altered``       every group confidence 1% low (an answer altered
                         where it is produced);
``half_rows_left_out``   every accumulation sees only the first half of
                         its tuples (half of the batch left out);
``logcf_phase_scaled``   the scalar exact-CF kernel's phases 0.1% too
                         large (a kernel that returns a wrong
                         characteristic function), which only the exact
                         distributions show.

``calibrate.py --faults`` reads them at a cell's own size on the card;
``tests/test_pb_cells.py`` at the tiny size on the CPU.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def answer_altered():
    from repro_torch.core import uda
    return _patched(uda.AtLeastOne, "finalize",
                    lambda orig: lambda self, st: orig(self, st) * 0.99)


def half_rows_left_out():
    from repro_torch.core import uda

    def make(orig):
        def half(udas, probs, *a, **k):
            keep = torch.arange(probs.shape[0], device=probs.device) \
                < probs.shape[0] // 2
            return orig(udas, torch.where(keep, probs, 0), *a, **k)
        return half
    return _patched(uda, "accumulate", make)


#: the phase error of ``logcf_phase_scaled``
PHASE_SCALE = 1.001


def logcf_phase_scaled():
    from repro_torch.kernels import pb_cf

    def make(orig):
        def scaled(*a, **k):
            la, an = orig(*a, **k)
            return la, an * PHASE_SCALE
        scaled.launches = getattr(orig, "launches", 0)
        return scaled
    return _patched(pb_cf, "logcf", make)


FAULTS = {"answer_altered": answer_altered,
          "half_rows_left_out": half_rows_left_out,
          "logcf_phase_scaled": logcf_phase_scaled}
#: the query families whose answers a fault reaches (None: every family)
REACHES = {"logcf_phase_scaled": ("q6",)}
