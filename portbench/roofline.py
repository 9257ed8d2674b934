"""The yardstick of the kernels' roofline shares: the card's peaks and
the work each kernel call needs.

Peaks: NVIDIA's H100 SXM data sheet (dense rates at the full 700 W power
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores.  A share is stated against them with the card's power limit
beside it.

A call's least time is the larger of its bytes over the bandwidth and
its operations over the float32 rate, counted from what these inputs
need, not from what a launch happens to do (the kernels' own ``cost``
functions count every tuple live; ``chip_smoke.py`` holds the same
formulas):

* bytes: every input element the call is handed read once, every output
  element written once;
* operations: live tuples (p > 0) times the operations a tuple costs:
  ``OPS_PER_PAIR`` = 11 for each (tuple, frequency) pair of a CF sum
  (re = q + p cos, im = p sin, |.|^2, the clamp, log, atan2, two adds;
  a transcendental counts one), over the N/2 + 1 frequencies the scalar
  CF computes (the rest are mirrored) or the grouped CF's window;
  O^2 + 4 O - 1 a tuple for O cumulant orders (Horner over each
  kappa_j, the powers of v, the accumulating FMAs).

While a traced run's window is open, :class:`Instrument` wraps the kernel
entry points that the cell's metrics name (module attributes, which the
program's call sites look up at call time), counts each call's work and
marks the call with a ``record_function`` range ``portbench.kernel.<name>``
that the trace attributes device time to.
"""
from __future__ import annotations

import importlib

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_PAIR = 11
RANGE = "portbench.kernel."


def cumulant_ops(orders: int) -> int:
    return orders * orders + 4 * orders - 1


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def logcf_work(probs, values, *, num_freq, freq_lo=0, freq_cnt=None):
    """(live tuples tensor, operations a live tuple, bytes) of
    ``pb_cf.logcf``: the N/2 + 1 computed frequencies (or the window),
    two float32 output rows of N (or of the window)."""
    half = num_freq // 2 + 1
    cnt = half if freq_cnt is None else freq_cnt
    out = num_freq if freq_cnt is None else freq_cnt
    return (torch.count_nonzero(probs), cnt * OPS_PER_PAIR,
            _nbytes(probs, values) + 2 * out * 4)


def group_logcf_work(probs, values, gids, *, num_groups, num_freq,
                     freq_lo=0, freq_cnt=None, operands=None):
    """``group_cf.group_logcf``: the frequency window of every group, two
    float32 (num_groups, window) outputs; with ``operands`` the inputs
    are the presorted probabilities, phases and group ids."""
    if freq_cnt is None:
        freq_cnt = num_freq - freq_lo
    if operands is not None:
        probs, values, gids = operands[0], operands[1], operands[3]
    return (torch.count_nonzero(probs), freq_cnt * OPS_PER_PAIR,
            _nbytes(probs, values, gids) + 2 * num_groups * freq_cnt * 4)


def group_cumulant_sums_work(probs, values, gids, *, num_groups, orders=8,
                             operands=None):
    """``group_cumulants.group_cumulant_sums``: a float32 (num_groups,
    orders) output."""
    if operands is not None:
        probs, values, gids = operands
    return (torch.count_nonzero(probs), cumulant_ops(orders),
            _nbytes(probs, values, gids) + num_groups * orders * 4)


def bound_seconds(calls: list) -> float:
    """Sum over calls of max(bytes / bandwidth, operations / rate);
    ``calls`` holds (operations, bytes) on the host."""
    return sum(max(b / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
               for ops, b in calls)


class Instrument:
    """Context manager: wrap ``(module, attribute, work)`` entry points,
    collect each call's work; ``calls()`` after the window gives
    {attribute: [(operations, bytes)]} on the host."""

    def __init__(self, targets: list):
        self.targets = targets
        self._saved: list = []
        self._calls: dict = {attr: [] for _, attr, _ in targets}

    def __enter__(self):
        for modname, attr, work in self.targets:
            mod = importlib.import_module(modname)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, attr, work))
        return self

    def _wrap(self, orig, attr, work):
        calls = self._calls[attr]

        def wrapped(*args, **kwargs):
            calls.append(work(*args, **kwargs))
            with torch.profiler.record_function(RANGE + attr):
                return orig(*args, **kwargs)
        # the wrappers count their launches on their own global name
        wrapped.launches = getattr(orig, "launches", 0)
        return wrapped

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            wrapped = getattr(mod, attr)
            orig.launches = getattr(wrapped, "launches", 0)
            setattr(mod, attr, orig)
        return False

    def calls(self) -> dict:
        out = {}
        for attr, rows in self._calls.items():
            if not rows:
                out[attr] = []
                continue
            live = torch.stack([r[0] for r in rows]).tolist()
            out[attr] = [(n * per, b)
                         for n, (_, per, b) in zip(live, rows)]
        return out


def share(ctx: dict, attr: str):
    """Percent of its roofline that the calls of kernel entry ``attr`` in
    the traced window reached, or None when none ran."""
    calls = ctx["calls"].get(attr)
    trace = ctx["trace"]
    if not calls or trace is None:
        return None
    device_s = trace.range_device_s(RANGE + attr)
    if device_s <= 0:
        return None
    return 100.0 * bound_seconds(calls) / device_s
