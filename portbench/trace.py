"""The device trace of a ``--trace 1`` run, reduced to what the per-layer
metrics and the ``breakdown`` read.

``torch.profiler`` (CPU and CUDA activities) records the whole measured
window; its Chrome trace is written to a temporary file under ``TMPDIR``,
read once and deleted.  Kept from it:

* device activity: kernels, copies and memsets (name, start, end,
  correlation id);
* the benchmark's host ranges (``record_function`` names starting with
  ``portbench.``): the window, each query or sweep, each instrumented
  kernel call (name, start, end, thread);
* host launch calls (CUDA runtime and driver: start, thread, correlation
  id), which tie a device operation to the host range that launched it.

Times are in seconds on the profiler's clock.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

WINDOW = "portbench.window"
QUERY = "portbench.query."
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def capture(holder: dict):
    """Profile the body; ``holder["trace"]`` is then the :class:`Trace`."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    holder["trace"] = Trace(events)


class Trace:
    def __init__(self, events: list):
        self.device, self.ranges, self.launches = [], [], []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat is None:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0)) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in _DEVICE:
                self.device.append((e["name"], t0, t1, corr))
            elif cat == "user_annotation" and e["name"].startswith(
                    "portbench."):
                self.ranges.append((e["name"], t0, t1, e.get("tid")))
            elif cat in _LAUNCH and corr is not None:
                self.launches.append((t0, e.get("tid"), corr))
        self.device.sort(key=lambda d: d[1])

    def window(self) -> tuple:
        spans = [(a, b) for n, a, b, _ in self.ranges if n == WINDOW]
        return spans[0] if spans else (None, None)

    def busy_intervals(self) -> list:
        """The union of device activity inside the window."""
        w0, w1 = self.window()
        out: list = []
        for _, a, b, _ in self.device:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self) -> float:
        w0, w1 = self.window()
        return w1 - w0

    def idle_gaps(self) -> list:
        """[(start, end)] of the window where the device ran nothing."""
        w0, w1 = self.window()
        gaps, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        return gaps

    def range_device_s(self, name: str) -> float:
        """Device seconds of the operations launched from inside the host
        ranges called ``name`` (on the range's thread)."""
        spans = sorted((a, b, tid) for n, a, b, tid in self.ranges
                       if n == name)
        if not spans:
            return 0.0
        starts = [a for a, _, _ in spans]
        corrs = set()
        for t0, tid, corr in self.launches:
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t0 <= spans[i][1] and tid == spans[i][2]:
                corrs.add(corr)
        return sum(b - a for _, a, b, c in self.device if c in corrs)

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]]: the device operations that took most time."""
        tot: dict = {}
        for n, a, b, _ in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a)
        return [[n[:160], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_by_query(self, top: int = 10) -> list:
        """[[label, seconds]]: the window's idle time summed by what the
        host was running (the query or sweep range around the gap's
        start; "between" outside any), largest first."""
        qs = sorted((a, b, n[len(QUERY):]) for n, a, b, _ in self.ranges
                    if n.startswith(QUERY))
        starts = [a for a, _, _ in qs]
        tot: dict = {}
        for a, b in self.idle_gaps():
            i = bisect.bisect_right(starts, a) - 1
            label = qs[i][2] if i >= 0 and a < qs[i][1] else "between"
            tot[label] = tot.get(label, 0.0) + (b - a)
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
