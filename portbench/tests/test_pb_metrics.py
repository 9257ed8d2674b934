"""Each per-layer metric reader on a synthetic trace and synthetic
counters."""
import pytest

from portbench import roofline, trace as T
from portbench.harness import Manifest
from portbench.tests.tiny import ROOT

US = 1e6


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts * US,
            "dur": dur * US, "tid": 1, "args": args}


def _trace():
    """A 10 s window: 4 s of kernels (one overlapping pair), a 1 s logcf
    call whose two kernels take 0.5 s, a query range over the first 6 s."""
    return T.Trace([
        _ev("user_annotation", T.WINDOW, 0, 10),
        _ev("user_annotation", T.QUERY + "q1", 0, 6),
        _ev("user_annotation", roofline.RANGE + "logcf", 1, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 1.1, 0.01, correlation=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 1.2, 0.01, correlation=8),
        _ev("cuda_runtime", "cudaLaunchKernel", 3.0, 0.01, correlation=9),
        _ev("kernel", "cf_partial", 1.2, 0.3, correlation=7),
        _ev("kernel", "cf_mirror_sum", 1.5, 0.2, correlation=8),
        _ev("kernel", "indexing_backward", 3.0, 2.0, correlation=9),
        _ev("kernel", "other", 4.5, 1.0, correlation=10),
        _ev("gpu_memcpy", "Memcpy HtoD", 8.0, 0.5, correlation=11),
    ])


def _reader(name):
    return Manifest(ROOT).metric(name)


def test_trace_reduction():
    t = _trace()
    assert t.window_s() == pytest.approx(10)
    # 1.2-1.7, 3.0-5.5, 8.0-8.5
    assert t.busy_s() == pytest.approx(0.5 + 2.5 + 0.5)
    assert t.range_device_s(roofline.RANGE + "logcf") == pytest.approx(0.5)
    assert t.device_ops()[0] == ["indexing_backward", pytest.approx(2.0)]
    idle = dict(t.idle_by_query())
    # gaps labelled by what ran at their start
    assert idle["q1"] == pytest.approx(1.2 + 1.3 + 2.5)
    assert idle["between"] == pytest.approx(1.5)


@pytest.mark.parametrize("name", ["device_idle_share.queries",
                                  "device_idle_share.streamed",
                                  "device_idle_share.sweep"])
def test_idle_share(name):
    ctx = {"trace": _trace()}
    assert _reader(name).read(ctx) == pytest.approx(65.0)
    assert _reader(name).read({"trace": None}) is None


def test_roofline_share():
    # 1e12 operations: 1e12 / 67e12 s against 0.5 s of device time
    ctx = {"trace": _trace(), "calls": {"logcf": [(1e12, 1e6)]}}
    for name in ("logcf_roofline", "logcf_roofline.streamed"):
        got = _reader(name).read(ctx)
        assert got == pytest.approx(
            100 * (1e12 / roofline.F32_OPS_PER_S) / 0.5)
    assert _reader("group_logcf_roofline").read(ctx) is None
    assert _reader("group_cumulant_sums_roofline").read(
        dict(ctx, calls={})) is None


def test_work_counts():
    import torch
    p = torch.tensor([0.0, 0.5, 0.25, 0.0])
    v = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    live, per, nbytes = roofline.logcf_work(p, v, num_freq=16)
    assert int(live) == 2 and per == 9 * roofline.OPS_PER_PAIR
    assert nbytes == 4 * 4 + 4 * 8 + 2 * 16 * 4
    g = torch.zeros(4, dtype=torch.int64)
    live, per, nbytes = roofline.group_logcf_work(
        p, v, g, num_groups=3, num_freq=16, freq_lo=2, freq_cnt=5)
    assert per == 5 * roofline.OPS_PER_PAIR
    assert nbytes == 4 * (4 + 8 + 8) + 2 * 3 * 5 * 4
    live, per, nbytes = roofline.group_cumulant_sums_work(
        p, v.float(), g, num_groups=3, orders=8)
    assert per == 95 and nbytes == 4 * (4 + 4 + 8) + 3 * 8 * 4
    assert roofline.bound_seconds([(67e12, 0), (0, 3.35e12)]) == \
        pytest.approx(2.0)


def test_streamed_counters():
    st = {"slab_bytes": 50e9, "copy_s": 2.0, "slice_s": 1.5, "waves": 32}
    ctx = {"stream_stats": st, "window_s": 30.0}
    assert _reader("h2d_gb_per_s.streamed").read(ctx) == pytest.approx(25)
    assert _reader("slice_s_share.streamed").read(ctx) == pytest.approx(5)
    empty = {"stream_stats": {"slab_bytes": 0, "copy_s": 0.0,
                              "slice_s": 0.0, "waves": 0}, "window_s": 1.0}
    assert _reader("h2d_gb_per_s.streamed").read(empty) is None
    assert _reader("slice_s_share.streamed").read(empty) is None
