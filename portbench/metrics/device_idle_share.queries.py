"""Share of the measured window in which the device ran nothing, while
queries ran (the device trace: 1 - union of device activity / window)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.window_s() > 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
