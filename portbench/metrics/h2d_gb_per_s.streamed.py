"""Host-to-device rate of the streamed executor's slab copies over the
window: the program's counters ``plans.stream_stats()``, slab bytes over
the device seconds of the copies (CUDA events)."""


def read(ctx):
    st = ctx["stream_stats"]
    if not st.get("copy_s"):
        return None
    return st["slab_bytes"] / st["copy_s"] / 1e9
