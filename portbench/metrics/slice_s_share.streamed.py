"""Share of the window the streamed executor's worker spent cutting slabs
into its pinned buffers on the host (``plans.stream_stats()["slice_s"]``
over the window)."""


def read(ctx):
    st = ctx["stream_stats"]
    if not st.get("waves"):
        return None
    return 100.0 * st["slice_s"] / ctx["window_s"]
