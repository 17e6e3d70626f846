"""device.idle_share: the share of the traced window in which no
operation ran on the card (1 - union of the profiler's device intervals
over the window), in %."""


def read(ctx):
    if not ctx.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
