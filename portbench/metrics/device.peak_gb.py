"""device.peak_gb: ``torch.cuda.max_memory_allocated`` over the window,
after a reset at its start, in GB (1e9 bytes)."""


def read(ctx):
    peak = ctx.get("window_peak_bytes")
    return peak / 1e9 if peak else None
