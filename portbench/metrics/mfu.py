"""mfu: model FLOPs of the window's steps (the configuration's
reference module's ``train_flops_per_token``) per second of the window,
as a share of the card's bf16 dense peak (``yardstick.PEAKS``), in %."""
from portbench import yardstick


def read(ctx):
    ends = ctx.get("window_ends")
    peak = yardstick.PEAKS.get(ctx.get("device_kind"), {}).get("bf16_flops")
    if not ends or peak is None or ctx.get("flops_per_step") is None:
        return None
    rate = len(ends) * ctx["flops_per_step"] / (ends[-1] - ctx["setup_end"])
    return 100.0 * rate / peak
