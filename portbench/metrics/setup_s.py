"""setup_s: seconds from process start to the start of the window
(imports, CUDA context, weights made on the card, the engine's start and
the warm-up steps)."""


def read(ctx):
    if ctx.get("setup_end") is None:
        return None
    return ctx["setup_end"] - ctx["t0"]
