"""train_tokens_per_s: the tokens of every step that finished in the
window, over the time from the window's start to the end of the last of
them (host clock, after each step's sync)."""


def read(ctx):
    ends = ctx.get("window_ends")
    if not ends:
        return None
    return len(ends) * ctx["tokens_per_step"] / (ends[-1] - ctx["setup_end"])
