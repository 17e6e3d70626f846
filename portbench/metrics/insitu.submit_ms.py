"""insitu.submit_ms: mean milliseconds per in-transit output of the
window in the engine's ``submit`` span, on the training thread: staging
the state's clone on the card, the stall the trainer pays an output."""
SPAN = "submit"


def read(ctx):
    durs = [sp["dur"] for sp in ctx.get("spans", ()) if sp["name"] == SPAN]
    return sum(durs) / len(durs) / 1e3 if durs else None
