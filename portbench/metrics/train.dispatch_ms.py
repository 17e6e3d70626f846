"""train.dispatch_ms: mean milliseconds per traced step in the trainer's
``train.dispatch`` span: the host builds the batch and queues the
forward, the backward and AdamW, up to the first ``float()`` of the
step's metrics. The runner passes the spans of the window's in-transit
steps (every 2nd step), so the mean is over those."""
SPAN = "train.dispatch"


def read(ctx):
    durs = [sp["dur"] for sp in ctx.get("spans", ()) if sp["name"] == SPAN]
    return sum(durs) / len(durs) / 1e3 if durs else None
