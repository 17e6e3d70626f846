"""train.sync_ms: mean milliseconds per traced step in the trainer's
``train.sync`` span: the step's ``float()``s, the host waiting for the
card. The runner passes the spans of the window's in-transit steps
(every 2nd step), so the mean is over those."""
SPAN = "train.sync"


def read(ctx):
    durs = [sp["dur"] for sp in ctx.get("spans", ()) if sp["name"] == SPAN]
    return sum(durs) / len(durs) / 1e3 if durs else None
