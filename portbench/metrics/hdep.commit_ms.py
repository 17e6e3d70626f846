"""hdep.commit_ms: mean milliseconds per in-transit output of the
window in the engine's ``manifest.commit`` span: the HDep context's
finalize with its fsync."""
SPAN = "manifest.commit"


def read(ctx):
    durs = [sp["dur"] for sp in ctx.get("spans", ()) if sp["name"] == SPAN]
    return sum(durs) / len(durs) / 1e3 if durs else None
