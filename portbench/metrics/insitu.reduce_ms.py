"""insitu.reduce_ms: mean milliseconds per in-transit output of the
window in the lane's ``reduce`` span: the device reducers and the
reduced objects' copy to the host."""
SPAN = "reduce"


def read(ctx):
    durs = [sp["dur"] for sp in ctx.get("spans", ()) if sp["name"] == SPAN]
    return sum(durs) / len(durs) / 1e3 if durs else None
