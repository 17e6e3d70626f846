"""train.host_syncs: mean synchronizing CUDA calls per traced step, of
the training thread and the autograd engine's (``host_syncs`` of the
trainer's ``train.step`` span, counted with torch's sync debug mode:
the batch's upload, the ``float()``s, and any the forward, the backward
or remat's recompute makes). The runner passes the spans of the
window's in-transit steps (every 2nd step), so the mean is over those."""


def read(ctx):
    n = [sp["args"]["host_syncs"] for sp in ctx.get("spans", ())
         if sp["name"] == "train.step" and "host_syncs" in sp["args"]]
    return sum(n) / len(n) if n else None
