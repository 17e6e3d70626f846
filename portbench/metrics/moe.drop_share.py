"""moe.drop_share: the share of the MoE layers' routed assignments that
fell past an expert's capacity in their group, in %: 100 x the sum of
``moe_dropped`` over the sum of ``moe_assigned`` in the trainer's
``train.step`` spans (every layer's forward once a step; remat's
recompute is not counted again). The runner passes the spans of the
window's in-transit steps (every 2nd step), so the sums are over
those."""


def read(ctx):
    steps = [sp["args"] for sp in ctx.get("spans", ())
             if sp["name"] == "train.step" and sp["args"].get("moe_assigned")]
    if not steps:
        return None
    return 100.0 * sum(a["moe_dropped"] for a in steps) / \
        sum(a["moe_assigned"] for a in steps)
