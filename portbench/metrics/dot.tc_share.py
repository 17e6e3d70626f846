"""dot.tc_share: the share of the model's float32-result products that
ran on the tensor cores, in %: 100 x the sum of ``dot_tc`` over the sum
of ``dot_f32`` in the trainer's ``train.step`` spans (every such product
of the forward once a step; remat's recompute is not counted again). A
program without these counters gives nothing. The runner passes the
spans of the window's in-transit steps (every 2nd step), so the sums are
over those."""


def read(ctx):
    steps = [sp["args"] for sp in ctx.get("spans", ())
             if sp["name"] == "train.step" and sp["args"].get("dot_f32")]
    if not steps:
        return None
    return 100.0 * sum(a["dot_tc"] for a in steps) / \
        sum(a["dot_f32"] for a in steps)
