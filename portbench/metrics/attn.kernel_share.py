"""attn.kernel_share: the share of the model's attention calls that the
fused attention kernel took, in %: 100 x the sum of ``attn_kernel`` over
the sum of ``attn_calls`` in the trainer's ``train.step`` spans (every
layer's forward once a step; remat's recompute is not counted again).
A program without these counters gives nothing. The runner passes the
spans of the window's in-transit steps (every 2nd step), so the sums are
over those."""


def read(ctx):
    steps = [sp["args"] for sp in ctx.get("spans", ())
             if sp["name"] == "train.step" and sp["args"].get("attn_calls")]
    if not steps:
        return None
    return 100.0 * sum(a["attn_kernel"] for a in steps) / \
        sum(a["attn_calls"] for a in steps)
