"""moe.held_share: the share of the MoE layers' routed assignments that
went to the experts held on this card, in %: 100 x the sum of
``moe_held`` over the sum of ``moe_routed`` in the trainer's
``train.step`` spans (every layer's forward once a step; remat's
recompute is not counted again). Where a layer holds E_held of E
experts and the router spreads its load evenly, it reads 100 E_held /
E (12.5 % at 9 of 72); where every expert is held, 100. A program
without these counters gives nothing. The runner passes the spans of
the window's in-transit steps (every 2nd step), so the sums are over
those."""


def read(ctx):
    steps = [sp["args"] for sp in ctx.get("spans", ())
             if sp["name"] == "train.step" and sp["args"].get("moe_routed")]
    if not steps:
        return None
    return 100.0 * sum(a["moe_held"] for a in steps) / \
        sum(a["moe_routed"] for a in steps)
