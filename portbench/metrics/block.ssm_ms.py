"""block.ssm_ms: mean stream milliseconds per traced step in the trainer's
``block.ssm`` span: ``ln1`` through the Mamba-2 mixer (projections, the
conv over x, B and C, the chunked SSD, the gated norm, the output
projection) and its residual add, forward, remat's recompute and
backward, summed over the Mamba-2 layers on the card's stream (CUDA
events; ``repro_torch.models.probe``). The MoE that follows each mixer
is ``block.ffn``'s. This is the stream's time in the region, not the
card's busy time: time the card sat idle there, waiting for the host,
counts too. The runner passes the spans of the window's in-transit steps
(every 2nd step), so the mean is over those. A program without the span
gives nothing."""
SPAN = "block.ssm"


def read(ctx):
    ms = [sp["args"]["device_ms"] for sp in ctx.get("spans", ())
          if sp["name"] == SPAN]
    return sum(ms) / len(ms) if ms else None
