"""block.head_ms: mean stream milliseconds per traced step in the trainer's
``block.head`` span: the final norm, the unembedding and the loss,
forward and backward, on the card's stream (CUDA events;
``repro_torch.models.probe``). This is the stream's time in the region,
not the card's busy time: time the card sat idle there, waiting for the
host, counts too. The runner passes the spans of the window's in-transit
steps (every 2nd step), so the mean is over those."""
SPAN = "block.head"


def read(ctx):
    ms = [sp["args"]["device_ms"] for sp in ctx.get("spans", ())
          if sp["name"] == SPAN]
    return sum(ms) / len(ms) if ms else None
