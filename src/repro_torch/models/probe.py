"""What a traced training step measures inside the model and the step.

``Trainer.run`` makes a :class:`StepProbe` the step's :data:`ACTIVE`
probe while ``obs.TRACER`` is enabled; otherwise :data:`ACTIVE` is
``None`` and each call site below costs one attribute read.

- **Stream time per block kind.** The model marks each region of a
  step (``block.embed``, ``block.attention``, ``block.ffn`` or the
  mixer's own kind, ``block.head``, ``train.adamw``) with a stamp on the
  current stream: a CUDA event on the card, the host clock on the CPU,
  where ops are synchronous. :meth:`StepProbe.enter` and
  :meth:`StepProbe.exit` wrap the region's input and output in identity
  ``autograd.Function``\\ s, so the backward stamps the region too: its
  output's gradient arrives first (``exit``'s backward), its input's
  leaves last (``enter``'s backward). Each stamp says which region the
  stream works on from there to the next stamp, so a region's time is
  exclusive: under ``remat: full`` the recompute, which runs inside the
  backward of the layer's last region, is given to the regions it
  recomputes, and the stream returns to the backward's region after
  each. A region's time is the stream's time from its stamps to the
  next, so it holds the time the card sat idle there as well as the
  time it worked (the profiler's trace tells them apart).
  :meth:`StepProbe.device_times` reads the stamps after the step's own
  sync and adds no sync.
- **Attention route.** ``attention.multihead`` counts its calls and
  those the fused kernel took (:meth:`StepProbe.count_attention`), once
  per forward (not in remat's recompute), on the host.
- **Float32-result products.** ``layers.dot`` counts its products with
  a float32 result and those that took the tensor cores
  (:meth:`StepProbe.count_dot`), once per forward (not in remat's
  recompute), on the host.
- **MoE routing.** ``moe._dispatch`` counts the step's routed
  assignments, those to the experts held here and those of them past
  an expert's capacity in their group (:meth:`StepProbe.count_moe`),
  on the device, once per forward (not in remat's recompute), summed
  over microbatches.
"""
from __future__ import annotations

import collections
import contextlib

import torch

from ..obs.trace import now_us

#: the probe of the traced step in progress, else None
ACTIVE = None


def in_backward() -> bool:
    """True inside the autograd engine: remat's recompute calls the
    forward from there."""
    return torch._C._current_graph_task_id() != -1


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, probe, kind):
        ctx.probe = probe
        probe._stamp(kind)
        if not in_backward():
            probe.calls[kind] += 1
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.probe._bwd_kind = None
        ctx.probe._stamp(None)
        return g, None, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, probe, kind):
        ctx.probe, ctx.kind = probe, kind
        # a recompute hands the stream back to the backward's region
        probe._stamp(probe._bwd_kind if in_backward() else None)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.probe._bwd_kind = ctx.kind
        ctx.probe._stamp(ctx.kind)
        return g, None, None


class StepProbe:
    """One training step's stamps and MoE counters (see the module)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._events: list = []         # CUDA events, reused step to step
        self.reset()

    def reset(self) -> None:
        self._stamps: list = []         # (event or None, region or None,
        #                                   host us on TRACER's clock)
        self._bwd_kind = None
        self.calls: collections.Counter = collections.Counter()
        self.moe_routed = 0
        self._moe_held = self._moe_dropped = None
        self.attn_calls = self.attn_kernel = 0
        self.dot_f32 = self.dot_tc = 0

    @contextlib.contextmanager
    def active(self):
        """This probe as :data:`ACTIVE` for the block."""
        global ACTIVE
        self.reset()
        ACTIVE = self
        try:
            yield self
        finally:
            ACTIVE = None

    # ------------------------------------------------------------ stamps
    def _stamp(self, region) -> None:
        ev = None
        if self.cuda:
            i = len(self._stamps)
            if i == len(self._events):
                self._events.append(torch.cuda.Event(enable_timing=True))
            ev = self._events[i]
            ev.record()
        self._stamps.append((ev, region, now_us()))

    def enter(self, kind: str, x):
        """``x``, marked as the input of a ``kind`` region."""
        return _Enter.apply(x, self, kind)

    def exit(self, kind: str, x):
        """``x``, marked as the output of a ``kind`` region."""
        return _Exit.apply(x, self, kind)

    def mark(self, kind) -> None:
        """The stream works on ``kind`` from here (``None``: on no
        region); for a region with no backward."""
        if kind is not None and not in_backward():
            self.calls[kind] += 1
        self._stamp(kind)

    def device_times(self) -> dict:
        """{region: (stream ms, forward calls, host us of its first
        stamp)} of the step, in the order the regions were first met;
        call after the step's sync."""
        ms: dict = {}
        first: dict = {}
        for (a, region, t), (b, _, u) in zip(self._stamps,
                                             self._stamps[1:]):
            if region is None:
                continue
            d = a.elapsed_time(b) if self.cuda else (u - t) / 1e3
            ms[region] = ms.get(region, 0.0) + d
            first.setdefault(region, t)
        return {k: (v, self.calls[k], first[k]) for k, v in ms.items()}

    # ------------------------------------------------------ MoE counters
    def count_moe(self, per_expert, cap: int, routed: int,
                  share: bool = False) -> None:
        """Add one dispatch's routing: ``routed`` assignments (groups x
        tokens x k, a host number), ``per_expert`` of them per (group,
        held expert) on the device, of which those past ``cap`` are
        dropped. With ``share`` the layer holds only some of the experts
        and the held ones' assignments are counted on the device; else
        every routed assignment is held."""
        if in_backward():
            return
        self.moe_routed += routed
        held = per_expert.sum() if share else routed
        dropped = torch.clamp(per_expert - cap, min=0).sum()
        if self._moe_dropped is None:
            self._moe_held, self._moe_dropped = held, dropped
        else:
            self._moe_held = self._moe_held + held
            self._moe_dropped = self._moe_dropped + dropped

    def moe_counts(self) -> dict:
        """{"moe_routed", "moe_held", "moe_assigned", "moe_dropped"}
        where the step routed any token, else {}: every routed
        assignment, those to held experts (the ones dispatched here,
        also under their older name ``moe_assigned``) and those of them
        dropped; reads the device after the step's sync."""
        if self._moe_dropped is None:
            return {}
        held = int(self._moe_held)
        return {"moe_routed": self.moe_routed, "moe_held": held,
                "moe_assigned": held, "moe_dropped": int(self._moe_dropped)}

    # ------------------------------------------------ attention counters
    def count_attention(self, kernel: bool) -> None:
        """Add one attention call of the step's forward, taken by the
        fused kernel or not."""
        if in_backward():
            return
        self.attn_calls += 1
        self.attn_kernel += int(kernel)

    def attn_counts(self) -> dict:
        """{"attn_calls", "attn_kernel"} where the step attended, else
        {}."""
        if not self.attn_calls:
            return {}
        return {"attn_calls": self.attn_calls,
                "attn_kernel": self.attn_kernel}

    # ---------------------------------------------------- product counters
    def count_dot(self, tensor_cores: bool) -> None:
        """Add one float32-result product of the step's forward, taken by
        the tensor cores (``layers._BF16F32Dot``) or not."""
        if in_backward():
            return
        self.dot_f32 += 1
        self.dot_tc += int(tensor_cores)

    def dot_counts(self) -> dict:
        """{"dot_f32", "dot_tc"} where the step made a float32-result
        product, else {}."""
        if not self.dot_f32:
            return {}
        return {"dot_f32": self.dot_f32, "dot_tc": self.dot_tc}
