"""Per-step critical-path attribution from pipeline spans.

Every traced step leaves a family of spans — producer ``submit`` and
``stage.push``, lane ``stage.pop``/``reduce``/``write`` (possibly from
several contributor groups in parallel), ``device.*`` transfers,
``manifest.commit``, and checkpoint ``ckpt.*`` work. This module folds
them into one answer per step: *where did the wall time go?*

Two subtleties make this more than a per-name sum:

* **Parallelism.** Four lanes reducing concurrently spend 4x CPU but
  1x wall; attribution is over the *union* of each stage's time
  intervals, so a stage's share is the wall time during which at least
  one span of that stage was open — the quantity that actually gates
  step latency.
* **Partial steps.** A crashed lane leaves a step without its commit
  span. :class:`Attributor` keeps such steps pending and surfaces them
  with ``partial=True`` when asked (the run ledger flushes pending
  attribution on crash dumps), so a postmortem still shows where an
  interrupted step's time went.
"""
from __future__ import annotations

#: span name -> attribution stage; names absent here fall back to their
#: span ``cat`` (e.g. every ``ckpt.*`` span has cat="ckpt") and then to
#: the name's first dotted token
STAGE_OF_NAME = {
    "submit": "submit",
    "stage.push": "staging",
    "stage.pop": "staging",
    "reduce": "reduce",
    "write": "write",
    "manifest.commit": "commit",
}

STAGE_OF_CAT = {"ckpt": "ckpt", "device": "device", "serve": "serve"}

#: stages named by span-name prefix when neither table matches
_PREFIX_STAGES = ("device", "serve", "ckpt")


def stage_of(span: dict) -> str:
    """Attribution stage of one span dict."""
    name = span.get("name", "")
    st = STAGE_OF_NAME.get(name)
    if st is not None:
        return st
    st = STAGE_OF_CAT.get(span.get("cat", ""))
    if st is not None:
        return st
    head = name.split(".", 1)[0]
    return head if head in _PREFIX_STAGES else "other"


def union_seconds(intervals) -> float:
    """Total coverage of a list of ``(t0_us, t1_us)`` intervals."""
    if not intervals:
        return 0.0
    ivs = sorted(intervals)
    total = 0.0
    lo, hi = ivs[0]
    for a, b in ivs[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    total += hi - lo
    return total / 1e6


def attribute(step: int, spans: list[dict], *, partial: bool = False
              ) -> dict:
    """Fold one step's spans into a stage attribution dict."""
    by_stage: dict[str, list] = {}
    t_min, t_max = float("inf"), float("-inf")
    for sp in spans:
        t0 = float(sp.get("ts", 0.0))
        t1 = t0 + float(sp.get("dur", 0.0))
        t_min, t_max = min(t_min, t0), max(t_max, t1)
        by_stage.setdefault(stage_of(sp), []).append((t0, t1))
    stages = {st: round(union_seconds(ivs), 9)
              for st, ivs in sorted(by_stage.items())}
    total = max(0.0, (t_max - t_min) / 1e6) if spans else 0.0
    covered = union_seconds([iv for ivs in by_stage.values()
                             for iv in ivs])
    critical = max(stages, key=stages.get) if stages else None
    return {"step": int(step), "total_s": round(total, 9),
            "idle_s": round(max(0.0, total - covered), 9),
            "stages": stages, "critical": critical,
            "n_spans": len(spans), "partial": bool(partial)}


class Attributor:
    """Incremental per-step attribution over a span stream.

    Feed span batches with :meth:`ingest`; a step is *complete* once
    its ``manifest.commit`` (or ``ckpt.commit``) span arrives, at which
    point its attribution is returned and the buffered spans released.
    Steps older than ``max_pending`` completed steps are assumed
    abandoned and also flushed (partial) to bound memory.
    """

    #: spans that mark a step's pipeline as finished
    _TERMINAL = {"manifest.commit", "ckpt.commit"}

    def __init__(self, max_pending: int = 256):
        self._spans: dict[int, list[dict]] = {}
        self._done: set[int] = set()
        self.max_pending = int(max_pending)

    def ingest(self, spans) -> list[dict]:
        """Buffer new spans; returns attributions for completed steps."""
        completed = []
        for sp in spans:
            step = (sp.get("args") or {}).get("step")
            # the trainer's own step spans are not the pipeline's
            if step is None or sp.get("cat") == "train":
                continue
            step = int(step)
            self._spans.setdefault(step, []).append(sp)
            if sp.get("name") in self._TERMINAL:
                completed.append(step)
        out = [attribute(s, self._spans.pop(s))
               for s in dict.fromkeys(completed) if s in self._spans]
        self._done.update(a["step"] for a in out)
        # bound the pending set: steps far behind the newest completed
        # step will never finish (dropped parts, dead lanes)
        if len(self._spans) > self.max_pending:
            horizon = sorted(self._spans)[:-self.max_pending]
            out.extend(attribute(s, self._spans.pop(s), partial=True)
                       for s in horizon)
        return out

    def flush_pending(self) -> list[dict]:
        """Attribution for every incomplete step (crash-dump path)."""
        out = [attribute(s, spans, partial=True)
               for s, spans in sorted(self._spans.items())]
        self._spans.clear()
        return out

    @property
    def pending_steps(self) -> list[int]:
        return sorted(self._spans)
