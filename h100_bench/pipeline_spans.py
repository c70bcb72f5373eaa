"""The sampled pipeline's spans in the port's record, for the readers of the
``sampling pipeline`` layer.

The producer thread's batches are thread roots of their own
(``sampled.produce`` > ``sampled.sample``, and ``sampled.ship`` after a
host draw), which
``port_spans.stretch`` does not keep: it keeps the spans rooted in the
stretch's ``step`` roots. Each traced step makes one consumer wait
(``sampled.wait``, a root opened before the step's span), so the traced
stretch is its last ``units`` waits, and it runs from the first of them to
the end of the last ``step`` root. A program without these spans (one
older than them) gives None, and the readers report nothing.
"""

from __future__ import annotations

from typing import List, Optional


class Pipeline:
    """The traced stretch's consumer waits and the producer batches that
    closed inside it, each with its spans."""

    def __init__(self, spans: List, waits: List, produced: List, units: int):
        self.waits = waits
        self.produced = produced
        self.units = units
        self._children = {}
        for s in spans:
            if s.parent is not None:
                self._children.setdefault(s.parent, []).append(s)

    def wait_ms(self) -> float:
        """Host time a step blocked on the producer's queue (ms)."""
        return sum(s.end_ns - s.start_ns for s in self.waits) * 1e-6 / self.units

    def part_ms(self, name: str) -> Optional[float]:
        """Host time of the producer's part ``name`` a batch (ms), over the
        batches that closed inside the stretch; None without one."""
        if not self.produced:
            return None
        tot = sum(c.end_ns - c.start_ns for p in self.produced
                  for c in self._children.get(p.id, ()) if c.name == name)
        return tot * 1e-6 / len(self.produced)


def pipeline(ctx) -> Optional[Pipeline]:
    """The traced stretch's pipeline spans, or None without a trace, without
    the port's record or these spans, or where the record lost part of the
    stretch."""
    tr = ctx.get("trace")
    if tr is None or tr.units <= 0:
        return None
    try:
        from mma_tpu_torch.utils import profiling
    except ImportError:
        return None
    record = getattr(profiling, "RECORD", None)
    if record is None:
        return None
    spans = list(record.spans)
    roots = [s for s in spans if s.parent is None]
    waits = [s for s in roots if s.name == "sampled.wait"][-tr.units:]
    steps = [s for s in roots if s.name == "step"]
    if len(waits) < tr.units or not steps or steps[-1].end_ns < waits[-1].end_ns:
        return None
    # A span enters the record when it closes: were spans dropped, those that
    # closed before the oldest kept one may belong to the stretch.
    if record.dropped and waits[0].start_ns < spans[0].end_ns:
        return None
    start, end = waits[0].start_ns, steps[-1].end_ns
    produced = [s for s in roots if s.name == "sampled.produce" and start <= s.end_ns <= end]
    return Pipeline(spans, waits, produced, tr.units)
