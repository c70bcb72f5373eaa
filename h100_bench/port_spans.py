"""The port's own record of a traced stretch, for the per-layer readers.

While a profiler records, the port opens spans at its layer boundaries and
counts the synchronizing calls torch reports under the innermost one
(``mma_tpu_torch.utils.profiling``: ``RECORD``, one ``SpanRecord`` per
finished span with ``name``, ``parent``, ``root``, ``start_ns``,
``end_ns`` and ``counts``). A traffic kind's profiled stretch is its last
``units`` outermost spans of one name (``step`` for a training step,
``serve.call`` for a served call). A program without that record (one
older than it) gives None, and the readers report nothing.
"""

from __future__ import annotations

from typing import Callable, List, Optional


class Stretch:
    """The spans of the traced stretch's ``units`` outermost spans."""

    def __init__(self, spans: List, units: int):
        self.spans = spans
        self.units = units
        self._by_id = {s.id: s for s in spans}

    def _outermost(self, s, match: Callable[[str], bool]) -> bool:
        p = self._by_id.get(s.parent)
        while p is not None:
            if match(p.name):
                return False
            p = self._by_id.get(p.parent)
        return True

    def host_ms(self, match: Callable[[str], bool]) -> float:
        """Host time a unit, in ms, of the spans whose name ``match``es
        (nested matches counted once, by the outermost)."""
        picked = [s for s in self.spans if match(s.name) and self._outermost(s, match)]
        return sum((s.end_ns - s.start_ns) * 1e-6 for s in picked) / self.units

    def count(self, name: str) -> float:
        """Counter ``name`` a unit, summed over every span."""
        return sum(s.counts.get(name, 0) for s in self.spans) / self.units


def stretch(ctx, root: str) -> Optional[Stretch]:
    """The traced stretch of ``root`` spans, or None without a trace, without
    the port's record, or where the record lost part of the stretch."""
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
    roots = [s for s in spans if s.parent is None and s.name == root][-tr.units:]
    if len(roots) < tr.units:
        return None
    # A span enters the record when it closes: were spans dropped, those that
    # closed before the oldest kept one may belong to the stretch.
    if record.dropped and roots[0].start_ns < spans[0].end_ns:
        return None
    ids = {s.id for s in roots}
    return Stretch([s for s in spans if s.root in ids], tr.units)
