"""Reduction of a ``torch.profiler`` trace to what the per-layer readers read.

A traffic kind profiles a short steady stretch inside the benchmark's own
spans (``record_function`` ranges named ``bench.*``, opened by
:func:`span` and by the module hooks of :class:`ModuleSpans`) and hands
the profiler to :func:`reduce_profile`. The reduction works on the
exported Chrome trace (the profiler's documented output format):

- device operations: the events of category ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``, with their device intervals;
- each device operation's launch on the host: the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``correlation`` id. An operation
  whose launch the trace does not hold takes the launch of the operation
  before it on its stream (one stream runs in launch order);
- spans: the ``bench.*`` annotations (forward), and for a module span the
  backward: every ``autograd::engine::evaluate_function`` whose
  ``Sequence number`` lies in the range of sequence numbers of the ops
  that the module's forward span holds (autograd numbers its nodes in
  creation order, so the layer's nodes are one range);
- a device operation belongs to the innermost span whose host interval,
  on the launching thread, holds its launch.

Busy time is the union of the device intervals inside the profiled
window (the ``bench.window`` span); idle gaps are the rest of the window,
each labelled by the innermost span that the host was in at the gap's
middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench."
BWD = "autograd::engine::evaluate_function"
TOP = 10


@contextlib.contextmanager
def span(name: str):
    """A benchmark span, ``bench.<name>``, seen by the profiler."""
    import torch

    with torch.profiler.record_function(PREFIX + name):
        yield


class ModuleSpans:
    """Forward hooks that open ``bench.<label>`` around each call of the
    given modules' forwards (the backward is found from the trace)."""

    def __init__(self, modules: Dict[str, "object"]):
        self._handles = []
        self._open: List = []
        for label, module in modules.items():
            self._handles.append(module.register_forward_pre_hook(self._enter(label)))
            self._handles.append(module.register_forward_hook(self._exit))

    def _enter(self, label: str):
        import torch

        def hook(module, args):
            rf = torch.profiler.record_function(PREFIX + label)
            rf.__enter__()
            self._open.append(rf)

        return hook

    def _exit(self, module, args, out):
        self._open.pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # us, device clock aligned to the host's
    end: float
    span: Optional[str]  # innermost bench span of its launch, without the prefix
    kernel: bool


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    gaps: List[Tuple[str, float]]  # (label, seconds)
    units: int  # steps or requests inside the window

    def device_seconds(self, span_prefix: Optional[str] = None, kernels_only: bool = False
                       ) -> float:
        """Summed device time of the operations (of spans whose name starts
        with ``span_prefix``, when given)."""
        tot = 0.0
        for op in self.ops:
            if kernels_only and not op.kernel:
                continue
            if span_prefix is not None and not (op.span or "").startswith(span_prefix):
                continue
            tot += op.end - op.start
        return tot * 1e-6

    def breakdown(self) -> Dict[str, List]:
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[short_name(op.name)] += (op.end - op.start) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        by_label: Dict[str, float] = defaultdict(float)
        for label, sec in self.gaps:
            by_label[label] += sec
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


_OP = re.compile(r"[A-Za-z_]\w*(?:kernel|Functor|_impl|_cuda)\w*")


def short_name(name: str) -> str:
    """A device operation's name without its parameter list and template
    arguments, keeping the operation named inside them:
    ``elementwise_kernel<where_kernel_impl>``."""
    name = name[5:] if name.startswith("void ") else name
    if "<" not in name:
        return re.sub(r"(?<=\w)\(.*$", "", name)
    base = name.split("<", 1)[0].split("::")[-1]
    inner = []
    for m in _OP.findall(name[len(name.split("<", 1)[0]):]):
        if m != base and m not in inner and not m.startswith("gpu_kernel_impl"):
            inner.append(m)
    return f"{base}<{','.join(inner[:2])}>" if inner else base


@dataclasses.dataclass
class _Span:
    name: str
    tid: object
    start: float
    end: float


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _module_backward_spans(events: Sequence[dict], fwd_spans: List[_Span]) -> List[_Span]:
    """Backward spans of the module spans: evaluate_function events whose
    sequence numbers lie in a forward span's range (see module docstring)."""
    ranges = []
    for sp in fwd_spans:
        seqs = [e["args"]["Sequence number"] for e in events
                if e.get("cat") == "cpu_op" and e["tid"] == sp.tid
                and "Sequence number" in e.get("args", {})
                and not e["name"].startswith(BWD)
                and sp.start <= e["ts"] <= sp.end]
        if seqs:
            ranges.append((min(seqs), max(seqs), sp.name))
    if not ranges:
        return []
    ranges.sort()
    lows = [r[0] for r in ranges]
    out = []
    for e in events:
        if e.get("cat") != "cpu_op" or not e["name"].startswith(BWD):
            continue
        seq = e.get("args", {}).get("Sequence number")
        if seq is None:
            continue
        i = bisect.bisect_right(lows, seq) - 1
        if i >= 0 and ranges[i][0] <= seq <= ranges[i][1]:
            out.append(_Span(ranges[i][2].replace(".fwd", ".bwd"), e["tid"], e["ts"],
                             e["ts"] + e.get("dur", 0.0)))
    return out


def reduce_events(events: Sequence[dict], units: int, module_spans: Sequence[str] = ()
                  ) -> Optional[Reduced]:
    """Reduce Chrome-trace events (see the module docstring). ``module_spans``
    names the span labels (without the prefix) whose backward is sought;
    their forward labels end in ``.fwd``. Returns None without a
    ``bench.window`` span or without device operations."""
    xs = [e for e in events if e.get("ph") == "X"]
    spans: List[_Span] = [
        _Span(e["name"][len(PREFIX):], e["tid"], e["ts"], e["ts"] + e.get("dur", 0.0))
        for e in xs if e.get("cat") in ("user_annotation", "cpu_op")
        and e["name"].startswith(PREFIX)]
    windows = [s for s in spans if s.name == "window"]
    if not windows:
        return None
    w0, w1 = windows[0].start, windows[0].end
    fwd = [s for s in spans if s.name in module_spans]
    spans += _module_backward_spans(xs, fwd)
    spans = [s for s in spans if s.name != "window"]

    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["ts"], e["tid"])
    dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    by_tid: Dict[object, List[_Span]] = defaultdict(list)
    for s in spans:
        by_tid[s.tid].append(s)

    def innermost(ts: float, tid) -> Optional[str]:
        best = None
        for s in by_tid.get(tid, ()):
            if s.start <= ts <= s.end and (best is None or s.end - s.start < best.end - best.start):
                best = s
        return best.name if best else None

    ops: List[DeviceOp] = []
    last_by_stream: Dict[object, Optional[str]] = {}
    for e in dev:
        s, t = e["ts"], e["ts"] + e.get("dur", 0.0)
        if t < w0 or s > w1:
            continue
        stream = (e.get("pid"), e.get("tid"))
        launch = launches.get(e.get("args", {}).get("correlation"))
        label = innermost(*launch) if launch else last_by_stream.get(stream)
        last_by_stream[stream] = label
        ops.append(DeviceOp(e["name"], max(s, w0), min(t, w1), label, e.get("cat") == "kernel"))
    if not ops:
        return None
    busy = _union((o.start, o.end) for o in ops)
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            mid = 0.5 * (prev + s)
            label = None
            best = None
            for sp in spans:
                if sp.start <= mid <= sp.end and (best is None or
                                                  sp.end - sp.start < best.end - best.start):
                    best = sp
            label = best.name if best else "outside spans"
            gaps.append((label, (s - prev) * 1e-6))
        prev = max(prev, e)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    return Reduced(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, ops=ops, gaps=gaps, units=units)


def reduce_profile(prof, units: int, module_spans: Sequence[str] = ()) -> Optional[Reduced]:
    """Export ``prof``'s Chrome trace to a temporary file, read it back,
    delete it and reduce it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, units, module_spans)
