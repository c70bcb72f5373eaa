"""Tracing and profiling helpers: the port's one tracer.

The port of the JAX package's ``mma_tpu/utils/profiling.py`` (the
reference has only wall-clock prints):

- ``trace(name)``: a span. It does nothing unless a ``torch.profiler`` is
  recording (the off path is one check of
  ``torch.autograd._profiler_enabled()``). While one records, the span is
  a ``record_function`` range, so it lies in the profiler's trace beside
  the device operations, and a :class:`SpanRecord` in :data:`RECORD`:
  name, parent span, thread, start and end on ``time.perf_counter_ns()``.
  The spans opened inside an outermost span share its id (``root``). A
  span opened on a thread with no open span of its own (the autograd
  engine's device thread during ``backward``) takes the innermost open
  span of the thread that opened the outermost one as its parent.
- ``trace(name, thread_root=True)``: an outermost span of its own thread,
  for work that runs beside the step on a plain thread (the sampled
  pipeline's producer). A plain thread does not take the profiler's state
  along, so such a span records while any profiler of the process records
  (``torch.autograd.profiler._is_profiler_enabled``), and the spans opened
  inside it on its thread record with it. It joins no other thread's tree
  and leaves the sync counter alone.
- ``count(name, n)``: adds ``n`` to counter ``name`` of the innermost open
  span (nothing without one).
- The sync counter: while an outermost span records on a process that has
  used CUDA, torch's sync debug mode is set to ``"warn"``, and each
  synchronizing call that torch reports counts as ``"sync"`` on the
  innermost open span. The mode and the warning filters are restored when
  the outermost span closes, so syncs outside the port's spans are never
  counted.
- ``profile_to(log_dir)``: profile the enclosed block (CPU, and the card
  when there is one) and write a Chrome trace into ``log_dir``
  (``chrome://tracing`` or Perfetto opens it); it holds the spans on the
  device operations' timeline.
- ``annotate_fn(name)``: the decorator form of ``trace``.

Span names are ``<layer>.<part>``: ``step`` (``step.forward``,
``step.loss``, ``step.backward``, ``step.optimizer``), ``gcn.layer``,
``mma.layer``, ``serve.call`` (``serve.check``, ``serve.inputs``,
``serve.graph``), ``sampled.produce`` (``sampled.sample``, ``sampled.ship``)
on the sampled pipeline's producer thread and ``sampled.wait``,
``sampled.finish``, ``sampled.assemble`` on its consumer,
``kernel.<LAUNCHES key>`` and ``sync.<what>`` around each call on a step's
or a request's path that waits for the card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

# Spans the record keeps; older ones are dropped and counted.
CAPACITY = 1 << 16
# The start of the message of torch's sync debug mode.
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class SpanRecord:
    """One finished span. Times are ``time.perf_counter_ns()``; ``parent``
    and ``root`` are span ids (``parent`` None for an outermost span, whose
    ``root`` is its own id); ``counts`` holds the counters that landed on
    it."""

    id: int
    name: str
    parent: Optional[int]
    root: int
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Record:
    """The bounded record of finished spans, oldest first: a span is added
    when it closes. ``dropped`` counts the spans pushed out past
    ``capacity``."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0

    def add(self, span: SpanRecord) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(span)

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0


RECORD = Record()

_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


# The open spans of the thread that opened the outermost open span: a thread
# with no open span of its own opens its spans under the innermost of these.
_root_stack: Optional[List[SpanRecord]] = None


def _stack() -> List[SpanRecord]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _innermost() -> Optional[SpanRecord]:
    stack = _stack()
    if stack:
        return stack[-1]
    return _root_stack[-1] if _root_stack else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    span = _innermost()
    if span is not None:
        span.counts[name] = span.counts.get(name, 0) + n


def open_span() -> Optional[SpanRecord]:
    """The record of the span :func:`count` would count on (None unless one
    records here): for counts known only after the span has closed."""
    return _innermost()


class _SyncCounter:
    """Counts torch's sync debug warnings on the innermost open span while
    an outermost span is open (see the module docstring)."""

    def __init__(self):
        self.on = torch.cuda.is_initialized()

    def __enter__(self):
        if not self.on:
            return
        self.catch = warnings.catch_warnings()
        self.catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.show = warnings.showwarning
        warnings.showwarning = self._show
        self.mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            count("sync")
        else:
            self.show(message, category, filename, lineno, file, line)

    def __exit__(self, *exc):
        if not self.on:
            return
        torch.cuda.set_sync_debug_mode(self.mode)
        self.catch.__exit__(*exc)


class _Span:
    __slots__ = ("name", "rec", "rf", "sync", "thread_root")

    def __init__(self, name: str, thread_root: bool = False):
        self.name = name
        self.sync = None
        self.thread_root = thread_root

    # A span's interval holds its own bookkeeping, so that spans opened one
    # after another cover their parent's interval between them.
    def __enter__(self):
        global _root_stack
        start = time.perf_counter_ns()
        stack = _stack()
        parent = None if self.thread_root else _innermost()
        sid = next(_ids)
        self.rec = SpanRecord(sid, self.name, parent.id if parent else None,
                              parent.root if parent else sid, threading.get_ident(), start)
        if parent is None and not self.thread_root:
            _root_stack = stack
            self.sync = _SyncCounter()
            self.sync.__enter__()
        stack.append(self.rec)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        global _root_stack
        self.rf.__exit__(*exc)
        _stack().pop()
        if self.sync is not None:
            self.sync.__exit__(*exc)
            _root_stack = None
        self.rec.end_ns = time.perf_counter_ns()
        RECORD.add(self.rec)


def trace(name: str, *, thread_root: bool = False):
    """A span named ``name`` (see the module docstring); a context manager
    that does nothing unless a ``torch.profiler`` is recording.
    ``thread_root``: an outermost span of this thread alone, recorded while
    any profiler of the process records (module docstring)."""
    if thread_root:
        if not getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
            return _OFF
        return _Span(name, thread_root=True)
    # A span inside an open thread root records on that root's thread too.
    if not torch.autograd._profiler_enabled() and not getattr(_local, "stack", None):
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the enclosed block and write its Chrome trace to
    ``log_dir/trace_<pid>_<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate_fn(name: str):
    def deco(f):
        @functools.wraps(f)
        def wrapper(*a, **kw):
            with trace(name):
                return f(*a, **kw)

        return wrapper

    return deco
