"""Tracing and profiling helpers.

The port of the JAX package's ``mma_tpu/utils/profiling.py`` (the
reference has only wall-clock prints):

- ``trace(name)``: a named range that shows up in a ``torch.profiler``
  trace (``record_function``) and, on a CUDA host, as an NVTX range for
  an external timeline tool;
- ``profile_to(log_dir)``: profile the enclosed block (CPU, and the card
  when there is one) and write a Chrome trace into ``log_dir``
  (``chrome://tracing`` or Perfetto opens it);
- ``annotate_fn(name)``: the decorator form of ``trace``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


@contextlib.contextmanager
def trace(name: str):
    """A named range, visible in profiler traces (and NVTX on CUDA)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
