"""Synchronizing calls a training step, as torch's sync debug mode reports
them inside the port's ``step`` span (the port's counter, traced stretch)."""

from h100_bench.port_spans import stretch


def read(ctx):
    s = stretch(ctx, "step")
    return None if s is None else s.count("sync")
