"""Synchronizing calls a served request, as torch's sync debug mode reports
them inside the port's ``serve.call`` span (the port's counter, traced
stretch)."""

from h100_bench.port_spans import stretch


def read(ctx):
    s = stretch(ctx, "serve.call")
    return None if s is None else s.count("sync")
