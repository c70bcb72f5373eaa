"""Host time a served request in the exported graph's nodes and the output's
unflatten: the port's ``serve.graph`` span (ms, traced stretch)."""

from h100_bench.port_spans import stretch


def read(ctx):
    s = stretch(ctx, "serve.call")
    return None if s is None else s.host_ms(lambda n: n == "serve.graph")
