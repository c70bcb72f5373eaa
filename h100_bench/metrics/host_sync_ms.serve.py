"""Host time a served request in the port's ``sync.*`` spans inside
``serve.call`` (ms, traced stretch)."""

from h100_bench.port_spans import stretch


def read(ctx):
    s = stretch(ctx, "serve.call")
    return None if s is None else s.host_ms(lambda n: n.startswith("sync."))
