"""Host time a training step in the port's ``sync.*`` spans, around the calls
that wait for the card (ms, traced stretch)."""

from h100_bench.port_spans import stretch


def read(ctx):
    s = stretch(ctx, "step")
    return None if s is None else s.host_ms(lambda n: n.startswith("sync."))
