"""Host time a served request from the call's entry to the exported graph's
first node: the port's ``serve.check`` (the device check) and
``serve.inputs`` (the loaded module's pre-hooks, input checks and pytree
flatten) spans (ms, traced stretch)."""

from h100_bench.port_spans import stretch


def read(ctx):
    s = stretch(ctx, "serve.call")
    return None if s is None else s.host_ms(lambda n: n in ("serve.check", "serve.inputs"))
