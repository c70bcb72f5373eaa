"""Mean host time of a call into the training step, from the call to its
return, before any wait the benchmark adds (ms)."""


def read(ctx):
    return ctx.get("step_host_ms")
