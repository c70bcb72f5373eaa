"""Mean host time of a call into the served callable, from the call to its
return, before the copy back that waits for the device (ms)."""


def read(ctx):
    return ctx.get("served_call_host_ms")
