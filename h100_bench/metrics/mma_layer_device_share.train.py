"""Device time of the operations launched inside the MMA layer's spans
(its forward, and the backward nodes that its forward made), over all
device time of the profiled steps (%)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    layer = tr.device_seconds("mma_layer")
    total = tr.device_seconds()
    return 100.0 * layer / total if layer > 0 and total > 0 else None
