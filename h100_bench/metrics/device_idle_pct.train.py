"""1 - (union of the device operations' intervals) / the profiled window,
over training steps (%)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
