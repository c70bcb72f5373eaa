"""The model FLOPs of every step of the timed window (forward, backward and
the optimizer, counted once from the shapes), over the window's seconds
times the configuration's peak (%)."""


def read(ctx):
    peaks = ctx.get("peaks")
    if peaks is None or not ctx.get("window_s"):
        return None
    rate = peaks[f"{ctx['config']['peak_dtype']}_flops_per_s"]
    return 100.0 * ctx["work"]["step"]["flops"] * ctx["units"] / (ctx["window_s"] * rate)
