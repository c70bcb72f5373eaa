"""The forward FLOPs of every request answered in the timed window (counted
from each request's real atoms, bonds and molecules), over the window's
seconds times the configuration's peak (%)."""


def read(ctx):
    peaks = ctx.get("peaks")
    if peaks is None or not ctx.get("window_s"):
        return None
    rate = peaks[f"{ctx['config']['peak_dtype']}_flops_per_s"]
    return 100.0 * ctx["flops_total"] / (ctx["window_s"] * rate)
