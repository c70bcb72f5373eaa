"""The MMA layer's least time (forward and backward: max of bytes over the
HBM rate and FLOPs over the configuration's peak, counted from its
shapes) over the device time of the kernels inside its spans (%)."""

from h100_bench.work import least_seconds


def read(ctx):
    tr, peaks = ctx.get("trace"), ctx.get("peaks")
    if tr is None or peaks is None:
        return None
    kernels = tr.device_seconds("mma_layer", kernels_only=True)
    if kernels <= 0:
        return None
    w = ctx["work"]["mma_layer"]
    least = least_seconds(w["flops"], w["bytes"], peaks, ctx["config"]["peak_dtype"])
    return 100.0 * least * tr.units / kernels
