"""The whole forward's least time (max of bytes over the HBM rate and
FLOPs over the configuration's peak, counted from each request's real
atoms, bonds and molecules) over the device time of the kernels launched
inside the served calls of the profiled requests (%)."""

from h100_bench.work import least_seconds


def read(ctx):
    tr, peaks, w = ctx.get("trace"), ctx.get("peaks"), ctx.get("traced_work")
    if tr is None or peaks is None or w is None:
        return None
    kernels = tr.device_seconds("served_call", kernels_only=True)
    if kernels <= 0:
        return None
    least = least_seconds(w["flops"], w["bytes"], peaks, ctx["config"]["peak_dtype"])
    return 100.0 * least / kernels
