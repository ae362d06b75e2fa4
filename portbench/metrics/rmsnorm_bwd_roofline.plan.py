"""rmsnorm_bwd_roofline.plan: the rmsnorm backward kernels' share of their
roofline over the traced window, in %: the least time of the backward calls
the window's ladder steps need (two a layer and the final norm, over every
token of the job's batch) over the device time of the kernels named
rmsnorm_bwd and rmsnorm_dscale."""
from portbench.counts import kernels as K
from portbench.devicetrace import kernel_seconds


def read(ctx):
    cfg, t = ctx["config"], ctx["trace"]
    secs = kernel_seconds(t, "rmsnorm_bwd") + \
        kernel_seconds(t, "rmsnorm_dscale")
    reqs = ctx["record"]["requests"]
    if secs <= 0 or not reqs:
        return None
    dt = ctx["traffic"]["run"]["compute_dtype"]
    st = ctx["traffic"]["run"]["param_dtype"]
    bound = sum((2 * depth + 1) * K.rmsnorm_backward(
        r["B"] * r["S"], cfg["d_model"], dt, st)
        for r in reqs for depth in r["ladder"])
    return 100.0 * bound / secs
