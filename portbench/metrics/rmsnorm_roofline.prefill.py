"""rmsnorm_roofline.prefill: the rmsnorm forward kernels' share of their
roofline over the traced window, in %: the least time of the calls the
window's prompts need (two a layer over every token, the final norm over
the last position of each prompt) over the device time of the kernels whose
name holds rmsnorm (not the backward's)."""
from portbench.counts import kernels as K
from portbench.devicetrace import kernel_seconds


def read(ctx):
    cfg = ctx["config"]
    secs = kernel_seconds(ctx["trace"], "rmsnorm", exclude=("bwd", "dscale"))
    reqs = ctx["record"]["requests"]
    if secs <= 0 or not reqs:
        return None
    dt = ctx["traffic"]["run"]["compute_dtype"]
    st = ctx["traffic"]["run"]["param_dtype"]
    d = cfg["d_model"]
    bound = sum(2 * cfg["n_layers"] * K.rmsnorm(r["B"] * r["S"], d, dt, st) +
                K.rmsnorm(r["B"], d, dt, st) for r in reqs)
    return 100.0 * bound / secs
