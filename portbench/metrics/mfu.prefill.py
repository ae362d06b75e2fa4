"""mfu.prefill: the model FLOPs of the traced window's prompts (products
only, the routed experts a token goes to, the head over the last position)
over the window, against the bfloat16 peak of one H100, in %."""
from portbench.counts import kernels as K
from portbench.counts import models as M


def read(ctx):
    reqs = ctx["record"]["requests"]
    window = ctx["trace"]["window_s"]
    if not reqs or window <= 0:
        return None
    flops = sum(M.prefill_flops(ctx["config"], r["B"], r["S"]) for r in reqs)
    peak = K.PEAK_FLOPS[ctx["traffic"]["run"]["compute_dtype"]]
    return 100.0 * flops / window / peak
