"""mfu.plan: the useful training FLOPs of the traced window's ladder steps
(one step at each depth of each answer: products only, three times the
forward's, no remat recompute) over the window, against the peak of the
step's type on one H100 (float32 outside the tensor cores: the port leaves
TF32 off), in %."""
from portbench.counts import kernels as K
from portbench.counts import models as M


def read(ctx):
    reqs = ctx["record"]["requests"]
    window = ctx["trace"]["window_s"]
    if not reqs or window <= 0:
        return None
    flops = sum(M.train_flops(dict(ctx["config"], n_layers=depth),
                              r["B"], r["S"])
                for r in reqs for depth in r["ladder"])
    peak = K.PEAK_FLOPS[ctx["traffic"]["run"]["compute_dtype"]]
    return 100.0 * flops / window / peak
