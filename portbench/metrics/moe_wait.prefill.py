"""moe_wait.prefill: the share of the traced window in which the host
waited for the MoE dispatch's expert counts (``counts.tolist()``, once a MoE
layer a batch): the union of the program's own "moe.count_wait" ranges over
the window, in %."""
from portbench.spantrace import program_host


def read(ctx):
    got = program_host(ctx, "moe.count_wait")
    window = ctx["trace"]["window_s"]
    if got is None or window <= 0:
        return None
    return 100.0 * got["host_s"] / window
