"""release.plan: the share of the traced window in which the planner
released memory between the steps it profiles (``gc.collect``, the cuBLAS
workspaces' clear and ``empty_cache``, twice a ladder point): the union of
the program's own "planner.release" ranges over the window, in %."""
from portbench.spantrace import program_host


def read(ctx):
    got = program_host(ctx, "planner.release")
    window = ctx["trace"]["window_s"]
    if got is None or window <= 0:
        return None
    return 100.0 * got["host_s"] / window
