"""The paper end to end through the PyTorch port's allocation plane: profile
the seven HiBench-family jobs with the OS-level RSS profiler (five sample
sizes each), fit the memory model, gate on R^2 and select an AWS-style
cluster configuration (Crispy §III steps 1-4 with real measurements),
through ``repro_torch.pipeline.AllocationPipeline``.

A second pass re-runs the suite adaptively under one shared
ProfilingBudget with both point placements (the ladder prefix and
``placement="infogain"``); a third shows the objective axis, where
``objective="min_cost"`` ranks the memory-feasible configurations by $/h
x predicted runtime on a job whose runtime grows superlinearly.

  PYTHONPATH=src python examples/profile_and_select_torch.py

The jobs run on the host and are measured by their peak RSS: this script
uses no GPU. It mirrors ``examples/profile_and_select.py`` of the JAX
package.
"""
from repro_torch.allocator.model_zoo import zoo_fitter
from repro_torch.core.catalog import aws_like_catalog
from repro_torch.core.local_jobs import LOCAL_JOBS
from repro_torch.core.memory_model import fit_memory_model
from repro_torch.core.profiler import ProfileResult, RSSProfiler
from repro_torch.core.sampling import ladder_from_anchor
from repro_torch.core.selector import OBJECTIVES
from repro_torch.core.simulator import build_history
from repro_torch.pipeline import AllocationPipeline, PipelineRequest
from repro_torch.profiling import ProfilingBudget

GiB = 1024 ** 3
ANCHOR = 48 * 1024 * 1024            # profiling sample anchor (48 MiB)
FULL_DATASET_GIB = 64                # the production dataset's size
BUDGET_WALL_S = 120.0                # the ten-minute envelope, scaled down
SUPERLINEAR_FULL = 1e11


def rss_profile_fns(profiler=None):
    """profile_fn(name, factory) -> profile_at(size): the job's peak RSS
    at `size`; a job's first profile_fn runs it once at the anchor first,
    to warm it up."""
    profiler = profiler or RSSProfiler(interval_s=0.002)
    warm = set()

    def profile_fn(name, factory):
        if name not in warm:
            profiler.profile(factory(int(ANCHOR)), ANCHOR)
            warm.add(name)

        def profile_at(size):
            return profiler.profile(factory(int(size)), size)
        return profile_at
    return profile_fn


def _request(name, profile_at, ladder, **kw):
    return PipelineRequest(name, profile_at, FULL_DATASET_GIB * GiB,
                           sizes=ladder.sizes, exclude_job_in_history=False,
                           **kw)


def fixed_pass(profile_fn, catalog, history, log=print):
    """The paper's five-point ladder and OLS linear fit for each local job
    -> {job: trace}."""
    ladder = ladder_from_anchor(ANCHOR)
    pipeline = AllocationPipeline(catalog, history, fitter=fit_memory_model,
                                  overhead_per_node_gib=2.0, leeway=0.05)
    log("== fixed 5-point ladders (the paper) ==")
    log(f"{'job':16s} {'R2':>9s} {'gate':>9s} {'req(GiB)':>9s} "
        f"{'selected':>16s} {'profiling(s)':>12s}")
    traces = {}
    for name, factory in LOCAL_JOBS.items():
        trace = pipeline.run(_request(name, profile_fn(name, factory), ladder))
        model = trace.plan.fit
        log(f"{name:16s} {model.r2:9.5f} "
            f"{'PASS' if model.confident else 'fallback':>9s} "
            f"{trace.requirement_gib:9.1f} "
            f"{trace.selection.config.name:>16s} {trace.wall_s:12.2f}")
        traces[name] = trace
    return traces


def adaptive_pass(placement, profile_fn, catalog, history, log=print):
    """Adaptive profiling under one budget with the model zoo -> ({job:
    trace}, the budget's snapshot)."""
    ladder = ladder_from_anchor(ANCHOR)
    log(f"\n== adaptive ({placement}) under one {BUDGET_WALL_S:.0f}s "
        f"budget ==")
    budget = ProfilingBudget(wall_s=BUDGET_WALL_S)
    pipeline = AllocationPipeline(catalog, history, overhead_per_node_gib=2.0,
                                  leeway=0.05, fitter=zoo_fitter(),
                                  adaptive=True, placement=placement,
                                  budget=budget)
    log(f"{'job':16s} {'points':>6s} {'gate':>9s} {'req(GiB)':>9s} "
        f"{'notes':>22s}")
    traces = {}
    for name, factory in LOCAL_JOBS.items():
        trace = pipeline.run(_request(name, profile_fn(name, factory), ladder))
        plan = trace.plan
        notes = " ".join(n for n, on in (("early-stop", plan.early_stop),
                                         ("escalated", plan.escalated),
                                         ("budget-cut",
                                          plan.budget_exhausted)) if on)
        log(f"{name:16s} {plan.total_points:6d} "
            f"{'PASS' if plan.fit.confident else 'fallback':>9s} "
            f"{trace.requirement_gib:9.1f} {notes:>22s}")
        traces[name] = trace
    snap = budget.snapshot()
    log(f"budget: {snap['points_spent']} points, {snap['elapsed_s']:.1f}/"
        f"{snap['wall_s']:.0f}s elapsed, {snap['denials']} denials")
    return traces, snap


def superlinear_profile(size):
    """A job whose memory is linear in its size and whose runtime grows as
    size^1.35."""
    return ProfileResult(size, 0.9 * size + 1.6e9, 0.0, 1e-11 * size ** 1.35)


def objectives_pass(catalog, history, log=print):
    """Each selection objective on the superlinear-runtime job -> {objective:
    trace}: where "cheapest config that fits" and "cheapest total run"
    disagree."""
    log("\n== selection objectives (superlinear-runtime job) ==")
    pipeline = AllocationPipeline(catalog, history, overhead_per_node_gib=2.0,
                                  fitter=zoo_fitter())
    log(f"{'objective':14s} {'selected':>16s} {'$/h':>7s} "
        f"{'pred runtime':>12s} {'pred cost':>10s}")
    traces = {}
    for objective in OBJECTIVES:
        trace = pipeline.run(PipelineRequest(
            "example/superlinear", superlinear_profile, SUPERLINEAR_FULL,
            sizes=ladder_from_anchor(SUPERLINEAR_FULL * 0.01).sizes,
            exclude_job_in_history=False, objective=objective))
        sel = trace.selection
        rt = (f"{sel.predicted_runtime_s:10.1f}s"
              if sel.predicted_runtime_s is not None else "         -")
        cost = (f"${sel.predicted_cost_usd:8.3f}"
                if sel.predicted_cost_usd is not None else "        -")
        log(f"{objective:14s} {sel.config.name:>16s} "
            f"{sel.config.usd_per_hour:7.2f} {rt:>12s} {cost:>10s}"
            + ("  [fell back to cheapest_fit]"
               if sel.objective_fell_back else ""))
        traces[objective] = trace
    return traces


def main():
    catalog, history = aws_like_catalog(), build_history()
    profile_fn = rss_profile_fns()
    fixed_pass(profile_fn, catalog, history)
    for placement in ("ladder", "infogain"):
        adaptive_pass(placement, profile_fn, catalog, history)
    objectives_pass(catalog, history)


if __name__ == "__main__":
    main()
