"""The port's examples against the JAX package's, on the CPU:
``examples/quickstart_torch.py``'s training and serving on weights carried
from the reference and the same synthetic batches (5 steps), the serving
demos of ``examples/serve_demo_torch.py`` (the allocation answers, the
engines' greedy tokens) and ``examples/profile_and_select_torch.py``'s
three passes over fixed profile points."""
import importlib.util
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.allocator import AllocationService as JaxAllocationService
from repro.allocator.model_zoo import zoo_fitter as jax_zoo_fitter
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import RunConfig as JaxRunConfig
from repro.core.catalog import aws_like_catalog as jax_catalog
from repro.core.memory_model import fit_memory_model as jax_fit_memory_model
from repro.core.profiler import ProfileResult as JaxProfileResult
from repro.core.sampling import ladder_from_anchor as jax_ladder
from repro.core.selector import OBJECTIVES as JAX_OBJECTIVES
from repro.core.simulator import build_history as jax_build_history
from repro.core.simulator import make_profile_fn as jax_make_profile_fn
from repro.core.simulator import scout_like_jobs as jax_scout_jobs
from repro.data.pipeline import ShardedLoader as JaxShardedLoader
from repro.data.pipeline import SyntheticLMDataset as JaxSyntheticLMDataset
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_adamw as jax_init_adamw
from repro.pipeline import AllocationPipeline as JaxPipeline
from repro.pipeline import PipelineRequest as JaxPipelineRequest
from repro.profiling import ProfilingBudget as JaxProfilingBudget
from repro.serve.engine import AllocationEndpoint as JaxEndpoint
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import train_loop as jax_train_loop
from repro.train.step import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model
from test_torch_parity import numpy_tree

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
STEPS = 5
GiB = 1024 ** 3


def load(name):
    """examples/<name>.py as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quiet(*_):
    pass


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_trains_and_serves_as_the_reference_does(tmp_path):
    """The quickstart's body for STEPS steps from the reference's weights:
    every step's loss within 1e-4 relative of the reference's train_loop on
    the same synthetic batches, and the four requests' greedy tokens
    equal."""
    qs = load("quickstart_torch")
    jcfg = jax_get_arch("deepseek-7b").reduced(d_model=128, n_layers=4,
                                               vocab_size=512, d_ff=256)
    jmodel = JaxModel(jcfg, JaxRunConfig(attn_impl="full", remat="nothing",
                                         compute_dtype="float32"))
    params = jmodel.init(jax.random.PRNGKey(0))
    acfg = JaxAdamWConfig(lr=qs.LR)
    state = JaxTrainState(params, jax_init_adamw(params, acfg), None)
    step = jax.jit(jax_make_train_step(jmodel, acfg, None, total_steps=STEPS))
    loader = JaxShardedLoader(JaxSyntheticLMDataset(jcfg.vocab_size),
                              qs.BATCH, qs.SEQ)
    state, want = jax_train_loop(
        state, step, loader,
        JaxLoopConfig(total_steps=STEPS, ckpt_every=qs.CKPT_EVERY,
                      ckpt_dir=str(tmp_path / "jax"), log_every=25),
        log=quiet)
    engine = JaxServeEngine(jmodel, state.params, slots=qs.SLOTS,
                            max_len=qs.MAX_LEN)
    for rid, prompt in enumerate(qs.PROMPTS):
        engine.submit(JaxRequest(rid, prompt=list(prompt),
                                 max_new_tokens=qs.MAX_NEW))
    want_done = sorted(engine.run(), key=lambda r: r.rid)

    assert qs.config() == get_arch("deepseek-7b").reduced(
        d_model=128, n_layers=4, vocab_size=512, d_ff=256)
    model = params_from_numpy(numpy_tree(params), Model(qs.config(), qs.RUN,
                                                        device="cpu"))
    report, done = qs.train_and_serve(model, steps=STEPS,
                                      ckpt_dir=str(tmp_path / "torch"),
                                      log=quiet)
    assert len(report.losses) == len(want.losses) == STEPS
    np.testing.assert_allclose(report.losses, want.losses, rtol=1e-4, atol=0)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in want_done]
    assert all(len(r.out_tokens) == qs.MAX_NEW for r in done)


# ---------------------------------------------------------------------------
# the serving demos
# ---------------------------------------------------------------------------


def test_demo_allocation_answers_as_the_reference_does():
    """The allocation demo's mix, one worker at a time so that the order
    of first visits is fixed: every wire answer's job, source, candidate,
    requirement and configuration equal to the reference service's on the
    same history."""
    demo = load("serve_demo_torch")
    got = demo.demo_allocation(n_requests=16, workers=1)
    jobs = jax_scout_jobs()
    catalog = jax_catalog()
    history = jax_build_history(jobs, catalog)
    with JaxAllocationService(catalog, history) as svc:
        endpoint = JaxEndpoint(svc)
        want = [endpoint.handle(job=j.name, profile_at=jax_make_profile_fn(j),
                                full_size=j.dataset_gib * GiB,
                                anchor=j.dataset_gib * GiB * 0.01)
                for j in demo.allocation_mix(jobs, 16)]
    keys = ("job", "source", "candidate", "config", "usd_per_hour")
    assert [{k: a[k] for k in keys} for a in got] == \
        [{k: a[k] for k in keys} for a in want]
    np.testing.assert_allclose([a["requirement_gib"] for a in got],
                               [a["requirement_gib"] for a in want],
                               rtol=1e-9)


@pytest.mark.parametrize("arch", ["deepseek-7b", "rwkv6-7b"])
def test_engine_demo_serves_the_references_greedy_tokens(arch):
    """``demo`` on the reduced arch, on the reference's weights of seed 0:
    every greedy request's tokens equal the reference engine's (the
    sampled ones draw from another generator)."""
    demo = load("serve_demo_torch")
    jmodel = JaxModel(jax_get_arch(arch).reduced(),
                      JaxRunConfig(attn_impl="full", remat="nothing",
                                   compute_dtype="float32"))
    params = jmodel.init(jax.random.PRNGKey(0))
    engine = JaxServeEngine(jmodel, params, slots=4, max_len=64)
    for req in demo.demo_requests(12):
        engine.submit(JaxRequest(req.rid, prompt=req.prompt,
                                 max_new_tokens=req.max_new_tokens,
                                 temperature=req.temperature))
    want = {r.rid: r.out_tokens for r in engine.run()}
    model = params_from_numpy(numpy_tree(params), Model(
        get_arch(arch).reduced(), demo.RUN, device="cpu"))
    done = demo.demo(arch, device="cpu", model=model)
    assert [r.rid for r in done] == list(range(12))
    greedy = [r for r in done if r.temperature == 0.0]
    assert len(greedy) == 6
    for r in greedy:
        assert r.out_tokens == want[r.rid], r.rid
    assert all(len(r.out_tokens) == 16 for r in done)


# ---------------------------------------------------------------------------
# profile and select
# ---------------------------------------------------------------------------


def fixed_points(result):
    """profile_fn(name, factory) -> profile_at(size): a job's peak grows
    linearly in its size, with a slope and an intercept of its own and a
    little curvature, its wall time as size^1.1; `result` the package's
    ProfileResult."""
    def profile_fn(name, factory):
        h = zlib.crc32(name.encode())
        slope, base = 2.0 + h % 7, (1 + h % 5) * 1e8

        def profile_at(size):
            return result(size, slope * size + base + 1e-10 * size ** 2, 0.0,
                          1e-9 * size ** 1.1)
        return profile_at
    return profile_fn


def jax_fixed_pass(ps, profile_fn, catalog, history):
    ladder = jax_ladder(ps.ANCHOR)
    pipeline = JaxPipeline(catalog, history, fitter=jax_fit_memory_model,
                           overhead_per_node_gib=2.0, leeway=0.05)
    return {name: pipeline.run(JaxPipelineRequest(
        name, profile_fn(name, None), ps.FULL_DATASET_GIB * GiB,
        sizes=ladder.sizes, exclude_job_in_history=False))
        for name in ps.LOCAL_JOBS}


def jax_adaptive_pass(ps, placement, profile_fn, catalog, history):
    ladder = jax_ladder(ps.ANCHOR)
    pipeline = JaxPipeline(catalog, history, overhead_per_node_gib=2.0,
                           leeway=0.05, fitter=jax_zoo_fitter(),
                           adaptive=True, placement=placement,
                           budget=JaxProfilingBudget(wall_s=ps.BUDGET_WALL_S))
    return {name: pipeline.run(JaxPipelineRequest(
        name, profile_fn(name, None), ps.FULL_DATASET_GIB * GiB,
        sizes=ladder.sizes, exclude_job_in_history=False))
        for name in ps.LOCAL_JOBS}


def jax_objectives_pass(ps, catalog, history):
    pipeline = JaxPipeline(catalog, history, overhead_per_node_gib=2.0,
                           fitter=jax_zoo_fitter())

    def superlinear(size):
        return JaxProfileResult(size, 0.9 * size + 1.6e9, 0.0,
                                1e-11 * size ** 1.35)
    return {objective: pipeline.run(JaxPipelineRequest(
        "example/superlinear", superlinear, ps.SUPERLINEAR_FULL,
        sizes=jax_ladder(ps.SUPERLINEAR_FULL * 0.01).sizes,
        exclude_job_in_history=False, objective=objective))
        for objective in JAX_OBJECTIVES}


def assert_same_choices(got, want):
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        assert g.selection.config.name == w.selection.config.name, name
        assert g.plan.total_points == w.plan.total_points, name
        assert g.plan.fit.confident == w.plan.fit.confident, name
        np.testing.assert_allclose(g.requirement_gib, w.requirement_gib,
                                   rtol=1e-9, err_msg=name)


def test_profile_and_select_chooses_what_the_reference_does():
    """The example's fixed, adaptive (ladder and infogain) and objective
    passes over fixed profile points: the same configurations, points,
    confidence and requirements as the reference's pipelines given the
    same points."""
    from repro_torch.core.catalog import aws_like_catalog
    from repro_torch.core.profiler import ProfileResult
    from repro_torch.core.simulator import build_history
    ps = load("profile_and_select_torch")
    catalog, history = aws_like_catalog(), build_history()
    jcatalog, jhistory = jax_catalog(), jax_build_history()
    assert_same_choices(
        ps.fixed_pass(fixed_points(ProfileResult), catalog, history, quiet),
        jax_fixed_pass(ps, fixed_points(JaxProfileResult), jcatalog, jhistory))
    for placement in ("ladder", "infogain"):
        got, snap = ps.adaptive_pass(placement, fixed_points(ProfileResult),
                                     catalog, history, quiet)
        assert snap["points_spent"] == sum(t.plan.total_points
                                           for t in got.values())
        assert_same_choices(got, jax_adaptive_pass(
            ps, placement, fixed_points(JaxProfileResult), jcatalog,
            jhistory))
    got = ps.objectives_pass(catalog, history, quiet)
    want = jax_objectives_pass(ps, jcatalog, jhistory)
    assert set(got) == set(want)
    for objective in want:
        g, w = got[objective].selection, want[objective].selection
        assert g.config.name == w.config.name, objective
        assert g.objective_fell_back == w.objective_fell_back, objective
