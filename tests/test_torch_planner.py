"""Crispy's planner over the port against the JAX package's, on the CPU:
the depth ladder, the linear fit and its R^2 gate, family rounding of
depths, the selectors, HBMPlanner.plan with per-depth bytes injected in
place of a profile, ProfileResult's dict form, and the port's `build_step`.
The arithmetic is the same float64 code in both packages, so numbers agree
to 1e-12 relative; where a number goes through the peak-FLOP/s constant
(the reference normalizes capacity to a v5e's 197 TFLOP/s, the port to an
H100's 989) the test states the factor 197/989. The measurement itself
(CUDAMemoryProfiler) runs on the card only: tests/test_torch_cuda.py."""
import dataclasses
import math
import time
import types

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import catalog as jcat
from repro.core import hbm_planner as jplan
from repro.core import history as jhist
from repro.core import memory_model as jmm
from repro.core import profiler as jprof
from repro.core import sampling as jsamp
from repro.core import selector as jsel

from repro_torch.configs import ARCHS, ShapeConfig, get_arch
from repro_torch.core import catalog as tcat
from repro_torch.core import hbm_planner as tplan
from repro_torch.core import history as thist
from repro_torch.core import memory_model as tmm
from repro_torch.core import profiler as tprof
from repro_torch.core import sampling as tsamp
from repro_torch.core import selector as tsel
from repro_torch.launch.dryrun import build_step

REL = 1e-12
# capacity of a config with peak p: p / 197 x n in the reference, p / 989 x
# n in the port
PEAK_RATIO = 197.0 / 989.0


def close(a, b, rel=REL):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return a == pytest.approx(b, rel=rel, abs=0.0)


# -- sampling ------------------------------------------------------------------

@pytest.mark.parametrize("anchor", [1, 2, 3, 5, 7, 12, 18, 30, 100])
def test_integer_ladder_matches_the_reference(anchor):
    for n in (2, 3, 5, 8):
        for lo in (0, 1, 2, 5, 6):
            assert tsamp.integer_ladder(anchor, n, lo) == \
                jsamp.integer_ladder(anchor, n, lo), (anchor, n, lo)
    assert tsamp.N_SAMPLES == jsamp.N_SAMPLES


@pytest.mark.parametrize("anchor", [0.5, 1.0, 7.0, 1e6, 3.3e9])
def test_ladder_from_anchor_matches_the_reference(anchor):
    for n in (2, 3, 5):
        for lo_frac in (0.1, 0.2, 0.5):
            got = tsamp.ladder_from_anchor(anchor, n, lo_frac)
            want = jsamp.ladder_from_anchor(anchor, n, lo_frac)
            assert got.sizes == want.sizes and got.anchor == want.anchor


def test_calibrate_anchor_matches_the_reference():
    def wall(size):      # a run whose wall time is 0.02 s a unit of size
        return 0.02 * size
    for initial in (1.0, 50.0, 5000.0):
        assert tsamp.calibrate_anchor(wall, initial) == \
            jsamp.calibrate_anchor(wall, initial)


# -- memory model --------------------------------------------------------------

def _series():
    rng = np.random.default_rng(7)
    x = np.array([2.0, 3.0, 4.0, 6.0, 7.0])
    return {
        "linear_noisy": (x, 0.54e9 * x + 2.8e9 + rng.normal(0, 1e6, x.size)),
        "flat": (x, np.full(x.size, 3.0e9)),
        "quadratic": (x, 1e9 * (x - 4.5) ** 2),
        "one_point": (x[:1], np.array([5e9])),
        "no_spread": (np.full(3, 4.0), np.array([1e9, 2e9, 3e9])),
    }


@pytest.mark.parametrize("name", sorted(_series()))
def test_fit_memory_model_matches_the_reference(name):
    x, y = _series()[name]
    got = tmm.fit_memory_model(list(x), list(y))
    want = jmm.fit_memory_model(list(x), list(y))
    assert close(got.slope, want.slope) and \
        close(got.intercept, want.intercept)
    assert close(got.r2, want.r2) and got.n == want.n
    assert got.confident == want.confident
    for full, leeway in ((30, 0.0), (30, 0.05), (81, 0.05), (1, 0.0)):
        assert close(got.requirement(full, leeway),
                     want.requirement(full, leeway))
    assert got.to_dict() == want.to_dict()
    assert tmm.LinearMemoryModel.from_dict(want.to_dict()) == got
    expect = {"linear_noisy": True, "flat": True, "quadratic": False,
              "one_point": False, "no_spread": False}[name]
    assert got.confident is expect
    assert tmm.R2_GATE == jmm.R2_GATE == 0.99


# -- family rounding of depths -------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_depth_matches_the_reference(arch):
    for L in range(1, 40):
        got = tplan._reduced_depth(get_arch(arch), L)
        want = jplan._reduced_depth(jax_get_arch(arch), L)
        assert got.n_layers == want.n_layers, (arch, L)


def test_depth_ladder_is_the_one_plan_fits():
    assert tplan.HBMPlanner.depth_ladder(get_arch("deepseek-7b")) == \
        [2, 3, 4, 6, 7]
    zamba = get_arch("zamba2-7b")
    assert tplan.HBMPlanner.depth_ladder(zamba) == [6, 9, 12, 15, 18]
    assert [tplan._reduced_depth(zamba, L).n_layers
            for L in (6, 9, 12, 15, 18)] == [6, 6, 12, 12, 18]


# -- catalogs, history and selection -------------------------------------------

def _nodes():
    """The reference's AWS-like and TPU nodes, and the port's H100."""
    h100 = tcat.gpu_catalog()[0].node
    return [dataclasses.asdict(n) for n in jcat._AWS_NODES] + \
        [dataclasses.asdict(n) for n in (jcat.V5E, jcat.V4, jcat.V5P)] + \
        [dataclasses.asdict(h100)]


def _catalogs():
    """One catalog built identically in both packages."""
    scales = [1, 2, 4, 8, 16, 32]
    jc = [jcat.ClusterConfig(jcat.NodeType(**n), s)
          for n in _nodes() for s in scales]
    tc = [tcat.ClusterConfig(tcat.NodeType(**n), s)
          for n in _nodes() for s in scales]
    return jc, tc


def _histories(catalog_names):
    rng = np.random.default_rng(3)
    rows = [(f"job{j}", name, float(rng.uniform(10, 1000)),
             float(rng.uniform(0.1, 50)))
            for j in range(6) for name in catalog_names
            if rng.uniform() < 0.8]
    return (jhist.ExecutionHistory(jhist.Execution(*r) for r in rows),
            thist.ExecutionHistory(thist.Execution(*r) for r in rows))


def test_gpu_catalog_is_h100s_priced_in_gpu_hours():
    cat = tcat.gpu_catalog(unit_price=2.5)
    assert [c.scale_out for c in cat] == [1, 2, 4, 8, 16, 32, 64]
    for c in cat:
        assert c.node.mem_gib == tcat.H100_MEM_BYTES / tcat.GiB
        assert c.node.peak_tflops == 989.0 and c.node.hbm_gbps == 3350.0
        assert c.usd_per_hour == 2.5 * c.scale_out
    assert tcat.H100_PEAK_FLOPS == 989e12


def test_medium_config_matches_the_reference():
    jc, tc = _catalogs()
    assert tcat.medium_config(tc).name == jcat.medium_config(jc).name
    assert tsel.select_medium(tc).name == jsel.select_medium(jc).name


def test_history_matches_the_reference():
    jc, tc = _catalogs()
    jh, th = _histories([c.name for c in jc])
    assert th.jobs() == jh.jobs() and th.config_names() == jh.config_names()
    for job in jh.jobs():
        assert th.normalized_costs(job) == jh.normalized_costs(job)
        assert th.best_config_name(job) == jh.best_config_name(job)
        assert th.bfa_scores(job) == jh.bfa_scores(job)
        assert tsel.random_expected_cost(tc, th, job) == \
            jsel.random_expected_cost(jc, jh, job)


def test_select_bfa_and_like_match_the_reference():
    jc, tc = _catalogs()
    jh, th = _histories([c.name for c in jc])
    for job in [None] + jh.jobs():
        assert tsel.select_bfa(tc, th, job).name == \
            jsel.select_bfa(jc, jh, job).name
        if job is not None:
            assert tsel.select_like(tc, th, job).config.name == \
                jsel.select_like(jc, jh, job).config.name


def test_config_capacity_differs_by_the_peak_ratio():
    jc, tc = _catalogs()
    for a, b in zip(jc, tc):
        if a.node.peak_tflops > 0:
            assert close(tsel.config_capacity(b),
                         jsel.config_capacity(a) * PEAK_RATIO)
        else:
            assert tsel.config_capacity(b) == jsel.config_capacity(a)


@pytest.mark.parametrize("objective", ["cheapest_fit", "min_cost",
                                       "min_runtime"])
@pytest.mark.parametrize("requirement", [0.0, 10.0, 150.0, 1e4, 1e7])
def test_select_crispy_matches_the_reference(objective, requirement):
    """Picks agree on every catalog row; with a runtime model the predicted
    runtime differs by (989/197)^0.9 on accelerator rows, the same factor
    on every such row, so the Pareto front and the argmin are the same."""
    jc, tc = _catalogs()
    jh, th = _histories([c.name for c in jc])
    jrt = jmm.LinearMemoryModel(3.0, 100.0, 1.0, 5)     # a runtime model
    trt = tmm.LinearMemoryModel(3.0, 100.0, 1.0, 5)
    for cat_j, cat_t in ((jc, tc),
                         ([c for c in jc if c.node.peak_tflops > 0],
                          [c for c in tc if c.node.peak_tflops > 0])):
        want = jsel.select_crispy(cat_j, jh, requirement, 1.25, "job0",
                                  objective, jrt, 1000.0)
        got = tsel.select_crispy(cat_t, th, requirement, 1.25, "job0",
                                 objective, trt, 1000.0)
        assert got.config.name == want.config.name
        assert (got.feasible_count, got.fell_back, got.objective_fell_back) \
            == (want.feasible_count, want.fell_back, want.objective_fell_back)
        if want.predicted_runtime_s is not None and \
                got.config.node.peak_tflops > 0:
            assert close(got.predicted_runtime_s,
                         want.predicted_runtime_s / PEAK_RATIO ** 0.9)


def test_pareto_front_matches_the_reference():
    jc, tc = _catalogs()
    rng = np.random.default_rng(5)
    costs = rng.uniform(1, 10, len(jc)).round(1)
    times = rng.uniform(1, 10, len(jc)).round(1)
    want = jsel.pareto_front(list(zip(jc, costs, times)))
    got = tsel.pareto_front(list(zip(tc, costs, times)))
    assert [r[0].name for r in got] == [r[0].name for r in want]
    with pytest.raises(ValueError):
        tsel.select_crispy(tc, None, 1.0, objective="fastest")


# -- the planner with bytes injected in place of a profile ---------------------

def _bytes(kind):
    """Per-depth bytes a profile would give: a line with seeded noise,
    flat, or a curve the gate must refuse."""
    rng = np.random.default_rng(11)
    noise = {L: float(rng.normal(0, 2e6)) for L in range(1, 200)}
    return {"linear": lambda L: 0.5e9 * L + 2.8e9 + noise[L],
            "flat": lambda L: 6e9,
            "curved": lambda L: 1e8 * L ** 3}[kind]


def _inject(planner, fn, seen):
    """Replace profile_memory on this instance only: bytes from the depth,
    and a record of the depths profiled."""
    def profile_memory(cfg, shape, *args, **kwargs):
        seen.append(cfg.n_layers)
        return fn(cfg.n_layers)
    planner.profile_memory = profile_memory
    return planner


@pytest.mark.parametrize("kind", ["linear", "flat", "curved"])
@pytest.mark.parametrize("arch,anchor", [("deepseek-7b", None),
                                         ("deepseek-7b", 9),
                                         ("zamba2-7b", None),
                                         ("mistral-large-123b", None)])
@pytest.mark.parametrize("with_history", [False, True])
def test_plan_with_injected_bytes_matches_the_reference(arch, anchor, kind,
                                                        with_history):
    jc, tc = _catalogs()
    jh, th = _histories([c.name for c in jc]) if with_history else \
        (None, None)
    fn = _bytes(kind)
    seen_j, seen_t = [], []
    jp = _inject(jplan.HBMPlanner(jc, jh, overhead_gib=1.75, leeway=0.05),
                 fn, seen_j)
    tp = _inject(tplan.HBMPlanner(tc, th, overhead_gib=1.75, leeway=0.05),
                 fn, seen_t)
    one_device = types.SimpleNamespace(devices=np.empty((1, 1)))
    want = jp.plan(jax_get_arch(arch), JShapeConfig("p", 2048, 4, "prefill"),
                   one_device, anchor_layers=anchor)
    got = tp.plan(get_arch(arch), ShapeConfig("p", 2048, 4, "prefill"),
                  anchor_layers=anchor)
    assert seen_t == seen_j
    assert got.job == want.job and got.ladder == want.ladder
    assert got.per_dev_bytes == want.per_dev_bytes
    assert got.model.to_dict() == want.model.to_dict()
    assert close(got.predicted_per_dev_gib, want.predicted_per_dev_gib)
    assert close(got.requirement_gib, want.requirement_gib)
    assert got.profile_mesh_devices == want.profile_mesh_devices == 1
    assert got.selection.config.name == want.selection.config.name
    assert (got.selection.feasible_count, got.selection.fell_back) == \
        (want.selection.feasible_count, want.selection.fell_back)
    assert got.selection.method == want.selection.method == "crispy-hbm"


@pytest.mark.parametrize("requirement", [0.0, 30.0, 78.0, 300.0, 1e6])
def test_select_on_the_gpu_catalog_matches_the_reference(requirement):
    """The reference's selection over the same GPU catalog, built in its
    own NodeType, at the port's measured overhead."""
    tc = tcat.gpu_catalog()
    jc = [jcat.ClusterConfig(jcat.NodeType(**dataclasses.asdict(c.node)),
                             c.scale_out) for c in tc]
    over = tplan.GPU_OVERHEAD_GIB
    got = tplan.HBMPlanner(overhead_gib=over).select(requirement, 0.0)
    want = jplan.HBMPlanner(jc, overhead_gib=over).select(requirement, 0.0)
    assert got.config.name == want.config.name
    assert (got.feasible_count, got.fell_back) == \
        (want.feasible_count, want.fell_back)


def test_fewest_gpus_that_hold_the_requirement():
    planner = tplan.HBMPlanner()
    usable = tcat.H100_MEM_BYTES / tcat.GiB - tplan.GPU_OVERHEAD_GIB
    for need, gpus in ((1.0, 1), (usable, 1), (usable + 0.1, 2),
                       (3.5 * usable, 4), (63 * usable, 64)):
        sel = planner.select(need, 0.0)
        assert sel.config.scale_out == gpus and not sel.fell_back
    sel = planner.select(65 * usable, 0.0)
    assert sel.fell_back and sel.config.scale_out == 64


# -- profile results -----------------------------------------------------------

@pytest.mark.parametrize("with_trace", [False, True])
def test_profile_result_dicts_load_across_the_packages(with_trace):
    j = jprof.ProfileResult(5.0, 3.5e9, 1.25e8, 0.75, [1.0, 2.5], [0.0, 0.1])
    t = tprof.ProfileResult.from_dict(j.to_dict(with_trace))
    assert t.to_dict(True) == jprof.ProfileResult.from_dict(
        j.to_dict(with_trace)).to_dict(True)
    assert t.job_mem_bytes == j.job_mem_bytes
    c = tprof.CUDAProfileResult(5.0, 3.5e9, 1.25e8, 0.75,
                                reserved_mem_bytes=4e9,
                                device_used_bytes=4.6e9)
    assert c.to_dict() == j.to_dict()
    assert c.overhead_bytes == pytest.approx(1.1e9)
    assert jprof.ProfileResult.from_dict(c.to_dict()).job_mem_bytes == \
        c.job_mem_bytes


def test_rss_profiler_reads_a_host_allocation():
    def job():
        a = np.ones(64 * 2 ** 20, dtype=np.uint8)     # 64 MiB, touched
        time.sleep(0.05)                 # held while the sampler reads
        return int(a[::4096].sum())

    r = tprof.RSSProfiler(interval_s=0.001).profile(job, 64.0)
    assert r.size == 64.0 and r.wall_s > 0 and r.trace
    assert r.job_mem_bytes >= 32 * 2 ** 20


# -- build_step and the profiler's device rule ---------------------------------

def _dense():
    return get_arch("deepseek-7b").reduced(n_layers=3)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_build_step_runs_one_step_on_the_cpu(mode):
    cfg = _dense()
    shape = ShapeConfig(mode, 16, 2, mode)
    step = build_step(cfg, shape, device="cpu", seed=3)
    out, again = step(), step()
    if mode == "train":
        assert math.isfinite(float(out["loss"]))
        assert float(out["loss"]) == float(again["loss"])
        return
    logits, caches = out
    assert logits.shape == (2, 1, cfg.vocab_size) and \
        bool(torch.isfinite(logits.float()).all())
    assert torch.equal(logits, again[0])
    k = caches["k"]
    assert k.shape[:3] == (cfg.n_layers, 2, 16)


def test_build_step_runs_a_hybrid_prefill_on_the_cpu():
    cfg = get_arch("zamba2-7b").reduced()
    step = build_step(cfg, ShapeConfig("p", 16, 2, "prefill"), device="cpu")
    logits, caches = step()
    assert logits.shape[:2] == (2, 1)
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size].float()).all())
    assert set(caches) == {"mamba", "attn"}


def test_build_step_takes_the_preset_without_a_run():
    """run=None is preset_run on one device, which is the reference's
    preset for the same job."""
    from repro_torch.launch.dryrun import ONE_DEVICE
    from repro_torch.launch.presets import preset_run
    from repro.configs.base import MeshConfig as JMeshConfig
    from repro.launch.presets import preset_run as jax_preset_run
    for mode, B in (("train", 8), ("prefill", 4), ("decode", 4)):
        got = preset_run(_dense(), ShapeConfig(mode, 16, B, mode), ONE_DEVICE)
        want = jax_preset_run(jax_get_arch("deepseek-7b").reduced(n_layers=3),
                              JShapeConfig(mode, 16, B, mode),
                              JMeshConfig((1, 1), ("data", "model")))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    out = build_step(_dense(), ShapeConfig("t", 16, 4, "train"),
                     device="cpu")()
    assert math.isfinite(float(out["loss"]))


def test_memory_profiler_and_planner_refuse_the_cpu():
    shape = ShapeConfig("p", 16, 2, "prefill")
    with pytest.raises(ValueError, match="CUDA device"):
        tprof.CUDAMemoryProfiler().profile(lambda: None, 1.0, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tplan.HBMPlanner().profile_memory(_dense(), shape, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tplan.HBMPlanner().plan(_dense(), shape, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        build_step(_dense(), ShapeConfig("x", 16, 2, "serve"), device="cpu")
