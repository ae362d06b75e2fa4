"""The port's ranges on the profiler's timeline (``telemetry.traced``): none
without a profiler, and under one each phase of the planner and of the MoE
prefill opened as often as the program runs it."""
import collections
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.configs.base import RunConfig
from repro_torch.models.model import Model
from repro_torch.telemetry import spans

ROOT = Path(__file__).resolve().parents[1]


def annotations(prof) -> collections.Counter:
    return collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation())


def test_traced_is_the_shared_null_span_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range opened with no profiler recording")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = len(spans.traced_ranges())
    assert spans.traced("moe.count_wait") is spans._NULL_SPAN
    with spans.traced("planner.point", depth=3) as got:
        assert got is None
    assert len(spans.traced_ranges()) == before


def test_the_span_module_loads_no_torch():
    """spans.py alone (the package's __init__ loads torch for the rest of
    the port) imports no torch, and `traced` opens nothing without it."""
    path = ROOT / "src/repro_torch/telemetry/spans.py"
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('s', {str(path)!r})\n"
            "s = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(s)\n"
            "with s.traced('planner.point', depth=2):\n"
            "    pass\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env={"PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_a_range_under_the_profiler_is_an_annotation_kept_on_the_host():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.traced("planner.point", depth=7):
            torch.ones(4).sum()
    point = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "planner.point"]
    assert len(point) == 1 and point[0].is_user_annotation()
    name, start, end = spans.traced_ranges()[-1]
    assert name == "planner.point" and end >= start


@pytest.mark.parametrize("arch, moe_layers", [("olmoe-1b-7b", 4),
                                              ("deepseek-7b", 0)])
def test_prefill_opens_a_range_a_layer_and_a_wait_a_moe_layer(arch,
                                                              moe_layers):
    cfg = get_arch(arch).reduced()
    model = Model(cfg, RunConfig(), device="cpu")
    model.init(seed=0)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.prefill({"tokens": toks}, 16)
    got = annotations(prof)
    assert got["prefill.attention"] == cfg.n_layers
    assert got["prefill.moe"] == moe_layers
    assert got["moe.count_wait"] == moe_layers


def test_a_plan_opens_point_build_and_step_at_every_depth(tmp_path,
                                                          monkeypatch):
    """One answer of the benchmark's plan cell on the CPU at the real cell's
    depth (a ladder of five points), the planner's readings from
    portbench's CPU profiler, its checked point built by the benchmark's own
    wrapper of ``build_step``."""
    from portbench import testing
    from portbench.drivers import plan
    root = testing.small_copy(tmp_path)
    bench = root / "portbench"
    cfg = dict(json.loads((bench / "configs/tiny-dense.json").read_text()),
               n_layers=30)
    mix = json.loads((bench / "traffic/tiny-plan.json").read_text())
    testing.cpu_planner(monkeypatch, cfg)
    cell = plan.Cell(cfg, mix, 2 ** 31 + 5, "cpu")
    cell.prepare()
    B, S = mix["cycle"][0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        answer = cell.plan(B, S, 0)
    got = annotations(prof)
    assert answer["ladder"] == [2, 3, 4, 6, 7]
    assert len(cell.steps) == 1                # the wrapped point ran
    assert got["planner.point"] == got["planner.build"] == \
        got["planner.step"] == 5


def test_the_release_between_points_is_a_range(monkeypatch):
    from repro_torch.core import profiler as P
    calls = []
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: calls.append("workspaces"), raising=False)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append("cache"))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P._release_cached(torch.device("cuda", 0))
    assert calls == ["workspaces", "cache"]
    assert annotations(prof)["planner.release"] == 1
    assert spans.traced_ranges()[-1][0] == "planner.release"
