"""The program's ranges as the benchmark reads them: the span table on
synthetic intervals, the readers on the program's own record of its ranges,
a traced CPU run, and (marked cuda) the counts and the launch join in traced
runs of the real cells on the card."""
import io
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import devicetrace, harness, spantrace, testing
from portbench.harness import ROOT, Spec
from repro_torch.telemetry import spans, traced

SEED = 2 ** 31 + 29


def test_the_span_table_on_synthetic_intervals():
    # device busy in the window (0, 50): 0-20, 30-40, 45-50; idle 20-30,
    # 40-45. The op at 12-15 has no launch found: it is busy time, put down
    # to no range.
    dev = [(0, 10, 2), (5, 20, 6), (12, 15, None), (30, 40, 25),
           (45, 70, 44)]
    ranges = [(0, 35, "outer"), (18, 32, "inner"),        # nested
              (1, 4, "twice"), (3, 8, "twice"),           # overlapping
              (40, 60, "late"),                           # past the window
              (60, 70, "after")]                          # outside it
    got = spantrace.table(dev, ranges, (0, 50))
    assert set(got) == {"outer", "inner", "twice", "late"}
    want = {"outer": (1, 35, 10, 35), "inner": (1, 14, 10, 10),
            "twice": (2, 7, 0, 25), "late": (1, 10, 5, 5)}
    for name, (n, host, idle, device) in want.items():
        row = got[name]
        assert row["n"] == n, name
        assert row["host_s"] == pytest.approx(host * 1e-9), name
        assert row["idle_s"] == pytest.approx(idle * 1e-9), name
        assert row["device_s"] == pytest.approx(device * 1e-9), name


def test_a_window_with_no_device_work_is_idle_in_every_range():
    got = spantrace.table([], [(10, 30, "a")], (0, 100))
    assert got["a"]["idle_s"] == pytest.approx(20e-9)
    assert got["a"]["device_s"] == 0


def _profiled():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devicetrace.WINDOW):
            with traced("moe.count_wait"):
                torch.ones(8).sum()
            with traced("moe.count_wait"):
                torch.ones(8).sum()
    return prof


def test_recording_leaves_the_summary_as_it_was():
    prof = _profiled()
    got, log = {}, io.StringIO()
    with spantrace.recording(got, log=log):
        summary = harness.summarise(prof)
    assert harness.summarise is devicetrace.summarise
    assert summary == devicetrace.summarise(prof)
    assert got["spans"]["moe.count_wait"]["n"] == 2
    assert got["spans"]["moe.count_wait"]["host_s"] > 0
    assert got["launch_found"] is None              # no device op on a CPU
    assert "span moe.count_wait 2 " in log.getvalue()


def ctx(requests, window=2.0, busy=1.0):
    return {"record": {"requests": requests},
            "trace": {"window_s": window, "busy_s": busy, "kernel_s": {}}}


def read(name, c):
    return Spec(ROOT).reader(name)(c)


@pytest.mark.parametrize("metric, span", [("release.plan", "planner.release"),
                                          ("moe_wait.prefill",
                                           "moe.count_wait")])
def test_a_reader_takes_the_union_of_its_ranges_in_the_window(
        monkeypatch, metric, span):
    ranges = [(span, 1.0, 1.5), (span, 1.4, 2.0),      # 1.0-2.0
              (span, 9.0, 9.5),                        # after the window
              ("planner.point", 0.5, 3.0)]
    monkeypatch.setattr(spans, "traced_ranges", lambda: ranges)
    c = ctx([{"done": 1.2, "latency_s": 0.7}, {"done": 3.0, "latency_s": 1.8}])
    assert read(metric, c) == pytest.approx(50.0)
    assert spantrace.program_host(c, span)["n"] == 2


@pytest.mark.parametrize("metric", ["release.plan", "moe_wait.prefill"])
def test_a_reader_without_its_range_returns_nothing(monkeypatch, metric):
    c = ctx([{"done": 3.0, "latency_s": 2.5}])
    monkeypatch.setattr(spans, "traced_ranges",
                        lambda: [("planner.point", 1.0, 2.0)])
    assert read(metric, c) is None
    monkeypatch.delattr(spans, "traced_ranges")       # an older program
    assert read(metric, c) is None
    monkeypatch.undo()
    assert read(metric, ctx([])) is None


def test_the_shares_of_the_span_table():
    table = {"planner.release": {"host_s": 0.5}, "planner.build":
             {"device_s": 0.25}, "moe.count_wait": {"host_s": 0.1},
             "prefill.moe": {"idle_s": 0.2}, "prefill.attention":
             {"idle_s": 0.3}}
    trace = {"window_s": 2.0, "busy_s": 1.0}
    got = {k: f(table, trace) for k, f in spantrace.SHARES.items()}
    assert got == pytest.approx({"release.plan": 25.0,
                                 "init_share.plan": 25.0,
                                 "moe_wait.prefill": 5.0,
                                 "idle_moe.prefill": 10.0,
                                 "idle_attention.prefill": 15.0})
    assert all(f({}, trace) is None for f in spantrace.SHARES.values())


def test_a_traced_run_prints_the_table_before_the_checks(tmp_path):
    root = testing.small_copy(tmp_path)
    got, log = {}, io.StringIO()
    with spantrace.recording(got, log=log):
        out = harness.run(testing.PREFILL, SEED, 0.3, True, device="cpu",
                          root=root, log=log)
    lines = log.getvalue().splitlines()
    first_check = next(i for i, x in enumerate(lines)
                       if x.startswith("check "))
    assert any(x.startswith("span moe.count_wait ")
               for x in lines[:first_check])
    batches = got["spans"]["portbench.prefill"]["n"]
    layers = testing.TINY_MOE["n_layers"]
    assert got["spans"]["moe.count_wait"]["n"] == layers * batches
    assert got["spans"]["prefill.attention"]["n"] == layers * batches
    assert out["metrics"]["moe_wait.prefill"]["value"] > 0


# -- on the card ------------------------------------------------------------

def traced_run(workload, seconds, card):
    got = {}
    with spantrace.recording(got, log=sys.stderr):
        out = harness.run(workload, SEED, seconds, True, device=card)
    return out, got


@pytest.mark.cuda
def test_a_traced_plan_run_counts_its_ranges_and_joins_every_launch(card):
    out, got = traced_run("deepseek-7b.plan-train", 1.0, card)
    s = got["spans"]
    answers = s["portbench.plan"]["n"]
    assert out["correct"] and answers >= 1
    assert out["checked"]["step_missing"]["value"] == 0
    assert s["planner.point"]["n"] == 5 * answers
    assert s["planner.release"]["n"] == 10 * answers
    assert s["planner.build"]["n"] == s["planner.step"]["n"] == 5 * answers
    assert s["portbench.plan"]["device_s"] >= 0.99 * got["kernel_s"]
    assert "release.plan" in out["metrics"]


@pytest.mark.cuda
def test_a_traced_prefill_run_counts_its_ranges_and_joins_every_launch(card):
    out, got = traced_run("olmoe-1b-7b.prefill-mixed", 3.0, card)
    s = got["spans"]
    batches = s["portbench.prefill"]["n"]
    assert out["correct"] and batches >= 2
    assert s["moe.count_wait"]["n"] == 16 * batches
    assert s["prefill.moe"]["n"] == s["prefill.attention"]["n"] == \
        16 * batches
    assert s["portbench.prefill"]["device_s"] >= 0.99 * got["kernel_s"]
    assert "moe_wait.prefill" in out["metrics"]
