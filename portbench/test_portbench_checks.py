"""The harness driven on the CPU in a temporary copy with small cells added
as new files only: each file is found by its name, a sound run is correct,
and the control and each fault a cell can have make `correct` false.

The look for a card (in run.py) is skipped: these call harness.run with
device "cpu". The prefill cell's program runs in bfloat16, as the real
cell's does; the plan cell's readings come from testing.CPUProfiler, since
the card's peak cannot be read here."""
import json

import pytest
import torch

from portbench import harness, testing
from portbench import weights as W
from portbench.reference import transformer as ref

SEED = 2 ** 31 + 17


@pytest.fixture
def root(tmp_path):
    return testing.small_copy(tmp_path)


def run(root, workload, trace=False, seconds=0.3):
    return harness.run(workload, SEED, seconds, trace, device="cpu",
                       root=root)


def test_a_config_traffic_limits_and_metric_added_as_files_are_found(root):
    plain = run(root, testing.PREFILL)
    assert plain["correct"] and plain["attempted"] > 0
    assert set(plain["metrics"]) == {"prefill_tokens_per_s",
                                     "prefill_p95_ms", "setup_s"}
    assert list(plain)[-1] == "checked"
    assert set(plain["checked"]) == set(testing.PREFILL_LIMITS)
    traced = run(root, testing.PREFILL, trace=True)
    assert traced["correct"]
    assert traced["metrics"]["throwaway.metric"]["value"] >= 1
    assert "prefill_tokens_per_s" not in traced["metrics"]
    assert traced["device"]["window_s"] > 0
    json.dumps(traced)


def test_the_result_line_prints_each_number_beside_its_limit(root, capsys):
    import sys
    harness.run(testing.PREFILL, SEED, 0.2, False, device="cpu", root=root,
                log=sys.stderr)
    err = capsys.readouterr().err.strip().splitlines()
    tail = err[-len(testing.PREFILL_LIMITS):]
    for line, name in zip(tail, testing.PREFILL_LIMITS):
        assert line.startswith(f"check {name}: ") and "(limit " in line


def _prefill(monkeypatch, change):
    from repro_torch.models.model import Model
    real = Model.prefill

    def prefill(self, batch, max_len):
        return change(self, real, batch, max_len)
    monkeypatch.setattr(Model, "prefill", prefill)


def _state_unchanged(self, real, batch, max_len):
    """The caches come back as they were made, never written."""
    logits, caches = real(self, batch, max_len)
    for t in caches["moe"].values():
        t.zero_()
    return logits, caches


def _half_batch(self, real, batch, max_len):
    """Half of the prompts left out."""
    toks = batch["tokens"]
    return real(self, {"tokens": toks[:toks.shape[0] // 2]}, max_len)


def _answer_altered(self, real, batch, max_len):
    """One prompt's keys altered where the first layer writes them."""
    logits, caches = real(self, batch, max_len)
    caches["moe"]["k"][0, 0] += 1.0
    return logits, caches


def _control(self, real, batch, max_len):
    """The reference in float8 products in the program's place."""
    cfg = dict(json.loads((self._bench_root / "portbench/configs/tiny-moe.json")
                          .read_text()))
    w = {n: t.float() for n, t in self.state_dict().items()}
    ks, vs = [], []
    toks = batch["tokens"].long()
    last = ref.prefill(w, cfg, toks, precision="fp8",
                       observe=lambda l, k, v: (ks.append(k), vs.append(v)))
    L, B, S = len(ks), toks.shape[0], toks.shape[1]
    caches = {"moe": {"k": torch.stack(ks), "v": torch.stack(vs),
                      "pos": torch.full((L, B), S, dtype=torch.int32)}}
    return last[:, None], caches


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _control])
def test_the_prefill_control_and_faults_are_not_correct(root, monkeypatch,
                                                        fault):
    from repro_torch.models.model import Model
    monkeypatch.setattr(Model, "_bench_root", root, raising=False)
    _prefill(monkeypatch, fault)
    out = run(root, testing.PREFILL)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checked"].values())


@pytest.fixture
def planner(root, monkeypatch):
    cfg = json.loads((root / "portbench/configs/tiny-dense.json").read_text())
    testing.cpu_planner(monkeypatch, cfg)
    return cfg


def test_a_sound_plan_run_is_correct(root, planner):
    out = run(root, testing.PLAN, seconds=0.5)
    assert out["correct"], out["checked"]
    assert set(out["metrics"]) == {"plan_s", "setup_s"}
    traced = run(root, testing.PLAN, trace=True, seconds=0.5)
    assert traced["correct"] and "throwaway.metric" in traced["metrics"]


def _stale_answer(monkeypatch):
    """The planner hands back its first answer again: its state unchanged."""
    from repro_torch.core.hbm_planner import HBMPlanner
    real, first = HBMPlanner.plan, []

    def plan(self, *args, **kwargs):
        if not first:
            first.append(real(self, *args, **kwargs))
        return first[0]
    monkeypatch.setattr(HBMPlanner, "plan", plan)


def _reading_altered(monkeypatch):
    """The deepest point's reading 10 % low where it is measured: the
    answer under-provisions the job."""
    import repro_torch.core.hbm_planner as HP
    real = HP.CUDAMemoryProfiler.profile

    def profile(self, job, size, device=None):
        out = real(self, job, size, device)
        if int(size) == 4:
            out.peak_mem_bytes *= 0.9
        return out
    monkeypatch.setattr(HP.CUDAMemoryProfiler, "profile", profile)


def _selection_altered(monkeypatch):
    """The answer names twice the cards the requirement needs."""
    import dataclasses
    from repro_torch.core.hbm_planner import HBMPlanner
    real = HBMPlanner.select

    def select(self, *args, **kwargs):
        sel = real(self, *args, **kwargs)
        cfg = dataclasses.replace(sel.config, scale_out=2 * sel.config.scale_out)
        return dataclasses.replace(sel, config=cfg)
    monkeypatch.setattr(HBMPlanner, "select", select)


@pytest.mark.parametrize("fault", [_stale_answer, _reading_altered,
                                   _selection_altered])
def test_the_plan_faults_are_not_correct(root, planner, monkeypatch, fault):
    fault(monkeypatch)
    out = run(root, testing.PLAN, seconds=0.5)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checked"].values())


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_the_plan_step_faults_are_not_correct(root, planner, fault):
    """The step the planner times, broken underneath: half of its batch
    left out and the mean taken over the rest, or its state handed back
    unchanged. The planner's bytes read the same; the step's check fails."""
    from portbench import control
    with control.planted(fault):
        out = run(root, testing.PLAN, seconds=0.5)
    assert out["correct"] is False
    bad = {k for k, c in out["checked"].items() if c["value"] > c["limit"]}
    assert bad and bad <= {"loss_rel", "grad_rel"}


def test_a_sound_plan_run_checks_a_step_of_every_answer(root, planner):
    out = run(root, testing.PLAN, seconds=0.5)
    assert out["checked"]["step_missing"]["value"] == 0.0
    assert out["checked"]["grad_rel"]["value"] < 1e-5


def test_the_weights_the_program_gets_are_the_references(root):
    cfg = json.loads((root / "portbench/configs/tiny-moe.json").read_text())
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import Model
    m = Model(harness.port_config(cfg), RunConfig(param_dtype="bfloat16"),
              device="cpu")
    W.fill(dict(m.state_dict()), cfg, SEED)
    again = dict(W.draw(cfg, SEED, "cpu", torch.bfloat16))
    assert all(torch.equal(t, again[n]) for n, t in m.state_dict().items())
