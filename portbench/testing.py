"""Support for the benchmark's CPU tests: a temporary copy of the benchmark
with small cells added as new files only (a configuration, a traffic mix, a
cell's limits and a per-layer metric), as a later change would add them.

  root = small_copy(tmp_path)
  harness.run("tiny-moe.tiny-prefill", seed, 1.0, False, device="cpu",
              root=root)
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness import ROOT

PREFILL = "tiny-moe.tiny-prefill"
PLAN = "tiny-dense.tiny-plan"

TINY_MOE = dict(name="tiny-moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_head=16, d_ff=32, vocab_size=256)
TINY_DENSE = dict(name="tiny-dense", n_layers=16, d_model=64, n_heads=4,
                  n_kv_heads=4, d_head=16, d_ff=96, vocab_size=256)
PREFILL_LIMITS = {"kv_rel.layer0": 0.026, "kv_rel.layer1": 0.15,
                  "kv_rel.deep": 0.15, "pos_wrong": 0}
PLAN_LIMITS = {"slope_below_state": 0.13, "fit_rel": 6e-8, "gpus_wrong": 0,
               "job_wrong": 0, "loss_rel": 1e-5, "grad_rel": 1e-4,
               "param_moved": 0, "step_missing": 0}
THROWAWAY_METRIC = '''"""throwaway.metric: the number of requests in the traced window."""


def read(ctx):
    return float(len(ctx["record"]["requests"]))
'''


def _write(path: Path, data) -> None:
    path.write_text(data if isinstance(data, str) else json.dumps(data))


def small_copy(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ under `tmp` with the cells
    PREFILL (a 2-layer MoE, bfloat16 on the CPU, batches of 64 tokens) and
    PLAN (a 16-layer dense float32 job of 32 tokens), and the per-layer
    metric "throwaway.metric" in both."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / "portbench"

    moe = json.loads((bench / "configs/olmoe-1b-7b.json").read_text())
    moe.update(TINY_MOE)
    moe["moe"].update(n_experts=8, top_k=2, d_ff_expert=32)
    dense = json.loads((bench / "configs/deepseek-7b.json").read_text())
    dense.update(TINY_DENSE)
    prefill = json.loads((bench / "traffic/prefill-mixed.json").read_text())
    prefill.update(tokens_per_batch=64, cycle=[[16, 2], [32, 1], [64, 1]])
    plan = json.loads((bench / "traffic/plan-train.json").read_text())
    plan.update(cycle=[[2, 16], [1, 32], [4, 8]])
    _write(bench / "configs/tiny-moe.json", moe)
    _write(bench / "configs/tiny-dense.json", dense)
    _write(bench / "traffic/tiny-prefill.json", prefill)
    _write(bench / "traffic/tiny-plan.json", plan)
    _write(bench / f"limits/{PREFILL}.json", {"limits": PREFILL_LIMITS})
    _write(bench / f"limits/{PLAN}.json", {"limits": PLAN_LIMITS})
    _write(bench / "metrics/throwaway.metric.py", THROWAWAY_METRIC)

    for name in ("tiny-moe", "tiny-dense"):
        spec["configs"].append({"name": name, "source": "a test's",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "a test's"})
    for name in (PREFILL, PLAN):
        config, traffic = name.split(".")
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a test's"})
    like = {PREFILL: "olmoe-1b-7b.prefill-mixed",
            PLAN: "deepseek-7b.plan-train"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        for new, old in like.items():
            if old in m.get("workloads", ()):
                m["workloads"].append(new)
    spec["per_layer"].append({"name": "throwaway.metric", "unit": "1",
                              "better": "higher", "source": "program_counter",
                              "layer": "device", "moves": "setup_s",
                              "workloads": [PREFILL, PLAN]})
    _write(root / "BENCHMARK.json", spec)
    return root


class CPUProfiler:
    """Stands in for the program's ``CUDAMemoryProfiler`` on the CPU, where
    the planner cannot read a card's peak: it runs the job and reads the
    bytes a float32 AdamW step of that depth keeps (16 a parameter) plus a
    fixed activation term, a straight line in depth."""

    config = None

    def profile(self, job, size, device=None):
        from portbench.reference import planner as R
        from repro_torch.core.profiler import ProfileResult
        job()
        cfg = self.config
        outside = 2 * cfg["vocab_size"] * cfg["d_model"] + cfg["d_model"]
        reading = 16.0 * (R.layer_params(cfg) * int(size) + outside) + 4096.0
        return ProfileResult(size, reading, 0.0, 0.0)


def cpu_planner(monkeypatch, config: dict) -> None:
    """Put CPUProfiler in the planner's place for `config`."""
    import repro_torch.core.hbm_planner as HP
    profiler = type("Profiler", (CPUProfiler,), {"config": config})
    monkeypatch.setattr(HP, "CUDAMemoryProfiler", profiler)
