"""What a run loads: no module whose top-level name is jax, jaxlib, flax or
repro (the JAX package; repro_torch is not it), compared whole; the
reference loads nothing of the program. Each check runs in a fresh process,
since the test process itself may hold JAX."""
import json
import os
import shutil
import subprocess
import sys

from portbench.harness import ROOT, banned_modules

RUN_SMALL = """
import json, sys, tempfile
from pathlib import Path
from portbench import harness, testing
root = testing.small_copy(Path(tempfile.mkdtemp(dir=sys.argv[1])))
r = harness.run(testing.PREFILL, 2 ** 31 + 3, 0.2, True, device="cpu",
                root=root)
print(json.dumps({"correct": r["correct"],
                  "banned": harness.banned_modules(),
                  "program": "repro_torch" in sys.modules}))
"""

REFERENCE_ONLY = """
import json, sys
import torch
from portbench import weights as W
from portbench.reference import planner, train, transformer
cfg = json.load(open(sys.argv[1]))
cfg.update(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
           vocab_size=128)
cfg["moe"].update(n_experts=4, top_k=2, d_ff_expert=16)
w = {n: t.float() for n, t in W.draw(cfg, 1, "cpu", torch.bfloat16)}
transformer.prefill(w, cfg, torch.randint(0, 128, (2, 8)))
planner.numbers(dict(cfg, family="dense", d_ff=64),
                {"ladder": [2, 3, 4], "readings": [1.0, 2.0, 3.1],
                 "slope": 1.05, "intercept": -1.0, "r2": 0.99,
                 "requirement_gib": 0.0, "gpus": 1, "job": "a",
                 "expected_job": "a", "param_dtype": "float32"})
dense = dict(cfg, family="dense", d_ff=64, n_layers=1)
w = {n: t.float() for n, t in W.draw(dense, 1, "cpu", torch.float32)}
toks = torch.randint(0, 128, (2, 8))
train.first_step(w, dense, toks, toks, {"lr": 3e-4, "b1": 0.9, "b2": 0.95,
                 "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
                 "warmup": 100, "total_steps": 10000, "floor": 0.1})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def python(code, *args, pythonpath):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pythonpath))
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=600)


def test_banned_names_are_compared_whole():
    assert banned_modules({"repro": 1, "repro.core": 1, "jax.numpy": 1,
                           "jaxlib": 1, "flax.linen": 1, "repro_torch": 1,
                           "jaxtyping": 1, "reprox.y": 1}) == \
        ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    out = python(RUN_SMALL, str(tmp_path),
                 pythonpath=[str(ROOT / "src"), str(ROOT)])
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "banned": [], "program": True}


def test_the_reference_loads_nothing_of_the_program():
    out = python(REFERENCE_ONLY,
                 str(ROOT / "portbench/configs/olmoe-1b-7b.json"),
                 pythonpath=[str(ROOT)])
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert "torch" in loaded


def test_the_command_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return                   # the card's own runs show the other side
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "olmoe-1b-7b.prefill-mixed", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "olmoe-1b-7b.prefill-mixed", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
