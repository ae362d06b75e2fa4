"""The PyTorch package, its examples and chip_smoke.py stand on their own:
no import of jax or of the JAX package, no library attention or norm call,
no failure swallowed in chip_smoke.py, and no module of the package but
sharding/collectives.py that calls torch.distributed."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
TORCH_EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
EXAMPLES = TORCH_EXAMPLES + [
            ROOT / "benchmarks" / "torch_train_step_memory.py",
            ROOT / "benchmarks" / "torch_loss_backward_peak.py",
            ROOT / "benchmarks" / "torch_serve_profile.py"]
SOURCES = sorted(PACKAGE.rglob("*.py")) + [SMOKE] + EXAMPLES
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "repro"}


def imported_roots(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names.add(node.module.split(".")[0])
    return names


def test_sources_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"src/repro_torch/models/model.py",
            "src/repro_torch/kernels/rmsnorm.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/kernels/wkv6.py",
            "src/repro_torch/kernels/ssd.py",
            "src/repro_torch/models/rwkv.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/launch/serve.py", "chip_smoke.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/schedule.py",
            "src/repro_torch/optim/compression.py",
            "src/repro_torch/train/step.py", "src/repro_torch/train/loop.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/checkpoint/ckpt.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/core/sampling.py",
            "src/repro_torch/core/memory_model.py",
            "src/repro_torch/core/catalog.py",
            "src/repro_torch/core/history.py",
            "src/repro_torch/core/selector.py",
            "src/repro_torch/core/profiler.py",
            "src/repro_torch/core/hbm_planner.py",
            "src/repro_torch/launch/presets.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/allocator/service.py",
            "src/repro_torch/pipeline/pipeline.py",
            "src/repro_torch/telemetry/spans.py",
            "src/repro_torch/core/crispy.py",
            "src/repro_torch/core/simulator.py",
            "src/repro_torch/core/local_jobs.py",
            "src/repro_torch/profiling/budget.py",
            "src/repro_torch/profiling/executor.py",
            "src/repro_torch/profiling/scheduler.py",
            "src/repro_torch/profiling/store.py",
            "src/repro_torch/state/backend.py",
            "src/repro_torch/state/compaction.py",
            "src/repro_torch/state/file_backend.py",
            "src/repro_torch/state/transport.py",
            "src/repro_torch/state/daemon.py",
            "src/repro_torch/state/sharding.py",
            "src/repro_torch/telemetry/trace_tool.py",
            "src/repro_torch/sharding/collectives.py",
            "src/repro_torch/sharding/rules.py",
            "src/repro_torch/sharding/pipeline.py",
            "src/repro_torch/launch/mesh.py",
            "examples/gpu_advisor_torch.py",
            "examples/serve_demo_torch.py",
            "examples/mesh_advisor_torch.py",
            "examples/quickstart_torch.py",
            "examples/profile_and_select_torch.py",
            "benchmarks/torch_train_step_memory.py",
            "benchmarks/torch_loss_backward_peak.py",
            "benchmarks/torch_serve_profile.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_of_jax_or_the_jax_package(path):
    assert not imported_roots(path) & FORBIDDEN


def test_package_imports_with_jax_and_repro_blocked():
    """Every module of the package imports in a process where `jax` and
    `repro` cannot be imported at all."""
    modules = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
               .removesuffix(".__init__") for p in sorted(PACKAGE.rglob("*.py"))]
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


@pytest.mark.parametrize("path", TORCH_EXAMPLES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_each_example_imports_with_jax_and_repro_blocked(path):
    """An example of the port loads (its main not run) in a process where
    `jax` and `repro` cannot be imported at all, and none is left
    imported."""
    code = ("import sys, importlib.util\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_library_attention_or_norm_in_the_package(path):
    """Library kernels are yardsticks in chip_smoke.py only."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Name):
            names.add(node.id)
    assert not names & {"scaled_dot_product_attention", "compile",
                        "cpp_extension", "layer_norm", "group_norm"}


def test_rms_norm_is_the_ports_own_everywhere():
    """Every `x.rms_norm` in the package is `L.rms_norm`, the port's own
    function over its kernel, never torch.nn.functional's."""
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr == "rms_norm":
                owner = node.value
                assert isinstance(owner, ast.Name) and owner.id == "L", \
                    f"{path}: rms_norm of {ast.dump(owner)}"


def test_chip_smoke_swallows_no_failure():
    """No `try` at all: a phase that fails ends the run."""
    tree = ast.parse(SMOKE.read_text())
    assert not [n for n in ast.walk(tree)
                if isinstance(n, (ast.Try, ast.ExceptHandler))]


def test_kernel_wrappers_have_no_fallback():
    """On a CUDA tensor a wrapper launches its kernel or raises."""
    for name in ("rmsnorm.py", "flash_attention.py", "wkv6.py", "ssd.py",
                 "build.py"):
        tree = ast.parse((PACKAGE / "kernels" / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


COLLECTIVES = PACKAGE / "sharding" / "collectives.py"


def names_torch_distributed(path: Path) -> bool:
    """Whether `path` imports torch.distributed or reaches it as an
    attribute (``torch.distributed``, ``dist.`` after such an import)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import) and any(
                a.name.startswith("torch.distributed") for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.startswith("torch.distributed") or
                (node.module == "torch" and
                 any(a.name == "distributed" for a in node.names))):
            return True
        if isinstance(node, ast.Attribute) and node.attr == "distributed":
            return True
    return False


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_only_the_collectives_module_calls_torch_distributed(path):
    assert names_torch_distributed(path) == (path == COLLECTIVES), path
