"""The harness: finds a cell's files by name, runs set-up, the window and
the check, and builds the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

  portbench/configs/<config>.json    the sizes, as the program runs them
  portbench/traffic/<traffic>.json   a mix's parameters; its "driver" names
                                     the general generator and entry,
                                     portbench/drivers/<driver>.py
  portbench/limits/<workload>.json   the limits of the cell's check
  portbench/metrics/<metric>.py      a per-layer metric's reader,
                                     ``read(ctx) -> float | None``

A driver module has ``Cell(config, traffic, seed, device)`` with ``setup()``,
``window(seconds, mark)`` -> record, ``release()``, ``check()`` -> every
number it reads of the outputs due (those the cell's limits name are
compared; a missing one fails), and ``end_to_end(record)`` -> metric values.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench.devicetrace import WINDOW, summarise

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of BANNED, compared whole (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in BANNED)


class Spec:
    """``BENCHMARK.json`` of a checkout, and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def json(self, rel: str) -> Dict:
        return json.loads((self.root / rel).read_text())

    def cell(self, workload: str) -> Dict:
        for cell in self.data["workloads"]:
            if cell["name"] == workload:
                return cell
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return self.json(c["file"])
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: Dict) -> Dict:
        return self.json(f"portbench/traffic/{cell['traffic']}.json")

    def limits(self, cell: Dict) -> Dict[str, float]:
        return self.json(f"portbench/limits/{cell['name']}.json")["limits"]

    def _applies(self, metric: Dict, cell: Dict, reported=()) -> bool:
        if "workloads" in metric:
            return cell["name"] in metric["workloads"]
        return metric.get("moves") is None or metric["moves"] in reported

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: Dict) -> List[Dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if self._applies(m, cell, reported)]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def port_config(cfg: dict):
    """The program's ModelConfig of a configuration file: the file's keys
    that name fields of ``repro_torch.configs.base.ModelConfig``."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig, MoEConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def _synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_info(device, peak: int, count: int) -> Dict:
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", root: Path = ROOT, t0: Optional[float] = None,
        log=sys.stderr) -> Dict:
    """One run of a cell -> the result line (a dict). `t0` is when the
    process started, for set-up; the numbers compared are printed to `log`
    last."""
    import torch
    t0 = time.monotonic() if t0 is None else t0
    spec = Spec(root)
    cell = spec.cell(workload)
    traffic = spec.traffic(cell)
    limits = spec.limits(cell)
    program = driver(traffic["driver"]).Cell(spec.config(cell), traffic,
                                             seed, device)
    cuda = torch.device(device).type == "cuda"
    program.setup()
    _synchronize(device)
    setup_s = time.monotonic() - t0

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
    mark = _mark(trace)
    with prof if prof is not None else nullcontext():
        with mark(WINDOW):
            record = program.window(seconds, mark)
    summary = None
    if prof is not None:
        summary = summarise(prof)
        del prof
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    program.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    read = program.check()
    checked = {name: compared(read.get(name, float("inf")), limit)
               for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checked.values())

    if trace:
        ctx = {"config": program.config, "traffic": traffic,
               "record": record, "trace": summary}
        metrics = {}
        for m in spec.per_layer(cell):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(program.end_to_end(record), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(cell)}
    dev = _device_info(device, peak, cell["chips"])
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checked"] = checked
    for name in sorted(set(read) - set(limits)):
        print(f"read {name}: {read[name]!r} (not compared)", file=log)
    for name, c in checked.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
              f"{'' if c['value'] <= c['limit'] else '  FAILED'}", file=log)
    return result


def _mark(trace: bool):
    """A context manager factory naming a range of the window in the trace
    (a no-op when not tracing)."""
    if not trace:
        return lambda name: nullcontext()
    from torch.profiler import record_function
    return record_function


def compared(value: float, limit: float) -> Dict[str, float]:
    """One number compared beside its limit. A value that is not finite
    fails, and is written as 1e308 so that the line stays JSON."""
    value = float(value)
    if value != value or abs(value) == float("inf"):
        value = 1e308
    return {"value": value, "limit": float(limit)}
