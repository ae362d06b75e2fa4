#!/usr/bin/env python3
"""Where the time goes in the PyTorch package's serving path on one GPU.

    PYTHONPATH=src python benchmarks/torch_serve_profile.py [--layers 30]

Builds deepseek-7b (bfloat16, random weights from a seed), then traces with
torch.profiler (CPU and CUDA activities):

  * one `Model.forward` at B=4, S=2048, and
  * `--steps` decode steps at B=8 over a cache of 256 positions, the shape
    of one tick of the serving engine.

For each it prints one JSON line: the wall time of a call, the time the
device was busy (sum of kernel times), the idle share, the number of kernels
a call, and the kernels that take most device time. Needs a GPU; fails
without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import RunConfig, get_arch
from repro_torch.models.model import build_model


def traced(fn, calls: int, top: int = 8):
    fn()                                     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / calls
    rows = []
    for evt in prof.key_averages():
        # kernels and copies only: an operator's row repeats the device
        # time of the kernels it launched
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3 / calls, evt.count / calls))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        raise RuntimeError("the profiler saw no device time")
    return {"wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels_per_call": sum(r[2] for r in rows),
            "top_kernels": [{"name": r[0][:80], "ms_per_call": r[1],
                             "launches_per_call": r[2]} for r in rows[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=30, help="cut of depth")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    cfg = replace(get_arch("deepseek-7b"), n_layers=args.layers)
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_model(cfg, run, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    common = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "bfloat16",
              "gpu": gpu, "torch": torch.__version__}

    tokens = rng.integers(0, cfg.vocab_size, size=(4, 2048))
    out = traced(lambda: model.forward({"tokens": tokens}), calls=2)
    print(json.dumps({"path": "forward", "batch": 4, "seq": 2048, **common,
                      **out}), flush=True)

    slots, max_len = 8, 256
    caches = model.init_caches(slots, max_len)
    caches["pos"] += 64                       # mid-request
    step = {"tokens": rng.integers(0, cfg.vocab_size, size=(slots, 1))}

    def tick():
        nonlocal caches
        logits, caches = model.decode_step(step, caches)
        logits[:, 0].float().cpu()           # the engine's copy to the host

    out = traced(tick, calls=args.steps)
    print(json.dumps({"path": "decode_step", "batch": slots,
                      "max_len": max_len, **common, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
