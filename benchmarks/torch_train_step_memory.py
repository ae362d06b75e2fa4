#!/usr/bin/env python3
"""Time and memory of the PyTorch package's float32 train step on one GPU.

    PYTHONPATH=src python benchmarks/torch_train_step_memory.py \
        --arch deepseek-7b --layers 4 [--chunk 16777216]

Builds the model at full width with its depth cut to `--layers` (float32,
blocked attention, remat "nothing": the train launcher's choices), then runs
`--steps` steps of loss, backward and AdamW update on one (B, S) batch of
tokens drawn from a seed, and prints one JSON line with:

  * the device time (CUDA events, median over the steps after the first) of
    the loss with its backward, and of the AdamW update (`--chunk` sets the
    update's chunk bound; left out, the package's default);
  * the peak bytes allocated by a step (`max_memory_allocated` after a
    reset, the collector run between steps);
  * the bytes allocated between steps with the garbage collector off, in
    bytes a parameter: 12 (weights, m, v) when nothing of a step outlives
    it.

Needs a GPU; fails without one.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
from dataclasses import replace

import torch

from repro_torch.configs import RunConfig, get_arch
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import leaves, like_tree
from repro_torch.train.step import init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = replace(get_arch(args.arch), n_layers=args.layers)
    model = Model(cfg, RunConfig(attn_impl="blocked", remat="nothing",
                                 compute_dtype="float32"))
    acfg = AdamWConfig(lr=3e-4)
    state = init_train_state(model, args.seed, acfg)
    n_params = sum(p.numel() for p in leaves(state.params))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.seq + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    chunk = {} if args.chunk is None else {"chunk": args.chunk}

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, _ = model.loss_fn(batch, state.params)
        grads = like_tree(state.params,
                          torch.autograd.grad(loss, leaves(state.params)))
        ev[1].record()
        adamw_update(state.params, grads, state.opt, acfg, **chunk)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    loss_ms, update_ms, peaks = [], [], []
    for i in range(args.steps):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        a, b = step()
        peaks.append(torch.cuda.max_memory_allocated())
        if i:
            loss_ms.append(a)
            update_ms.append(b)
    gc.collect()
    gc.disable()
    try:
        for _ in range(3):
            step()
        between = torch.cuda.memory_allocated()
    finally:
        gc.enable()

    def median(v):
        return sorted(v)[len(v) // 2]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "batch": args.batch,
        "seq": args.seq, "params": n_params, "chunk": args.chunk,
        "loss_and_backward_ms": median(loss_ms),
        "update_ms": median(update_ms),
        "step_peak_bytes": max(peaks),
        "bytes_a_param_between_steps_collector_off": between / n_params,
        "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
