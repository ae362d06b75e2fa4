#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` (rmsnorm and
its backward, flash_attention, wkv6, ssd), holds each against its plain
PyTorch version on the card, drives the serving paths of deepseek-7b,
rwkv6-7b, zamba2-7b, olmoe-1b-7b and whisper-small at full width and depth,
of deepseek-v3-671b at full width cut to 4 layers (its 3 dense layers, 1 MoE
layer and the MTP block's weights: 53 GB in bfloat16) and of
llama-3.2-vision-90b at full width cut to 10 layers (two groups of four
self-attention layers and one gated cross-attention layer over 1601 media
tokens: 21.3 GB in bfloat16), random weights from a seed and random media
and frames, through ``Model.forward``, ``Model.prefill``,
``Model.decode_step`` and the ``repro_torch.launch.serve`` command line,
the training path of every family through the ``repro_torch.launch.train``
command line, each with a resume from its checkpoint: deepseek-7b,
olmoe-1b-7b and rwkv6-7b at full width cut to 4 layers, zamba2-7b to one
group of 6 Mamba2 blocks and a shared block (so that the float32 state
fits), whisper-small whole at its text context of 448; one train step of
deepseek-7b, olmoe-1b-7b, rwkv6-7b and zamba2-7b at full width (cut in
depth), whisper-small whole, deepseek-v3-671b and llama-3.2-vision-90b
reduced, on the card against the CPU; the loss and backward at full width
of deepseek-v3-671b (1 dense + 1 MoE layer of 16 experts, the MTP block)
and of llama-3.2-vision-90b (one group of 5 layers, 25.5 GB of float32
weights), whose optimizer state does not fit one card; and Crispy's
planner over the port (``repro_torch.core.hbm_planner``): six jobs
profiled over their depth ladders on the card, extrapolated, and held
against one measured step at the depth extrapolated to (deepseek-7b's
float32 train step at 20 layers, near the card's memory, among them).
Every line of
standard output is
one JSON object, except the line before the last, which is the card's name
and power limit as ``nvidia-smi`` prints them. The last line is
``{"ok": true, "device": {...}}``. Any failure (no card, a kernel that does
not build, launch or agree, a phase out of its gate) ends the run with a
traceback and a non-zero exit code; no failure is caught.

Phases, in order: env, kernels, parity, prefill, serve, train, planner.
``--phases`` runs a subset while developing; such a run never prints the
last line and exits 2.
The kernels phase times each kernel on the device (CUDA events) beside its
plain version and, where there is one, a PyTorch call; for rmsnorm at a
decode step's rows it also prints the wrapper's cost on the host per call
(``time.perf_counter`` around 1000 calls with no synchronisation), so that
host time and device time are told apart.

Peaks used for the bounds are the H100 SXM data sheet's: 989 TFLOP/s bf16
dense, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of device
memory.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PHASES = ("env", "kernels", "parity", "prefill", "serve", "train",
          "planner")

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the reference's kernel test grid (tests/test_kernels.py)
ATTN_GRID = [(1, 32, 32, 2, 2, 16), (2, 64, 64, 4, 2, 32),
             (1, 96, 48, 4, 1, 64), (2, 33, 65, 2, 2, 16)]
NORM_GRID = [(4, 64), (3, 17, 96), (2, 5, 7, 128)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}    # atol = rtol

WKV_TOL = {torch.float32: (1e-4, 5e-4), torch.bfloat16: (2e-2, 2e-2)}  # atol, rtol
WKV_STATE_TOL = 1e-3
KERNELS = ("rmsnorm", "rmsnorm_backward", "flash_attention", "wkv6", "ssd")

# Launches a forward (or prefill) and a decode step make, from the configs:
#   deepseek-7b: 30 layers, 2 norms each + the final one; attention each layer
#   rwkv6-7b:    32 layers, 2 norms each + 1; wkv6 each layer, also at decode
#   zamba2-7b:   81 // 6 = 13 groups of 6 Mamba2 blocks (78), 2 norms each
#                (ln, ssm_norm), 13 shared attention blocks with 2 norms each,
#                + 1 = 183; ssd each Mamba2 block and flash attention each
#                shared block, neither at decode
#   olmoe-1b-7b: 16 layers, 2 norms each + 1; attention (D = 128) each layer
#   deepseek-v3-671b at 4 layers: ln1, ln2, MLA's q_norm and kv_norm each
#                layer + 1 = 17; attention (MLA, D = 192) each layer (the
#                MTP block serves no token)
#   llama-3.2-vision-90b at 10 layers: two groups of 4 self-attention
#                blocks and 1 gated cross-attention block, 2 norms a block
#                + 1 = 21 a forward, prefill or tick; attention each block
#                (8 causal self, 2 non-causal cross over the 1601 media
#                tokens) a forward or prefill; at a tick the self blocks
#                attend over the cache in plain code and the 2 cross blocks
#                take the kernel with one query row
#   whisper-small: 12 encoder blocks with 2 norms each, enc_ln, 12 decoder
#                layers with 3 (ln1, ln2, ln_cross) and the final norm = 62
#                a forward or prefill (the prefill's final norm over the
#                last position only); a tick runs the decoder alone: 36 + 1
#                = 37; attention 12 encoder (non-causal, 1500 frames) + 12
#                decoder self (causal) + 12 cross (non-causal over 1500) a
#                forward or prefill, the 12 cross at a tick
# (inference: no rmsnorm backward anywhere)
PER_CALL = {
    "deepseek-7b": {"rmsnorm": 61, "rmsnorm_backward": 0,
                    "flash_attention": 30, "wkv6": 0, "ssd": 0},
    "rwkv6-7b": {"rmsnorm": 65, "rmsnorm_backward": 0, "flash_attention": 0,
                 "wkv6": 32, "ssd": 0},
    "zamba2-7b": {"rmsnorm": 183, "rmsnorm_backward": 0,
                  "flash_attention": 13, "wkv6": 0, "ssd": 78},
    "olmoe-1b-7b": {"rmsnorm": 33, "rmsnorm_backward": 0,
                    "flash_attention": 16, "wkv6": 0, "ssd": 0},
    "deepseek-v3-671b": {"rmsnorm": 17, "rmsnorm_backward": 0,
                         "flash_attention": 4, "wkv6": 0, "ssd": 0},
    "llama-3.2-vision-90b": {"rmsnorm": 21, "rmsnorm_backward": 0,
                             "flash_attention": 10, "wkv6": 0, "ssd": 0},
    "whisper-small": {"rmsnorm": 62, "rmsnorm_backward": 0,
                      "flash_attention": 36, "wkv6": 0, "ssd": 0},
}
PER_STEP = {
    "deepseek-7b": {"rmsnorm": 61, "rmsnorm_backward": 0,
                    "flash_attention": 0, "wkv6": 0, "ssd": 0},
    "rwkv6-7b": {"rmsnorm": 65, "rmsnorm_backward": 0, "flash_attention": 0,
                 "wkv6": 32, "ssd": 0},
    "zamba2-7b": {"rmsnorm": 183, "rmsnorm_backward": 0,
                  "flash_attention": 0, "wkv6": 0, "ssd": 0},
    "olmoe-1b-7b": {"rmsnorm": 33, "rmsnorm_backward": 0,
                    "flash_attention": 0, "wkv6": 0, "ssd": 0},
    "deepseek-v3-671b": {"rmsnorm": 17, "rmsnorm_backward": 0,
                         "flash_attention": 0, "wkv6": 0, "ssd": 0},
    "llama-3.2-vision-90b": {"rmsnorm": 21, "rmsnorm_backward": 0,
                             "flash_attention": 2, "wkv6": 0, "ssd": 0},
    "whisper-small": {"rmsnorm": 37, "rmsnorm_backward": 0,
                      "flash_attention": 12, "wkv6": 0, "ssd": 0},
}
# flash attention's instances on the VLM and enc-dec paths, at the prefill
# and serve phases' batch of 4: (use, arch, Sq, Skv, H, Hkv, D, causal).
# Skv 1601 and 1500 end in a partial tile of keys; a tick's cross-attention
# has one query row. The wrapper counts its launches by shape: those two
# phases assert that every launch of these archs has one of these shapes,
# and the kernels line reads each shape's count.
NEW_FLASH = (
    ("vlm_self", "llama-3.2-vision-90b", 2048, 2048, 64, 8, 128, True),
    ("vlm_cross", "llama-3.2-vision-90b", 2048, 1601, 64, 8, 128, False),
    ("vlm_cross_tick", "llama-3.2-vision-90b", 1, 1601, 64, 8, 128, False),
    ("whisper_encoder", "whisper-small", 1500, 1500, 12, 12, 64, False),
    ("whisper_self", "whisper-small", 448, 448, 12, 12, 64, True),
    ("whisper_cross", "whisper-small", 448, 1500, 12, 12, 64, False),
    ("whisper_cross_tick", "whisper-small", 1, 1500, 12, 12, 64, False),
)
NEW_FLASH_B = 4
# the prompt length of the prefill phase: 2048, and whisper's published text
# context of 448 (arXiv:2212.04356)
PREFILL_S = {"whisper-small": 448}
# the training path: deepseek-7b at full width cut to TRAIN_LAYERS layers,
# float32, B x S tokens a step, blocked attention (the reference launcher's
# choice above 512 tokens), no remat; a step launches 2L + 1 rmsnorm
# forwards and as many backwards, and no other kernel
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2, 2048, 5
PARITY_TRAIN = {"layers": 2, "batch": 1, "seq": 128, "block": 64}
# the MoE family's training, float32 as the train launcher runs it:
# olmoe-1b-7b at full width (64 experts top-8, vocabulary 50304) through the
# launcher, depth 16 -> MOE_TRAIN_LAYERS (1.88 G parameters, 30.1 GB of
# state at 16 bytes a parameter; 16 layers would be 110 GB), with the same
# batch, steps and resume as deepseek-7b's; the card-vs-CPU parities of
# olmoe-1b-7b at full width (2 layers) and of deepseek-v3-671b reduced (MLA,
# a dense layer, a shared expert, the MTP block); and deepseek-v3-671b's
# loss and backward at full width, 1 dense + 1 MoE layer with 16 of its 256
# routed experts and the MTP block (4.41 G parameters: 17.6 GB of weights
# and as many of gradients; an AdamW state would be 70.6 GB, so no
# optimizer step is taken)
MOE_TRAIN_LAYERS = 4
PARITY_TRAIN_MOE = {"layers": 2, "batch": 2, "seq": 256, "block": 64}
PARITY_TRAIN_DSV3 = {"batch": 2, "seq": 64, "block": 16}
WIDTH_BACKWARD_DSV3 = {"layers": 2, "experts": 16, "batch": 1, "seq": 256}
# the ssm, hybrid, vlm and audio families' training, float32 as the train
# launcher runs it (attention "full" up to 512 tokens, "blocked" above; the
# plain chunked recurrences; only rmsnorm and its backward on the card):
# rwkv6-7b at full width cut to 4 layers (1.41 G parameters, 22.6 GB of
# state) and zamba2-7b to 6 Mamba2 blocks and a shared block (one group;
# 1.11 G, 17.7 GB) at TRAIN_B x TRAIN_S, whisper-small whole (0.278 G) at
# its text context of 448 over 1500 frames, each through the launcher with
# a checkpoint and a bit-exact resume; the card-vs-CPU parities of rwkv6-7b
# (2 layers) and zamba2-7b (one group) at full width, whisper-small whole
# and the vlm's reduced config (gates set nonzero, random media); and the
# vlm's loss and backward at full width, one group of 4 self-attention
# layers and the cross-attention layer (6.38 G parameters: 25.5 GB of
# weights and as many of gradients; an AdamW state would be 102 GB, so no
# optimizer step is taken), B=1, S=2048, blocked attention, over 1601
# random media tokens with the gate at 0.7
FAMILY_TRAIN = (("rwkv6-7b", 4, TRAIN_S), ("zamba2-7b", 6, TRAIN_S),
                ("whisper-small", 12, PREFILL_S["whisper-small"]))
# (whisper's blocks of 512: blocks of 64 walk the encoder's 1500 x 1500
# scores in 576 steps a layer, ~11 s of launches on the host a card step)
PARITY_TRAIN_WHISPER = {"batch": 1, "seq": 64, "block": 512}
PARITY_TRAIN_VLM = {"batch": 2, "seq": 64, "block": 16}
WIDTH_BACKWARD_VLM = {"layers": 5, "batch": 1, "seq": 2048, "gate": 0.7}
# rmsnorm's float32 rows of those train steps, checked forward and backward
# and timed: whisper's encoder (B x 1500) and decoder (B x 448) at d 768,
# zamba2-7b's d_model and Mamba2 inner width (ssm_norm), the vlm's 8192
# (rwkv6-7b's (4096, 4096) is the train shape of the kernels' line)
FAMILY_TRAIN_NORMS = ((3000, 768), (896, 768), (4096, 3584), (4096, 7168),
                      (2048, 8192))
# the planner phase: four jobs, each profiled over the planner's depth
# ladder on the card (core/hbm_planner.py), extrapolated to the job's
# n_layers and held against one measured step at that depth. deepseek-7b's
# float32 training is extrapolated to PLANNER_TRAIN_LAYERS (2.9x the
# ladder's top of 7; a step of 20 layers peaks at ~76 GiB, near the card's
# 79.2, so that the allocator's reserve beside the peak is read where the
# card is nearly full; 30 layers would need two cards), then selected for
# at its full 30; olmoe-1b-7b's float32 training (6.7 GB of state a layer)
# over the ladder of PLANNER_MOE_ANCHOR, extrapolated to
# PLANNER_MOE_LAYERS (1.5x the ladder's top; there the allocator reserves
# 75.0 of an H100 80GB HBM3's 79.2 GiB), then selected for at its full 16.
# PLANNER_GATE is the reference's own bound (tests/test_planner.py).
PLANNER_B, PLANNER_S = 4, 2048
PLANNER_TRAIN_B, PLANNER_TRAIN_LAYERS, PLANNER_TRAIN_ANCHOR = 2, 20, 7
PLANNER_MOE_LAYERS, PLANNER_MOE_ANCHOR = 9, 6
# whisper-small's float32 train step at its text context over its 1500
# frames, over the ladder of PLANNER_WHISPER_ANCHOR (2..6 decoder layers;
# the default anchor of 12 // 4 gives two points), held at its full 12
# (the encoder is in the intercept); zamba2-7b's over whole groups of 6
# Mamba2 blocks and a shared block, held at PLANNER_ZAMBA_BLOCKS (5 groups:
# 2.98 G parameters, 47.7 GB of state), then selected for at its full 81
PLANNER_WHISPER_S, PLANNER_WHISPER_ANCHOR = 448, 6
PLANNER_ZAMBA_BLOCKS = 30
PLANNER_GATE = 0.10
N_LAYERS = {"deepseek-7b": 30, "rwkv6-7b": 32, "zamba2-7b": 81,
            "olmoe-1b-7b": 16, "deepseek-v3-671b": 61,
            "llama-3.2-vision-90b": 100, "whisper-small": 12}
# depth cut at full width, where the model does not fit one card whole:
# deepseek-v3-671b's 61 layers are 682.6 G parameters; 4 (3 dense, 1 MoE,
# with the MTP block) are 26.7 G, 53.4 GB in bfloat16.
# llama-3.2-vision-90b's 100 layers are 87.7 G parameters (175 GB in
# bfloat16); 10, two groups of period 5, are 10.66 G, 21.3 GB
CUT_LAYERS = {"deepseek-v3-671b": 4, "llama-3.2-vision-90b": 10}
# Models whose bfloat16 decode is no check of their bfloat16 forward at full
# depth, so that decode is gated with float32 arithmetic on the same
# (bfloat16) weights; the bfloat16 numbers are recorded, not gated.
# rwkv6-7b and zamba2-7b: random init amplifies rounding through the
# recurrence. The MoE models: the reference's expert init takes the expert
# count as w_gate's and w_up's fan-in (64 or 256, not d_model), so an MoE
# layer's output is many times its input, and where a token's 8th and 9th
# experts nearly tie, bfloat16 rounding on either path can route it to the
# other, which moves the logits by whole units (olmoe-1b-7b through 16 MoE
# layers, deepseek-v3-671b's one at S = 2048). Only deepseek-7b keeps the
# bfloat16 gate.
DECODE_IN_F32 = ("rwkv6-7b", "zamba2-7b", "olmoe-1b-7b", "deepseek-v3-671b")
SERVE_ARCHS = ("deepseek-7b", "rwkv6-7b", "zamba2-7b", "olmoe-1b-7b",
               "deepseek-v3-671b", "llama-3.2-vision-90b", "whisper-small")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean time of one call on the device, by CUDA events around `iters`
    calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns: dict, iters: int, rounds: int = 2) -> dict:
    """Time several functions on the one card in turns; the least mean of
    the rounds for each."""
    best = {name: None for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t = time_ms(fn, iters)
            best[name] = t if best[name] is None else min(best[name], t)
    return best


def graph_ms(fn, calls: int = 10) -> float:
    """Device time of one call with the host's cost taken out: `calls`
    calls captured in a CUDA graph, the graph replayed and timed by CUDA
    events. Where a kernel is shorter than its launch on the host, `time_ms`
    reads the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, 5) / calls
    del graph
    return ms


def host_us_in_turns(fns: dict, calls: int = 1000, rounds: int = 2) -> dict:
    """Time on the host of one call, by time.perf_counter around `calls`
    calls with no synchronisation between them, several functions in turns;
    the least of the rounds for each."""
    best = {name: None for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            us = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
            best[name] = us if best[name] is None else min(best[name], us)
    return best


def close(got, want, dtype):
    """(max abs error, whether within atol = rtol = TOL[dtype])."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= TOL[dtype] + TOL[dtype] * want.abs()).all())
    return float(err.max()), ok and bool(torch.isfinite(got).all())


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------


def phase_env(state):
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    state["smi"] = smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-2:],
          "triton_imports": importlib.util.find_spec("triton") is not None,
          "gpu": state["smi"],
          "capability": list(torch.cuda.get_device_capability(0))})


def norm_bwd_bound(rows, d, dtype, scale_dtype):
    """x and g read once, dx written once, scale read and dscale written
    once; about 10 float32 operations an element."""
    size = torch.empty((), dtype=dtype).element_size()
    ssize = torch.empty((), dtype=scale_dtype).element_size()
    nbytes = 3 * rows * d * size + 2 * d * ssize
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 10.0 * rows * d / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", nbytes


def attn_bound(B, Sq, Skv, H, Hkv, D, causal, dtype):
    """Least time for the call: bytes of q, k, v, out once each over the
    memory rate, against 4*D operations for every visible (query, key) pair
    over the peak rate of the type."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * D * (2 * B * Sq * H + 2 * B * Skv * Hkv)
    if causal:
        pairs = sum(min(i + 1, Skv) for i in range(Sq))
    else:
        pairs = Sq * Skv
    flops = 4.0 * D * pairs * B * H
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", flops


def norm_bound(rows, d, dtype, scale_dtype):
    """x read once, out written once, scale read once; about 4 float32
    operations an element."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * rows * d * size + d * torch.empty((), dtype=scale_dtype).element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 4.0 * rows * d / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", nbytes


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def wkv6_bound(B, S, H, K, dtype, state_in):
    """r, k, v read once in their type, lw read and y written once in
    float32, u read once, the state read (if given) and written once. The
    operations of the chunked form with chunks of 16 rows (the TPU kernel's
    and this one's): per chunk of q rows, q(q-1)/2 decayed r.k sums of 3K
    (an exp among them), the bonus r.(u k) of 3K a row, A V over q(q+1)/2
    pairs, (r exp(cum)) S, the state update, and the 2qK + K exps of the
    decay factors; at the peak rate of the inputs' type."""
    size = torch.empty((), dtype=dtype).element_size()
    n = B * S * H * K
    nbytes = 3 * n * size + 2 * 4 * n + 4 * H * K + \
        4 * B * H * K * K * (2 if state_in else 1)
    flops = 0
    for c0 in range(0, S, 16):
        q = min(16, S - c0)
        flops += (q * (q - 1) // 2) * 3 * K + q * 3 * K \
            + (q * (q + 1) // 2) * 2 * K + 2 * q * K * K \
            + K * K * (2 * q + 1) + 2 * q * K + K
    flops *= B * H
    return (*bound(nbytes, flops, dtype), nbytes, flops)


def ssd_bound(B, S, H, P, N, dtype, n_groups):
    """xs read once in its type, dt read once and y written once in float32,
    A read once, Bm and Cm read once per group (mamba2 hands the kernel one
    group expanded over the heads). The operations of the chunked form with
    the kernel's tile of 64 rows: per tile of q rows, the q(q+1)/2 entries
    of M (C.B of 2N, a decay and dt_j), M x, C h and its decay, and the
    state update; at the peak rate of the inputs' type."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = B * S * H * P * size + 4 * B * S * H + 4 * H + \
        2 * B * S * n_groups * N * size + 4 * B * S * H * P
    flops = 0
    for c0 in range(0, S, 64):
        q = min(64, S - c0)
        tri = q * (q + 1) // 2
        flops += tri * (2 * N + 3) + tri * 2 * P + q * N * P * 2 + 2 * q * P \
            + N * P * (2 * q + 1) + q * (N + 2)
    flops *= B * H
    return (*bound(nbytes, flops, dtype), nbytes, flops)


def phase_kernels(state):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_backward,
                                             rmsnorm_backward_plain,
                                             rmsnorm_plain)
    from repro_torch.kernels.ssd import TILE, ssd, ssd_plain
    from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
    from repro_torch.models.rwkv import wkv_recurrent
    from repro_torch.models.ssm import ssd_recurrent

    t0 = time.monotonic()
    lib_path = build.build(verbose=state["verbose"])
    build.library()
    build_s = time.monotonic() - t0
    require(lib_path.is_file() and ROOT in lib_path.parents,
            f"kernel library not built inside the checkout: {lib_path}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(state["seed"])

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    checks = []
    # --- the reference's test grid -----------------------------------------
    # + ragged 128-row tiles of the bf16 kernel, Sq > Skv and a single query
    # row; the same at D = 192 (MLA), whose key tiles are 64 rows
    for (B, Sq, Skv, H, Hkv, D) in ATTN_GRID + [(2, 150, 150, 4, 2, 112),
                                                (1, 200, 130, 8, 2, 128),
                                                (2, 1, 300, 4, 1, 128),
                                                (2, 150, 150, 4, 4, 192),
                                                (1, 200, 130, 8, 2, 192),
                                                (2, 1, 300, 4, 1, 192)]:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (randn((B, Sq, H, D), dtype),
                           randn((B, Skv, Hkv, D), dtype),
                           randn((B, Skv, Hkv, D), dtype))
                got = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err, ok = close(got, flash_attention_plain(q, k, v, causal=causal), dtype)
                checks.append({"kernel": "flash_attention",
                               "shape": [B, Sq, Skv, H, Hkv, D], "causal": causal,
                               "dtype": str(dtype), "max_abs_err": err,
                               "tol": TOL[dtype], "ok": ok})
    for shape in NORM_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(shape, dtype)
            sc = 1.0 + 0.1 * randn(shape[-1:], torch.float32)
            got = rmsnorm(x, sc)
            torch.cuda.synchronize()
            err, ok = close(got, rmsnorm_plain(x, sc), dtype)
            checks.append({"kernel": "rmsnorm", "shape": list(shape),
                           "dtype": str(dtype), "residual": False,
                           "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
    for shape, dtype in (((8, 64), torch.float32), ((3, 17, 96), torch.bfloat16),
                         ((5, 70), torch.float32), ((5, 70), torch.bfloat16),
                         ((2, 12288), torch.float32), ((2, 20000), torch.float32)):
        # (5, 70): a row length that is no multiple of 16 bytes, scalar path;
        # (2, 12288): mistral-large's width, a row of 512 threads in registers;
        # (2, 20000): no whole vectors a thread, an 80 KB row in shared memory
        x, r = randn(shape, dtype), randn(shape, dtype)
        sc = 1.0 + 0.1 * randn(shape[-1:], dtype)
        got = rmsnorm(x, sc, residual=r)
        torch.cuda.synchronize()
        err, ok = close(got, rmsnorm_plain(x, sc, residual=r), dtype)
        checks.append({"kernel": "rmsnorm", "shape": list(shape),
                       "dtype": str(dtype), "residual": True,
                       "max_abs_err": err, "tol": TOL[dtype], "ok": ok})

    def check_wkv6(shape, dtype, r, k, v, lw, u, st, y, st_out):
        want_y, want_st = wkv6_plain(r, k, v, lw, u, state=st)
        torch.cuda.synchronize()
        atol, rtol = WKV_TOL[dtype]
        err = (y - want_y).abs()
        ok = bool((err <= atol + rtol * want_y.abs()).all()) and \
            bool(torch.isfinite(y).all())
        st_diff = (st_out - want_st).abs()
        st_err = float(st_diff.max())
        ok = ok and bool((st_diff <= WKV_STATE_TOL * (1.0 + want_st.abs())).all())
        checks.append({"kernel": "wkv6", "shape": list(shape), "dtype": str(dtype),
                       "state_in": st is not None, "max_abs_err": float(err.max()),
                       "state_max_abs_err": st_err, "tol": [atol, rtol],
                       "state_tol": WKV_STATE_TOL, "ok": ok})
        return float(err.max())

    def wkv_inputs(B, S, H, K, dtype, realistic=False):
        r, k, v = (randn((B, S, H, K), dtype) for _ in range(3))
        if realistic:   # the model's decay: w0 = -0.6 plus a small LoRA term
            lw = -torch.exp(-0.6 + 0.5 * randn((B, S, H, K)))
            u = 0.1 * randn((H, K))
        else:           # the reference's kernel test (tests/test_kernels.py)
            lw = -torch.exp(randn((B, S, H, K)))
            u = 0.3 * randn((H, K))
        return r, k, v, lw, u

    for (B, S, H, K) in ((1, 16, 1, 8), (2, 40, 3, 16), (1, 33, 2, 32),
                         (2, 100, 4, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for with_state in (False, True):
                r, k, v, lw, u = wkv_inputs(B, S, H, K, dtype)
                st = randn((B, H, K, K)) if with_state else None
                y, st_out = wkv6(r, k, v, lw, u, state=st)
                check_wkv6((B, S, H, K), dtype, r, k, v, lw, u, st, y, st_out)
    # the bf16 kernel at its boundaries: one row, a short, a whole and one
    # more chunk, past two chunks and many; every K (four warps up to 32,
    # eight at 64; K = 8 padded to an mma step); no state, a state, a state
    # in place
    for S in (1, 15, 16, 17, 33, 200):
        for K in (8, 16, 32, 64):
            for state_mode in ("none", "given", "in_place"):
                B, H = 2, 3
                r, k, v, lw, u = wkv_inputs(B, S, H, K, torch.bfloat16)
                st = None if state_mode == "none" else randn((B, H, K, K))
                st0 = None if st is None else st.clone()
                out = st if state_mode == "in_place" else None
                y, st_out = wkv6(r, k, v, lw, u, state=st, state_out=out)
                require(st_out is st if state_mode == "in_place" else True,
                        "wkv6: not in place")
                check_wkv6((B, S, H, K), torch.bfloat16, r, k, v, lw, u, st0,
                           y, st_out)

    def ssd_inputs(B, S, H, P, N, dtype, groups=None, realistic=False):
        xs = randn((B, S, H, P), dtype)
        if realistic:   # mamba2's: dt = softplus(proj + dt_bias), A = -(1..16)
            bias = torch.log(torch.expm1(torch.exp(
                math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) *
                torch.rand((H,), generator=gen, device=dev))))
            dt = F.softplus(0.5 * randn((B, S, H)) + bias)
            A = -torch.linspace(1.0, 16.0, H, device=dev)
        else:           # the reference's kernel test
            dt = F.softplus(randn((B, S, H)))
            A = -torch.exp(randn((H,)))
        if groups:      # one group of B, C shared by every head, as mamba2 gives
            Bm = randn((B, S, 1, N), dtype).expand(B, S, H, N)
            Cm = randn((B, S, 1, N), dtype).expand(B, S, H, N)
        else:
            Bm, Cm = randn((B, S, H, N), dtype), randn((B, S, H, N), dtype)
        return xs, dt, A, Bm, Cm

    def check_ssd(shape, dtype, inputs, y, expanded):
        # the plain version over the kernel's tile: the same rows summed
        want, _ = ssd_plain(*inputs, chunk=TILE)
        torch.cuda.synchronize()
        err, ok = close(y, want, dtype)
        checks.append({"kernel": "ssd", "shape": list(shape), "dtype": str(dtype),
                       "bm_cm_expanded": expanded, "max_abs_err": err,
                       "tol": TOL[dtype], "ok": ok})
        return err

    # the reference's grid, then three tiles of the model's widths with the
    # model's dt and A: with the reference test's (dt ~ 0.8, |A| down to
    # ~0.1) the state grows to hundreds over 130 rows and y becomes a sum of
    # such terms that cancel, where float32 rounding alone passes 2e-5
    # (+ a shape past one tile with P split in two blocks of the bf16
    # kernel and N padded to 16 columns)
    for (B, S, H, P, N) in ((1, 32, 2, 16, 8), (2, 50, 3, 8, 16),
                            (1, 16, 1, 32, 4), (2, 130, 6, 64, 64),
                            (2, 65, 3, 40, 24)):
        for dtype in (torch.float32, torch.bfloat16):
            for expanded in (False, True):
                inputs = ssd_inputs(B, S, H, P, N, dtype, groups=expanded,
                                    realistic=S > TILE)
                y, _ = ssd(*inputs)
                check_ssd((B, S, H, P, N), dtype, inputs, y, expanded)

    # the float32 ssd kernel and the plain version at its tile against a
    # float64 step recurrence, with the reference test's dt and A
    f64 = []
    for (B, S, H, P, N) in ((2, 64, 2, 16, 32), (1, 63, 2, 64, 16), (2, 1, 3, 8, 16),
                            (1, 63, 2, 32, 4), (1, 65, 3, 64, 8), (1, 200, 2, 8, 64),
                            (2, 65, 2, 32, 32), (1, 129, 2, 40, 24), (1, 70, 2, 12, 20)):
        inputs = ssd_inputs(B, S, H, P, N, torch.float32)
        got, _ = ssd(*inputs)
        plain, _ = ssd_plain(*inputs, chunk=TILE)
        want, _ = ssd_recurrent(*inputs, dtype=torch.float64)
        scale = 1.0 + want.abs()
        f64.append({"shape": [B, S, H, P, N],
                    "kernel_max_abs_err": float((got.double() - want).abs().max()),
                    "kernel_max_rel_err": float(((got.double() - want).abs() / scale).max()),
                    "plain_max_abs_err": float((plain.double() - want).abs().max()),
                    "plain_max_rel_err": float(((plain.double() - want).abs() / scale).max()),
                    "max_abs_y": float(want.abs().max())})
    emit({"ssd_f32_against_float64": f64,
          "inputs": "the reference test's: dt = softplus(randn), A = -exp(randn)",
          "rel": "max |err| / (1 + |y|), against float32's 2e-5", "gpu": state["smi"]})
    # gated at float32's 2e-5 up to one tile; past it only recorded: the
    # state grows to hundreds, and float32 rounding alone (the plain version
    # on the CPU) can pass 2e-5 there
    require(all(e["kernel_max_rel_err"] <= TOL[torch.float32] for e in f64
                if e["shape"][1] <= TILE),
            f"ssd float32 against float64 past 2e-5: {f64}")

    # --- the models' shapes, checked and timed -------------------------------
    bf16, f32 = torch.bfloat16, torch.float32
    timed = []
    # deepseek-7b and rwkv6-7b (4096), zamba2-7b (3584, and 7168 for ssm_norm),
    # llama-3.2-vision-90b (8192) at a prefill's rows and a decode step's;
    # whisper-small (768) at the encoder's 4 x 1500 rows, the decoder's
    # 4 x 448 and a tick's 4
    host = []
    for rows, d in ((8192, 4096), (8, 4096), (8192, 3584), (8, 3584),
                    (8192, 7168), (8, 7168), (8192, 8192), (4, 8192),
                    (6000, 768), (1792, 768), (4, 768)):
        x = randn((rows, d), bf16)
        sc = (1.0 + 0.1 * randn((d,), torch.float32)).to(bf16)
        got = rmsnorm(x, sc)
        torch.cuda.synchronize()
        err, ok = close(got, rmsnorm_plain(x, sc), bf16)
        checks.append({"kernel": "rmsnorm", "shape": [rows, d],
                       "dtype": str(bf16), "residual": False,
                       "max_abs_err": err, "tol": TOL[bf16], "ok": ok})
        t = time_in_turns({
            "ms": lambda: rmsnorm(x, sc),
            "plain_ms": lambda: rmsnorm_plain(x, sc),
            "library_ms": lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-5),
        }, iters=50)
        bnd, by, nbytes = norm_bound(rows, d, bf16, bf16)
        timed.append({"name": "rmsnorm", "shape": [rows, d], "dtype": str(bf16),
                      "max_abs_err": err, **t, "bound_ms": bnd,
                      "bound_by": by, "share_of_bound": bnd / t["ms"],
                      "gbytes_per_s": nbytes / t["ms"] / 1e6})
        if rows == 8:
            host.append({"shape": [rows, d], **host_us_in_turns({
                "us": lambda: rmsnorm(x, sc),
                "library_us": lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-5),
            })})
        del x, got

    # the rmsnorm backward: every norm width at a prefill's rows, a decode
    # step's and the train phase's (B x S = 4096 rows of 4096, float32),
    # with and without residual, against the plain backward and against
    # autograd of the plain forward; dscale twice, the same bits. The MoE
    # train jobs' float32 norms too, forward and backward, untimed:
    # olmoe-1b-7b's (B x S rows of 2048 through the launcher and the
    # parity), deepseek-v3's at width (256 rows of 7168, and of 1536 and
    # 512 for q_norm and kv_norm; 255 of each in the MTP block). The other
    # families' float32 train widths (FAMILY_TRAIN_NORMS) are checked
    # forward and backward and timed both ways
    train_norms = ((4096, 2048), (512, 2048), (256, 7168), (255, 7168),
                   (256, 1536), (255, 1536), (256, 512), (255, 512))
    bwd_tol = {f32: (2e-5, 1e-4), bf16: (2e-2, 2e-2)}    # dx atol=rtol, dscale

    def rel_err(got, want):
        return float((got.float() - want.float()).abs().max()) / \
            max(float(want.float().abs().max()), 1e-30)

    for rows, d in ((8192, 4096), (8192, 3584), (8192, 7168), (8, 4096),
                    (4096, 4096)) + train_norms + FAMILY_TRAIN_NORMS:
        family = (rows, d) in FAMILY_TRAIN_NORMS
        train_norm = family or (rows, d) in train_norms
        for dtype in (f32,) if train_norm else (f32, bf16):
            for residual in (False, True):
                x, g = randn((rows, d), dtype), randn((rows, d), dtype)
                r = randn((rows, d), dtype) if residual else None
                sc = (1.0 + 0.1 * randn((d,), torch.float32)).to(dtype)
                if train_norm:
                    got = rmsnorm(x, sc, residual=r)
                    torch.cuda.synchronize()
                    err, ok = close(got, rmsnorm_plain(x, sc, residual=r), dtype)
                    checks.append({"kernel": "rmsnorm", "shape": [rows, d],
                                   "dtype": str(dtype), "residual": residual,
                                   "max_abs_err": err, "tol": TOL[dtype],
                                   "ok": ok})
                    del got
                    if family and not residual:
                        t = time_in_turns({
                            "ms": lambda: rmsnorm(x, sc),
                            "plain_ms": lambda: rmsnorm_plain(x, sc),
                            "library_ms": lambda: F.rms_norm(
                                x, (d,), weight=sc, eps=1e-5),
                        }, iters=50)
                        bnd, by, nbytes = norm_bound(rows, d, dtype, dtype)
                        timed.append({
                            "name": "rmsnorm", "shape": [rows, d],
                            "dtype": str(dtype), "max_abs_err": err, **t,
                            "bound_ms": bnd, "bound_by": by,
                            "share_of_bound": bnd / t["ms"],
                            "gbytes_per_s": nbytes / t["ms"] / 1e6})
                dx, ds = rmsnorm_backward(x, sc, g, residual=r)
                dx2, ds2 = rmsnorm_backward(x, sc, g, residual=r)
                want_dx, want_ds = rmsnorm_backward_plain(x, sc, g, residual=r)
                leaves = [t.clone().requires_grad_() for t in (x, sc)] + \
                    ([r.clone().requires_grad_()] if residual else [])
                auto = torch.autograd.grad(
                    rmsnorm_plain(leaves[0], leaves[1],
                                  residual=leaves[2] if residual else None),
                    leaves, g)
                torch.cuda.synchronize()
                tol_dx, tol_ds = bwd_tol[dtype]
                err, ok = close(dx, want_dx, dtype)
                auto_err, auto_ok = close(dx, auto[0], dtype)
                ds_rel = rel_err(ds, want_ds)
                ds_auto_rel = rel_err(ds, auto[1])
                same_bits = bool(torch.equal(ds, ds2)) and bool(torch.equal(dx, dx2))
                res_ok = True
                if residual:
                    res_ok = close(dx, auto[2], dtype)[1]
                checks.append({
                    "kernel": "rmsnorm_backward", "shape": [rows, d],
                    "dtype": str(dtype), "residual": residual,
                    "max_abs_err": err, "vs_autograd_max_abs_err": auto_err,
                    "dscale_rel_err": ds_rel, "dscale_vs_autograd_rel_err": ds_auto_rel,
                    "tol": tol_dx, "dscale_tol": tol_ds, "same_bits_twice": same_bits,
                    "ok": ok and auto_ok and res_ok and same_bits and
                          ds_rel <= tol_ds and ds_auto_rel <= tol_ds and
                          bool(torch.isfinite(ds).all())})
                if not residual and (family or not train_norm):
                    xr = x.clone().requires_grad_()
                    scr = sc.clone().requires_grad_()
                    y_lib = F.rms_norm(xr, (d,), weight=scr, eps=1e-5)
                    t = time_in_turns({
                        "ms": lambda: rmsnorm_backward(x, sc, g),
                        "forward_ms": lambda: rmsnorm(x, sc),
                        "plain_ms": lambda: rmsnorm_backward_plain(x, sc, g),
                        # the backward alone of F.rms_norm (its graph kept)
                        "library_ms": lambda: torch.autograd.grad(
                            y_lib, (xr, scr), g, retain_graph=True),
                    }, iters=20)
                    bnd, by, nbytes = norm_bwd_bound(rows, d, dtype, dtype)
                    timed.append({"name": "rmsnorm_backward", "shape": [rows, d],
                                  "dtype": str(dtype), "max_abs_err": err, **t,
                                  "bound_ms": bnd, "bound_by": by,
                                  "share_of_bound": bnd / t["ms"],
                                  "gbytes_per_s": nbytes / t["ms"] / 1e6})
                    del xr, scr, y_lib
                del x, g, r, dx, dx2, want_dx, leaves, auto
    B, S = 4, 2048
    # deepseek-v3's MLA core at float32 too: q and k of 128 + 64, one rotated
    # key broadcast over the heads, v zero-padded to 192
    H, D = 128, 192
    q = randn((B, S, H, D), f32)
    k = torch.cat([randn((B, S, H, 128), f32),
                   randn((B, S, 1, 64), f32).expand(B, S, H, 64)], dim=-1)
    v = F.pad(randn((B, S, H, 128), f32), (0, 64))
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, ok = close(got, flash_attention_plain(q, k, v, causal=True), f32)
    checks.append({"kernel": "flash_attention", "shape": [B, S, S, H, H, D],
                   "causal": True, "dtype": str(f32), "mla_inputs": True,
                   "max_abs_err": err, "tol": TOL[f32], "ok": ok})
    t = time_in_turns({
        "ms": lambda: flash_attention(q, k, v, causal=True),
        "plain_ms": lambda: flash_attention_plain(q, k, v, causal=True),
    }, iters=5, rounds=1)
    bnd, by, flops = attn_bound(B, S, S, H, H, D, True, f32)
    timed.append({"name": "flash_attention", "shape": [B, S, S, H, H, D],
                  "causal": True, "dtype": str(f32), "max_abs_err": err, **t,
                  "library_ms": None, "bound_ms": bnd, "bound_by": by,
                  "share_of_bound": bnd / t["ms"],
                  "tflops": flops / t["ms"] / 1e9})
    del q, k, v, got
    torch.cuda.empty_cache()
    # deepseek-7b (D=128, three kv-head counts), zamba2-7b (D=112),
    # olmoe-1b-7b (D=128, 16 heads) and deepseek-v3-671b (MLA, D=192)
    for H, Hkv, D in ((32, 32, 128), (32, 8, 128), (32, 2, 128), (32, 32, 112),
                      (16, 16, 128), (128, 128, 192)):
        q, k, v = (randn((B, S, H, D), bf16), randn((B, S, Hkv, D), bf16),
                   randn((B, S, Hkv, D), bf16))
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, ok = close(got, flash_attention_plain(q, k, v, causal=True), bf16)
        checks.append({"kernel": "flash_attention",
                       "shape": [B, S, S, H, Hkv, D], "causal": True,
                       "dtype": str(bf16), "max_abs_err": err,
                       "tol": TOL[bf16], "ok": ok})
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))   # views, no copy
        t = time_in_turns({
            "ms": lambda: flash_attention(q, k, v, causal=True),
            "plain_ms": lambda: flash_attention_plain(q, k, v, causal=True),
            "library_ms": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=Hkv != H),
        }, iters=20)       # steady enough to compare with SDPA
        bnd, by, flops = attn_bound(B, S, S, H, Hkv, D, True, bf16)
        timed.append({"name": "flash_attention", "shape": [B, S, S, H, Hkv, D],
                      "causal": True, "dtype": str(bf16), "max_abs_err": err,
                      **t, "bound_ms": bnd, "bound_by": by,
                      "share_of_bound": bnd / t["ms"],
                      "tflops": flops / t["ms"] / 1e9})
        del q, k, v, qt, kt, vt, got
        torch.cuda.empty_cache()
    # the VLM and enc-dec paths' instances (NEW_FLASH), bf16 at B = 4: key
    # lengths that end in a partial tile, a single query row, non-causal
    # with Sq != Skv, and D = 64. k and v are views of buffers whose rows
    # past Skv hold NaN: a kernel that read or weighed a key past the end
    # of the tensor would put NaN in the output
    for use, _, Sq, Skv, H, Hkv, D, causal in NEW_FLASH:
        B = NEW_FLASH_B
        q = randn((B, Sq, H, D), bf16)
        k, v = (randn((B, Skv + 128, Hkv, D), bf16).index_fill_(
            1, torch.arange(Skv, Skv + 128, device=dev), float("nan"))[:, :Skv]
            for _ in range(2))
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, ok = close(got, flash_attention_plain(q, k, v, causal=causal), bf16)
        checks.append({"kernel": "flash_attention", "use": use,
                       "shape": [B, Sq, Skv, H, Hkv, D], "causal": causal,
                       "dtype": str(bf16), "nan_past_skv": True,
                       "max_abs_err": err, "tol": TOL[bf16], "ok": ok})
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        t = time_in_turns({
            "ms": lambda: flash_attention(q, k, v, causal=causal),
            "plain_ms": lambda: flash_attention_plain(q, k, v, causal=causal),
            "library_ms": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=Hkv != H),
        }, iters=20)
        # the device's time alone, in a CUDA graph: the short calls are
        # shorter than their launch on the host
        t["graph_ms"] = graph_ms(lambda: flash_attention(q, k, v, causal=causal))
        t["library_graph_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=Hkv != H))
        bnd, by, flops = attn_bound(B, Sq, Skv, H, Hkv, D, causal, bf16)
        timed.append({"name": "flash_attention", "use": use,
                      "shape": [B, Sq, Skv, H, Hkv, D], "causal": causal,
                      "dtype": str(bf16), "max_abs_err": err, **t,
                      "bound_ms": bnd, "bound_by": by,
                      "share_of_bound": bnd / t["ms"],
                      "tflops": flops / t["ms"] / 1e9})
        del q, k, v, qt, kt, vt, got
        torch.cuda.empty_cache()
    # and in float32 at the parity phase's shapes (B = 1, S = 64; whisper's
    # encoder over its 1500 frames), the same NaN past Skv
    for Sq, Skv, H, Hkv, D, causal in ((64, 1601, 64, 8, 128, False),
                                       (1, 1601, 64, 8, 128, False),
                                       (64, 64, 64, 8, 128, True),
                                       (1500, 1500, 12, 12, 64, False),
                                       (64, 1500, 12, 12, 64, False),
                                       (1, 1500, 12, 12, 64, False),
                                       (64, 64, 12, 12, 64, True)):
        q = randn((1, Sq, H, D), f32)
        k, v = (randn((1, Skv + 128, Hkv, D), f32).index_fill_(
            1, torch.arange(Skv, Skv + 128, device=dev), float("nan"))[:, :Skv]
            for _ in range(2))
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, ok = close(got, flash_attention_plain(q, k, v, causal=causal), f32)
        checks.append({"kernel": "flash_attention",
                       "shape": [1, Sq, Skv, H, Hkv, D], "causal": causal,
                       "dtype": str(f32), "nan_past_skv": True,
                       "max_abs_err": err, "tol": TOL[f32], "ok": ok})
        del q, k, v, got
    # wkv6 at rwkv6-7b's prefill (B=4, S=2048, H=64, K=64) and decode step
    # (B=8 slots, S=1, the state read and written in place)
    for (B, S, dtype, with_state) in ((4, 2048, bf16, False), (4, 2048, f32, False),
                                      (8, 1, bf16, True)):
        H, K = 64, 64
        r, k, v, lw, u = wkv_inputs(B, S, H, K, dtype, realistic=True)
        st = randn((B, H, K, K)) if with_state else None
        st0 = st.clone() if with_state else None
        y, st_out = wkv6(r, k, v, lw, u, state=st, state_out=st)
        require(st_out is st if with_state else True, "wkv6: not in place")
        err = check_wkv6((B, S, H, K), dtype, r, k, v, lw, u, st0, y, st_out)
        if S > 1 and dtype == bf16:
            # and against a float64 step recurrence of the same inputs
            exact_y, exact_st = wkv_recurrent(r, k, v, lw, u, dtype=torch.float64)
            want_y, _ = wkv6_plain(r, k, v, lw, u)
            emit({"wkv6_against_float64": [B, S, H, K], "dtype": str(dtype),
                  "decay": "rwkv6-7b's (w0 = -0.6 plus a small term)",
                  "kernel_max_abs_err": float((y.double() - exact_y).abs().max()),
                  "plain_max_abs_err": float((want_y.double() - exact_y).abs().max()),
                  "kernel_state_max_abs_err":
                      float((st_out.double() - exact_st).abs().max()),
                  "kernel_vs_plain_max_abs_err": err,
                  "max_abs_y": float(exact_y.abs().max()), "gpu": state["smi"]})
            del exact_y, exact_st, want_y
        t = time_in_turns({
            "ms": lambda: wkv6(r, k, v, lw, u, state=st, state_out=st),
            "plain_ms": lambda: wkv6_plain(r, k, v, lw, u, state=st),
        }, iters=5 if S > 1 else 50)
        bnd, by, nbytes, flops = wkv6_bound(B, S, H, K, dtype, with_state)
        timed.append({"name": "wkv6", "shape": [B, S, H, K], "dtype": str(dtype),
                      "state_in_place": with_state, "max_abs_err": err, **t,
                      "library_ms": None, "bound_ms": bnd, "bound_by": by,
                      "share_of_bound": bnd / t["ms"],
                      "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                      "tflops": flops / t["ms"] / 1e9})
        del r, k, v, lw, y, st, st0, st_out
    # ssd at zamba2-7b's prefill: B=4, S=2048, H=112, P=N=64, one group
    for dtype in (bf16, f32):
        B, S, H, P, N = 4, 2048, 112, 64, 64
        inputs = ssd_inputs(B, S, H, P, N, dtype, groups=True, realistic=True)
        y, _ = ssd(*inputs)
        err = check_ssd((B, S, H, P, N), dtype, inputs, y, True)
        t = time_in_turns({
            "ms": lambda: ssd(*inputs),
            # the plain version at the model's chunk, as its plain path runs it
            "plain_ms": lambda: ssd_plain(*inputs, chunk=256),
        }, iters=5)
        bnd, by, nbytes, flops = ssd_bound(B, S, H, P, N, dtype, 1)
        timed.append({"name": "ssd", "shape": [B, S, H, P, N], "dtype": str(dtype),
                      "tile": TILE, "plain_chunk": 256, "max_abs_err": err, **t,
                      "library_ms": None, "bound_ms": bnd, "bound_by": by,
                      "share_of_bound": bnd / t["ms"],
                      "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                      "tflops": flops / t["ms"] / 1e9})
        del inputs, y
    torch.cuda.empty_cache()

    emit({"rmsnorm_host_us_per_call": host,
          "timing": "time.perf_counter around 1000 calls with no synchronisation "
                    "(the host's cost of a call), wrapper and F.rms_norm in "
                    "turns, least of 2 rounds", "gpu": state["smi"]})
    bad = [c for c in checks if not c["ok"]]
    emit({"phase": "kernels", "build_seconds": build_s,
          "library": str(lib_path.relative_to(ROOT)),
          "timing": "CUDA events around repeated launches after a warm-up, "
                    "kernel, plain and library call in turns, least of 2 rounds",
          "n_checks": len(checks), "n_failed": len(bad), "checks": checks,
          "timed": timed, "gpu": state["smi"]})
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    state["timed"] = timed
    state["worst_err"] = {
        name: max(c["max_abs_err"] for c in checks
                  if c["kernel"] == name and c["dtype"] == str(bf16))
        for name in KERNELS}
    state["worst_err"]["flash_attention_d192"] = max(
        c["max_abs_err"] for c in checks if c["kernel"] == "flash_attention"
        and c["dtype"] == str(bf16) and c["shape"][5] == 192)


def numpy_weights(model, seed):
    """A parameter tree for `model` made with numpy from `seed`: norms near
    one, matrices normal with standard deviation 1/sqrt(fan_in)."""
    from repro_torch.convert import unflatten_tree
    rng = np.random.default_rng(seed)
    flat = {}
    for path, p in model.state_dict().items():
        shape = tuple(p.shape)
        leaf = path.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "norm"):
            w = 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
        else:
            if leaf in ("embed", "head"):
                fan_in = shape[-1]
            elif leaf == "wo":
                fan_in = shape[1] * shape[2]
            else:                       # (L, fan_in, ...)
                fan_in = shape[1]
            w = rng.standard_normal(shape, dtype=np.float32)
            w *= 1.0 / math.sqrt(fan_in)
        flat[path] = w
    return unflatten_tree(flat)


def media_batch(cfg, B, seed, device):
    """The vlm family's media or the audio family's frames for a batch of
    B, random from `seed` on `device` (constant ones would make every key of
    the cross-attention equal, and its softmax uniform); {} for the other
    families."""
    if cfg.family == "vlm":
        name, rows = "media", cfg.cross_attn.n_media_tokens
    elif cfg.family == "audio":
        name, rows = "frames", cfg.encdec.enc_len
    else:
        return {}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {name: torch.randn((B, rows, cfg.d_model), generator=gen,
                              device=device)}


@torch.no_grad()
def decode_batch(model, batch):
    """What decode_step takes beside the tokens: the vlm's media as they
    are, the audio family's encoder output over the frames (as the
    reference's decode test feeds it)."""
    from repro_torch.models.transformer import encdec_encode
    if model.cfg.family == "vlm":
        return {"media": batch["media"]}
    if model.cfg.family == "audio":
        frames = batch["frames"].to(model.device, model.compute_dtype)
        return {"enc_out": encdec_encode(model.params["layers"], frames,
                                         model.cfg, model.run)}
    return {}


def phase_parity(state):
    """The card's kernel path against the same model on the CPU (plain
    versions), float32, each model at full width and cut in depth:
    deepseek-7b at 2 layers (weights from numpy), rwkv6-7b at 2 layers,
    zamba2-7b at 6 (one group of Mamba2 blocks and one shared attention
    block), olmoe-1b-7b at 2 layers, deepseek-v3-671b at 1 dense and 1
    MoE layer with 16 of its 256 experts and no MTP block, whisper-small
    whole and llama-3.2-vision-90b at 5 layers (one group) with its gate
    set to 0.5 (weights drawn on the card by the model's own init; the vlm's
    gate starts at 0, which would hide the cross path); random media and
    frames."""
    from dataclasses import replace
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import Model

    # full float32 products on the card, said and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="kernel")
    gate = 1e-3
    dsv3 = get_arch("deepseek-v3-671b")
    for arch, cfg, (B, S), cut in (
            ("deepseek-7b", replace(get_arch("deepseek-7b"), n_layers=2),
             (2, 256), "depth 30 -> 2; width and vocabulary full"),
            ("rwkv6-7b", replace(get_arch("rwkv6-7b"), n_layers=2),
             (2, 256), "depth 32 -> 2; width and vocabulary full"),
            ("zamba2-7b", replace(get_arch("zamba2-7b"), n_layers=6),
             (2, 256), "depth 81 -> 6: one group of 6 Mamba2 blocks and "
                       "one shared attention block; width and vocabulary full"),
            ("olmoe-1b-7b", replace(get_arch("olmoe-1b-7b"), n_layers=2),
             (2, 256), "depth 16 -> 2; width, 64 experts top-8 and "
                       "vocabulary full"),
            ("deepseek-v3-671b", replace(
                dsv3, n_layers=2, mtp_depth=0,
                moe=replace(dsv3.moe, n_experts=16, first_dense_layers=1)),
             (2, 128), "depth 61 -> 2 (1 dense, 1 MoE layer), routed experts "
                       "256 -> 16 (top-8 and the shared expert kept), no MTP "
                       "block: the float32 model of 1 dense + 1 MoE layer + "
                       "MTP at full width is over 100 GB; width, MLA ranks, "
                       "heads and vocabulary full"),
            ("whisper-small", get_arch("whisper-small"), (1, 64),
             "none: 12 encoder layers over 1500 frames, 12 decoder layers"),
            ("llama-3.2-vision-90b",
             replace(get_arch("llama-3.2-vision-90b"), n_layers=5), (1, 64),
             "depth 100 -> 5: one group of 4 self-attention layers and the "
             "gated cross-attention layer (25.5 GB in float32), over all "
             "1601 media tokens; width and vocabulary full")):
        cpu = Model(cfg, run, device="cpu")
        if arch == "deepseek-7b":
            tree = numpy_weights(cpu, state["seed"])
            params_from_numpy(tree, cpu)
            gpu = params_from_numpy(tree, Model(cfg, run))
            del tree
        else:
            gpu = Model(cfg, run).init(seed=state["seed"])
            if cfg.family == "vlm":
                gpu.params["layers"]["cross"]["attn"]["gate"].fill_(0.5)
            cpu.load_state_dict(gpu.state_dict())
        tokens = np.random.default_rng(state["seed"] + 1).integers(
            0, cfg.vocab_size, size=(B, S))
        batch = {"tokens": tokens,
                 **media_batch(cfg, B, state["seed"] + 4, "cpu")}
        t0 = time.monotonic()
        want = cpu.forward(batch)
        cpu_s = time.monotonic() - t0
        reset_counts()
        got_gpu = gpu.forward(batch)
        got = got_gpu.cpu()
        counts = read_counts()
        err = float((got - want).abs().max())
        decode_errs = []
        if cfg.family != "dense":
            # the decode path (wkv6 at S=1 with the state in place; Mamba2's
            # carried window and state; MLA's absorbed latent cache and the
            # MoE dispatch at 2 tokens; cross-attention with one query row
            # over the media or the encoder's output) against the card's
            # own forward, at the reference's gate (tests/test_models.py)
            caches = gpu.init_caches(B, S)
            extra = decode_batch(gpu, batch)
            for t in range(8):
                lg, caches = gpu.decode_step(
                    {"tokens": tokens[:, t:t + 1], **extra}, caches)
                decode_errs.append(float((lg[:, 0] - got_gpu[:, t]).abs().max()))
            del caches, extra
        decode_gate = 5e-4
        emit({"phase": "parity", "arch": cfg.name, "n_layers": cfg.n_layers,
              "cut": cut, "dtype": "float32", "allow_tf32": False, "batch": B,
              "seq": S, "random_inputs": sorted(k for k in batch if k != "tokens"),
              "tanh_gate": 0.5 if cfg.family == "vlm" else None,
              "logits_max_abs_err": err,
              "logits_max_abs": float(want[..., :cfg.vocab_size].abs().max()),
              "gate": gate,
              "gate_reason": "same float32 arithmetic, sums over the width and "
                             "the recurrences taken in another order on the card",
              "decode_vs_forward_max_abs_err": decode_errs,
              "decode_gate": decode_gate,
              "launches": counts, "cpu_forward_seconds": cpu_s})
        require(bool(torch.isfinite(got).all()), f"parity {arch}: logits not finite")
        require(err < gate, f"parity {arch}: logits differ by {err} (gate {gate})")
        require(all(e < decode_gate for e in decode_errs),
                f"parity {arch}: decode vs forward {decode_errs} (gate {decode_gate})")
        require(all(counts[name] > 0 for name in KERNELS
                    if PER_CALL[arch][name] > 0),
                f"parity {arch}: a kernel of the path was not launched: {counts}")
        del cpu, gpu, got, got_gpu, want, batch
        gc.collect()
        torch.cuda.empty_cache()


def reset_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_backward
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    for fn in (rmsnorm, rmsnorm_backward, flash_attention, wkv6, ssd):
        fn.launches = 0
    flash_attention.launches_by_shape = {}
    rmsnorm.launches_by_width = {}
    rmsnorm_backward.launches_by_width = {}


def read_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_backward
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    return {"rmsnorm": rmsnorm.launches,
            "rmsnorm_backward": rmsnorm_backward.launches,
            "flash_attention": flash_attention.launches,
            "wkv6": wkv6.launches, "ssd": ssd.launches}


def read_shapes():
    """The wrappers' counts by shape: flash attention's by (B, Sq, Skv, H,
    Hkv, D, causal), rmsnorm's and its backward's by row width."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_backward
    return {"flash_attention": dict(flash_attention.launches_by_shape),
            "rmsnorm": dict(rmsnorm.launches_by_width),
            "rmsnorm_backward": dict(rmsnorm_backward.launches_by_width)}


def add_shapes(total, shapes):
    for name, by in shapes.items():
        into = total.setdefault(name, {})
        for key, n in by.items():
            into[key] = into.get(key, 0) + n


def add_launches(state, counts, shapes):
    """Add one main-path run's counts to the totals of the kernels line."""
    for name in counts:
        state["launches"][name] += counts[name]
    add_shapes(state["shape_launches"], shapes)


def shapes_text(shapes):
    """`read_shapes()`'s counts with their keys as text, for the JSON lines."""
    return {name: {",".join(map(str, key)) if isinstance(key, tuple)
                   else str(key): n for key, n in by.items()}
            for name, by in shapes.items()}


def check_flash_shapes(arch, shapes):
    """On the VLM and enc-dec paths every flash attention launch has one of
    NEW_FLASH's shapes, those that the kernels phase checks and times."""
    keys = {(NEW_FLASH_B, Sq, Skv, H, Hkv, D, causal)
            for _, a, Sq, Skv, H, Hkv, D, causal in NEW_FLASH if a == arch}
    if keys:
        other = set(shapes["flash_attention"]) - keys
        require(not other, f"{arch}: flash attention launched at shapes "
                           f"{sorted(other)}, not among NEW_FLASH's")


def timed_call(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


def leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def continue_prefill(model, tokens, caches, last, n, call):
    """Greedy decode steps that continue a prefill of `tokens`, each against
    the forward over the grown sequence: (max abs errors, argmax agreement,
    ms of each step). `call(step)` runs a step -> ((logits, caches), ms)."""
    errs, agree, step_ms = [], [], []
    seq = tokens.to(model.device)
    nxt = last.argmax(-1, keepdim=True)
    for _ in range(n):
        seq = torch.cat([seq, nxt], dim=1)
        (lg_d, caches), ms = call(
            lambda: model.decode_step({"tokens": nxt}, caches))
        step_ms.append(ms)
        ref = model.forward({"tokens": seq})[:, -1].float()
        got = lg_d[:, 0].float()
        require(bool(torch.isfinite(got).all()),
                f"{model.cfg.name} decode: logits not finite")
        errs.append(float((got - ref).abs().max()))
        agree.append(float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
        nxt = ref.argmax(-1, keepdim=True)
    return errs, agree, step_ms


@torch.no_grad()
def rescaled_expert_drift(model, cfg, tokens, max_len, n=4):
    """The bfloat16 decode-vs-forward continuation with the MoE layers'
    w_gate and w_up scaled by sqrt(n_experts / d_model), from the
    reference's fan-in (the expert count) to d_model's; the weights are put
    back as they were after."""
    moe = model.params["layers"]["moe"]
    kept = {name: moe[name].clone() for name in ("w_gate", "w_up")}
    for name in kept:
        moe[name].mul_(math.sqrt(cfg.moe.n_experts / cfg.d_model))
    lg, caches = model.prefill({"tokens": tokens}, max_len)
    errs, agree, _ = continue_prefill(model, tokens, caches, lg[:, 0].float(),
                                      n, timed_call)
    for name, value in kept.items():
        moe[name].copy_(value)
    return {"expert_fan_in_d_decode_vs_forward_max_abs_err": errs,
            "expert_fan_in_d_decode_argmax_agreement": agree}


def prefill_path(state, arch):
    """One model at full width and depth (deepseek-v3-671b and
    llama-3.2-vision-90b: depth cut to CUT_LAYERS), bfloat16: forward,
    prefill and decode_step through the kernels, held against each other,
    with the kernels' launches counted and asserted. The vlm's gates are
    set to 0.5 and its media, or whisper's frames, drawn at random."""
    from dataclasses import replace
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models.model import build_model

    cfg = get_arch(arch)
    require(cfg.n_layers == N_LAYERS[arch], f"{arch} depth changed")
    cut = "none"
    if arch in CUT_LAYERS:
        cfg = replace(cfg, n_layers=CUT_LAYERS[arch])
        cut = (f"depth {N_LAYERS[arch]} -> {cfg.n_layers} "
               + ("(two groups of 4 self-attention layers and 1 gated "
                  "cross-attention layer); width, heads, media tokens"
                  if cfg.family == "vlm" else
                  "(the MTP block's weights kept); width, heads, experts")
               + " and vocabulary full")
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                    attn_impl="kernel")
    B, S, n_decode = 4, PREFILL_S.get(arch, 2048), 8
    max_len = S + 256
    per_call, per_step = PER_CALL[arch], PER_STEP[arch]
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = timed_call(lambda: build_model(cfg, run, seed=state["seed"]))
    if cfg.family == "vlm":
        model.params["layers"]["cross"]["attn"]["gate"].fill_(0.5)
    tokens = torch.from_numpy(np.random.default_rng(state["seed"] + 2).integers(
        0, cfg.vocab_size, size=(B, S)))
    extras = media_batch(cfg, B, state["seed"] + 5, "cuda")
    batch = {"tokens": tokens, **extras}
    model.forward({"tokens": tokens[:, :64], **extras})   # warm-up of the libraries

    launches = dict.fromkeys(KERNELS, 0)
    shapes = {"flash_attention": {}, "rmsnorm": {}}

    def counted(fn, want):
        reset_counts()
        out, ms = timed_call(fn)
        got, by = read_counts(), read_shapes()
        require(got == want, f"{arch}: launch counts {got}, expected {want}")
        check_flash_shapes(arch, by)
        for name in launches:
            launches[name] += got[name]
        add_shapes(shapes, by)
        return out, ms

    lg_f, forward_ms = counted(lambda: model.forward(batch), per_call)
    require(lg_f.shape == (B, S, model.padded_vocab), f"forward shape {lg_f.shape}")
    require(bool(torch.isfinite(lg_f).all()), f"{arch} forward: logits not finite")
    last_f = lg_f[:, -1].float()
    head_f = lg_f[:, :n_decode].float()
    # largest |logit| without a (B, S, V) temporary, which the peak would count
    logits_max_abs = max(abs(float(m)) for m in
                         torch.aminmax(lg_f[..., :cfg.vocab_size]))
    del lg_f
    # the prefill's own peak, apart from the forward's (B, S, V) logits
    forward_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (lg_p, caches), prefill_ms = counted(
        lambda: model.prefill(batch, max_len), per_call)
    prefill_peak = torch.cuda.max_memory_allocated()
    require(lg_p.shape == (B, 1, model.padded_vocab), f"prefill shape {lg_p.shape}")
    require(lg_p.untyped_storage().nbytes() == lg_p.numel() * lg_p.element_size(),
            f"{arch}: prefill's logits hold more than the last position")
    prefill_err = float((lg_p[:, 0].float() - last_f).abs().max())

    # bfloat16 keeps 8 bits: a logit of size 4 moves by 0.016 a rounding, and
    # the decode path rounds at other places than the sequence path (other
    # shapes of matrix product; for deepseek-7b the softmax weights in
    # bfloat16 before PV) through every layer. The gate is on the largest of
    # 4 x vocabulary logits.
    gate = 0.25
    decode_errs, decode_ms, agree = [], [], []
    if cfg.family in ("dense", "moe"):
        if cfg.family == "dense":
            first = caches["k"]
            want_shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.d_head)
        else:
            n_moe = cfg.n_layers - cfg.moe.first_dense_layers
            if cfg.attention_kind == "mla":
                first = caches["moe"]["ckv"]
                want_shape = (n_moe, B, max_len, cfg.mla.kv_lora_rank)
            else:
                first = caches["moe"]["k"]
                want_shape = (n_moe, B, max_len, cfg.n_kv_heads, cfg.d_head)
        require(first.shape == want_shape, f"cache shape {first.shape}")
        decode_errs, agree, decode_ms = continue_prefill(
            model, tokens, caches, last_f, n_decode,
            lambda step: counted(step, per_step))
    else:
        # prefill hands back zeroed caches, as the reference's does for this
        # family; decode feeds the prompt token by token from them (the
        # engine's teacher forcing), each step against forward's row
        require(all(float(leaf.abs().max()) == 0.0 for leaf in leaves(caches)),
                f"{arch}: prefill caches are not zero")
        extra = decode_batch(model, batch)
        for t in range(n_decode):
            (lg_d, caches), ms = counted(
                lambda: model.decode_step({"tokens": tokens[:, t:t + 1], **extra},
                                          caches),
                per_step)
            decode_ms.append(ms)
            got, ref = lg_d[:, 0].float(), head_f[:, t]
            require(bool(torch.isfinite(got).all()), f"{arch} decode: logits not finite")
            decode_errs.append(float((got - ref).abs().max()))
            agree.append(float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
    peak = max(forward_peak, torch.cuda.max_memory_allocated())
    profiled = {}
    if cfg.family == "moe":
        # where a MoE model's forward and decode step spend the device's
        # time (torch.profiler, as benchmarks/torch_serve_profile.py does)
        sys.path.insert(0, str(ROOT / "benchmarks"))
        from torch_serve_profile import traced
        profiled = {
            "forward_profile": traced(
                lambda: model.forward({"tokens": tokens}), calls=1, top=10),
            "decode_step_profile": traced(
                lambda: model.decode_step({"tokens": tokens[:, :1]}, caches),
                calls=4, top=10)}
    rescaled = {}
    if arch == "olmoe-1b-7b":
        # recorded, not gated: the same continuation with w_gate and w_up
        # scaled from the reference's fan-in (the expert count) to d_model's
        # (deepseek-v3-671b's copy of two expert leaves would not fit)
        rescaled = rescaled_expert_drift(model, cfg, tokens, max_len)
    f32_errs, f32_gate = [], 1e-2
    if arch in DECODE_IN_F32:
        # Random-init RWKV6 amplifies rounding through its depth: at full
        # depth its two bfloat16 paths (matrix products of other shapes, the
        # recurrence stepped or chunked) part by more than a bfloat16 logit
        # rounds, and are no check of each other (recorded above, not
        # gated); so do olmoe-1b-7b's, through routing flips (DECODE_IN_F32).
        # The check is the same weights with float32 arithmetic:
        # decode against forward over the first tokens. The gate leaves room
        # for float32 rounding through 32 layers; a wrong path moves logits
        # by whole units. The weights are drawn again from the seed (the
        # same bfloat16 values) once the first model is freed: two copies of
        # deepseek-v3-671b's 53 GB do not fit.
        del model, caches
        gc.collect()
        torch.cuda.empty_cache()
        exact = build_model(cfg, run.with_(compute_dtype="float32"),
                            seed=state["seed"])
        want = exact.forward({"tokens": tokens[:, :n_decode]}).float()
        caches = exact.init_caches(B, n_decode)
        for t in range(n_decode):
            lg_d, caches = exact.decode_step({"tokens": tokens[:, t:t + 1]}, caches)
            f32_errs.append(float((lg_d[:, 0] - want[:, t]).abs().max()))
        model = exact
        del want
    emit({"phase": "prefill", "arch": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers, "cut": cut, "dtype": "bfloat16",
          "batch": B, "seq": S, "max_len": max_len,
          "params": sum(p.numel() for p in model.tree.parameters()),
          "init_ms": init_ms, "forward_ms": forward_ms, "prefill_ms": prefill_ms,
          "decode_step_ms": decode_ms,
          "prefill_vs_forward_max_abs_err": prefill_err,
          "decode_vs_forward_max_abs_err": decode_errs,
          "decode_argmax_agreement": agree, "logits_max_abs": logits_max_abs,
          "gate": gate,
          "gate_reason": "bfloat16 rounding at other places on the two paths, "
                         "through every layer; largest of 4 x vocabulary logits"
                         + ("" if arch not in DECODE_IN_F32 else
                            "; gates prefill only: decode is gated in float32"),
          "f32_decode_vs_forward_max_abs_err": f32_errs, "f32_gate": f32_gate,
          **rescaled, **profiled,
          "launches_per_call": per_call, "launches_per_decode_step": per_step,
          "launches": dict(launches), "launches_by_shape": shapes_text(shapes),
          "peak_memory_bytes": peak, "prefill_peak_memory_bytes": prefill_peak,
          "gpu": state["smi"]})
    require(prefill_err < gate, f"{arch} prefill vs forward {prefill_err} (gate {gate})")
    if arch not in DECODE_IN_F32:
        require(max(decode_errs) < gate,
                f"{arch} decode vs forward {max(decode_errs)} (gate {gate})")
    else:
        require(max(f32_errs) < f32_gate,
                f"{arch} float32 decode vs forward {f32_errs} (gate {f32_gate})")
    add_launches(state, launches, shapes)
    state["prefill_launches"][arch] = dict(launches)
    del model, caches, last_f, head_f, batch, extras
    gc.collect()
    torch.cuda.empty_cache()


def phase_prefill(state):
    for arch in SERVE_ARCHS:
        prefill_path(state, arch)


def serve_path(state, arch, slots, n_req, prompt_len, max_new, max_len):
    """The command line a user would call, one model at full size (or at
    full width cut to CUT_LAYERS, through --layers)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--dtype", "bfloat16",
            "--slots", str(slots), "--requests", str(n_req),
            "--prompt-len", str(prompt_len), "--max-new", str(max_new),
            "--max-len", str(max_len), "--seed", str(state["seed"])]
    if arch in CUT_LAYERS:
        argv += ["--layers", str(CUT_LAYERS[arch])]
    per_step = PER_STEP[arch]
    reset_counts()
    text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(text):
        done, wall_ms = timed_call(lambda: serve.main(argv))
    counts, shapes = read_counts(), read_shapes()
    require(len(done) == n_req, f"serve {arch}: {len(done)} of {n_req} finished")
    require(all(len(r.out_tokens) == max_new for r in done),
            f"serve {arch}: a request ended short")
    vocab = get_arch(arch).vocab_size
    require(all(0 <= t < vocab for r in done for t in r.out_tokens),
            f"serve {arch}: token out of range")
    norms = per_step["rmsnorm"]
    require(counts["rmsnorm"] > 0 and counts["rmsnorm"] % norms == 0,
            f"serve {arch}: {counts['rmsnorm']} rmsnorm launches, no multiple "
            f"of {norms}")
    ticks = counts["rmsnorm"] // norms
    # waves of `slots` requests, each prompt_len + max_new - 1 ticks long
    require(ticks == -(-n_req // slots) * (prompt_len + max_new - 1),
            f"serve {arch}: {ticks} ticks")
    want = {name: n * ticks for name, n in per_step.items()}
    require(counts == want, f"serve {arch}: launches {counts}, expected {want}")
    check_flash_shapes(arch, shapes)
    run_s = max(r.finished_at for r in done) - min(r.submitted_at for r in done)
    n_tokens = sum(len(r.out_tokens) for r in done)
    emit({"phase": "serve", "arch": arch, "argv": argv, "requests": len(done),
          "new_tokens": n_tokens, "ticks": ticks,
          "engine_seconds": run_s, "tokens_per_s": n_tokens / run_s,
          "tick_ms": run_s * 1e3 / ticks,
          "with_model_init_ms": wall_ms,
          "launches_per_tick": per_step,
          "launches": counts, "launches_by_shape": shapes_text(shapes),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "stdout": text.getvalue().strip().splitlines(), "gpu": state["smi"]})
    add_launches(state, counts, shapes)
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(state):
    serve_path(state, "deepseek-7b", slots=8, n_req=16, prompt_len=32,
               max_new=32, max_len=256)
    # one wave of 8 requests each: every tick of rwkv6-7b launches wkv6
    serve_path(state, "rwkv6-7b", slots=8, n_req=8, prompt_len=16, max_new=16,
               max_len=64)
    serve_path(state, "zamba2-7b", slots=8, n_req=8, prompt_len=16, max_new=16,
               max_len=64)
    serve_path(state, "olmoe-1b-7b", slots=8, n_req=16, prompt_len=16,
               max_new=16, max_len=64)
    serve_path(state, "deepseek-v3-671b", slots=8, n_req=8, prompt_len=16,
               max_new=16, max_len=64)
    # 4 slots, the batch of NEW_FLASH's tick shapes; the engine feeds the
    # reference's all-zero media and encoder output
    serve_path(state, "llama-3.2-vision-90b", slots=4, n_req=4, prompt_len=16,
               max_new=16, max_len=64)
    serve_path(state, "whisper-small", slots=4, n_req=8, prompt_len=16,
               max_new=16, max_len=64)


def train_norms(cfg):
    """rmsnorm launches of one train step's forward, and as many of its
    backward (remat "nothing"), and of a forward: ln1 and ln2 a block (MLA
    adds q_norm and kv_norm; rwkv's layer has the same two), the final
    norm, and for an MTP block its own norm, its block's and the final norm
    again over its logits; the hybrid's Mamba2 blocks have ln and ssm_norm
    and its shared blocks ln1 and ln2, one a group; the vlm's cross blocks
    ln1 and ln2 as its self blocks; whisper's encoder blocks two each, then
    enc_ln, and its decoder layers three (ln1, ln2, ln_cross)."""
    if cfg.family == "hybrid":
        groups = max(1, cfg.n_layers // cfg.hybrid.period)
        return 2 * groups * cfg.hybrid.period + 2 * groups + 1
    if cfg.family == "audio":
        return 2 * cfg.encdec.n_encoder_layers + 1 + 3 * cfg.n_layers + 1
    per_block = 4 if cfg.attention_kind == "mla" else 2
    n = per_block * cfg.n_layers + 1
    if cfg.mtp_depth:
        n += 1 + per_block + 1
    return n


def loss_terms(metrics):
    return {k: float(metrics[k]) for k in ("ce", "aux", "mtp") if k in metrics}


def train_parity(state, cfg, P, cut, weights, gate=None):
    """One train step of `cfg`, float32, on the card and on the CPU (the
    plain path) from one converted state: the loss, the gradients' norm and
    every leaf's first moment, which after one step is (1 - b1) x the
    clipped gradient. Parameters are not compared: step 1 moves each weight
    by about lr * sign(g), so a gradient near 0 whose sign differs between
    the two moves it 2 lr apart, which says nothing of the kernels.
    `weights`: "numpy" (``numpy_weights``) or "init" (the model's own init
    on the card, from the seed); `gate`, the vlm's tanh gates (they start
    at 0, which hides the cross path). The vlm's media and whisper's frames
    are random."""
    from repro_torch.configs import RunConfig
    from repro_torch.convert import (flatten_tree, params_to_numpy,
                                     train_state_from_numpy, unflatten_tree)
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.step import make_train_step

    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="blocked", remat="nothing",
                    attn_block_q=P["block"], attn_block_kv=P["block"])
    cpu = Model(cfg, run, device="cpu")
    if weights == "numpy":
        params = numpy_weights(cpu, state["seed"])
        gpu = Model(cfg, run)
    else:
        gpu = Model(cfg, run).init(seed=state["seed"])
        if gate is not None:
            gpu.params["layers"]["cross"]["attn"]["gate"].fill_(gate)
        params = params_to_numpy(gpu)

    def zeros():
        return unflatten_tree({k: np.zeros_like(v)
                               for k, v in flatten_tree(params).items()})

    tree = {"params": params, "residual": None,
            "opt": {"step": np.zeros((), np.int32), "m": zeros(), "v": zeros(),
                    "master": None}}
    cpu_state = train_state_from_numpy(tree, cpu)
    gpu_state = train_state_from_numpy(tree, gpu)
    del tree, params
    toks = np.random.default_rng(state["seed"] + 3).integers(
        0, cfg.vocab_size, size=(P["batch"], P["seq"] + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
             **media_batch(cfg, P["batch"], state["seed"] + 4, "cpu")}
    acfg = AdamWConfig(lr=1e-3)
    t0 = time.monotonic()
    cpu_state, cpu_met = make_train_step(cpu, acfg)(cpu_state, batch)
    cpu_s = time.monotonic() - t0
    reset_counts()
    (gpu_state, gpu_met), gpu_ms = timed_call(
        lambda: make_train_step(gpu, acfg)(gpu_state, batch))
    counts = read_counts()
    per_step = train_norms(cfg)
    want = {"rmsnorm": per_step, "rmsnorm_backward": per_step,
            "flash_attention": 0, "wkv6": 0, "ssd": 0}
    loss_cpu, loss_gpu = float(cpu_met["loss"]), float(gpu_met["loss"])
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    gn_rel = abs(float(gpu_met["grad_norm"]) - float(cpu_met["grad_norm"])) / \
        float(cpu_met["grad_norm"])
    names = sorted(flatten_tree(cpu_state.opt.m))
    per_leaf = {}
    for name, a, b in zip(names, leaves(gpu_state.opt.m), leaves(cpu_state.opt.m)):
        per_leaf[name] = float((a.cpu() - b).abs().max()) / \
            max(float(b.abs().max()), 1e-30)
    grad_gate, loss_gate = 1e-3, 1e-4
    emit({"phase": "train", "part": "parity", "arch": cfg.name,
          "n_layers": cfg.n_layers, "cut": cut,
          "dtype": "float32", "allow_tf32": False, "batch": P["batch"],
          "seq": P["seq"], "attn_impl": "blocked", "attn_block": P["block"],
          "random_inputs": sorted(k for k in batch
                                  if k not in ("tokens", "labels")),
          "tanh_gate": gate, "loss_cpu": loss_cpu, "loss_gpu": loss_gpu, "loss_rel_err": loss_rel,
          "loss_terms_cpu": loss_terms(cpu_met),
          "loss_terms_gpu": loss_terms(gpu_met),
          "loss_gate": loss_gate, "grad_norm_rel_err": gn_rel,
          "grad_rel_err_by_leaf": per_leaf, "grad_gate": grad_gate,
          "grad_gate_reason": "max |m_gpu - m_cpu| / max |m_cpu| a leaf; m after "
                              "one step is (1 - b1) x the clipped gradient; the same "
                              "float32 arithmetic, sums over the width, the tokens "
                              "and the vocabulary taken in another order",
          "launches": counts, "gpu_step_ms": gpu_ms, "cpu_step_seconds": cpu_s,
          "gpu": state["smi"]})
    require(counts == want,
            f"train parity {cfg.name}: launches {counts}, expected {want}")
    require(math.isfinite(loss_gpu) and math.isfinite(gn_rel),
            f"train parity {cfg.name}: loss or gradient norm not finite")
    require(loss_rel < loss_gate,
            f"train parity {cfg.name}: loss {loss_gpu} vs {loss_cpu}")
    require(max(per_leaf.values()) < grad_gate,
            f"train parity {cfg.name}: gradients differ: {per_leaf}")
    del cpu, gpu, cpu_state, gpu_state
    gc.collect()
    torch.cuda.empty_cache()


def train_parities(state):
    """deepseek-7b at full width, 2 layers (numpy weights); olmoe-1b-7b at
    full width, 2 layers; deepseek-v3-671b reduced with its MTP block;
    rwkv6-7b at full width, 2 layers; zamba2-7b at full width, one group;
    whisper-small whole; the vlm reduced, its gates at 0.7."""
    from dataclasses import replace
    from repro_torch.configs import get_arch

    train_parity(state, replace(get_arch("deepseek-7b"),
                                n_layers=PARITY_TRAIN["layers"]),
                 PARITY_TRAIN, "depth 30 -> 2; width and vocabulary full",
                 "numpy")
    train_parity(state, replace(get_arch("olmoe-1b-7b"),
                                n_layers=PARITY_TRAIN_MOE["layers"]),
                 PARITY_TRAIN_MOE, "depth 16 -> 2; width, 64 experts top-8 "
                 "and vocabulary full", "init")
    train_parity(state, get_arch("deepseek-v3-671b").reduced(),
                 PARITY_TRAIN_DSV3, "the reduced config (d_model 64, 4 layers: "
                 "1 dense + 3 MoE of 8 experts top-2 and a shared expert, MLA "
                 "ranks 32/16, the MTP block), the CPU tests' own", "init")
    train_parity(state, replace(get_arch("rwkv6-7b"),
                                n_layers=PARITY_TRAIN["layers"]),
                 PARITY_TRAIN, "depth 32 -> 2; width and vocabulary full",
                 "init")
    train_parity(state, replace(get_arch("zamba2-7b"), n_layers=6),
                 PARITY_TRAIN, "depth 81 -> 6: one group of 6 Mamba2 blocks "
                 "and a shared attention block; width and vocabulary full",
                 "init")
    train_parity(state, get_arch("whisper-small"), PARITY_TRAIN_WHISPER,
                 "none: 12 encoder layers over 1500 random frames, 12 decoder "
                 "layers", "init")
    train_parity(state, get_arch("llama-3.2-vision-90b").reduced(),
                 PARITY_TRAIN_VLM, "the reduced config (d_model 64, 4 layers: "
                 "two groups of a self-attention and a gated cross-attention "
                 "layer over 16 random media tokens), the CPU tests' own; a "
                 "full-width group is 51 GB of host memory for weights and "
                 "gradients", "init", gate=0.7)


def width_backward_dsv3(state):
    """deepseek-v3-671b's loss and backward at full width, float32: 1 dense
    and 1 MoE layer, 16 of its 256 routed experts (top-8 and the shared
    expert kept), the MTP block on; no optimizer step. The loss, its terms
    and every leaf's gradient must be finite, each norm launched forward
    and backward."""
    from dataclasses import replace
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.convert import flatten_tree
    from repro_torch.train.step import loss_and_grads

    P = WIDTH_BACKWARD_DSV3
    dsv3 = get_arch("deepseek-v3-671b")
    cfg = replace(dsv3, n_layers=P["layers"],
                  moe=replace(dsv3.moe, n_experts=P["experts"],
                              first_dense_layers=P["layers"] - 1))
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="full", remat="nothing")   # the launcher's at 256
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, run).init(seed=state["seed"]).trainable()
    n_params = sum(p.numel() for p in model.tree.parameters())
    toks = np.random.default_rng(state["seed"] + 5).integers(
        0, cfg.vocab_size, size=(P["batch"], P["seq"] + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (loss, metrics, grads), ms = timed_call(
        lambda: loss_and_grads(model, model.params, batch))
    counts, shapes = read_counts(), read_shapes()
    peak = torch.cuda.max_memory_allocated()
    names = sorted(flatten_tree(grads))
    not_finite = [n for n, g in zip(names, leaves(grads))
                  if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in zip(names, leaves(grads)) if float(g.abs().max()) == 0]
    per_step = train_norms(cfg)
    want = {"rmsnorm": per_step, "rmsnorm_backward": per_step,
            "flash_attention": 0, "wkv6": 0, "ssd": 0}
    terms = loss_terms(metrics)
    emit({"phase": "train", "part": "width_backward", "arch": cfg.name,
          "n_layers": cfg.n_layers, "n_experts": P["experts"],
          "cut": "depth 61 -> 2 (1 dense, 1 MoE layer), routed experts 256 -> "
                 "16 (top-8 and the shared expert kept), the MTP block on; "
                 "width, MLA ranks, heads and vocabulary full; no optimizer "
                 "step (an AdamW state of 4.41 G parameters is 70.6 GB)",
          "params": n_params, "dtype": "float32", "allow_tf32": False,
          "batch": P["batch"], "seq": P["seq"], "attn_impl": "full",
          "loss": float(loss), "loss_terms": terms,
          "grad_leaves": len(names), "grad_leaves_not_finite": not_finite,
          "grad_leaves_all_zero": zero, "loss_and_backward_ms": ms,
          "peak_memory_bytes": peak, "launches": counts, "gpu": state["smi"]})
    require(counts == want, f"train width {cfg.name}: launches {counts}, "
                            f"expected {want}")
    require(math.isfinite(float(loss)) and
            all(math.isfinite(v) for v in terms.values()) and
            set(terms) == {"ce", "aux", "mtp"},
            f"train width {cfg.name}: loss {float(loss)}, terms {terms}")
    require(not not_finite, f"train width {cfg.name}: gradients not finite: "
                            f"{not_finite}")
    add_launches(state, counts, shapes)
    del model, grads, loss, metrics
    gc.collect()
    torch.cuda.empty_cache()


def width_backward_vlm(state):
    """llama-3.2-vision-90b's loss and backward at full width, float32: one
    group of 4 self-attention layers and the gated cross-attention layer,
    B=1, S=2048 with blocked attention (the train launcher's choice above
    512 tokens), remat "nothing", the gate at 0.7 and 1601 random media
    tokens; no optimizer step. The loss and every leaf's gradient must be
    finite, no leaf's gradient all zero, each norm launched forward and
    backward. The peak is given beside the reckoning: the weights, as many
    bytes of gradients, and what is left, the activations."""
    from dataclasses import replace
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.convert import flatten_tree
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.step import loss_and_grads

    P = WIDTH_BACKWARD_VLM
    cfg = replace(get_arch("llama-3.2-vision-90b"), n_layers=P["layers"])
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="blocked", remat="nothing")
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, run).init(seed=state["seed"]).trainable()
    with torch.no_grad():
        model.params["layers"]["cross"]["attn"]["gate"].fill_(P["gate"])
    n_params = sum(p.numel() for p in model.tree.parameters())
    toks = np.random.default_rng(state["seed"] + 6).integers(
        0, cfg.vocab_size, size=(P["batch"], P["seq"] + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
             **media_batch(cfg, P["batch"], state["seed"] + 7, "cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    (loss, metrics, grads), ms = timed_call(
        lambda: loss_and_grads(model, model.params, batch))
    counts, shapes = read_counts(), read_shapes()
    peak = torch.cuda.max_memory_allocated()
    names = sorted(flatten_tree(grads))
    not_finite = [n for n, g in zip(names, leaves(grads))
                  if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in zip(names, leaves(grads)) if float(g.abs().max()) == 0]
    per_step = train_norms(cfg)
    want = {"rmsnorm": per_step, "rmsnorm_backward": per_step,
            "flash_attention": 0, "wkv6": 0, "ssd": 0}
    weight_bytes = 4 * n_params
    emit({"phase": "train", "part": "width_backward", "arch": cfg.name,
          "n_layers": cfg.n_layers,
          "cut": "depth 100 -> 5: one group of 4 self-attention layers and the "
                 "gated cross-attention layer; width, heads, media tokens and "
                 "vocabulary full; no optimizer step (an AdamW state of 6.38 G "
                 "parameters is 102 GB)",
          "params": n_params, "dtype": "float32", "allow_tf32": False,
          "batch": P["batch"], "seq": P["seq"], "attn_impl": "blocked",
          "remat": "nothing", "tanh_gate": P["gate"], "random_inputs": ["media"],
          "loss": float(loss), "loss_terms": loss_terms(metrics),
          "grad_leaves": len(names), "grad_leaves_not_finite": not_finite,
          "grad_leaves_all_zero": zero, "loss_and_backward_ms": ms,
          "peak_memory_bytes": peak, "allocated_before_bytes": base,
          "weight_bytes": weight_bytes, "gradient_bytes": weight_bytes,
          "beyond_weights_and_gradients_bytes": peak - 2 * weight_bytes,
          "launches": counts, "launches_by_width": shapes_text(shapes),
          "gpu": state["smi"]})
    require(counts == want, f"train width {cfg.name}: launches {counts}, "
                            f"expected {want}")
    require(math.isfinite(float(loss)),
            f"train width {cfg.name}: loss {float(loss)}")
    require(not not_finite, f"train width {cfg.name}: gradients not finite: "
                            f"{not_finite}")
    require(not zero, f"train width {cfg.name}: gradients all zero: {zero}")
    add_launches(state, counts, shapes)
    del model, grads, loss, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_full_width(state, arch, layers, cut, S=TRAIN_S):
    """`arch` at full width, cut to `layers` layers, float32, through the
    command line a user would call: TRAIN_STEPS steps of TRAIN_B x S tokens
    that write a checkpoint at the end; the launches of each kernel counted
    and asserted; then one more step from the state in memory and the same
    step from the checkpoint, which must agree to the bit (for the MoE
    family this holds the dispatch's backward to the same bits too). The
    vlm and audio families' steps take the launcher's all-zero media or
    frames."""
    from dataclasses import replace
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import Model, analytic_param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.step import init_train_state, make_train_step

    L, B, N = layers, TRAIN_B, TRAIN_STEPS
    lr = 3e-4
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", arch, "--layers", str(L), "--steps", str(N),
            "--batch", str(B), "--seq", str(S), "--lr", str(lr),
            "--ckpt-dir", str(ck), "--ckpt-every", "1000",
            "--seed", str(state["seed"])]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        (train_state, report), wall_ms = timed_call(lambda: train_cli.main(argv))
    counts, shapes = read_counts(), read_shapes()
    peak = torch.cuda.max_memory_allocated()
    cfg = replace(get_arch(arch), n_layers=L)
    per_step = train_norms(cfg)
    want = {"rmsnorm": N * per_step, "rmsnorm_backward": N * per_step,
            "flash_attention": 0, "wkv6": 0, "ssd": 0}
    n_params = sum(t.numel() for t in leaves(train_state.params))
    losses = report.losses
    steady = sorted(report.step_times[1:])
    step_s = steady[len(steady) // 2]

    # one more step from the state in memory, and from the checkpoint
    run = RunConfig(attn_impl="full" if S <= 512 else "blocked",
                    remat="nothing", compute_dtype="float32")  # the launcher's
    acfg = AdamWConfig(lr=lr)
    model = Model(cfg, run)
    step_fn = make_train_step(model, acfg, total_steps=N)
    batch = {**make_batch_fn(cfg.vocab_size, B, S, state["seed"])(N),
             **train_cli.family_inputs(cfg, B)}
    state_a, met_a = step_fn(train_state, batch)
    loss_a = float(met_a["loss"])
    want_params = [t.detach().cpu() for t in leaves(state_a.params)]
    del train_state, state_a, met_a
    gc.collect()
    torch.cuda.empty_cache()
    state_b = init_train_state(model, None, acfg)
    (_, extra), restore_ms = timed_call(
        lambda: restore_checkpoint(str(ck), latest_step(str(ck)), state_b))
    restored_step = int(state_b.opt.step)
    reset_counts()
    (state_b, met_b), resume_step_ms = timed_call(lambda: step_fn(state_b, batch))
    one_step = read_counts()
    loss_b = float(met_b["loss"])
    bit_exact = loss_a == loss_b and all(
        torch.equal(a.cpu(), b) for a, b in zip(leaves(state_b.params), want_params))
    ckpt_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    emit({"phase": "train", "part": "full_width", "arch": cfg.name,
          "argv": argv, "n_layers": L,
          "cut": cut, "params": n_params,
          "active_params": analytic_param_count(cfg, active_only=True),
          "dtype": "float32", "batch": B, "seq": S,
          "attn_impl": run.attn_impl, "remat": "nothing", "lr": lr,
          "family_inputs": {k: list(v.shape) for k, v in
                            train_cli.family_inputs(cfg, B).items()},
          "losses": losses, "router_aux": report.aux,
          "step_seconds": report.step_times,
          "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
          "timing": "host clock around each step (it waits for the loss); "
                    "step_ms the median of steps 2..N",
          "peak_memory_bytes": peak, "state_bytes": 16 * n_params,
          "launches": counts, "launches_per_step": per_step,
          "launcher_wall_ms": wall_ms, "checkpoint_bytes": ckpt_bytes,
          "restore_ms": restore_ms, "restored_step": restored_step,
          "resume_step_ms": resume_step_ms, "resume_step_launches": one_step,
          "loss_step_in_memory": loss_a, "loss_step_from_checkpoint": loss_b,
          "resume_bit_exact": bit_exact,
          "stdout": text.getvalue().strip().splitlines(), "gpu": state["smi"]})
    shutil.rmtree(ck, ignore_errors=True)
    require(counts == want, f"train {arch}: launches {counts}, expected {want}")
    require(one_step == {"rmsnorm": per_step, "rmsnorm_backward": per_step,
                         "flash_attention": 0, "wkv6": 0, "ssd": 0},
            f"train {arch}: one step launched {one_step}")
    require(len(losses) == N and all(math.isfinite(x) for x in losses),
            f"train {arch}: losses {losses}")
    require(len(report.aux) == N and all(math.isfinite(x) for x in report.aux),
            f"train {arch}: router aux {report.aux}")
    require(losses[-1] < losses[0],
            f"train {arch}: the loss did not fall: {losses}")
    require(restored_step == N and extra.get("step") == N,
            f"train {arch}: restored step {restored_step}, extra {extra}")
    require(bit_exact, f"train {arch}: resume not bit-exact (loss {loss_a} vs "
                       f"{loss_b})")
    add_launches(state, counts, shapes)
    del model, state_b, want_params
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(state):
    # full float32 products on the card, said and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_parities(state)
    train_full_width(state, "deepseek-7b", TRAIN_LAYERS,
                     "depth 30 -> 4: the float32 state (16 bytes a parameter: "
                     "weights, gradients, m, v) of 30 layers is 110 GB; width, "
                     "heads and vocabulary full")
    train_full_width(state, "olmoe-1b-7b", MOE_TRAIN_LAYERS,
                     "depth 16 -> 4: the float32 state (16 bytes a parameter) "
                     "of 16 layers is 110 GB; width, 64 experts top-8, heads "
                     "and vocabulary full")
    width_backward_dsv3(state)
    cuts = {"rwkv6-7b": "depth 32 -> 4: the float32 state (16 bytes a "
                        "parameter) of 32 layers is 120 GB; width, heads and "
                        "vocabulary full",
            "zamba2-7b": "depth 81 -> 6: one group of 6 Mamba2 blocks and a "
                         "shared attention block (of the 13 groups' 107.5 GB "
                         "of float32 state); width and vocabulary full",
            "whisper-small": "none: 12 encoder layers over 1500 frames (the "
                             "launcher's zeros), 12 decoder layers, S = 448"}
    for arch, layers, S in FAMILY_TRAIN:
        train_full_width(state, arch, layers, cuts[arch], S=S)
    width_backward_vlm(state)


def planner_job(state, arch, mode, run, kernels, n_layers=None,
                anchor=None, seq=PLANNER_S):
    """One job through HBMPlanner.plan on the card (the ladder profiled,
    fitted and selected for), then one step at the depth extrapolated to
    under CUDAMemoryProfiler: the prediction must be confident and within
    PLANNER_GATE of that step's peak, and each kernel in `kernels` must
    have launched. Returns (the plan, the measured profile, the planner)."""
    from dataclasses import replace
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.hbm_planner import HBMPlanner
    from repro_torch.core.profiler import CUDAMemoryProfiler
    from repro_torch.launch.dryrun import build_step

    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    B = PLANNER_TRAIN_B if mode == "train" else PLANNER_B
    shape = ShapeConfig(f"{mode}_{seq}", seq, B, mode)
    planner = HBMPlanner()
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    rep = planner.plan(cfg, shape, run=run, anchor_layers=anchor)
    truth = CUDAMemoryProfiler().profile(build_step(cfg, shape, run),
                                         cfg.n_layers)
    counts, shapes = read_counts(), read_shapes()
    GiB = 1024 ** 3
    pred = rep.model.predict(cfg.n_layers)
    rel = abs(pred - truth.job_mem_bytes) / truth.job_mem_bytes
    sel = rep.selection
    line = {"phase": "planner", "arch": arch, "mode": mode, "batch": B,
            "seq": seq, "dtype": run.compute_dtype,
            "attn_impl": run.attn_impl, "remat": run.remat,
            "n_layers": cfg.n_layers,
            "ladder": planner.depth_ladder(cfg, anchor),
            "effective_depths": rep.ladder,
            "gib": [m / GiB for m in rep.per_dev_bytes],
            "slope_gib": rep.model.slope / GiB,
            "intercept_gib": rep.model.intercept / GiB, "r2": rep.model.r2,
            "confident": rep.model.confident,
            "predicted_gib": pred / GiB,
            "measured_gib": truth.job_mem_bytes / GiB,
            "measured_depth": cfg.n_layers, "rel_err": rel,
            "gate": PLANNER_GATE,
            "reserved_gib": truth.reserved_mem_bytes / GiB,
            "overhead_gib": truth.overhead_bytes / GiB,
            "requirement_gib": rep.requirement_gib, "leeway": planner.leeway,
            "profile_wall_s": rep.profile_wall_s,
            "measured_step_wall_s": truth.wall_s,
            "selection": sel.config.name, "feasible": sel.feasible_count,
            "fell_back": sel.fell_back, "launches": counts,
            "gpu": state["smi"]}
    if cfg.hybrid is not None:
        blocks = (cfg.n_layers // cfg.hybrid.period) * cfg.hybrid.period
        line["blocks_in_model"] = blocks
        line["slopes_over"] = (cfg.n_layers - blocks)
    emit(line)
    require(rep.model.confident, f"planner {arch} {mode}: R2 {rep.model.r2}")
    require(rel < PLANNER_GATE,
            f"planner {arch} {mode}: predicted {pred / GiB:.3f} GiB against "
            f"{truth.job_mem_bytes / GiB:.3f} measured ({rel:.2%})")
    require(all(counts[k] > 0 for k in kernels),
            f"planner {arch} {mode}: a kernel of the path was not launched: "
            f"{counts}")
    add_launches(state, counts, shapes)
    return rep, truth, planner


def select_at_full_depth(state, arch, rep, planner, **extra):
    """The planner's selection for `arch`'s train job at its full depth,
    from the fit of `rep`: it must be feasible."""
    from repro_torch.configs import get_arch

    GiB = 1024 ** 3
    full = get_arch(arch).n_layers
    req = rep.model.requirement(full, planner.leeway) / GiB
    sel = planner.select(req, req)
    emit({"phase": "planner", "arch": arch, "mode": "train",
          "selection_at_layers": full, "requirement_gib": req,
          "selection": sel.config.name, "feasible": sel.feasible_count,
          "fell_back": sel.fell_back, **extra, "gpu": state["smi"]})
    require(not sel.fell_back,
            f"planner {arch}: no feasible config for {req:.1f} GiB: {sel}")


def phase_planner(state):
    """Crispy's planner over the port: deepseek-7b's and zamba2-7b's bf16
    prefill at B=4, S=2048 (the kernels' path), and deepseek-7b's,
    olmoe-1b-7b's and zamba2-7b's float32 train steps at B=2, S=2048 and
    whisper-small's at B=2, S=448 as the train launcher runs them, with the
    presets' remat; then the selection for the deepseek-7b, olmoe-1b-7b and
    zamba2-7b train jobs at their full depths (30, 16 and 81 layers), which
    must be feasible."""
    from repro_torch.configs import RunConfig
    from repro_torch.core.catalog import gpu_catalog
    from repro_torch.core.hbm_planner import GPU_OVERHEAD_GIB

    GiB = 1024 ** 3
    bf16 = RunConfig(attn_impl="kernel", remat="nothing",
                     param_dtype="bfloat16", compute_dtype="bfloat16")
    f32 = RunConfig(attn_impl="blocked", remat="boundaries",
                    param_dtype="float32", compute_dtype="float32")
    _, truth, _ = planner_job(state, "deepseek-7b", "prefill", bf16,
                              ("rmsnorm", "flash_attention"))
    overhead_gib = truth.overhead_bytes / GiB
    planner_job(state, "zamba2-7b", "prefill", bf16,
                ("rmsnorm", "flash_attention", "ssd"))
    rep, _, planner = planner_job(
        state, "deepseek-7b", "train", f32, ("rmsnorm", "rmsnorm_backward"),
        n_layers=PLANNER_TRAIN_LAYERS, anchor=PLANNER_TRAIN_ANCHOR)
    select_at_full_depth(
        state, "deepseek-7b", rep, planner,
        overhead_gib_at_deepseek_7b_prefill=overhead_gib,
        GPU_OVERHEAD_GIB=GPU_OVERHEAD_GIB,
        card_total_bytes=torch.cuda.mem_get_info()[1],
        catalog_mem_gib=gpu_catalog()[0].node.mem_gib)
    rep, _, planner = planner_job(
        state, "olmoe-1b-7b", "train", f32, ("rmsnorm", "rmsnorm_backward"),
        n_layers=PLANNER_MOE_LAYERS, anchor=PLANNER_MOE_ANCHOR)
    select_at_full_depth(state, "olmoe-1b-7b", rep, planner)
    planner_job(state, "whisper-small", "train", f32,
                ("rmsnorm", "rmsnorm_backward"), anchor=PLANNER_WHISPER_ANCHOR,
                seq=PLANNER_WHISPER_S)
    rep, _, planner = planner_job(
        state, "zamba2-7b", "train", f32, ("rmsnorm", "rmsnorm_backward"),
        n_layers=PLANNER_ZAMBA_BLOCKS)
    select_at_full_depth(state, "zamba2-7b", rep, planner)


def kernels_line(state):
    """One entry for each kernel at the prefill shape of the model that
    carries it (the rmsnorm backward: at the train phase's, in its float32,
    and at the other families' float32 train widths 768, 3584, 7168 and
    8192; flash attention at D = 128 and, as its own entry, at deepseek-v3's
    D = 192, and at each shape of NEW_FLASH; rmsnorm at d = 8192 and 768
    too); `launches` counts the prefill, serve, train and planner phases
    (the D = 192 instance: deepseek-v3-671b's prefill phase, which alone
    runs it; the NEW_FLASH shapes and the rmsnorm widths: the wrappers'
    counts at that shape or width)."""
    meta = {
        "rmsnorm": {"source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "replaces": "src/repro/kernels/rmsnorm.py:28",
                    "shape": [8192, 4096]},
        # the reference differentiates its rms_norm with XLA: the backward
        # of the function its rmsnorm kernel computes
        "rmsnorm_backward": {"source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                             "replaces": "src/repro/kernels/rmsnorm.py:28",
                             "shape": [TRAIN_B * TRAIN_S, 4096],
                             "dtype": str(torch.float32)},
        "flash_attention": {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:86",
            "shape": [4, 2048, 2048, 32, 32, 128]},
        "wkv6": {"source": "src/repro_torch/kernels/csrc/wkv6.cu",
                 "replaces": "src/repro/kernels/wkv6.py:69",
                 "shape": [4, 2048, 64, 64]},
        "ssd": {"source": "src/repro_torch/kernels/csrc/ssd.cu",
                "replaces": "src/repro/kernels/ssd.py:53",
                "shape": [4, 2048, 112, 64, 64]},
    }
    # deepseek-v3-671b's MLA core: the D = 192 instance of the same source,
    # launched by that model's prefill phase only
    meta["flash_attention_d192"] = {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "shape": [4, 2048, 2048, 128, 128, 192],
        "timed_as": "flash_attention",
        "launches": state["prefill_launches"]["deepseek-v3-671b"]["flash_attention"]}
    # the VLM and enc-dec paths' instances (NEW_FLASH), each at its own
    # shape, with the launches the wrapper counted at that shape on the main
    # path
    by_shape = state["shape_launches"]["flash_attention"]
    for use, _, Sq, Skv, H, Hkv, D, causal in NEW_FLASH:
        meta[f"flash_attention_{use}"] = {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:86",
            "shape": [NEW_FLASH_B, Sq, Skv, H, Hkv, D],
            "timed_as": "flash_attention", "use": use,
            "launches": by_shape.get((NEW_FLASH_B, Sq, Skv, H, Hkv, D, causal), 0)}
    # rmsnorm at the two new widths, with the launches the wrapper counted
    # at that width on the main path
    for name, shape in (("rmsnorm_d8192", [8192, 8192]),
                        ("rmsnorm_d768", [6000, 768])):
        meta[name] = {"source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                      "replaces": "src/repro/kernels/rmsnorm.py:28",
                      "shape": shape, "timed_as": "rmsnorm",
                      "launches": state["shape_launches"]["rmsnorm"].get(
                          shape[1], 0)}
    # the rmsnorm backward in float32 at the other families' train widths,
    # with the launches the wrapper counted at that width on the main path
    for rows, d in ((3000, 768), (4096, 3584), (4096, 7168), (2048, 8192)):
        meta[f"rmsnorm_backward_d{d}"] = {
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:28",
            "shape": [rows, d], "timed_as": "rmsnorm_backward",
            "dtype": str(torch.float32),
            "launches": state["shape_launches"]["rmsnorm_backward"].get(d, 0)}
    out = []
    bf16 = str(torch.bfloat16)
    for name, m in meta.items():
        t = next(x for x in state["timed"] if x["name"] == m.get("timed_as", name)
                 and x["shape"] == m["shape"] and x.get("use") == m.get("use")
                 and x["dtype"] == m.get("dtype", bf16))
        launches = m.get("launches", state["launches"].get(name))
        require(launches > 0, f"{name}: the main path never launched it")
        out.append({"name": name, "route": "cuda", "source": m["source"],
                    "replaces": m["replaces"], "launches": launches,
                    "max_abs_err": state["worst_err"].get(name, t["max_abs_err"]),
                    "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                    "shape": m["shape"], "dtype": t["dtype"],
                    **{k: t[k] for k in ("graph_ms", "library_graph_ms")
                       if k in t}})
    emit({"kernels": out})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true",
                    help="print the compiler's output for the kernels")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on a GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    state = {"seed": args.seed, "verbose": args.verbose, "smi": smi_line(),
             "launches": dict.fromkeys(KERNELS, 0), "prefill_launches": {},
             "shape_launches": {"flash_attention": {}, "rmsnorm": {},
                                "rmsnorm_backward": {}}}
    run = {"env": phase_env, "kernels": phase_kernels, "parity": phase_parity,
           "prefill": phase_prefill, "serve": phase_serve, "train": phase_train,
           "planner": phase_planner}
    t0 = time.monotonic()
    for name in PHASES:
        if name in phases:
            t1 = time.monotonic()
            run[name](state)
            emit({"phase_done": name, "seconds": time.monotonic() - t1})
    if phases != list(PHASES):
        emit({"ok": False, "partial": phases,
              "seconds": time.monotonic() - t0})
        return 2
    emit({"seconds": time.monotonic() - t0})
    kernels_line(state)
    print(state["smi"], flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
