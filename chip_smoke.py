#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc/``, holds each
against its plain PyTorch version on the card, and drives the serving path
of deepseek-7b at full width and depth (random weights from a seed) through
``Model.forward``, ``Model.prefill``, ``Model.decode_step`` and the
``repro_torch.launch.serve`` command line. Every line of standard output is
one JSON object, except the line before the last, which is the card's name
and power limit as ``nvidia-smi`` prints them. The last line is
``{"ok": true, "device": {...}}``. Any failure (no card, a kernel that does
not build, launch or agree, a phase out of its gate) ends the run with a
traceback and a non-zero exit code; no failure is caught.

Phases, in order: env, kernels, parity, prefill, serve. ``--phases`` runs a
subset while developing; such a run never prints the last line and exits 2.

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
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PHASES = ("env", "kernels", "parity", "prefill", "serve")

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the reference's kernel test grid (tests/test_kernels.py)
ATTN_GRID = [(1, 32, 32, 2, 2, 16), (2, 64, 64, 4, 2, 32),
             (1, 96, 48, 4, 1, 64), (2, 33, 65, 2, 2, 16)]
NORM_GRID = [(4, 64), (3, 17, 96), (2, 5, 7, 128)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}    # atol = rtol

N_LAYERS, NORMS_PER_CALL = 30, 61                    # deepseek-7b: 2*30 + 1


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


def phase_kernels(state):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    t0 = time.monotonic()
    lib_path = build.build(verbose=state["verbose"])
    build.library()
    build_s = time.monotonic() - t0
    require(lib_path.is_file() and ROOT in lib_path.parents,
            f"kernel library not built inside the checkout: {lib_path}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(state["seed"])

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    checks = []
    # --- the reference's test grid -----------------------------------------
    for (B, Sq, Skv, H, Hkv, D) in ATTN_GRID:
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
                         ((2, 12288), torch.float32)):
        # (5, 70): a row length that is no multiple of 16 bytes, scalar path;
        # (2, 12288): mistral-large's width, a 48 KB row in shared memory
        x, r = randn(shape, dtype), randn(shape, dtype)
        sc = 1.0 + 0.1 * randn(shape[-1:], dtype)
        got = rmsnorm(x, sc, residual=r)
        torch.cuda.synchronize()
        err, ok = close(got, rmsnorm_plain(x, sc, residual=r), dtype)
        checks.append({"kernel": "rmsnorm", "shape": list(shape),
                       "dtype": str(dtype), "residual": True,
                       "max_abs_err": err, "tol": TOL[dtype], "ok": ok})

    # --- the model's shapes, checked and timed -------------------------------
    bf16 = torch.bfloat16
    timed = []
    for rows, d in ((8192, 4096), (8, 4096)):
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
        bound, by, nbytes = norm_bound(rows, d, bf16, bf16)
        timed.append({"name": "rmsnorm", "shape": [rows, d], "dtype": str(bf16),
                      "max_abs_err": err, **t, "bound_ms": bound,
                      "bound_by": by, "gbytes_per_s": nbytes / t["ms"] / 1e6})
        del x, got
    B, S, H, D = 4, 2048, 32, 128
    for Hkv in (32, 8, 2):
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
        }, iters=5)
        bound, by, flops = attn_bound(B, S, S, H, Hkv, D, True, bf16)
        timed.append({"name": "flash_attention", "shape": [B, S, S, H, Hkv, D],
                      "causal": True, "dtype": str(bf16), "max_abs_err": err,
                      **t, "bound_ms": bound, "bound_by": by,
                      "tflops": flops / t["ms"] / 1e9})
        del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()

    bad = [c for c in checks if not c["ok"]]
    emit({"phase": "kernels", "build_seconds": build_s,
          "library": str(lib_path.relative_to(ROOT)),
          "timing": "CUDA events around repeated launches after a warm-up, "
                    "kernel, plain and library call in turns, least of 2 rounds",
          "n_checks": len(checks), "n_failed": len(bad), "checks": checks,
          "timed": timed})
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    state["timed"] = timed
    state["worst_err"] = {
        name: max(c["max_abs_err"] for c in checks
                  if c["kernel"] == name and c["dtype"] == str(bf16))
        for name in ("rmsnorm", "flash_attention")}


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


def phase_parity(state):
    """The card's kernel path against the same model on the CPU (plain
    versions), float32, deepseek-7b at full width and 2 layers."""
    from dataclasses import replace
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import Model

    # full float32 products on the card, said and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(get_arch("deepseek-7b"), n_layers=2)
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="kernel")
    B, S = 2, 256
    cpu = Model(cfg, run, device="cpu")
    tree = numpy_weights(cpu, state["seed"])
    params_from_numpy(tree, cpu)
    gpu = params_from_numpy(tree, Model(cfg, run))
    del tree
    tokens = np.random.default_rng(state["seed"] + 1).integers(
        0, cfg.vocab_size, size=(B, S))
    t0 = time.monotonic()
    want = cpu.forward({"tokens": tokens})
    cpu_s = time.monotonic() - t0
    got = gpu.forward({"tokens": tokens}).cpu()
    err = float((got - want).abs().max())
    gate = 1e-3
    emit({"phase": "parity", "arch": cfg.name, "n_layers": cfg.n_layers,
          "cut": "depth 30 -> 2; width and vocabulary full", "dtype": "float32",
          "allow_tf32": False, "batch": B, "seq": S,
          "logits_max_abs_err": err, "logits_max_abs": float(want.abs().max()),
          "gate": gate,
          "gate_reason": "same float32 arithmetic, sums over d=4096 and "
                         "ff=11008 taken in another order on the card",
          "cpu_forward_seconds": cpu_s})
    require(bool(torch.isfinite(got).all()), "parity: logits not finite")
    require(err < gate, f"parity: logits differ by {err} (gate {gate})")
    del cpu, gpu, got, want
    gc.collect()
    torch.cuda.empty_cache()


def reset_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    rmsnorm.launches = 0
    flash_attention.launches = 0


def read_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {"rmsnorm": rmsnorm.launches,
            "flash_attention": flash_attention.launches}


def timed_call(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


def phase_prefill(state):
    """deepseek-7b, full width and depth, bfloat16: forward, prefill and
    decode_step through the kernels, held against each other."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models.model import build_model

    cfg = get_arch("deepseek-7b")
    require(cfg.n_layers == N_LAYERS, "deepseek-7b depth changed")
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                    attn_impl="kernel")
    B, S, max_len, n_decode = 4, 2048, 2304, 8
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = timed_call(lambda: build_model(cfg, run, seed=state["seed"]))
    tokens = torch.from_numpy(np.random.default_rng(state["seed"] + 2).integers(
        0, cfg.vocab_size, size=(B, S)))
    model.forward({"tokens": tokens[:, :64]})        # warm-up of the libraries

    launches = {"rmsnorm": 0, "flash_attention": 0}

    def counted(fn, want):
        reset_counts()
        out, ms = timed_call(fn)
        got = read_counts()
        require(got == want, f"launch counts {got}, expected {want}")
        for name in launches:
            launches[name] += got[name]
        return out, ms

    per_call = {"rmsnorm": NORMS_PER_CALL, "flash_attention": N_LAYERS}
    lg_f, forward_ms = counted(lambda: model.forward({"tokens": tokens}), per_call)
    last_f = lg_f[:, -1].float()
    require(lg_f.shape == (B, S, cfg.vocab_size), f"forward shape {lg_f.shape}")
    require(bool(torch.isfinite(lg_f).all()), "forward: logits not finite")
    del lg_f
    (lg_p, caches), prefill_ms = counted(
        lambda: model.prefill({"tokens": tokens}, max_len), per_call)
    require(lg_p.shape == (B, 1, cfg.vocab_size), f"prefill shape {lg_p.shape}")
    require(caches["k"].shape == (N_LAYERS, B, max_len, cfg.n_kv_heads, cfg.d_head),
            f"cache shape {caches['k'].shape}")
    prefill_err = float((lg_p[:, 0].float() - last_f).abs().max())

    # bfloat16 keeps 8 bits: a logit of size 4 moves by 0.016 a rounding, and
    # the decode path rounds at other places than the sequence path (softmax
    # weights in bfloat16 before PV, other shapes of matrix product) through
    # 30 layers. The gate is on the largest of 4 x 102400 logits.
    gate = 0.25
    seq = tokens.to(model.device)
    nxt = last_f.argmax(-1, keepdim=True)
    decode_errs, decode_ms, agree = [], [], []
    for _ in range(n_decode):
        seq = torch.cat([seq, nxt], dim=1)
        (lg_d, caches), ms = counted(
            lambda: model.decode_step({"tokens": nxt}, caches),
            {"rmsnorm": NORMS_PER_CALL, "flash_attention": 0})
        decode_ms.append(ms)
        ref = model.forward({"tokens": seq})[:, -1].float()
        got = lg_d[:, 0].float()
        require(bool(torch.isfinite(got).all()), "decode: logits not finite")
        decode_errs.append(float((got - ref).abs().max()))
        agree.append(float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
        nxt = ref.argmax(-1, keepdim=True)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "prefill", "arch": cfg.name, "n_layers": cfg.n_layers,
          "cut": "none", "dtype": "bfloat16", "batch": B, "seq": S,
          "max_len": max_len, "params": sum(p.numel() for p in model.tree.parameters()),
          "init_ms": init_ms, "forward_ms": forward_ms, "prefill_ms": prefill_ms,
          "decode_step_ms": decode_ms,
          "prefill_vs_forward_max_abs_err": prefill_err,
          "decode_vs_forward_max_abs_err": decode_errs,
          "decode_argmax_agreement": agree, "gate": gate,
          "gate_reason": "bfloat16 rounding at other places on the two paths, "
                         "through 30 layers; largest of 4 x 102400 logits",
          "launches_per_call": per_call,
          "launches_per_decode_step": {"rmsnorm": NORMS_PER_CALL, "flash_attention": 0},
          "launches": dict(launches),
          "peak_memory_bytes": peak, "gpu": state["smi"]})
    require(prefill_err < gate, f"prefill vs forward {prefill_err} (gate {gate})")
    require(max(decode_errs) < gate,
            f"decode vs forward {max(decode_errs)} (gate {gate})")
    state["launches"] = launches
    del model, caches, seq
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(state):
    """The command line a user would call, deepseek-7b at full size."""
    from repro_torch.launch import serve
    slots, n_req, prompt_len, max_new, max_len = 8, 16, 32, 32, 256
    argv = ["--arch", "deepseek-7b", "--dtype", "bfloat16",
            "--slots", str(slots), "--requests", str(n_req),
            "--prompt-len", str(prompt_len), "--max-new", str(max_new),
            "--max-len", str(max_len), "--seed", str(state["seed"])]
    reset_counts()
    text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(text):
        done, wall_ms = timed_call(lambda: serve.main(argv))
    counts = read_counts()
    require(len(done) == n_req, f"serve: {len(done)} of {n_req} finished")
    require(all(len(r.out_tokens) == max_new for r in done),
            "serve: a request ended short")
    vocab = 102400
    require(all(0 <= t < vocab for r in done for t in r.out_tokens),
            "serve: token out of range")
    require(counts["rmsnorm"] > 0 and counts["rmsnorm"] % NORMS_PER_CALL == 0,
            f"serve: {counts['rmsnorm']} rmsnorm launches, no multiple of "
            f"{NORMS_PER_CALL}")
    ticks = counts["rmsnorm"] // NORMS_PER_CALL
    # two waves of 8 requests, each prompt_len + max_new - 1 ticks long
    require(ticks == (n_req // slots) * (prompt_len + max_new - 1),
            f"serve: {ticks} ticks")
    run_s = max(r.finished_at for r in done) - min(r.submitted_at for r in done)
    n_tokens = sum(len(r.out_tokens) for r in done)
    emit({"phase": "serve", "argv": argv, "requests": len(done),
          "new_tokens": n_tokens, "ticks": ticks,
          "engine_seconds": run_s, "tokens_per_s": n_tokens / run_s,
          "tick_ms": run_s * 1e3 / ticks,
          "with_model_init_ms": wall_ms,
          "rmsnorm_launches_per_tick": counts["rmsnorm"] / ticks,
          "launches": counts,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "stdout": text.getvalue().strip().splitlines(), "gpu": state["smi"]})
    for name in counts:
        state["launches"][name] += counts[name]
    gc.collect()
    torch.cuda.empty_cache()


def kernels_line(state):
    """One entry for each kernel at the shape deepseek-7b's prefill gives
    it; `launches` counts the prefill and serve phases."""
    meta = {
        "rmsnorm": {"source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "replaces": "src/repro/kernels/rmsnorm.py:28",
                    "shape": [8192, 4096]},
        "flash_attention": {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:86",
            "shape": [4, 2048, 2048, 32, 32, 128]},
    }
    out = []
    for name, m in meta.items():
        t = next(x for x in state["timed"]
                 if x["name"] == name and x["shape"] == m["shape"])
        launches = state["launches"][name]
        require(launches > 0, f"{name}: the main path never launched it")
        out.append({"name": name, "route": "cuda", "source": m["source"],
                    "replaces": m["replaces"], "launches": launches,
                    "max_abs_err": state["worst_err"][name], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                    "shape": m["shape"], "dtype": t["dtype"]})
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
             "launches": {"rmsnorm": 0, "flash_attention": 0}}
    run = {"env": phase_env, "kernels": phase_kernels, "parity": phase_parity,
           "prefill": phase_prefill, "serve": phase_serve}
    t0 = time.monotonic()
    for name in PHASES:
        if name in phases:
            run[name](state)
    if phases != list(PHASES):
        emit({"ok": False, "partial": phases,
              "seconds": time.monotonic() - t0})
        return 2
    kernels_line(state)
    print(state["smi"], flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
