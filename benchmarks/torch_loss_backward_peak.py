#!/usr/bin/env python3
"""Peak memory and device time of the PyTorch package's float32 loss and
backward on one GPU, with no optimizer step.

    PYTHONPATH=src python benchmarks/torch_loss_backward_peak.py \
        --arch llama-3.2-vision-90b --layers 5 --batch 1 --seq 2048

Builds the model at full width with its depth cut to `--layers`
(``configs.cut_depth``: the vlm keeps whole groups), float32, remat
"nothing" and the train launcher's attention ("full" up to 512 tokens,
"blocked" above), draws its weights from `--seed`, sets the vlm's tanh
gates to `--gate` and draws the vlm's media or the audio family's frames
at random. Then `--repeats` times: the loss and the gradient of every
parameter (``torch.autograd.grad``), timed by CUDA events, with the peak
read by ``max_memory_allocated`` after a reset. Prints one JSON line with
the parameters, the bytes of weights, the peak of each repeat, the bytes
beyond weights and gradients at the peak, and the times.

It uses only what every version of the package since the vlm family was
ported offers (``Model``, ``loss_fn``), so that the same command measures
an older tree: put that tree's ``src`` on ``PYTHONPATH``. Needs a GPU;
fails without one.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess

import torch

from repro_torch.configs import RunConfig, cut_depth, get_arch
from repro_torch.models.model import Model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.2-vision-90b")
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--gate", type=float, default=0.7)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = cut_depth(get_arch(args.arch), args.layers)
    run = RunConfig(attn_impl="full" if args.seq <= 512 else "blocked",
                    remat="nothing", compute_dtype="float32")
    model = Model(cfg, run).init(seed=args.seed).trainable()
    params = model.params
    if cfg.family == "vlm":
        with torch.no_grad():
            params["layers"]["cross"]["attn"]["gate"].fill_(args.gate)
    named = list(model.tree.named_parameters())
    n_params = sum(p.numel() for _, p in named)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.seq + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("vlm", "audio"):
        name, rows = (("media", cfg.cross_attn.n_media_tokens)
                      if cfg.family == "vlm" else
                      ("frames", cfg.encdec.enc_len))
        batch[name] = torch.randn((args.batch, rows, cfg.d_model),
                                  generator=gen, device="cuda")

    peaks, ms, loss = [], [], None
    for _ in range(args.repeats):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out, _ = model.loss_fn(batch, params)
        grads = torch.autograd.grad(out, [p for _, p in named],
                                    allow_unused=True)
        ev[1].record()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        ms.append(ev[0].elapsed_time(ev[1]))
        loss = float(out.detach())
        finite = all(g is None or bool(torch.isfinite(g).all()) for g in grads)
        del out, grads
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    weight_bytes = 4 * n_params
    print(json.dumps({
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": args.batch,
        "seq": args.seq, "attn_impl": run.attn_impl, "params": n_params,
        "weight_bytes": weight_bytes, "peak_bytes": peaks,
        "beyond_weights_and_gradients_bytes":
            [p - 2 * weight_bytes for p in peaks],
        "loss_and_backward_ms": ms, "loss": loss, "gradients_finite": finite,
        "timing": "CUDA events around loss_fn and torch.autograd.grad",
        "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
