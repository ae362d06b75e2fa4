"""Serving launcher: drive the continuous-batching engine from the CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --dtype bfloat16 --requests 16

Runs the full-size architecture on the GPU unless told otherwise:
``--reduced`` takes the tiny same-family config, ``--device cpu`` the plain
PyTorch path on the CPU. ``--layers N`` cuts the depth and keeps the width,
so that one card holds a model that does not fit it whole:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --layers 4

(3 dense layers and 1 MoE layer of deepseek-v3-671b, 53 GB in bfloat16 with
its MTP block), or

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-90b --layers 10

(two groups of 4 self-attention layers and 1 gated cross-attention layer,
10.66 G parameters, 21.3 GB in bfloat16). The reference's launcher has no
such flag. The vlm and audio families are fed the reference engine's
all-zero media and encoder output.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import cut_depth, get_arch
from repro_torch.configs.base import RunConfig
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="parameter and compute dtype")
    ap.add_argument("--device", default=None,
                    help="default: the GPU, an error where there is none")
    ap.add_argument("--prompt-len", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers at full width (not in "
                         "the reference's launcher)")
    args = ap.parse_args(argv)

    if args.int8_kv:
        raise NotImplementedError(
            "--int8-kv: the int8 KV cache is not ported yet (ROADMAP.md, "
            "Queue 1)")
    if args.prompt_len < 1 or args.prompt_len + args.max_new > args.max_len:
        raise ValueError("--prompt-len + --max-new must fit in --max-len")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    run = RunConfig(attn_impl="kernel", remat="nothing",
                    param_dtype=args.dtype, compute_dtype=args.dtype)
    model = build_model(cfg, run, device=device, seed=args.seed)
    engine = ServeEngine(model, slots=args.slots, max_len=args.max_len,
                         seed=args.seed)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=args.prompt_len).tolist()
        engine.submit(Request(rid, prompt=prompt, max_new_tokens=args.max_new,
                              temperature=args.temperature))
    done = engine.run()
    wall = time.monotonic() - t0
    toks = sum(len(r.out_tokens) for r in done)
    lats = [r.finished_at - r.submitted_at for r in done]
    print(f"[serve] {cfg.name}: {len(done)} requests, {toks} tokens in "
          f"{wall:.2f}s ({toks / wall:.1f} tok/s, slots={args.slots}, "
          f"ticks={engine.ticks}, layers={cfg.n_layers}, "
          f"kv={run.compute_dtype}, device={device})")
    print(f"[serve] latency p50={np.percentile(lats, 50):.2f}s "
          f"p95={np.percentile(lats, 95):.2f}s")
    return done


if __name__ == "__main__":
    main()
