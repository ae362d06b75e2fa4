"""Training launcher, as the reference's ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --reduced --device cpu --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck

Trains on the GPU unless ``--device cpu`` is given, in float32 (parameters,
compute and moments, the reference launcher's choice), with
``attn_impl="full"`` up to 512 tokens and ``"blocked"`` above and no remat,
on the synthetic token stream. ``--reduced`` takes the tiny same-family
config. ``--layers N`` is the one flag the reference's launcher lacks: it
cuts the depth and keeps the width, so that one card holds the float32
state of a full-width model (16 bytes a parameter with AdamW); for the MoE
family it must leave one MoE layer at least:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --layers 4 --steps 5 --batch 2 --seq 2048

The launch line gives the total parameters and those active a token (the
routed experts counted top_k / n_experts, as the reference counts them);
for the MoE family the last line gives the router's aux term too. The weights
are drawn from ``--seed`` by the port's own init, so they are not the
reference's for the same seed. Returns (final train state, loop report).
"""
from __future__ import annotations

import argparse
from dataclasses import replace

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import ShardedLoader, SyntheticLMDataset
from repro_torch.models.model import Model, analytic_param_count
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers at full width, so that "
                         "one card holds the training state (not in the "
                         "reference's launcher)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU, an error where there is none")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        first = cfg.moe.first_dense_layers if cfg.moe else 0
        if args.layers <= first:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has "
                             f"{first} dense layers before its MoE layers")
        cfg = replace(cfg, n_layers=args.layers)
    run = RunConfig(attn_impl="full" if args.seq <= 512 else "blocked",
                    remat="nothing", compute_dtype="float32",
                    microbatches=args.microbatches,
                    grad_compression=args.grad_compression)
    model = Model(cfg, run, device=device)
    acfg = AdamWConfig(lr=args.lr)
    state = init_train_state(model, args.seed, acfg)
    n_params = sum(p.numel() for p in model.tree.parameters())
    active = analytic_param_count(cfg, active_only=True)
    print(f"[launch] {cfg.name} ({'reduced' if args.reduced else 'full'}, "
          f"{cfg.n_layers} layers): {n_params / 1e6:.2f}M params "
          f"({active / 1e6:.2f}M active a token) on {device}")

    step_fn = make_train_step(model, acfg, total_steps=args.steps)
    ds = SyntheticLMDataset(cfg.vocab_size, args.seed)
    loader = ShardedLoader(ds, args.batch, args.seq)
    lcfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10)
    state, report = train_loop(state, step_fn, loader, lcfg)
    if report.losses:
        aux = f", router aux {report.aux[-1]:.4f}" if cfg.moe else ""
        print(f"[done] final loss {report.losses[-1]:.4f} "
              f"(first {report.losses[0]:.4f}){aux} over {report.final_step} "
              f"steps; stragglers: {len(report.stragglers)}")
    return state, report


if __name__ == "__main__":
    main()
