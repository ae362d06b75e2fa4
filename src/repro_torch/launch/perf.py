"""The reference's perf hill-climb cells (``repro/launch/perf.py``): named
variants of three cells, each a mesh shape and ``RunConfig`` changes over
the same 256 devices, each run through ``run_cell`` on rank 0 alone with
its roofline terms recorded. The variants' names, mesh shapes and
``RunConfig`` changes are the reference's; their hypotheses are its
comments, kept beside them.

  python -m repro_torch.launch.perf --cell ds7b --variant tp8
  python -m repro_torch.launch.perf --all

It runs on the card (``--device``, default the GPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback

from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch.dryrun import run_cell, summary
from repro_torch.launch.mesh import mesh_of
from repro_torch.launch.presets import preset_run


def ds7b_variants():
    cfg = get_arch("deepseek-7b")
    shape = SHAPES["train_4k"]

    def base_run(mesh_shape):
        return preset_run(cfg, shape, mesh_of(mesh_shape))

    return cfg, shape, [
        # (name, mesh shape, run)
        ("baseline", (16, 16), base_run((16, 16))),
        # H1: remat 'dots' removes the recompute forward's TP all-reduces
        ("remat_dots", (16, 16), base_run((16, 16)).with_(remat="dots")),
        # H2: TP=8/DP=32 halves the TP all-reduce volume per device
        ("tp8", (32, 8), base_run((32, 8))),
        # H3: TP=4/DP=64 + dots: collective down ~4x, compute unchanged
        ("tp4_dots", (64, 4), base_run((64, 4)).with_(remat="dots")),
        # H4: H3 + bf16 gradient all-reduce (halves the DP gradient wire)
        ("tp4_dots_gcomp", (64, 4),
         base_run((64, 4)).with_(remat="dots", grad_compression=True)),
        # H5: bf16 params/moments/accumulator + ZeRO-1 master under H3
        ("tp4_dots_bf16", (64, 4),
         base_run((64, 4)).with_(remat="dots", param_dtype="bfloat16",
                                 moment_dtype="bfloat16",
                                 accum_dtype="bfloat16")),
        # H6: TP=4 with remat=boundaries and bf16 params + accumulator
        ("tp4_bound_bf16", (64, 4),
         base_run((64, 4)).with_(param_dtype="bfloat16",
                                 moment_dtype="bfloat16",
                                 accum_dtype="bfloat16")),
    ]


def dsv3_variants():
    cfg = get_arch("deepseek-v3-671b")
    shape = SHAPES["train_4k"]
    cfg_a2a = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="ep_a2a"))

    def base_run(mesh_shape, **kw):
        return preset_run(cfg, shape, mesh_of(mesh_shape)).with_(**kw)

    return None, shape, [
        ("baseline", (16, 16), base_run((16, 16)), cfg),
        # H1: a2a EP (experts over model x data) instead of the
        # per-microbatch FSDP weight all-gathers
        ("ep_a2a", (16, 16), base_run((16, 16), fsdp_experts=False),
         cfg_a2a),
        # H2: + remat dots
        ("ep_a2a_dots", (16, 16),
         base_run((16, 16), fsdp_experts=False, remat="dots"), cfg_a2a),
        # H3: + microbatches 16 -> 8
        ("ep_a2a_dots_mb8", (16, 16),
         base_run((16, 16), fsdp_experts=False, remat="dots",
                  microbatches=8), cfg_a2a),
        # H4: TP 16 -> 8 on top of a2a
        ("ep_a2a_tp8", (32, 8),
         dataclasses.replace(base_run((32, 8)), fsdp_experts=False),
         cfg_a2a),
    ]


def whisper_variants():
    cfg = get_arch("whisper-small")
    shape = SHAPES["train_4k"]

    def base_run(mesh_shape):
        return preset_run(cfg, shape, mesh_of(mesh_shape))

    return cfg, shape, [
        ("baseline", (16, 16), base_run((16, 16))),
        # H1: pure DP-256: 12 heads cannot split 16 ways
        ("dp256", (256, 1), base_run((256, 1))),
        # H2: TP=2 (12 % 2 == 0)
        ("dp128_tp2", (128, 2), base_run((128, 2))),
    ]


CELLS = {
    "ds7b": ds7b_variants,
    "dsv3": dsv3_variants,
    "whisper": whisper_variants,
}


def variants(cell: str):
    """[(name, mesh shape, run, cfg)] of a cell, and its shape."""
    base_cfg, shape, rows = CELLS[cell]()
    return shape, [row if len(row) == 4 else (*row, base_cfg) for row in rows]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS), default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU, an error where there is none")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cells = sorted(CELLS) if args.all else [args.cell]
    failures = 0
    for cname in cells:
        shape, rows = variants(cname)
        for name, mshape, run, cfg in rows:
            if args.variant and name != args.variant:
                continue
            path = os.path.join(args.out, f"{cname}__{name}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {cname}/{name}")
                continue
            try:
                rec = run_cell(cfg, shape, mesh_of(mshape), run,
                               device=args.device)
                rec["variant"] = name
                rec["mesh_shape"] = list(mshape)
                rec["run_config"] = dataclasses.asdict(run)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[ok] {cname}/{name}: {summary(rec)}", flush=True)
            except Exception as e:
                failures += 1
                print(f"[FAIL] {cname}/{name}: {type(e).__name__}: {e}",
                      flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} variants failed")


if __name__ == "__main__":
    main()
