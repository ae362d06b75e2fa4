"""Crispy for GPUs: before launching an (arch x mode) job, profile one step
at five reduced depths on the card, fit peak memory against depth,
extrapolate to the full depth, and pick the fewest H100s that hold it from
the GPU catalog. Where the job fits on one card, it then measures the full
depth's step for comparison.

  PYTHONPATH=src python examples/gpu_advisor_torch.py --arch deepseek-7b \
      --mode prefill --batch 4 --seq 2048

Prefill and decode run as the serve launcher runs them (bfloat16, the
flash-attention kernel); train as the train launcher does (float32, full
attention up to 512 tokens and blocked above) with the presets' remat
("boundaries"). Runs on the GPU unless --device says otherwise; the
profiler measures a CUDA device only.
"""
import argparse

from repro_torch.configs import RunConfig, ShapeConfig, get_arch
from repro_torch.core.hbm_planner import HBMPlanner
from repro_torch.core.profiler import CUDAMemoryProfiler
from repro_torch.launch.dryrun import build_step

GiB = 1024 ** 3


def job_run(mode: str, seq: int) -> RunConfig:
    if mode == "train":
        return RunConfig(attn_impl="full" if seq <= 512 else "blocked",
                         remat="boundaries", param_dtype="float32",
                         compute_dtype="float32")
    return RunConfig(attn_impl="kernel", remat="nothing",
                     param_dtype="bfloat16", compute_dtype="bfloat16")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--mode", default="prefill",
                    choices=("train", "prefill", "decode"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--device", default=None,
                    help="default: the GPU, an error where there is none")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = ShapeConfig(f"{args.mode}_{args.seq}", args.seq, args.batch,
                        args.mode)
    run = job_run(args.mode, args.seq)
    planner = HBMPlanner(leeway=0.05)
    rep = planner.plan(cfg, shape, device=args.device, run=run)
    print(f"arch={cfg.name} mode={args.mode} B={args.batch} S={args.seq} "
          f"dtype={run.compute_dtype} attn={run.attn_impl} "
          f"remat={run.remat}")
    print(f"layers ladder={planner.depth_ladder(cfg)} "
          f"effective={rep.ladder}")
    print(f"peak bytes at ladder: "
          f"{[f'{m / GiB:.3f}GiB' for m in rep.per_dev_bytes]} "
          f"(profile wall {rep.profile_wall_s:.1f}s)")
    print(f"OLS: slope={rep.model.slope / GiB:.4f} GiB/layer, "
          f"intercept={rep.model.intercept / GiB:.3f} GiB, "
          f"R2={rep.model.r2:.6f} "
          f"({'PASS' if rep.model.confident else 'fallback'})")
    pred = rep.model.predict(cfg.n_layers)
    print(f"extrapolated to {cfg.n_layers} layers: {pred / GiB:.3f} GiB "
          f"-> requirement {rep.requirement_gib:.2f} GiB "
          f"(leeway {planner.leeway:.0%})")
    sel = rep.selection
    print(f"selected: {sel.config.name} "
          f"({sel.config.total_mem_gib:.1f} GiB, "
          f"{sel.config.usd_per_hour:.0f} GPU-hours/h; "
          f"{sel.feasible_count} feasible configs"
          f"{'; fell back' if sel.fell_back else ''})")
    card = planner.catalog[0].node.mem_gib - planner.overhead
    if not rep.model.confident or pred / GiB > card:
        print(f"full depth: does not fit one card ({card:.1f} GiB usable); "
              f"not measured")
        return rep
    truth = CUDAMemoryProfiler().profile(build_step(cfg, shape, run,
                                                    args.device),
                                         cfg.n_layers, args.device)
    err = abs(pred - truth.job_mem_bytes) / truth.job_mem_bytes
    print(f"measured full depth: {truth.job_mem_bytes / GiB:.3f} GiB peak "
          f"allocated, {truth.reserved_mem_bytes / GiB:.3f} GiB reserved, "
          f"{truth.overhead_bytes / GiB:.3f} GiB beside the peak "
          f"(extrapolation error {err:.2%})")
    return rep


if __name__ == "__main__":
    main()
