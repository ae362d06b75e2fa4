"""Crispy for a sharded job on H100s: before launching an (arch x shape)
job over a mesh, profile one step of rank 0 of that mesh, run alone on
this card, at five reduced depths; fit the rank's peak memory against
depth, extrapolate it to the full depth, multiply by the mesh's devices
and pick the cheapest feasible configuration from the GPU catalog; then
measure rank 0's step at the full depth for comparison.

  PYTHONPATH=src python examples/mesh_advisor_torch.py --arch \\
      mistral-large-123b --shape prefill_32k --mesh 16x16

The job runs with the whole model's presets on that mesh
(``launch.presets``: ``fsdp_params`` for the models of 30B parameters or
more, bf16 compute, blocked attention) at every depth of the ladder. It
runs on the GPU unless --device says otherwise; the profiler measures a
CUDA device only.
"""
import argparse

from repro_torch.configs import SHAPES, get_arch
from repro_torch.core.catalog import gpu_catalog
from repro_torch.core.hbm_planner import HBMPlanner
from repro_torch.launch.mesh import mesh_of
from repro_torch.launch.presets import preset_run

GiB = 1024 ** 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-large-123b")
    ap.add_argument("--shape", default="prefill_32k", choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="16x16",
                    help="the profile mesh, data x model (or pod x data x "
                         "model)")
    ap.add_argument("--anchor-layers", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU, an error where there is none")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = SHAPES[args.shape]
    mesh = mesh_of(args.mesh)
    # the whole model's presets at every depth of the ladder (a cut model's
    # own would lay it out otherwise: fsdp_params from 30B parameters on)
    run = preset_run(cfg, shape, mesh)
    planner = HBMPlanner(catalog=gpu_catalog(), leeway=0.05)
    rep = planner.plan(cfg, shape, device=args.device, run=run,
                       anchor_layers=args.anchor_layers, profile_mesh=mesh)
    print(f"arch={cfg.name} shape={shape.name} mesh={mesh.shape} "
          f"{tuple(mesh.axes)}: rank 0 alone, layers ladder={rep.ladder}")
    print(f"per-rank bytes at ladder: "
          f"{[f'{m / GiB:.3f}GiB' for m in rep.per_dev_bytes]} "
          f"(profile wall {rep.profile_wall_s:.1f}s)")
    print(f"OLS: slope={rep.model.slope / GiB:.4f} GiB/layer, "
          f"intercept={rep.model.intercept / GiB:.3f} GiB, "
          f"R2={rep.model.r2:.6f} "
          f"({'PASS' if rep.model.confident else 'fallback'})")
    pred = rep.model.predict(cfg.n_layers)
    print(f"extrapolated to {cfg.n_layers} layers: {pred / GiB:.3f} GiB a "
          f"rank ({rep.predicted_per_dev_gib:.3f} with the leeway) x "
          f"{mesh.n_devices} devices -> aggregate requirement "
          f"{rep.requirement_gib:.2f} GiB")
    sel = rep.selection
    print(f"selected: {sel.config.name} "
          f"({sel.config.total_mem_gib:.1f} GiB, "
          f"{sel.config.usd_per_hour:.0f} GPU-hours/h; "
          f"{sel.feasible_count} feasible configs"
          f"{'; fell back' if sel.fell_back else ''})")
    card = planner.catalog[0].node.mem_gib - planner.overhead
    if not rep.model.confident or pred / GiB > card:
        print(f"full depth: rank 0 does not fit one card ({card:.1f} GiB "
              f"usable); not measured")
        return rep, None
    truth = planner.profile_memory(cfg, shape, run, device=args.device,
                                   profile_mesh=mesh)
    err = (pred - truth) / truth
    print(f"ground truth, rank 0 at full depth: {truth / GiB:.3f} GiB a "
          f"rank (extrapolation error {err:+.2%})")
    return rep, truth


if __name__ == "__main__":
    main()
