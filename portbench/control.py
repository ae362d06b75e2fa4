"""Readings that set a cell's limits: the program's numbers over many
seeds, and the control's, in one process on the card.

  python3 portbench/control.py --workload <name> --seeds 1-12 \
      --control-seeds 1-3 [--out FILE]

For a prefill cell the program runs the first cycle of the mix (every
sample of a run) at the cell's own sizes for each seed, and its outputs are
compared with the float32 reference as a run compares them; the control is
the reference computed with float8 e4m3 products in the program's place,
compared the same way, both at several router margins
(``prefill.compare``). For a plan cell the program answers each seed's
first job, its checked step taken at that job's sampled depth; the control
is the program with its products in TF32 and its optimizer moments in
bfloat16, and the reference's fit computed in float32; the half-batch fault
is planted in the program's step. Prints one JSON line a seed and side, and
writes them all to --out.
"""
import os
import sys

if sys.path and os.path.abspath(sys.path[0]) == \
        os.path.dirname(os.path.abspath(__file__)):
    del sys.path[0]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out += list(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


# the router margins read beside the cell's own (``prefill.compare``)
MARGINS = (0.0, 0.005, 0.01, 0.02, 0.05, 0.1)


def prefill_readings(spec, cell, seed_list, control_list, device, emit):
    import torch
    from portbench.drivers import prefill as P
    from portbench.reference import transformer as ref
    config, traffic = spec.config(cell), spec.traffic(cell)
    program = P.Cell(config, traffic, seed_list[0], device)
    program.setup()
    dtype = getattr(torch, traffic["run"]["param_dtype"])
    n_first = sum(c for _, c in traffic["cycle"])
    margins = (P.ROUTE_MARGIN,) + tuple(m for m in MARGINS
                                        if m != P.ROUTE_MARGIN)
    for seed in seed_list:
        t0 = time.monotonic()
        program.reseed(seed)
        for i, S in enumerate(P.schedule(traffic, seed, n_first)):
            program.batch(i, S, lambda name: nullcontext())
        w = P.reference_weights(config, seed, dtype, device)
        rows = [P.compare(config, w, *program.kept[i], margins=margins)
                for i in sorted(program.kept)]
        emit({"side": "program", "seed": seed, **P.worst(rows),
              "s": time.monotonic() - t0})
        if seed in control_list:
            rows = []
            for i in sorted(program.kept):
                toks = program.kept[i][0]
                ks, vs = [], []
                last = ref.prefill(w, config, toks, precision="fp8",
                                   observe=lambda l, k, v: (ks.append(k),
                                                            vs.append(v)))
                kv = {"k": torch.stack(ks), "v": torch.stack(vs),
                      "pos": program.kept[i][2]["pos"]}
                del ks, vs
                rows.append(P.compare(config, w, toks, last, kv,
                                      margins=margins))
                del kv
            emit({"side": "control", "seed": seed, **P.worst(rows)})
        del w
        program.kept = {}
        torch.cuda.empty_cache()


@contextmanager
def planted(what):
    """The program's lower-precision products ("tf32"), or a fault planted
    in its step ("half_batch": the step takes the first half of its batch,
    or of its sequence where the batch is one, and the mean over it;
    "unchanged": the step returns its state as it was given)."""
    import torch
    from repro_torch.launch import dryrun
    real = dryrun.make_train_step
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)

    def half(model, acfg, **kw):
        step = real(model, acfg, **kw)

        def train_step(state, batch):
            B, S = batch["tokens"].shape
            cut = {k: t[:B // 2] if B > 1 else t[:, :S // 2]
                   for k, t in batch.items()}
            return step(state, cut)
        return train_step

    def unchanged(model, acfg, **kw):
        def train_step(state, batch):
            loss, _ = model.loss_fn(batch, state.params)
            return state, {"loss": loss.detach()}
        return train_step

    if what == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif what is not None:
        dryrun.make_train_step = {"half_batch": half,
                                  "unchanged": unchanged}[what]
    try:
        yield
    finally:
        dryrun.make_train_step = real
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def plan_readings(spec, cell, seed_list, control_list, device, emit):
    """The program's numbers for each seed's first answer; the control's
    (TF32 products, bfloat16 moments, the fit in float32) and the half-batch
    fault's for each control seed."""
    import copy
    import numpy as np
    from portbench.drivers import plan as PL
    from portbench.reference import planner as R
    config, traffic = spec.config(cell), spec.traffic(cell)
    low = copy.deepcopy(traffic)
    low["run"]["moment_dtype"] = "bfloat16"
    for side, plan_seeds, mix, plant in (
            ("program", seed_list, traffic, None),
            ("control", control_list, low, "tf32"),
            ("half_batch", control_list, traffic, "half_batch")):
        if not plan_seeds:
            continue
        program = PL.Cell(config, mix, plan_seeds[0], device)
        program.prepare()
        with planted(plant):
            for seed in plan_seeds:
                t0 = time.monotonic()
                program.seed, program.answers, program.steps = seed, [], []
                B, S = PL.schedule(mix, seed, 1)[0]
                a = program.plan(B, S, 0)
                a["param_dtype"] = traffic["run"]["param_dtype"]
                if side == "control":
                    line = R.fit(a["ladder"], a["readings"], np.float32)
                    a.update(line, requirement_gib=R.requirement_gib(
                        line, config["n_layers"]))
                program.answers.append(a)
                step = program.steps[0] if program.steps else {}
                emit({"side": side, "seed": seed, "B": B, "S": S,
                      "depth": step.get("depth"), "loss": step.get("loss"),
                      **program.check(), "readings": a["readings"],
                      "slope": a["slope"], "intercept": a["intercept"],
                      "gpus": a["gpus"], "s": time.monotonic() - t0})
        program.release()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(ROOT)
    cell = spec.cell(args.workload)
    kind = spec.traffic(cell)["driver"]
    lines = []

    def emit(row):
        row = {"workload": args.workload, **row}
        lines.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(json.dumps(r) for r in lines))

    readings = {"prefill": prefill_readings, "plan": plan_readings}[kind]
    readings(spec, cell, seeds(args.seeds), seeds(args.control_seeds),
             torch.device("cuda:0"), emit)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "banned": harness.banned_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
