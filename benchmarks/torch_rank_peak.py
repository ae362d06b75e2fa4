"""Rank 0's peak memory in one step of an (arch x shape) cell sharded over a
mesh, run alone on one card (``Mesh.alone``: its collectives return zeros
of their shapes), with the presets of that mesh.

  PYTHONPATH=src python benchmarks/torch_rank_peak.py \\
      --arch mistral-large-123b --shape train_4k --mesh 16x16

Prints one JSON line: the peak of ``torch.cuda.max_memory_allocated`` over
the step (weights, state and inputs live; the build's transients not
counted) less what was allocated before the build, the step's seconds, and
the card's name and power limit. It uses only ``launch.dryrun.build_step``
and ``launch.mesh.Mesh``, so that with ``PYTHONPATH`` on an older tree it
measures that tree the same way.
"""
import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs import SHAPES, MeshConfig, get_arch
from repro_torch.launch.dryrun import build_step
from repro_torch.launch.mesh import Mesh

GiB = 1024 ** 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-large-123b")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="16x16", help="data x model")
    args = ap.parse_args(argv)
    shape = tuple(int(n) for n in args.mesh.split("x"))
    mesh_cfg = MeshConfig(shape, ("data", "model"))
    dev = torch.device("cuda")
    mesh = Mesh.alone(mesh_cfg, 0, dev)
    step = build_step(get_arch(args.arch), SHAPES[args.shape], None, dev,
                      mesh=mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    out = step()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - base
    del out
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": list(shape), "rank": 0, "peak_bytes": peak,
                      "peak_gib": peak / GiB, "seconds": seconds,
                      "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
