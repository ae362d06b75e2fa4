"""Run one cell of the port's benchmark and print its result line.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic mix,
limits and metric readers are found by name from ``BENCHMARK.json`` and the
files under ``portbench/``. Set-up (the kernel library's load or build,
weights drawn from the seed, every shape of the mix warmed up) is timed from
the start of this process; then the window runs for --seconds; then the
outputs due are checked against the plain reference. The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when jax, jaxlib, flax or the JAX package
``repro`` is loaded once the window has closed.
"""
import os
import sys
import time

T0 = time.monotonic()
# run as a script, this file's folder heads sys.path; its modules are
# portbench.*, and one of them must not shadow a module of the library
if sys.path and os.path.abspath(sys.path[0]) == \
        os.path.dirname(os.path.abspath(__file__)):
    del sys.path[0]

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def _environment() -> None:
    """Kernel caches at fixed places inside the checkout, and no JAX
    behind a library's back."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch
    from portbench import harness
    cell = harness.Spec(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda:0", t0=T0)
    found = harness.banned_modules()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
