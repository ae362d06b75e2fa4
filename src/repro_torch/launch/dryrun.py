"""One step of an (architecture x shape) job on one device, for the
planner, and the dry run of a rank of the production mesh.

``build_step(cfg, shape, run, device, seed)`` is the port's counterpart of
the JAX package's ``build_lowered`` (``repro/launch/dryrun.py``) and
``input_specs`` (``repro/models/model.py``). Where the reference lowers the
step against abstract inputs for XLA's compile-time memory analysis, this
returns a callable that builds everything on the device and runs the step
once, so that a profiler reads what the step really allocates:

* ``train``:   ``Model`` + ``init_train_state`` (weights and zeroed AdamW
  moments) + one ``make_train_step`` step on a (B, S) batch of tokens and
  labels, for every ported family (the MoE family's loss with the
  router's aux term and the MTP loss); the moments stay alive at the
  peak, as in the reference's donated step;
* ``prefill``: ``Model.prefill`` of a (B, S) prompt into caches of S;
* ``decode``:  ``Model.init_caches(B, S)`` + one ``decode_step`` of a
  (B, 1) batch.

As the reference's ``input_specs``, the vlm family's batches carry
``media`` (B, n_media_tokens, d), and the audio family's ``frames`` (B,
enc_len, d) to train and prefill and ``enc_out`` of the same shape to
decode, in the compute dtype.

Inputs are drawn from a generator on the device seeded with ``seed``. On a
CUDA device the callable resets the allocator's peak statistics between
building and stepping, so that a profiler reads the step's peak with the
weights, state and inputs live, not the build's transients: the float32
draw of a bf16 vocabulary-sized weight would otherwise be the peak of a
shallow job. The callable returns the step's output and keeps nothing:
everything it made is freed when its result is dropped. ``run=None`` takes
``preset_run`` on the mesh (one device when there is none).
``prepare_step`` gives the build itself (``Built``: the model, what was
built, the step to run), which ``run_cell`` measures.

With ``mesh=`` the step is one rank's of a job sharded over that mesh
(``launch.mesh``), in each of the three modes: the model holds this rank's
blocks, drawn on the device (``Model.init``), the batch is this rank's (B
over the batch axes), a prefill writes and a decode step reads this rank's
blocks of the caches (``Model.init_caches`` of the whole batch), and the
step writes its collectives out. Under ``Mesh.alone`` the rank runs by
itself, its collectives returning zeros, which is how ``HBMPlanner``
profiles a rank of a profile mesh on one card.

``run_cell(cfg, shape, mesh_cfg)`` is the reference's dry run of a cell:
rank 0 of `mesh_cfg` run alone, one step under ``launch.costs``, and a
record with the reference's keys. The reference compiles; the port runs,
so the measurements map as follows:

* ``lower_s`` / ``compile_s`` -> ``build_s`` (the weights, state and
  inputs made on the device) / ``step_s`` (the counted step);
* ``memory.argument_bytes``: what the build left allocated (on the CPU:
  the bytes of the tensors it made); ``peak_bytes`` and
  ``per_device_bytes``: ``torch.cuda.max_memory_allocated`` over the step,
  less what the process held before the build (None on the CPU);
  ``temp_bytes`` the peak less the arguments; ``output_bytes`` the step's
  outputs that are no argument; ``alias_bytes`` 0, as the port updates in
  place;
* ``hlo_costs``: the dot set's FLOPs and bytes a rank (``launch.costs``);
  the Python loops run every turn, so ``n_while`` is 0 and
  ``max_trip_multiplier`` 1;
* ``collectives``, ``roofline`` (``launch.roofline``, the H100's
  constants; a train step adds the reference's analytic 2 x argument
  bytes of the optimizer's traffic to the memory term), ``params``: the
  reference's;
* ``cost_analysis_raw`` (XLA's count of a loop's body once) has no
  counterpart and is left out.

``main()`` takes the reference's command line and writes one JSON a cell::

  python -m repro_torch.launch.dryrun --arch mistral-large-123b \
      --shape prefill_32k [--multi-pod] [--out experiments/dryrun]
  python -m repro_torch.launch.dryrun --all [--multi-pod]

It runs on the card (``--device``, default the GPU).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch import resolve_device, resolve_dtype
from repro_torch.configs import (ARCHS, SHAPES, get_arch, shape_applicable)
from repro_torch.configs.base import (MULTI_POD, SINGLE_POD, MeshConfig,
                                      ModelConfig, RunConfig, ShapeConfig,
                                      cell_id)
from repro_torch.launch import costs as K
from repro_torch.launch.mesh import Mesh, mesh_config
from repro_torch.launch.presets import preset_run
from repro_torch.launch.roofline import model_flops, roofline_from_costs
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.telemetry.spans import traced
from repro_torch.train.step import init_train_state, make_train_step

ONE_DEVICE = MeshConfig((1, 1), ("data", "model"))
GiB = 1024 ** 3


@dataclass
class Built:
    """What ``prepare_step`` built: the model, the tensors of the step's
    arguments (weights, state, inputs, caches) and the step to run."""
    model: Model
    arguments: List[torch.Tensor]
    run: Callable[[], object]


def prepare_step(cfg: ModelConfig, shape: ShapeConfig,
                 run: Optional[RunConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, mesh=None) -> Callable[[], Built]:
    """A callable that builds one step of `shape.mode` for `cfg` on `device`
    (None: the mesh's, or the GPU), its weights, state and inputs there;
    over `mesh`, this rank's. ``Built.run()`` runs the step."""
    if shape.mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {shape.mode!r}")
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    run = run or preset_run(cfg, shape, ONE_DEVICE if mesh is None
                            else mesh_config(mesh))
    B, S = shape.global_batch, shape.seq_len
    if mesh is not None:
        dp = mesh.size(("pod", "data"))
        if B % dp:
            raise ValueError(f"batch {B} does not divide over {dp} data "
                             f"ranks")
        B //= dp

    def tokens(generator, n):
        return torch.randint(0, cfg.vocab_size, (B, n), generator=generator,
                             device=device, dtype=torch.int32)

    def inputs(generator, n):
        """The batch of a step: tokens, and the family's media, frames or
        encoder output."""
        batch = {"tokens": tokens(generator, n)}
        if cfg.family in ("vlm", "audio"):
            if cfg.family == "vlm":
                name, rows = "media", cfg.cross_attn.n_media_tokens
            else:
                name = "enc_out" if shape.mode == "decode" else "frames"
                rows = cfg.encdec.enc_len
            batch[name] = torch.randn(
                (B, rows, cfg.d_model), generator=generator, device=device,
                dtype=torch.float32).to(resolve_dtype(run.compute_dtype))
        return batch

    def build() -> Built:
        """Weights, state and inputs on the device -> the step to run. The
        build and the step are the ranges "planner.build" and "planner.step"
        while a profiler records (``telemetry.traced``); the step's closure
        names its arguments (a benchmark reads `state` and `batch` there)."""
        with traced("planner.build"):
            generator = torch.Generator(device=device)
            generator.manual_seed(seed)
            model = Model(cfg, run, device=device, mesh=mesh)
            if shape.mode == "train":
                acfg = AdamWConfig(moment_dtype=run.moment_dtype,
                                   keep_master=run.param_dtype != "float32")
                state = init_train_state(model, seed, acfg)
                batch = {**inputs(generator, S),
                         "labels": tokens(generator, S)}

                def train():
                    with traced("planner.step"):
                        return make_train_step(model, acfg)(state, batch)[1]
                return Built(model, _tensors((state, batch)), train)
            model.init(seed=seed)
            if shape.mode == "prefill":
                batch = inputs(generator, S)

                def prefill():
                    with traced("planner.step"):
                        return model.prefill(batch, S)
                return Built(model, _tensors((model.params, batch)), prefill)
            caches = model.init_caches(shape.global_batch if mesh is not None
                                       else B, S)
            batch = inputs(generator, 1)

            def decode():
                with traced("planner.step"):
                    return model.decode_step(batch, caches)
            return Built(model, _tensors((model.params, batch, caches)),
                         decode)

    return build


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               run: Optional[RunConfig] = None,
               device: Optional[Union[str, torch.device]] = None,
               seed: int = 0, mesh=None) -> Callable[[], object]:
    """A callable that runs one step of `shape.mode` for `cfg` on `device`
    (None: the mesh's, or the GPU), building its weights, state and inputs
    there; over `mesh`, this rank's."""
    prepare = prepare_step(cfg, shape, run, device, seed, mesh)

    def step():
        built = prepare()
        if built.model.device.type == "cuda":
            # the peak a profiler reads is the step's, with its weights,
            # state and inputs live, as XLA's analysis of the step counts
            # them: the build's own transients (a weight drawn in float32
            # and cast) are no part of it
            torch.cuda.reset_peak_memory_stats(built.model.device)
        return built.run()

    return step


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of nested dicts, lists, tuples and dataclasses."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(tree)
    return out


def _bytes(tensors, leave_out=()) -> int:
    """The bytes of the distinct storages of `tensors`, those of
    `leave_out` left out."""
    seen = {t.untyped_storage().data_ptr() for t in leave_out}
    total = 0
    for t in tensors:
        ptr = t.untyped_storage().data_ptr()
        if ptr not in seen:
            seen.add(ptr)
            total += t.untyped_storage().nbytes()
    return total


def run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
             run: Optional[RunConfig] = None,
             device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Rank 0 of `mesh_cfg` run alone (``Mesh.alone``) through one step of
    the cell under ``launch.costs`` -> the reference's record (the module
    docstring says how its keys map). device=None is the GPU."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    mesh = Mesh.alone(mesh_cfg, 0, device)
    run = run or preset_run(cfg, shape, mesh_cfg)
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    t0 = time.monotonic()
    built = prepare_step(cfg, shape, run, device, mesh=mesh)()
    if cuda:
        torch.cuda.synchronize(device)
        argument = torch.cuda.memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)
    else:
        argument = _bytes(built.arguments)
    t_build = time.monotonic() - t0
    t0 = time.monotonic()
    out, costs = K.count(built.run)
    if cuda:
        torch.cuda.synchronize(device)
    t_step = time.monotonic() - t0
    output = _bytes(_tensors(out), built.arguments)
    peak = torch.cuda.max_memory_allocated(device) - base if cuda else None
    del out, built
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n_dev = mesh_cfg.n_devices
    mf = model_flops(cfg, shape)
    # the optimizer's elementwise update reads and writes the parameters
    # and moments (and master) once a step: outside the dot set
    extra = 2.0 * argument if shape.mode == "train" else 0.0
    roof = roofline_from_costs(costs, n_dev, mf, extra_hbm_bytes=extra)
    return {
        "cell": cell_id(cfg.name, shape.name),
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": list(mesh_cfg.shape),
        "axes": list(mesh_cfg.axes),
        "n_devices": int(n_dev),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "build_s": round(t_build, 2),
        "step_s": round(t_step, 2),
        "memory": {
            "argument_bytes": int(argument),
            "output_bytes": int(output),
            "temp_bytes": None if peak is None else int(peak - argument),
            "alias_bytes": 0,
            "peak_bytes": peak,
            "per_device_bytes": peak,
            "per_device_gib": None if peak is None else round(peak / GiB, 3),
        },
        "hlo_costs": {
            "dot_flops_per_dev": costs.dot_flops,
            "dot_bytes_per_dev": costs.dot_bytes,
            "n_while": 0,
            "max_trip_multiplier": 1,
            "by_op": costs.by_op,
            "kernels": costs.kernels,
        },
        "collectives": {
            "wire_bytes_per_dev": costs.coll_wire_bytes,
            "by_kind": costs.coll_by_kind,
            "counts": costs.coll_counts,
        },
        "roofline": {
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "dominant": roof.dominant,
            "model_flops_total": mf,
            "model_flops_per_dev": roof.model_flops,
            "hlo_flops_per_dev": roof.flops_per_dev,
            "useful_flops_fraction": roof.useful_flops_fraction,
            "mfu_bound": roof.mfu_bound,
        },
        "params": {
            "total": cfg.param_count(),
            "active": cfg.active_param_count(),
        },
    }


def summary(rec: Dict) -> str:
    """One line of a record: memory, counts, roofline terms."""
    m, r, h = rec["memory"], rec["roofline"], rec["hlo_costs"]
    return (f"{rec['cell']} mesh={tuple(rec['mesh'])}: "
            f"{m['per_device_gib']} GiB/dev (args "
            f"{m['argument_bytes'] / GiB:.3f} GiB), "
            f"{h['dot_flops_per_dev']:.4g} FLOP, "
            f"{h['dot_bytes_per_dev']:.4g} B, coll "
            f"{rec['collectives']['wire_bytes_per_dev']:.4g} B; "
            f"comp={r['compute_s']:.4g}s mem={r['memory_s']:.4g}s "
            f"coll={r['collective_s']:.4g}s dom={r['dominant']} "
            f"useful={r['useful_flops_fraction']:.3f} "
            f"mfu_bound={r['mfu_bound']:.3f} "
            f"build={rec['build_s']}s step={rec['step_s']}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU, an error where there is none")
    args = ap.parse_args(argv)

    mesh_cfg = MULTI_POD if args.multi_pod else SINGLE_POD
    os.makedirs(args.out, exist_ok=True)
    suffix = "multipod" if args.multi_pod else "singlepod"
    if args.all:
        cells = [(cfg, shape) for cfg in ARCHS.values()
                 for shape in SHAPES.values()]
    else:
        cells = [(get_arch(args.arch), SHAPES[args.shape])]

    failures = 0
    for cfg, shape in cells:
        name = f"{cfg.name}__{shape.name}__{suffix}"
        path = os.path.join(args.out, name + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {name}")
            continue
        if not shape_applicable(cfg, shape):
            rec = {"cell": cell_id(cfg.name, shape.name), "skipped": True,
                   "reason": "long_500k requires sub-quadratic attention "
                             "(DESIGN.md §4)"}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[SKIP-BY-DESIGN] {name}")
            continue
        try:
            rec = run_cell(cfg, shape, mesh_cfg, device=args.device)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[ok] {summary(rec)}", flush=True)
        except Exception as e:
            failures += 1
            print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
