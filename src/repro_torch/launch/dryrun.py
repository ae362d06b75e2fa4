"""One step of an (architecture x shape) job on one device, for the planner.

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
``preset_run`` on a one-device mesh. ``run_cell``, the HLO dump and the
sharding specs of the reference wait for the port's multi-device
machinery.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch import resolve_device, resolve_dtype
from repro_torch.configs.base import (MeshConfig, ModelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.launch.presets import preset_run
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

ONE_DEVICE = MeshConfig((1, 1), ("data", "model"))


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               run: Optional[RunConfig] = None,
               device: Optional[Union[str, torch.device]] = None,
               seed: int = 0) -> Callable[[], object]:
    """A callable that runs one step of `shape.mode` for `cfg` on `device`
    (None: the GPU), building its weights, state and inputs there."""
    if shape.mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {shape.mode!r}")
    device = resolve_device(device)
    run = run or preset_run(cfg, shape, ONE_DEVICE)
    B, S = shape.global_batch, shape.seq_len

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

    def build():
        """Weights, state and inputs on the device -> the step to run."""
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        model = Model(cfg, run, device=device)
        if shape.mode == "train":
            acfg = AdamWConfig(moment_dtype=run.moment_dtype,
                               keep_master=run.param_dtype != "float32")
            state = init_train_state(model, seed, acfg)
            batch = {**inputs(generator, S), "labels": tokens(generator, S)}
            return lambda: make_train_step(model, acfg)(state, batch)[1]
        model.init(seed=seed)
        if shape.mode == "prefill":
            batch = inputs(generator, S)
            return lambda: model.prefill(batch, S)
        caches = model.init_caches(B, S)
        batch = inputs(generator, 1)
        return lambda: model.decode_step(batch, caches)

    def step():
        run_step = build()
        if device.type == "cuda":
            # the peak a profiler reads is the step's, with its weights,
            # state and inputs live, as XLA's analysis of the step counts
            # them: the build's own transients (a weight drawn in float32
            # and cast) are no part of it
            torch.cuda.reset_peak_memory_stats(device)
        return run_step()

    return step
