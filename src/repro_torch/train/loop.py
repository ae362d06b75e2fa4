"""Fault-tolerant training loop, as the reference's ``repro/train/loop.py``.

Wraps the train step with:
  * periodic async checkpoints (the loader cursor in the manifest) and a
    final one, and resume from the latest checkpoint of ``ckpt_dir``;
  * a SIGTERM/SIGINT hook: a final checkpoint, then a clean exit;
  * a straggler watchdog: an EWMA of the step time; steps slower than
    ``straggler_factor`` x EWMA are logged with the loader's late-batch
    count, which tells input stalls from compute stalls;
  * a NaN guard: a non-finite loss ends the run with FloatingPointError
    (the final checkpoint is still written, as the reference writes it).

The step time is the host's clock around one step, which waits for the
card when it reads the loss.
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.data.pipeline import LoaderState


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


@dataclass
class LoopReport:
    losses: List[float] = field(default_factory=list)
    aux: List[float] = field(default_factory=list)   # the router's, if any
    step_times: List[float] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    preempted: bool = False
    final_step: int = 0


def train_loop(state, train_step: Callable, loader, cfg: LoopConfig,
               log: Callable[[str], None] = print) -> tuple:
    """Runs `train_step(state, batch) -> (state, metrics)` up to
    cfg.total_steps. Returns (state, LoopReport). Closes `loader`."""
    report = LoopReport()
    ckpt = AsyncCheckpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
    start_step = 0

    if ckpt is not None:
        last = latest_step(cfg.ckpt_dir)
        if last is not None:
            state, extra = restore_checkpoint(cfg.ckpt_dir, last, state)
            start_step = int(extra.get("step", last))
            if hasattr(loader, "state") and "loader" in extra:
                loader.state = LoaderState.from_dict(extra["loader"])
            log(f"[resume] restored step {start_step} from {cfg.ckpt_dir}")

    preempt = {"flag": False}
    prev_handlers = {}

    def on_signal(signum, frame):
        preempt["flag"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:          # not the main thread
            pass

    ewma = None
    step = start_step
    try:
        while step < cfg.total_steps:
            batch = next(loader) if hasattr(loader, "__next__") \
                else loader(step)
            t0 = time.monotonic()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            report.losses.append(loss)
            report.step_times.append(dt)
            if "aux" in metrics:
                report.aux.append(float(metrics["aux"]))
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            if ewma is None:
                ewma = dt
            else:
                if dt > cfg.straggler_factor * ewma and step > start_step + 2:
                    late = getattr(loader, "late_batches", 0)
                    report.stragglers.append(step)
                    log(f"[straggler] step {step}: {dt:.3f}s vs EWMA "
                        f"{ewma:.3f}s (late input batches: {late})")
                ewma = (1 - cfg.ewma_alpha) * ewma + cfg.ewma_alpha * dt
            step += 1
            if cfg.log_every and step % cfg.log_every == 0:
                log(f"[train] step {step}: loss {loss:.4f} "
                    f"({dt * 1e3:.0f} ms)")
            if ckpt is not None and step % cfg.ckpt_every == 0:
                ckpt.save(step, state, extra=_extra(step, loader))
            if preempt["flag"]:
                log(f"[preempt] signal at step {step}; checkpointing")
                report.preempted = True
                break
    finally:
        if ckpt is not None:
            ckpt.wait()
            ckpt.save(step, state, extra=_extra(step, loader))
            ckpt.wait()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if hasattr(loader, "close"):
            loader.close()
    report.final_step = step
    return state, report


def _extra(step: int, loader):
    extra = {"step": step}
    if hasattr(loader, "state"):
        extra["loader"] = loader.state.to_dict()
    return extra
