"""Crispy for GPUs: the paper's pipeline applied to choosing a GPU count.

Paper step                      ->  here
1. five small dataset samples   ->  five reduced-DEPTH variants of the job
                                    (n_layers ladder; same family, same
                                    shape — depth is the knob device memory
                                    is linear in: layer params + optimizer
                                    state + activation stash)
2. profile on a single machine  ->  run one step of each variant on the one
                                    card and read the CUDA caching
                                    allocator's peak (CUDAMemoryProfiler)
3. OLS + R^2 > .99 gate         ->  identical (core/memory_model.py)
4. pick cheapest feasible config->  BFA over the GPU catalog restricted to
                                    configs with enough aggregate memory

A copy of the JAX package's ``repro/core/hbm_planner.py`` with the same
ladder, fit, gate and selection; the profile is a step on the card where the
reference's is an AOT compile on the host. The profile "mesh" is the one
card, so the per-device bytes are the aggregate requirement.

As in the reference, the fit is against the effective depths after family
rounding (``_reduced_depth``) and the extrapolation is to ``cfg.n_layers``:
for zamba2-7b that is 81 where the model holds 13 groups of 6 = 78 Mamba2
blocks, so the prediction is taken three blocks past the model.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core.catalog import ClusterConfig, gpu_catalog
from repro_torch.core.history import ExecutionHistory
from repro_torch.core.memory_model import LinearMemoryModel, fit_memory_model
from repro_torch.core.profiler import CUDAMemoryProfiler
from repro_torch.core.sampling import integer_ladder
from repro_torch.core.selector import Selection, select_bfa
from repro_torch.launch.dryrun import build_step

GiB = 1024 ** 3
# What an NVIDIA H100 80GB HBM3 (700 W) held beyond the allocator's peak at
# deepseek-7b's full-depth bf16 prefill (B=4, S=2048): the CUDA context and
# the caching allocator's slack, (total - free) of mem_get_info minus
# max_memory_allocated (CUDAProfileResult.overhead_bytes): 1.752 GiB in a
# process that runs the planner alone (chip_smoke.py --phases env,planner,
# examples/gpu_advisor_torch.py), 1.842 GiB after the whole smoke's other
# phases
GPU_OVERHEAD_GIB = 1.75


def _reduced_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """Same architecture, fewer layers (hybrid/vlm keep group structure)."""
    if cfg.hybrid is not None:
        period = cfg.hybrid.period
        n_layers = max(period, (n_layers // period) * period)
    if cfg.cross_attn is not None:
        period = cfg.cross_attn.period
        n_layers = max(period, (n_layers // period) * period)
    return dataclasses.replace(cfg, n_layers=n_layers)


@dataclass
class PlanReport:
    job: str
    ladder: List[int]
    per_dev_bytes: List[float]
    model: LinearMemoryModel
    predicted_per_dev_gib: float      # at full depth, on the profile card
    requirement_gib: float            # aggregate, extrapolated
    selection: Optional[Selection]
    profile_wall_s: float
    profile_mesh_devices: int


class HBMPlanner:
    def __init__(self, catalog: Optional[List[ClusterConfig]] = None,
                 history: Optional[ExecutionHistory] = None,
                 overhead_gib: float = GPU_OVERHEAD_GIB,
                 leeway: float = 0.05):
        self.catalog = catalog if catalog is not None else gpu_catalog()
        self.history = history
        self.overhead = overhead_gib
        self.leeway = leeway

    # -- profiling ----------------------------------------------------------
    def profile_memory(self, cfg: ModelConfig, shape: ShapeConfig,
                       run: Optional[RunConfig] = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> float:
        """Bytes one step of the job allocates on the card at its peak
        (device None: the GPU; any other than a CUDA device raises)."""
        job = build_step(cfg, shape, run, device)
        return CUDAMemoryProfiler().profile(job, cfg.n_layers,
                                            device).job_mem_bytes

    @staticmethod
    def depth_ladder(cfg: ModelConfig,
                     anchor_layers: Optional[int] = None) -> List[int]:
        """The five depths `plan` profiles, before family rounding."""
        anchor = anchor_layers or max(2, min(cfg.n_layers // 4, 12))
        # lo >= 2: the reference keeps a length-1 scan off its ladder (XLA
        # inlines it, and its buffer liveness differs from the scanned
        # steady state); the port keeps the same ladder
        lo = 2
        if cfg.hybrid is not None:
            lo = cfg.hybrid.period
            anchor = max(anchor, 3 * lo)
        if cfg.cross_attn is not None:
            lo = cfg.cross_attn.period
            anchor = max(anchor, 3 * lo)
        return integer_ladder(anchor, n=5, lo=lo)

    def plan(self, cfg: ModelConfig, shape: ShapeConfig,
             device: Optional[Union[str, torch.device]] = None,
             run: Optional[RunConfig] = None,
             anchor_layers: Optional[int] = None,
             select: bool = True) -> PlanReport:
        t0 = time.monotonic()
        n_dev = 1
        ladder = self.depth_ladder(cfg, anchor_layers)
        mems = []
        for L in ladder:
            small = _reduced_depth(cfg, L)
            mems.append(self.profile_memory(small, shape, run, device))
        # fit vs the *effective* layer counts after family rounding
        eff = [_reduced_depth(cfg, L).n_layers for L in ladder]
        model = fit_memory_model(eff, mems)
        pred_dev = model.requirement(cfg.n_layers, self.leeway)
        req_gib = pred_dev * n_dev / GiB
        wall = time.monotonic() - t0
        sel = None
        if select:
            sel = self.select(req_gib, pred_dev / GiB if model.confident
                              else 0.0, job=f"{cfg.name}:{shape.name}")
        return PlanReport(f"{cfg.name}:{shape.name}", list(eff), mems, model,
                          pred_dev / GiB, req_gib, sel, wall, n_dev)

    # -- selection ------------------------------------------------------------
    def select(self, requirement_gib: float, per_dev_gib_at_profile: float,
               job: str = "") -> Selection:
        """The cheapest feasible config (BFA over them when there is a
        history). As in the reference, a requirement is taken to divide
        evenly over a config's devices; the port cannot run a job sharded
        yet, so for more than one GPU that is an assumption, not a
        measurement."""
        feasible = []
        for c in self.catalog:
            usable = c.usable_mem_gib(self.overhead)
            if usable < requirement_gib:
                continue
            # per-device check: aggregate requirement divided over the GPUs
            if requirement_gib > 0 and \
                    requirement_gib / c.scale_out > c.node.mem_gib - self.overhead:
                continue
            feasible.append(c)
        fell_back = requirement_gib <= 0.0
        if not feasible:
            feasible = sorted(
                self.catalog,
                key=lambda c: -c.usable_mem_gib(self.overhead))[:1]
            fell_back = True
        if self.history is not None:
            cfg = select_bfa(feasible, self.history, exclude_job=job)
        else:
            cfg = min(feasible, key=lambda c: c.usd_per_hour)
        return Selection(cfg, "crispy-hbm", requirement_gib, len(feasible),
                         fell_back)
