"""Roofline terms of one rank's step: the port's counterpart of the
reference's ``repro/launch/roofline.py``, with an H100's constants.

    compute term    = dot FLOPs a rank / PEAK_FLOPS
    memory term     = dot bytes a rank (+ the optimizer's traffic) / HBM_BW
    collective term = ring wire bytes a rank / LINK_BW

The counts come from ``launch.costs`` (the reference's come from the
optimized HLO); the formulas are the reference's. Constants, NVIDIA H100
SXM5 80 GB (the data sheet):

* ``PEAK_FLOPS`` = 989e12, dense bfloat16 on the tensor cores, the
  number of ``core.catalog.H100_PEAK_FLOPS`` (not imported from there:
  ``core`` imports the planner, which imports ``launch.dryrun``);
* ``HBM_BW`` = 3.35e12 B/s of HBM3;
* ``LINK_BW`` = 450e9 B/s, NVLink 4 one way (900 GB/s both ways). A group
  wider than the 8 cards of a node crosses InfiniBand, which this one link
  constant does not model (the reference has one ICI constant too).
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float = 0.0
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """Model FLOPs over the counted FLOPs of a rank: what remat and
        redundant work add."""
        if self.flops_per_dev <= 0:
            return 0.0
        return self.model_flops / self.flops_per_dev

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound: model FLOPs a
        rank / (bound_s x peak)."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops / (self.bound_s * self.peak_flops)


def roofline_from(cost: dict, wire_bytes: float, n_devices: int,
                  model_flops_total: float, *, peak_flops: float = PEAK_FLOPS,
                  hbm_bw: float = HBM_BW, link_bw: float = LINK_BW
                  ) -> Roofline:
    """Terms from a cost dict with "flops" and "bytes accessed" (the
    reference's ``cost_analysis()`` keys) and the collectives' wire bytes."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        compute_s=flops / peak_flops,
        memory_s=byts / hbm_bw,
        collective_s=wire_bytes / link_bw,
        flops_per_dev=flops,
        bytes_per_dev=byts,
        coll_bytes_per_dev=wire_bytes,
        model_flops=model_flops_total / max(n_devices, 1),
        peak_flops=peak_flops,
    )


def roofline_from_costs(costs, n_devices: int, model_flops_total: float,
                        extra_hbm_bytes: float = 0.0, *,
                        peak_flops: float = PEAK_FLOPS,
                        hbm_bw: float = HBM_BW, link_bw: float = LINK_BW
                        ) -> Roofline:
    """Terms from a rank's ``costs.Costs`` (the reference's
    ``roofline_from_hlo``). `extra_hbm_bytes`: traffic outside the dot set
    a rank moves (the optimizer's update reading and writing the
    parameters and moments)."""
    byts = costs.dot_bytes + extra_hbm_bytes
    return Roofline(
        compute_s=costs.dot_flops / peak_flops,
        memory_s=byts / hbm_bw,
        collective_s=costs.coll_wire_bytes / link_bw,
        flops_per_dev=costs.dot_flops,
        bytes_per_dev=byts,
        coll_bytes_per_dev=costs.coll_wire_bytes,
        model_flops=model_flops_total / max(n_devices, 1),
        peak_flops=peak_flops,
    )


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs of the whole step over all devices:

    train:    6 * N_active * tokens     (forward 2 + backward 4)
    prefill:  2 * N_active * tokens
    decode:   2 * N_active * batch      (one token a sequence)

    (the attention's score FLOPs are left out by convention: 6 N D)."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.tokens
    if shape.mode == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch
