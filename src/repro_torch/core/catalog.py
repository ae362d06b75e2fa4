"""Cluster configuration catalogs of the port.

``NodeType``, ``ClusterConfig``, ``medium_config`` and ``aws_like_catalog``
(the paper's search space: {c,m,r} x {large, xlarge, 2xlarge} x scale-outs
4..48, with c4/m4/r4 memory and 2017-era us-east-1 on-demand prices) are
copies of the JAX package's ``repro/core/catalog.py``. In place of its TPU
catalog the port has ``gpu_catalog()``: NVIDIA H100 80GB HBM3 cards, one to eight in one node
and 16, 32 or 64 over several nodes.

* ``mem_gib`` is the card's whole memory as ``torch.cuda.mem_get_info``
  reports it on an NVIDIA H100 80GB HBM3 (power limit 700 W):
  H100_MEM_BYTES.
* ``peak_tflops`` and ``hbm_gbps`` are the H100 SXM data sheet's (989
  TFLOP/s bf16 dense, 3.35 TB/s).
* No price is known here, so ``usd_per_hour`` is GPU-hours times
  ``unit_price``: a unit, not dollars. With the default price of 1 the
  cheapest fit is the one with the fewest GPUs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

GiB = 1024 ** 3

# torch.cuda.mem_get_info()[1] on an NVIDIA H100 80GB HBM3, 700 W
H100_MEM_BYTES = 85_017_493_504
# the data sheet's dense bf16 rate: the capacity unit of selector.py
H100_PEAK_FLOPS = 989e12


@dataclass(frozen=True)
class NodeType:
    name: str
    cores: int               # cores (VMs) / devices per node (GPU: 1)
    mem_gib: float           # memory per node (VM RAM / device memory)
    usd_per_hour: float
    peak_tflops: float = 0.0     # accelerators only
    hbm_gbps: float = 0.0
    ici_gbps: float = 0.0


@dataclass(frozen=True)
class ClusterConfig:
    node: NodeType
    scale_out: int           # number of nodes (VMs / GPUs)

    @property
    def name(self) -> str:
        return f"{self.node.name}x{self.scale_out}"

    @property
    def total_mem_gib(self) -> float:
        return self.node.mem_gib * self.scale_out

    @property
    def total_cores(self) -> int:
        return self.node.cores * self.scale_out

    @property
    def usd_per_hour(self) -> float:
        return self.node.usd_per_hour * self.scale_out

    def usable_mem_gib(self, overhead_per_node_gib: float) -> float:
        """Paper §III-D: subtract the fixed per-node OS/framework overhead
        (~2 GiB for Spark/Hadoop on Ubuntu; on a GPU the CUDA context and
        the allocator's slack, hbm_planner.GPU_OVERHEAD_GIB)."""
        return max(0.0, (self.node.mem_gib - overhead_per_node_gib)
                   * self.scale_out)


def medium_config(catalog: List[ClusterConfig]) -> ClusterConfig:
    """Paper baseline 2: a medium VM at medium scale-out (12x m4.xlarge in
    the paper's dataset). Generalized: median node by memory, median
    scale-out."""
    nodes = sorted({c.node.name: c.node for c in catalog}.values(),
                   key=lambda n: (n.cores, n.mem_gib))
    node = nodes[len(nodes) // 2]
    scales = sorted({c.scale_out for c in catalog})
    scale = scales[len(scales) // 2]
    want = ClusterConfig(node, scale)
    for c in catalog:
        if c.name == want.name:
            return c
    return want


# -- AWS-like (paper evaluation space) --------------------------------------

_AWS_NODES = [
    #        name        cores mem$/h
    NodeType("c4.large", 2, 3.75, 0.100),
    NodeType("c4.xlarge", 4, 7.5, 0.199),
    NodeType("c4.2xlarge", 8, 15.0, 0.398),
    NodeType("m4.large", 2, 8.0, 0.100),
    NodeType("m4.xlarge", 4, 16.0, 0.200),
    NodeType("m4.2xlarge", 8, 32.0, 0.400),
    NodeType("r4.large", 2, 15.25, 0.133),
    NodeType("r4.xlarge", 4, 30.5, 0.266),
    NodeType("r4.2xlarge", 8, 61.0, 0.532),
]

_AWS_SCALEOUTS = [4, 6, 8, 10, 12, 16, 24, 32, 40, 48]


def aws_like_catalog() -> List[ClusterConfig]:
    return [ClusterConfig(n, s) for n in _AWS_NODES for s in _AWS_SCALEOUTS]


# -- GPU ----------------------------------------------------------------------

GPU_SCALEOUTS = [1, 2, 4, 8, 16, 32, 64]


def gpu_catalog(unit_price: float = 1.0) -> List[ClusterConfig]:
    node = NodeType("h100-80gb-hbm3", 1, H100_MEM_BYTES / GiB, unit_price,
                    peak_tflops=H100_PEAK_FLOPS / 1e12, hbm_gbps=3350.0)
    return [ClusterConfig(node, s) for s in GPU_SCALEOUTS]
