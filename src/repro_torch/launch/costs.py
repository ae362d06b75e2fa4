"""Counts of one rank's step for its roofline: the port's counterpart of the
reference's ``repro/launch/hlo_costs.py``.

The reference parses XLA's optimized HLO and charges every ``dot`` its
FLOPs (2 x output elements x contraction) and its bytes (both operands
and the output), each times the trip counts of the loops around it, and
every collective its ring wire bytes. The port's step is eager PyTorch, so
``count(fn)`` runs it with the dot set's four ATen ops counted as they
reach their CPU or CUDA kernel: the backward and a remat policy's
recompute included, and a loop's every turn (there is no trip count to
recover):

* FLOPs of the reference's dot set, from ``torch.utils.flop_counter``'s
  registered formulas: ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` (a
  ``matmul`` or ``einsum`` reaches the dispatcher as one of them). No
  family of the port runs a convolution (Mamba2's causal conv is a sum of
  shifted products), so the set holds no convolution;
* bytes: each such op's two matrix operands and its output (an addmm's
  bias is an add outside the dot, as in XLA);
* collectives from ``sharding.collectives.stats()``, each call charged
  the reference's ring wire bytes (``repro/launch/roofline.py``,
  ``parse_collectives``, ``hlo_costs.analyze``) over the group it spans:
  all-reduce 2 S (n-1)/n, all-gather, reduce-scatter and all-to-all
  S (n-1)/n, ppermute S, where S is the call's result, as the reference
  reads it from the HLO's result type: an all-gather's gathered output, a
  reduce-scatter's block of 1/n of its input, the others' input.

The hand-written kernels are ``ctypes`` launches that no dispatch mode
sees. Each wrapper reports its launch through ``kernels.build.launched``,
which ``count`` observes, with its module's formula (``costs(...)`` in
``kernels/{flash_attention,wkv6,ssd,rmsnorm}.py``): the FLOPs and bytes
that its plain version counts in the dot set, so that a step that runs a
kernel on the card counts what the same step counts on the CPU through
the plain version, and the bytes the kernel itself moves
(``kernels[name]["io_bytes"]``, its bound note's, outside the roofline's
terms). Flash attention, wkv6 and ssd contribute FLOPs and bytes: their
plain versions are products (``einsum``, two to five a chunk). rmsnorm
contributes bytes only, to its own record: its plain version holds no
product, and the reference's dot set leaves norms out. The reference's
dry run has no kernel in its count either: it takes
``attn_impl="blocked"``, plain dots.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build
from repro_torch.sharding import collectives as C

aten = torch.ops.aten
# op -> the positions of its two matrix operands
DOTS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2),
        aten.baddbmm: (1, 2)}
BACKENDS = ("CPU", "CUDA")
# the port's collective kinds under the reference's names
KIND_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
              "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
              "ppermute": "collective-permute"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@dataclass
class Costs:
    """One rank's counts: the dot set's FLOPs and bytes (by op), the
    kernels' launches, and the collectives' calls and ring wire bytes."""
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    by_op: Dict[str, Dict[str, float]] = field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    coll_wire_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, int] = field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.dot_flops += flops
        self.dot_bytes += nbytes
        entry = self.by_op.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        entry["calls"] += 1
        entry["flops"] += flops
        entry["bytes"] += nbytes

    def kernel(self, name: str, flops: float, nbytes: float,
               io_bytes: float) -> None:
        """A kernel wrapper's launch (``build.launched``): `flops` and
        `nbytes` are what its plain version counts in the dot set,
        `io_bytes` what the kernel moves."""
        self.dot_flops += flops
        self.dot_bytes += nbytes
        entry = self.kernels.setdefault(name, {
            "launches": 0, "flops": 0.0, "bytes": 0.0, "io_bytes": 0.0})
        entry["launches"] += 1
        entry["flops"] += flops
        entry["bytes"] += nbytes
        entry["io_bytes"] += io_bytes




class DotCounter:
    """While open, the dot set's ops are counted into `costs` as they reach
    their backend kernel. A ``TorchDispatchMode`` would see them as well,
    but it takes Python on every ATen op of the step (about 55 us an op
    against 5 without, measured on a CPU host: minutes for a train_4k
    step's millions of ops); here only the four products pass through
    Python:
    each one's CPU and CUDA kernel is replaced by one that computes
    it into a new tensor with the op's ``out=`` overload (a kernel of its
    own) and counts it. Closing removes the replacements, which puts the
    original kernels back."""

    def __init__(self, costs: Costs):
        self.costs = costs
        self.lib = None

    def _kernel(self, packet, where):
        name = str(packet).split(".", 1)[-1]
        out_op = packet.out

        def kernel(*args, **kwargs):
            a, b = args[where[0]], args[where[1]]
            out = a.new_empty((*a.shape[:-1], b.shape[-1]))
            out_op(*args, **kwargs, out=out)
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.costs.add(name, float(flops),
                           float(_nbytes(a) + _nbytes(b) + _nbytes(out)))
            return out

        return kernel

    def __enter__(self):
        self.lib = torch.library.Library("aten", "IMPL")
        with warnings.catch_warnings():
            # "Overriding a previously registered kernel": on purpose
            warnings.simplefilter("ignore", UserWarning)
            for packet, where in DOTS.items():
                kernel = self._kernel(packet, where)
                for key in BACKENDS:
                    self.lib.impl(str(packet).split(".", 1)[-1], kernel, key)
        return self

    def __exit__(self, *exc):
        self.lib._destroy()
        self.lib = None
        return False


def ring_wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """The reference's ring wire bytes of calls of `kind` whose inputs
    (what the port counts) hold `nbytes` in all, over `n` ranks."""
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    if kind == "all_reduce":
        return 2.0 * nbytes * ring
    if kind == "all_gather":
        return nbytes * n * ring          # S: the gathered output
    if kind == "reduce_scatter":
        return nbytes / n * ring          # S: this rank's block
    if kind == "ppermute":
        return float(nbytes)
    return nbytes * ring


def add_collectives(costs: Costs, stats: Dict) -> Costs:
    """Charge `costs` the calls of ``collectives.stats()``."""
    for kind, name in KIND_NAMES.items():
        entry = stats.get(kind) or {}
        if not entry.get("calls"):
            continue
        wire = sum(ring_wire_bytes(kind, g["bytes"], int(n))
                   for n, g in entry["groups"].items())
        costs.coll_wire_bytes += wire
        costs.coll_by_kind[name] = costs.coll_by_kind.get(name, 0.0) + wire
        costs.coll_counts[name] = costs.coll_counts.get(name, 0) + \
            entry["calls"]
    return costs


def count(fn: Callable[[], object]) -> Tuple[object, Costs]:
    """(fn(), its Costs): fn run with the dot set counted (``DotCounter``),
    the collectives' counts reset before and read after, and every kernel
    launch meanwhile counted. One count at a time."""
    costs = Costs()
    C.reset_stats()
    stop = build.observe(costs.kernel)
    try:
        with DotCounter(costs):
            out = fn()
    finally:
        stop()
    add_collectives(costs, C.stats())
    return out, costs
