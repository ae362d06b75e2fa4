"""Meshes of ranks, as the reference's ``repro/launch/mesh.py`` builds meshes
of devices.

A ``Mesh`` names its axes and their sizes (``MeshConfig``), this process's
rank and its coordinates (row-major over the axes, as ``jax.make_mesh``
lays out the CPU's devices), its device, and the transport of its
collectives (``sharding/collectives.py``):

* ``make_mesh(cfg, backend=, device=)``: one rank of a world of
  ``torch.distributed`` processes, with a process group for every set of
  axes (the world must have exactly ``cfg.n_devices`` ranks);
* ``Mesh.alone(cfg, rank=, device=)``: rank `rank` run by itself, every
  collective returning zeros of its result's shape; only this
  constructor selects that transport.

A ``MeshShape`` holds the axes alone, and gives any rank's coordinates
(``coords_of``); the rules read it, and no collective
runs over it.

``make_production_mesh``, ``mesh_of`` and ``mesh_config`` give shapes only
and start no process group. The reference's ``compat_shard_map`` and
``compat_axis_size`` have no counterpart here: the port writes its
collectives out (``collectives.axis_size``, ``collectives.axis_index``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules


@dataclass
class MeshShape:
    """Axis names and sizes, and the coordinates of any rank: what the
    sharding rules read (``mesh.shape[name]``, ``mesh.axis_names``). It
    runs no collective."""
    config: MeshConfig

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.config.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.config.axes, self.config.shape))

    def size(self, axis) -> int:
        n = 1
        for a in self.normalise(axis):
            n *= self.shape[a]
        return n

    def normalise(self, axis) -> Tuple[str, ...]:
        """`axis` (a name or names) as the names of the mesh's axes of size
        above 1 among them, in the mesh's order (a name the mesh does not
        have is an axis of size 1, as the rules take it)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis or ())
        return tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """World rank `rank`'s coordinates (row-major over the axes)."""
        return rules.rank_coords(self, rank)

    def index_of(self, axis, rank: int) -> int:
        """Rank `rank`'s place along `axis` (names combined row-major in
        the mesh's order)."""
        coords, i = self.coords_of(rank), 0
        for a in self.normalise(axis):
            i = i * self.shape[a] + coords[a]
        return i

    def ranks_along(self, axis, rank: int) -> Tuple[int, ...]:
        """The world ranks along `axis` through rank `rank`, by index."""
        axes, coords = self.normalise(axis), self.coords_of(rank)
        return tuple(_rank_of(self.config, {**coords, **dict(zip(
            axes, pos))}) for pos in itertools.product(
                *(range(self.shape[a]) for a in axes)))


TRANSPORTS = ("group", "alone")


@dataclass
class Mesh(MeshShape):
    """One rank of a mesh, with the transport of its collectives: built by
    ``make_mesh`` ("group") or ``Mesh.alone`` ("alone") and by nothing
    else (the transport has no default)."""
    rank: int
    device: torch.device
    transport: str                        # "group" | "alone"
    backend: Optional[str] = None         # "nccl" | "gloo" under "group"
    groups: Dict[Tuple[str, ...], object] = field(default_factory=dict,
                                                  repr=False)

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport {self.transport!r}: one of "
                             f"{TRANSPORTS}")

    @property
    def coords(self) -> Dict[str, int]:
        return self.coords_of(self.rank)

    def index(self, axis) -> int:
        """This rank's place along `axis`."""
        return self.index_of(axis, self.rank)

    def axis_ranks(self, axis) -> Tuple[int, ...]:
        """The world ranks along `axis` through this rank, by index."""
        return self.ranks_along(axis, self.rank)

    def group(self, axis):
        return self.groups[self.normalise(axis)]

    @classmethod
    def alone(cls, cfg: MeshConfig, rank: int = 0,
              device: Optional[Union[str, torch.device]] = None) -> "Mesh":
        """Rank `rank` of `cfg` with no peers: its collectives return
        zeros of the right shape (``collectives``). device=None is the GPU."""
        if not 0 <= rank < cfg.n_devices:
            raise ValueError(f"rank {rank} outside a mesh of "
                             f"{cfg.n_devices}")
        return cls(cfg, rank=rank, device=resolve_device(device),
                   transport="alone")


def _rank_of(cfg: MeshConfig, coords: Dict[str, int]) -> int:
    r = 0
    for name, n in zip(cfg.axes, cfg.shape):
        r = r * n + coords[name]
    return r


def make_mesh(cfg: MeshConfig, backend: Optional[str] = None,
              device: Optional[Union[str, torch.device]] = None, *,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              timeout_s: Optional[float] = None) -> Mesh:
    """This process's rank of `cfg` over ``torch.distributed``. When no world
    is running yet one is started (`init_method`, `rank`, the world size
    ``cfg.n_devices``; None reads the environment; `timeout_s` bounds a
    collective's wait for a peer). Every rank must call
    this with the same `cfg`: it creates a process group for every set of
    axes, in the same order on every rank. device=None is the GPU;
    backend=None is "nccl" on a CUDA device and "gloo" otherwise."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if C.world() is None:
        if rank is None:
            raise ValueError("make_mesh: no world is running; give `rank` "
                             "(and `init_method`)")
        C.init_world(backend, rank, cfg.n_devices, init_method, timeout_s)
    rank, world_size, backend = C.world()
    if world_size != cfg.n_devices:
        raise ValueError(f"a world of {world_size} ranks for a mesh of "
                         f"{cfg.n_devices} ({cfg.shape})")
    mesh = Mesh(cfg, rank=rank, device=device, transport="group",
                backend=backend)
    live = [a for a, n in zip(cfg.axes, cfg.shape) if n > 1]
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            other = [a for a in cfg.axes if a not in axes]
            for fixed in itertools.product(
                    *(range(mesh.shape[a]) for a in other)):
                ranks = [_rank_of(cfg, {**dict(zip(other, fixed)),
                                        **dict(zip(axes, pos))})
                         for pos in itertools.product(
                             *(range(mesh.shape[a]) for a in axes))]
                group = C.new_group(ranks)
                if rank in ranks:
                    mesh.groups[axes] = group
    return mesh


def make_local_mesh(model: int = 1, data: Optional[int] = None, *,
                    backend: Optional[str] = None, device=None,
                    init_method: Optional[str] = None,
                    rank: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the running world (data=None: the world's
    size over `model`), or over a new one of data x model ranks."""
    if data is None:
        running = C.world()
        if running is None:
            raise ValueError("make_local_mesh: give `data` when no world "
                             "is running")
        data = running[1] // model
    return make_mesh(MeshConfig((data, model), ("data", "model")), backend,
                     device, init_method=init_method, rank=rank)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production shapes, (16, 16) or (2, 16, 16): shapes
    only, no process group."""
    return MeshShape(MULTI_POD if multi_pod else SINGLE_POD)


def mesh_of(shape) -> MeshConfig:
    """The MeshConfig of a shape or of its text ("16x16"): two axes are
    (data, model), three (pod, data, model)."""
    if isinstance(shape, str):
        shape = tuple(int(n) for n in shape.split("x"))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return MeshConfig(tuple(shape), axes)


def mesh_config(mesh) -> MeshConfig:
    return MeshConfig(tuple(mesh.shape[a] for a in mesh.axis_names),
                      tuple(mesh.axis_names))


def shutdown(mesh: Optional[Mesh] = None) -> None:
    """End this process's world (a no-op for a rank alone)."""
    if mesh is None or mesh.transport == "group":
        C.shutdown()
