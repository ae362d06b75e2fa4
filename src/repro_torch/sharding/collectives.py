"""Collectives over the axes of a mesh: the port's counterpart of JAX's
``lax.psum``, ``all_gather``, ``all_to_all``, ``ppermute`` and
``axis_index``.

The reference leaves its sharded computation to GSPMD and writes only a
few collectives itself (in ``shard_map`` bodies). The port writes every
collective out, and every one goes through this module: no other module
of the port calls ``torch.distributed``.

Differentiable collectives are ``torch.autograd.Function``s. A tensor on a
rank is either replicated over an axis (each rank holds the same value,
and the same gradient) or split or partial over it, and the pairs are the
Megatron ones:

* ``all_reduce`` sums partial values into a replicated one; its backward
  is the identity (the gradient of a replicated value is whole already).
* ``enter_split`` marks a replicated value that feeds a computation split
  over the axis: the identity forward, and its backward sums the partial
  gradients of the ranks.
* ``all_gather`` / ``reduce_scatter`` along a dimension are each other's
  transposes; ``all_to_all`` is its own; ``ppermute`` (send to the next
  rank of the axis, receive from the previous) is transposed by the
  reverse shift.

Two transports:

* a process group per axis (``Mesh.transport == "group"``): ``nccl``, one
  rank per card, or ``gloo`` on the CPU. ``gloo`` also runs two ranks that
  share one card (NCCL refuses two ranks on one device): there a
  collective that gloo does not take on a CUDA tensor is staged through
  host memory, and its bytes are counted (``host_staged_bytes``);
* rank alone (``"alone"``, only by ``Mesh.alone``): no process group, rank r
  of an N-rank mesh runs by itself. Every collective returns a tensor of
  the shape, dtype and device the real one would, filled with zeros, so
  that the rank allocates what it would among its peers; the values mean
  nothing. This is how the planner measures one rank's peak on one card.
  NCCL's own device buffers lie outside PyTorch's allocator and are seen
  in neither mode.

``stats()`` counts the calls and bytes of each kind (the bytes of the
input a rank sends), and the bytes staged through host memory; each kind
also keeps its largest call's bytes (``max_bytes``) and its calls and
bytes by the size of the group they span (``groups``), from which
``launch.costs`` charges each call its ring wire bytes. A rank alone
counts what it would send among its peers.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axis = Union[str, Sequence[str]]
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "ppermute")

# What gloo takes on float32 CUDA tensors in torch 2.11 (two ranks on one
# NVIDIA H100 80GB HBM3): all-reduce, all-gather, reduce-scatter and
# all_to_all_single. Its isend / irecv of a CUDA tensor aborts the process
# (gloo's TCP transport writes from the device pointer), so ppermute is
# staged through host memory, as is every collective of another dtype
# there (gloo takes bfloat16 on the CPU).
GLOO_CUDA = frozenset({"all_reduce", "all_gather", "reduce_scatter",
                       "all_to_all"})

_STATS: Dict[str, Dict[str, int]] = {}


def reset_stats() -> None:
    _STATS.clear()
    for kind in KINDS:
        _STATS[kind] = {"calls": 0, "bytes": 0, "max_bytes": 0, "groups": {}}
    _STATS["host_staged"] = {"calls": 0, "bytes": 0}


def stats() -> Dict[str, Dict]:
    """{kind: {"calls", "bytes", "max_bytes", "groups": {n: {"calls",
    "bytes"}}}} since the last ``reset_stats``, n the ranks a call spans;
    kind "host_staged" ({"calls", "bytes"}) counts the bytes copied to and
    from host memory."""
    out = {}
    for k, v in _STATS.items():
        out[k] = dict(v)
        if "groups" in v:
            out[k]["groups"] = {n: dict(g) for n, g in v["groups"].items()}
    return out


reset_stats()


def _count(kind: str, t: torch.Tensor, n: int) -> None:
    """One call of `kind` sending `t` over a group of `n` ranks."""
    size = t.numel() * t.element_size()
    entry = _STATS[kind]
    entry["calls"] += 1
    entry["bytes"] += size
    entry["max_bytes"] = max(entry["max_bytes"], size)
    group = entry["groups"].setdefault(n, {"calls": 0, "bytes": 0})
    group["calls"] += 1
    group["bytes"] += size


# ---------------------------------------------------------------------------
# process groups (the only calls to torch.distributed in the port)
# ---------------------------------------------------------------------------


def init_world(backend: str, rank: int, world_size: int,
               init_method: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Start this process's rank of the world (``init_method`` as
    ``init_process_group`` takes it: ``tcp://localhost:<port>``,
    ``file://<path>``; None reads the environment). `timeout_s` bounds a
    collective that waits for a peer (None: the backend's default)."""
    kw = {}
    if timeout_s is not None:
        import datetime
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)


def world() -> Optional[Tuple[int, int, str]]:
    """(rank, world size, backend) of this process's world, or None."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def new_group(ranks: Sequence[int]):
    """A group over `ranks`; every rank of the world must call it, for
    every group, in the same order."""
    return dist.new_group(sorted(ranks))


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier(mesh) -> None:
    if not _alone(mesh):
        dist.barrier()


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _alone(mesh) -> bool:
    """Whether `mesh` is a rank alone; a mesh that is neither one rank of
    a world (``make_mesh``) nor a rank alone (``Mesh.alone``) runs no
    collective."""
    transport = getattr(mesh, "transport", None)
    if transport not in ("group", "alone"):
        raise RuntimeError(f"a collective over {type(mesh).__name__} "
                           f"(transport {transport!r}): build the mesh "
                           "with make_mesh or Mesh.alone")
    return transport == "alone"


def _staged(mesh, kind: str, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda" and \
        (kind not in GLOO_CUDA or t.dtype != torch.float32)


def _to_host(mesh, kind: str, t: torch.Tensor) -> torch.Tensor:
    if not _staged(mesh, kind, t):
        return t
    _STATS["host_staged"]["calls"] += 1
    _STATS["host_staged"]["bytes"] += t.numel() * t.element_size()
    return t.cpu()


def _to_device(mesh, kind: str, t: torch.Tensor, device) -> torch.Tensor:
    if t.device == device:
        return t
    _STATS["host_staged"]["bytes"] += t.numel() * t.element_size()
    return t.to(device)


def _reduce_(mesh, axes, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """All-reduce `t` IN PLACE over `axes` (already normalised)."""
    _count("all_reduce", t, mesh.size(axes))
    if _alone(mesh):
        return t.zero_()
    host = _to_host(mesh, "all_reduce", t)
    dist.all_reduce(host, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group(axes))
    if host is not t:
        t.copy_(_to_device(mesh, "all_reduce", host, t.device))
    return t


def _gather0(mesh, axes, t: torch.Tensor) -> torch.Tensor:
    """(n, *t.shape): every rank's t, in the axis's order."""
    _count("all_gather", t, mesh.size(axes))
    n = mesh.size(axes)
    if _alone(mesh):
        return t.new_zeros((n, *t.shape))
    src = _to_host(mesh, "all_gather", t.contiguous().reshape(1, -1))
    out = src.new_empty((n, src.shape[1]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=mesh.group(axes))
    return _to_device(mesh, "all_gather", out, t.device).view(n, *t.shape)


def _scatter0(mesh, axes, t: torch.Tensor) -> torch.Tensor:
    """t (n, *rest): the sum over the ranks of their t[i], at rank i."""
    _count("reduce_scatter", t, mesh.size(axes))
    if _alone(mesh):
        return t.new_zeros(t.shape[1:])
    n = t.shape[0]
    src = _to_host(mesh, "reduce_scatter", t.contiguous().reshape(n, -1))
    out = src.new_empty((1, src.shape[1]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=mesh.group(axes))
    return _to_device(mesh, "reduce_scatter", out,
                      t.device).view(t.shape[1:])


def _exchange0(mesh, axes, t: torch.Tensor) -> torch.Tensor:
    """t (n, *rest): chunk j goes to rank j; chunk j of the result came
    from rank j."""
    _count("all_to_all", t, mesh.size(axes))
    if _alone(mesh):
        return torch.zeros_like(t)
    n = t.shape[0]
    src = _to_host(mesh, "all_to_all", t.contiguous().reshape(n, -1))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axes))
    return _to_device(mesh, "all_to_all", out, t.device).view(t.shape)


def _shift(mesh, axes, t: torch.Tensor, shift: int) -> torch.Tensor:
    """Send t to the rank `shift` places on along the axis (cyclic), and
    return what the rank `shift` places back sent."""
    _count("ppermute", t, mesh.size(axes))
    if _alone(mesh):
        return torch.zeros_like(t)
    n, i = mesh.size(axes), mesh.index(axes)
    ranks = mesh.axis_ranks(axes)
    src = _to_host(mesh, "ppermute", t.contiguous())
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + shift) % n]),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _to_device(mesh, "ppermute", out, t.device)


def _axes(mesh, axis: Axis) -> Tuple[str, ...]:
    """`axis` as the mesh's axes of size above 1 (none without a mesh)."""
    return () if mesh is None else mesh.normalise(axis)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce_(mesh, axes, x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(ctx.mesh, ctx.axes, g.clone()), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _cat_blocks(_gather0(mesh, axes, x), dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.mesh, ctx.axes, ctx.dim), \
            None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter0(mesh, axes, _split_blocks(x, dim, mesh.size(axes)))

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.mesh, ctx.axes, ctx.dim), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _exchange0(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return _exchange0(ctx.mesh, ctx.axes, g), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, shift):
        ctx.mesh, ctx.axes, ctx.shift = mesh, axes, shift
        return _shift(mesh, axes, x, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.mesh, ctx.axes, g, -ctx.shift), None, None, None


def _split_blocks(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x with `dim` cut in n blocks, the blocks stacked first."""
    shape = x.shape
    x = x.reshape(*shape[:dim], n, shape[dim] // n, *shape[dim + 1:])
    return x.movedim(dim, 0)


def _cat_blocks(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of ``_split_blocks``: (n, *block) -> blocks along dim."""
    x = x.movedim(0, dim)
    shape = x.shape
    return x.reshape(*shape[:dim], shape[dim] * shape[dim + 1],
                     *shape[dim + 2:])


def all_reduce(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """Sum over `axis`; the result is replicated over it (backward: the
    identity)."""
    axes = _axes(mesh, axis)
    return x if not axes else _AllReduce.apply(x, mesh, axes)


def enter_split(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """x, replicated over `axis`, as the input of a computation split over
    it: the identity forward; the backward sums the ranks' gradients."""
    axes = _axes(mesh, axis)
    return x if not axes else _EnterSplit.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' blocks of `axis` concatenated along `dim` (backward: the
    reduce-scatter of the gradient along `dim`)."""
    axes = _axes(mesh, axis)
    return x if not axes else _AllGather.apply(x, mesh, axes,
                                                           dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: Axis, dim: int
                   ) -> torch.Tensor:
    """The sum over `axis`, each rank keeping its block along `dim`
    (backward: the all-gather of the gradient)."""
    axes = _axes(mesh, axis)
    return x if not axes else _ReduceScatter.apply(x, mesh, axes,
                                                               dim)


def all_to_all(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """x (n, ...): block j to rank j of `axis`; block j of the result is
    the one rank j sent (``lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
    axes = _axes(mesh, axis)
    return x if not axes else _AllToAll.apply(x, mesh, axes)


def ppermute(x: torch.Tensor, mesh, axis: Axis, shift: int = 1
             ) -> torch.Tensor:
    """x to the rank `shift` places on along `axis` (cyclic); the result
    is what the rank `shift` places back sent (``lax.ppermute`` with the
    permutation i -> i + shift)."""
    axes = _axes(mesh, axis)
    return x if not axes else _PPermute.apply(x, mesh, axes,
                                                          shift)


# ---------------------------------------------------------------------------
# in place, no autograd (the train step's reductions)
# ---------------------------------------------------------------------------


def reduce_(t: torch.Tensor, mesh, axis: Axis, op: str = "sum"
            ) -> torch.Tensor:
    """All-reduce `t` IN PLACE over `axis` (op "sum" or "max")."""
    axes = _axes(mesh, axis)
    if not axes:
        return t
    with torch.no_grad():
        return _reduce_(mesh, axes, t, op)


def gather_into_(out: torch.Tensor, block: torch.Tensor, mesh, axis: Axis,
                 dim: int) -> torch.Tensor:
    """Write every rank's `block` of `axis` into its place along `dim` of
    `out`, IN PLACE."""
    axes = _axes(mesh, axis)
    with torch.no_grad():
        if not axes:
            return out.copy_(block)
        return out.copy_(_cat_blocks(_gather0(mesh, axes, block), dim))


def axis_size(mesh, axis: Axis) -> int:
    return 1 if mesh is None else mesh.size(axis)


def axis_index(mesh, axis: Axis) -> int:
    return 0 if mesh is None else mesh.index(axis)
