"""Device mesh and the mesh gate of the port.

Counterpart of ``tchvp_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
with named axes over the ranks of the default process group
(:func:`init_distributed`); :func:`activate_mesh` puts one in scope, as
JAX's ``with mesh:`` and ``set_mesh`` do, and :func:`mesh_with_axis` is the
one gate every mesh-conditional path reads: the ambient mesh iff it carries
the axis with size > 1.

JAX's arrays are global and GSPMD splits them; here every rank holds only
its own part. Under sequence parallelism (the ``seq`` axis) a rank holds a
contiguous block of each clip's frames (:func:`shard_frames`), and the
paths that see the whole sequence (windowed attention, the positional
encoding, train-mode BatchNorm statistics, the loss) read their rank's
place from :func:`axis_shards`. Under data parallelism (the ``data`` axis,
:data:`DATA_AXIS`) a rank holds a contiguous block of the batch
(:func:`shard_batch`); train-mode BatchNorm, the losses and the metrics
reduce over the axis's group, as JAX's GSPMD step sees the global batch.
Under spatial partitioning (the ``spatial`` axis) a rank holds a block of
every map's rows (``parallel/spatial.py``); under pipelining (``pipe``) a
stage of the temporal layers (``parallel/pipeline.py``). Meshes of several
axes lay their ranks out row-major in the order the axes are given, and
:func:`group_over` is the group of several axes at once. JAX's sharding specs
(``batch_spec``, ``sequence_sharding``) have no counterpart: the port cuts
the tensors themselves (:func:`shard_batch`, :func:`shard_frames`).

The launch (:func:`init_distributed`) is JAX's ``jax.distributed``: one
process a card on every host, each given the rendezvous, the world size and
its rank. At the rendezvous each rank publishes its host's identity (the host
name and the cards it sees), and every rank reads the whole table back and
computes the same :class:`HostLayout` (:func:`host_layout`): its host, its
local rank, the card it takes and the backend. Transport: ``nccl`` carries
device tensors when every host has a card for each of its ranks; ``gloo``
carries CPU tensors (the CPU tests) and the ranks of a host that share its
cards (NCCL refuses two ranks on one device) (:mod:`.collectives`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import json
import math
import socket
import weakref
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# The batch axis of data parallelism (JAX's repo convention).
DATA_AXIS = "data"

# The mesh in scope (activate_mesh): JAX's mesh context.
_ambient: contextvars.ContextVar[Optional[DeviceMesh]] = contextvars.ContextVar(
    "ambient_mesh", default=None)
# Axes of the ambient mesh switched off in scope (axes_off): a stack kept
# whole on every rank of the axis.
_off: contextvars.ContextVar[frozenset] = contextvars.ContextVar("axes_off", default=frozenset())


# The layout of the launch that made the default process group, beside a weak
# reference to that group (destroying the group frees it, as without the
# layout): (group ref, layout), set by init_distributed.
_launch: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class HostLayout:
    """Where a rank of a launch runs: JAX's ``process_index`` and local
    devices. Hosts are numbered by their lowest rank, and a host's ranks by
    their global rank. ``card`` is the card the rank takes (None on the
    CPU); ``backend`` is ``"nccl"`` iff every host has a card for each of
    its ranks, else ``"gloo"``."""

    rank: int
    host_index: int
    local_rank: int
    card: Optional[int]
    backend: str
    host_of: Tuple[int, ...]  # every rank's host index
    host_cards: Tuple[int, ...]  # every host's cards (0 on the CPU)

    @property
    def hosts(self) -> int:
        return len(self.host_cards)

    @property
    def host_ranks(self) -> Tuple[int, ...]:
        """Every host's number of ranks."""
        return tuple(self.host_of.count(h) for h in range(self.hosts))

    @property
    def local_world(self) -> int:
        return self.host_ranks[self.host_index]


def _host_identity(cuda: bool, host: Optional[str] = None) -> list:
    """What this rank publishes at the rendezvous: its host's name
    (``host`` overrides it) and the UUIDs of the cards it sees, in order
    (none on the CPU). Ranks with the same identity share a host."""
    uuids = [str(torch.cuda.get_device_properties(i).uuid) for i in range(torch.cuda.device_count())] if cuda else []
    return [socket.gethostname() if host is None else host, uuids]


def host_layout(identities: Sequence[Sequence], rank: int, cuda: bool = True) -> HostLayout:
    """The layout of ``rank`` from every rank's :func:`_host_identity`: the
    same table gives every rank the same hosts and backend. A rank takes card
    ``local_rank`` where its host has a card for each of its ranks, else
    ``local_rank % cards`` (ranks sharing cards, over gloo)."""
    keys = [(name, tuple(uuids)) for name, uuids in identities]
    index: dict = {}
    host_of = tuple(index.setdefault(k, len(index)) for k in keys)
    host_cards = tuple(len(keys[host_of.index(h)][1]) if cuda else 0 for h in range(len(index)))
    if cuda and 0 in host_cards:
        raise ValueError(f"a CUDA launch where the ranks of host {host_cards.index(0)} see no card")
    h = host_of[rank]
    local_rank = host_of[:rank].count(h)
    shared = any(host_of.count(g) > cards for g, cards in enumerate(host_cards))
    card = (local_rank if host_cards[h] >= host_of.count(h) else local_rank % host_cards[h]) if cuda else None
    return HostLayout(rank, h, local_rank, card, "nccl" if cuda and not shared else "gloo", host_of, host_cards)


def launch_line(layout: HostLayout) -> str:
    """Rank 0's line of the launch: its hosts, whether every rank has a card
    of its own, the backend and why."""
    ranks = layout.host_ranks
    hosts = (f"{layout.hosts} host{'s' if layout.hosts > 1 else ''} x {ranks[0]} rank{'s' if ranks[0] > 1 else ''}"
             if len(set(ranks)) == 1 else f"{layout.hosts} hosts of {', '.join(map(str, ranks))} ranks")
    if layout.card is None:
        return f"launch: {hosts} on the CPU, backend gloo"
    if layout.backend == "gloo":
        short = [f"{n} ranks on {c} card{'s' if c > 1 else ''}" for n, c in zip(ranks, layout.host_cards) if n > c]
        return (f"launch: {hosts}, ranks share cards ({'; '.join(short)}), so backend gloo "
                f"(NCCL needs a card a rank)")
    return f"launch: {hosts}, a card a rank, backend nccl"


def launch_layout() -> Optional[HostLayout]:
    """The :class:`HostLayout` of the launch that made the default process
    group (:func:`init_distributed`), or None (one process, or a group made
    otherwise)."""
    if _launch is None or not dist.is_initialized() or _launch[0]() is not dist.group.WORLD:
        return None
    return _launch[1]


def init_distributed(init_method: str, world_size: int, rank: int, device: str = "cpu",
                     timeout_s: float = 300.0, host: Optional[str] = None) -> Optional[HostLayout]:
    """Join the default process group (no-op for one process) and return
    this rank's :class:`HostLayout`: each rank gives the rendezvous
    (``tcp://host:port`` or ``file://<path>``), the world size, its rank and
    the device type its tensors live on (``"cuda"``: the layout's card,
    which this sets current; ``"cuda:i"`` takes card i); nothing is read
    from the environment. ``host`` stands in for the host's name (the
    tests' emulated hosts). A collective that waits longer than
    ``timeout_s`` raises instead of hanging, and so does an NCCL group that
    does not start."""
    global _launch
    if world_size <= 1 or dist.is_initialized():
        return launch_layout()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(init_method, rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    table = dist.PrefixStore("tchvp_hosts", store)
    table.set(str(rank), json.dumps(_host_identity(cuda, host)))
    layout = host_layout([json.loads(table.get(str(r))) for r in range(world_size)], rank, cuda)
    if cuda:
        torch.cuda.set_device(layout.card if dev.index is None else dev.index)
    if layout.backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("every host has a card a rank, but this torch has no NCCL")
    dist.init_process_group(layout.backend, store=dist.PrefixStore("default_pg", store), world_size=world_size,
                            rank=rank, timeout=timeout)
    if layout.backend == "nccl":
        from tchvp_tpu_torch.parallel.collectives import all_reduce_sum_

        try:  # NCCL starts its communicator at the first collective
            all_reduce_sum_([torch.zeros(1, device="cuda")], dist.group.WORLD)
            torch.cuda.synchronize()
        except Exception as e:
            raise RuntimeError(f"NCCL did not start on rank {rank} ({launch_line(layout)})") from e
    _launch = (weakref.ref(dist.group.WORLD), layout)
    return layout


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A named mesh over the ranks of the default process group.

    Default: all ranks on one ``"data"`` axis. ``shape`` factors them over
    several axes, e.g. ``axes=("data", "seq"), shape=(2, 2)``; ranks are
    laid out row-major, so the last axis holds neighbouring ranks."""
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(axes)} x {tuple(shape)} does not cover {world} ranks")
    return _mesh_of(torch.arange(world).reshape(tuple(shape)), axes)


def _mesh_of(ranks: torch.Tensor, axes: Sequence[str]) -> DeviceMesh:
    """The named mesh of the default group's ranks laid out as ``ranks``."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_hybrid_mesh(ici_axes: Sequence[str], ici_shape: Sequence[int], dcn_axis: str = "replica",
                     dcn_size: Optional[int] = None) -> DeviceMesh:
    """JAX's multi-slice mesh: the slow ``dcn_axis`` outermost, the fast
    ``ici_axes`` inside, so collectives of the inner axes stay within a
    host's ranks and only the outer axis crosses hosts. A host is JAX's
    slice: ``dcn_size`` defaults to the number of hosts of the launch
    (:func:`launch_layout`; 1 on one host), and where it equals them, each
    group is a host's ranks in order, wherever they sit among the ranks;
    else (one host, or another ``dcn_size``) group g holds ranks g *
    prod(ici_shape) on, as JAX groups devices off a multi-slice pod."""
    world = dist.get_world_size()
    layout = launch_layout()
    hosts = layout.hosts if layout is not None else 1
    per_group = math.prod(ici_shape)
    if dcn_size is None:
        dcn_size = hosts
    if dcn_size * per_group != world:
        raise ValueError(f"{dcn_size} slices x {tuple(ici_shape)} ici = {dcn_size * per_group} ranks, "
                         f"have {world}")
    if hosts == dcn_size > 1:
        groups = [[r for r in range(world) if layout.host_of[r] == h] for h in range(hosts)]
        if any(len(g) != per_group for g in groups):
            raise ValueError(f"uneven slices: {[len(g) for g in groups]} ranks per slice, need {per_group}")
        ranks = torch.tensor(groups)
    else:
        ranks = torch.arange(world)
    return _mesh_of(ranks.reshape((dcn_size,) + tuple(ici_shape)), (dcn_axis,) + tuple(ici_axes))


def _slice_dim(x, mesh: DeviceMesh, axis: Optional[str], dim: int):
    """This rank's contiguous block of ``x``'s ``dim`` along ``axis``, where
    the mesh carries the axis with size > 1 and it divides the dim (JAX's
    ``shard_batch`` leaves a dim it does not divide whole)."""
    if axis is None or axis not in (mesh.mesh_dim_names or ()) or x.ndim <= dim:
        return x
    n = axis_size(mesh, axis)
    if n <= 1 or x.shape[dim] % n:
        return x
    i, per = mesh.get_local_rank(axis), x.shape[dim] // n
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, i * per, per)
    return x[(slice(None),) * dim + (slice(i * per, (i + 1) * per),)]


def shard_batch(batch, mesh: DeviceMesh, batch_axis: str = DATA_AXIS, seq_axis: Optional[str] = None,
                seq_dim: int = 1, sp_axis: Optional[str] = None, sp_dim: int = 2):
    """This rank's part of a global batch (a tensor, a numpy array, or a
    tuple or list of them): its block of dim 0 along ``batch_axis``, with
    ``seq_axis`` its block of the frames (``seq_dim``), with ``sp_axis`` its
    block of the image rows (``sp_dim``: 2 for clips, 1 for images), as
    JAX's ``shard_batch`` places them; a dim the axis does not divide stays
    whole."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, batch_axis, seq_axis, seq_dim, sp_axis, sp_dim)
                           for b in batch)
    batch = _slice_dim(_slice_dim(batch, mesh, batch_axis, 0), mesh, seq_axis, seq_dim)
    return _slice_dim(batch, mesh, sp_axis, sp_dim)


def replicate(tree, mesh: Optional[DeviceMesh] = None, src: int = 0):
    """Rank ``src``'s values on every rank, in place: a module's parameters
    and buffers, or the tensors of a dict, list or tuple (JAX's
    ``replicate`` of params and optimizer state). Returns ``tree``."""
    from tchvp_tpu_torch.parallel.collectives import broadcast_

    del mesh  # every mesh of the port spans the default group
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = [t for t in tree.values() if isinstance(t, torch.Tensor)]
    elif isinstance(tree, (list, tuple)):
        tensors = [t for t in tree if isinstance(t, torch.Tensor)]
    else:
        tensors = [tree]
    if dist.is_initialized() and dist.get_world_size() > 1:
        with torch.no_grad():
            broadcast_(tensors, src)
    return tree


def host_local_batch_slice(global_batch: int, axis: str = DATA_AXIS) -> Tuple[int, int]:
    """(start, size) of this rank's slice of the global batch dim: along
    ``axis`` of the ambient mesh, else over the processes. JAX slices per
    host (one process a host); here each rank is a process and reads its
    own slice, and a host's ranks, contiguous, together read its host's
    slice."""
    n, i = axis_shards(axis)
    if n == 1 and ambient_mesh() is None and dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} ranks")
    per = global_batch // n
    return i * per, per


def ambient_mesh() -> Optional[DeviceMesh]:
    """The mesh put in scope by the innermost :func:`activate_mesh`, or None."""
    return _ambient.get()


@contextlib.contextmanager
def activate_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Put ``mesh`` in scope for the paths gated by :func:`mesh_with_axis`."""
    token = _ambient.set(mesh)
    try:
        yield mesh
    finally:
        _ambient.reset(token)


@contextlib.contextmanager
def axes_off(axes: Sequence[str]) -> Iterator[None]:
    """Switch ``axes`` of the ambient mesh off in scope: :func:`mesh_with_axis`
    reads None for them, as for a mesh without them (a stack that runs
    whole on every rank of an axis, ``parallel/spatial.py::rows``)."""
    token = _off.set(_off.get() | frozenset(axes))
    try:
        yield
    finally:
        _off.reset(token)


def switched_off(axis: Optional[str]) -> Optional[DeviceMesh]:
    """The ambient mesh iff it carries ``axis`` with size > 1 and
    :func:`axes_off` has switched the axis off in scope, else None."""
    if axis is None or axis not in _off.get():
        return None
    mesh = ambient_mesh()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()) or axis_size(mesh, axis) <= 1:
        return None
    return mesh


def with_current_mesh(fn):
    """``fn`` run under the mesh in scope now (or none) and its axes
    switched off now, wherever it is called: the recompute of a
    checkpointed region runs in the backward, which on CUDA runs on the
    autograd engine's own thread, and a thread does not see another's
    :func:`activate_mesh` scope."""
    mesh, off = ambient_mesh(), _off.get()

    def run(*args):
        token, off_token = _ambient.set(mesh), _off.set(off)
        try:
            return fn(*args)
        finally:
            _off.reset(off_token)
            _ambient.reset(token)

    return run


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_with_axis(axis: Optional[str]) -> Optional[DeviceMesh]:
    """The ambient mesh iff it carries ``axis`` with size > 1 and the axis
    is not switched off in scope (:func:`axes_off`), else None: the gate of
    every mesh-conditional path, as in JAX."""
    if axis is None or axis in _off.get():
        return None
    mesh = ambient_mesh()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()) or axis_size(mesh, axis) <= 1:
        return None
    return mesh


def axis_shards(axis: Optional[str]) -> Tuple[int, int]:
    """(n, i): the size of ``axis`` on the ambient mesh and this rank's
    index along it, or (1, 0) when :func:`mesh_with_axis` is off."""
    mesh = mesh_with_axis(axis)
    if mesh is None:
        return 1, 0
    return axis_size(mesh, axis), mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str) -> dist.ProcessGroup:
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def group_over(axes: Sequence[Optional[str]]) -> Optional[dist.ProcessGroup]:
    """The group of this rank's ranks along every one of ``axes`` that the
    ambient mesh carries with size > 1: None when none does, that axis's
    group for one, the whole mesh's (the default group, which every mesh of
    the port spans) when they are all of its axes, else the group of the
    submesh over them (made once, by every rank, as all ranks reach the
    same layers in the same order)."""
    on = [a for a in dict.fromkeys(axes) if mesh_with_axis(a) is not None]
    if not on:
        return None
    mesh = ambient_mesh()
    if len(on) == 1:
        return axis_group(mesh, on[0])
    live = [a for a in mesh.mesh_dim_names if axis_size(mesh, a) > 1]
    if sorted(on) == sorted(live):
        return dist.group.WORLD
    names = tuple(a for a in mesh.mesh_dim_names if a in on)
    return mesh[names]._flatten("_".join(names)).get_group()


def shard_frames(clip: torch.Tensor, mesh: DeviceMesh, seq_axis: str, seq_dim: int = 1) -> torch.Tensor:
    """This rank's contiguous block of ``clip``'s frame dim (``seq_dim``)
    along ``seq_axis``: the counterpart of ``shard_batch(seq_axis=...,
    seq_dim=1)``, which GSPMD splits the same way. The frames must divide
    evenly (JAX's error for a sequence the axis does not divide)."""
    n, i = axis_size(mesh, seq_axis), mesh.get_local_rank(seq_axis)
    t = clip.shape[seq_dim]
    if t % n:
        raise ValueError(f"seq len {t} not divisible by {seq_axis}={n}")
    return clip.narrow(seq_dim, i * (t // n), t // n)
