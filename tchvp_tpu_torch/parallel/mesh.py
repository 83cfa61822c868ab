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
place from :func:`axis_shards`.

Transport: ``gloo`` carries CPU tensors (the CPU tests, and two ranks
sharing one GPU: NCCL refuses two ranks on one device), ``nccl`` device
tensors, one GPU per rank (:mod:`.collectives`).
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# The mesh in scope (activate_mesh): JAX's mesh context.
_ambient: contextvars.ContextVar[Optional[DeviceMesh]] = contextvars.ContextVar(
    "ambient_mesh", default=None)


def init_distributed(init_method: str, world_size: int, rank: int, backend: str = "gloo",
                     timeout_s: float = 300.0) -> None:
    """Join the default process group (no-op for one process): each rank
    gives the rendezvous (``tcp://localhost:<port>`` or ``file://<path>``),
    the world size and its rank; nothing is read from the environment. A
    collective that waits longer than ``timeout_s`` raises instead of
    hanging. Backend ``"nccl"`` needs one GPU per rank, set with
    ``torch.cuda.set_device`` first."""
    if world_size > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


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
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


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


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_with_axis(axis: Optional[str]) -> Optional[DeviceMesh]:
    """The ambient mesh iff it carries ``axis`` with size > 1, else None:
    the gate of every mesh-conditional path, as in JAX."""
    if axis is None:
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


def shard_frames(clip: torch.Tensor, mesh: DeviceMesh, seq_axis: str, seq_dim: int = 1) -> torch.Tensor:
    """This rank's contiguous block of ``clip``'s frame dim (``seq_dim``)
    along ``seq_axis``: the counterpart of ``shard_batch(seq_axis=...,
    seq_dim=1)``, which GSPMD splits the same way. The frames must divide
    evenly."""
    n, i = axis_size(mesh, seq_axis), mesh.get_local_rank(seq_axis)
    t = clip.shape[seq_dim]
    if t % n:
        raise ValueError(f"{t} frames do not split over {seq_axis}={n}")
    return clip.narrow(seq_dim, i * (t // n), t // n)
