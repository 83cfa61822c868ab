"""FSDP / ZeRO-3 sharding of the training state over the ``data`` axis.

Counterpart of ``tchvp_tpu/parallel/fsdp.py``, with its names and its
placement rule (:func:`fsdp_leaf_spec`): a parameter of at least
:data:`MIN_SHARD_ELEMS` elements is split over the axis along its largest
dimension that the axis size divides; smaller or indivisible ones, and
BatchNorm's running stats, stay replicated. Expert-sharded parameters
(``ops/moe.py::shard_experts``) keep their expert placement and are not
split again, as JAX's placement rule has it (``parallel/plan.py``).

JAX's arrays are global and GSPMD inserts the gathers; here every rank
holds only its slice of each sharded parameter between steps
(:func:`shard_train_state`): ``p.data`` is the slice, the optimizer's
per-element moments and the parameter EMA are slices too, and each such
parameter carries ``fsdp_dim``, ``fsdp_axis``, ``fsdp_mesh`` and
``fsdp_group``. A step gathers the full parameters once, before its
forward (:func:`gather_params`: one all-gather of one flat buffer), and
after the backward :func:`constrain_gradients` reduce-scatters each sharded
parameter's gradient to its mean over the axis, this rank keeping its
slice, all-reduces the replicated ones, and puts the slices back, so that
the optimizer updates this rank's slices. Gathering once a step rather than
per module keeps the step's math and its kernel launches those of the
replicated step; the step's peak holds the full parameters and gradients
besides the activations (the moments and the EMA stay sliced).

Beside the other axes (``video --mesh data=2,model=2 --fsdp``, and beside
``seq``, ``spatial`` and ``expert``): the slices and the groups are the
data axis's, the ranks of one data group holding the same index along the
others. A step gathers each parameter whole; tensor parallelism slices it
at use (``parallel/tp.py``) and the seq and spatial ranks use it whole, so
the step's sums over those axes (``train/steps.py::_reduce_grads``) run on
the whole gradients before the reduce-scatter. A rank thus holds 1/data of
each sharded parameter's bytes, as under ``data`` alone; the experts keep
their expert placement.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.parallel.collectives import all_gather_along, all_reduce_mean_, reduce_scatter_mean
from tchvp_tpu_torch.parallel.mesh import axis_group, axis_size, mesh_with_axis

# Leaves smaller than this stay replicated: sharding a 512-float BN
# vector saves nothing and costs a gather. 16 KiB fp32 = 4096 elements.
MIN_SHARD_ELEMS = 4096


def fsdp_leaf_spec(shape: Sequence[int], axis: str, axis_size: int,
                   min_elems: int = MIN_SHARD_ELEMS) -> Tuple[Optional[str], ...]:
    """JAX's ``PartitionSpec`` of one leaf as a tuple: ``axis`` at the
    LARGEST dimension of ``shape`` that ``axis_size`` divides (the first of
    equals), None elsewhere; ``()`` (replicated) for a leaf of fewer than
    ``min_elems`` elements, with no such dimension, or for an axis of
    size 1."""
    dim = leaf_dim(shape, axis_size, min_elems)
    if dim is None:
        return ()
    return tuple(axis if d == dim else None for d in range(len(shape)))


def leaf_dim(shape: Sequence[int], axis_size: int, min_elems: int = MIN_SHARD_ELEMS) -> Optional[int]:
    """The dimension :func:`fsdp_leaf_spec` shards, or None."""
    if axis_size <= 1 or math.prod(shape) < min_elems:
        return None
    best_dim, best_size = None, 0
    for d, s in enumerate(shape):
        if s % axis_size == 0 and s > best_size:
            best_dim, best_size = d, s
    return best_dim


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank's slice of a sharded parameter lies: its block of
    ``dim`` along ``axis`` of ``mesh`` (the ranks of ``group``, in order)."""

    dim: int
    axis: str
    mesh: DeviceMesh
    group: dist.ProcessGroup

    @property
    def shards(self) -> Tuple[int, int]:
        """(n, i): the axis size and this rank's index along it."""
        return dist.get_world_size(self.group), dist.get_rank(self.group)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``full``."""
        n, i = self.shards
        per = full.shape[self.dim] // n
        return full.narrow(self.dim, i * per, per)


def placement(p: torch.Tensor) -> Optional[Placement]:
    """The placement of a parameter this rank holds a slice of: FSDP's
    (:func:`shard_train_state`), the experts' (``ops/moe.py``) or a
    pipeline stage's (``parallel/pipeline.py``: its row of the stacked
    stages); None for a replicated one."""
    if getattr(p, "fsdp_group", None) is not None:
        return Placement(p.fsdp_dim, p.fsdp_axis, p.fsdp_mesh, p.fsdp_group)
    if getattr(p, "ep_group", None) is not None and getattr(p, "ep_mesh", None) is not None:
        return Placement(0, p.ep_axis, p.ep_mesh, p.ep_group)
    if getattr(p, "pipe_group", None) is not None:
        return Placement(0, p.pipe_axis, p.pipe_mesh, p.pipe_group)
    return None


def sharded_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters of ``model`` that FSDP holds as slices."""
    return [p for p in model.parameters() if getattr(p, "fsdp_group", None) is not None]


def state_shardings(state, mesh: DeviceMesh, axis: str = "data",
                    min_elems: int = MIN_SHARD_ELEMS) -> Dict[str, Tuple[Optional[str], ...]]:
    """The spec of each entry of a model's ``state_dict`` (``state``: a
    :class:`~tchvp_tpu_torch.train.state.TrainState` or a module), by name:
    parameters by :func:`fsdp_leaf_spec`, one already held as slices by its
    placement (FSDP's, or the experts' over their axis, which FSDP does not
    split again), buffers ``()``. A parameter's moments and EMA share its
    spec."""
    model = getattr(state, "model", state)
    n = axis_size(mesh, axis)
    params = dict(model.named_parameters())

    def spec(k: str, v: torch.Tensor) -> Tuple[Optional[str], ...]:
        p = params.get(k)
        if p is None:
            return ()
        where = placement(p)
        if where is not None:
            return tuple(where.axis if d == where.dim else None for d in range(p.dim()))
        return fsdp_leaf_spec(tuple(v.shape), axis, n, min_elems)

    return {k: spec(k, v) for k, v in model.state_dict().items()}


def sliced_spec(p: torch.Tensor) -> Optional[Tuple[Optional[str], ...]]:
    """The spec of a parameter :func:`shard_train_state` holds as slices
    (its axis at its sliced dim), else None: the spec of the whole
    parameter, which a rank's slice no longer shows."""
    if getattr(p, "fsdp_group", None) is None:
        return None
    return tuple(p.fsdp_axis if d == p.fsdp_dim else None for d in range(p.dim()))


def shard_train_state(state, mesh: DeviceMesh, axis: str = "data", min_elems: int = MIN_SHARD_ELEMS):
    """Hold ``state`` (a :class:`~tchvp_tpu_torch.train.state.TrainState`)
    sharded over ``axis``, in place: each parameter that
    :func:`state_shardings` shards keeps only this rank's slice, and so do
    its per-element optimizer moments and its EMA. The counterpart of
    ``parallel.mesh.replicate``: call it once after ``create_train_state``;
    a sharded restore keeps the placement. A no-op where the mesh lacks the
    axis or it has size 1; returns ``state``."""
    if axis not in (mesh.mesh_dim_names or ()) or axis_size(mesh, axis) <= 1:
        return state
    group = axis_group(mesh, axis)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    tx = state.tx
    names = {id(p): k for k, p in tx.named.items()}
    for p in state.model.parameters():
        if placement(p) is not None:
            continue
        dim = leaf_dim(tuple(p.shape), n, min_elems)
        if dim is None:
            continue
        full_shape = tuple(p.shape)
        per = full_shape[dim] // n
        with torch.no_grad():
            p.data = p.data.narrow(dim, i * per, per).clone()
            for key, v in tx.core.state.get(p, {}).items():
                if torch.is_tensor(v) and tuple(v.shape) == full_shape:
                    tx.core.state[p][key] = v.narrow(dim, i * per, per).clone()
            name = names.get(id(p))
            if tx.ema is not None and name in tx.ema:
                tx.ema[name] = tx.ema[name].narrow(dim, i * per, per).clone()
        p.fsdp_dim, p.fsdp_axis, p.fsdp_mesh, p.fsdp_group = dim, axis, mesh, group
    return state


def gather_params(model: nn.Module) -> List[nn.Parameter]:
    """Give each sharded parameter of ``model`` its full value for a
    forward, its slice kept aside: one all-gather of one flat buffer per
    group and dtype. Returns the parameters gathered (none for a model
    without sharded ones); :func:`reshard` puts the slices back."""
    params = [p for p in sharded_params(model) if not hasattr(p, "_fsdp_local")]
    by_group: Dict[int, List[nn.Parameter]] = {}
    for p in params:
        by_group.setdefault(id(p.fsdp_group), []).append(p)
    for ps in by_group.values():
        full = all_gather_along([p.data for p in ps], [p.fsdp_dim for p in ps], ps[0].fsdp_group)
        for p, f in zip(ps, full):
            p._fsdp_local = p.data
            p.data = f
    return params


def reshard(params: Sequence[nn.Parameter]) -> None:
    """Put back the slices :func:`gather_params` kept aside (idempotent)."""
    for p in params:
        local = p.__dict__.pop("_fsdp_local", None)
        if local is not None:
            p.data = local


@contextlib.contextmanager
def gathered(model: nn.Module) -> Iterator[List[nn.Parameter]]:
    """Within the scope the sharded parameters of ``model`` hold their full
    values (an eval forward of a sharded state); the slices come back at
    its end."""
    params = gather_params(model)
    try:
        yield params
    finally:
        reshard(params)


def constrain_gradients(model: nn.Module, axis: str, mesh: Optional[DeviceMesh] = None) -> None:
    """After the backward of a step whose parameters :func:`gather_params`
    made whole: each sharded parameter's gradient becomes its mean over
    ``axis``, reduce-scattered so that this rank keeps its slice, the
    parameter gets its slice back, and every other gradient is all-reduced
    to its mean. The mesh comes from ``mesh`` or the ambient scope; without
    one carrying the axis with size > 1 this is the identity (the step's
    ``fsdp_axis`` is dormant, as in JAX). Records the ``fsdp_constrain``
    marker."""
    if mesh is None:
        mesh = mesh_with_axis(axis)
        if mesh is None:
            return
    elif axis not in (mesh.mesh_dim_names or ()) or axis_size(mesh, axis) <= 1:
        return
    group = axis_group(mesh, axis)
    dispatch_trace.record("fsdp_constrain")
    sharded = [p for p in sharded_params(model) if p.grad is not None]
    slices = reduce_scatter_mean([p.grad for p in sharded], [p.fsdp_dim for p in sharded], group)
    reshard(sharded_params(model))
    for p, g in zip(sharded, slices):
        p.grad = g
    ids = {id(p) for p in sharded}
    all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None and id(p) not in ids], group)


def state_leaves(state) -> Dict[str, Tuple[torch.Tensor, Optional[Placement]]]:
    """``{key: (tensor, placement or None)}`` of every tensor of ``state``
    (a ``TrainState``, or a module): the model's entries (``model.<name>``),
    the optimizer's moments (``moment.<name>.<key>``: a per-element one
    shares its parameter's placement), the parameter EMA (``ema.<name>``)
    and the generators' states (``generator.noise``, ``generator.dropout``);
    the keys of a shard-wise checkpoint (``train/checkpoint.py``)."""
    model = getattr(state, "model", state)
    params = dict(model.named_parameters())
    out = {f"model.{k}": (v, placement(params[k]) if k in params else None)
           for k, v in model.state_dict().items()}
    tx = getattr(state, "tx", None)
    if tx is not None:
        names = {id(p): n for n, p in tx.named.items()}
        for p, st in tx.core.state.items():
            for key, v in st.items():
                if torch.is_tensor(v):
                    out[f"moment.{names[id(p)]}.{key}"] = (v, placement(p) if v.dim() > 0 else None)
        for n, v in (tx.ema or {}).items():
            out[f"ema.{n}"] = (v, placement(tx.named[n]))
        out["generator.noise"] = (state.noise_generator.get_state(), None)
        out["generator.dropout"] = (state.dropout_generator.get_state(), None)
    return out


def sharded_size_bytes(state) -> int:
    """This rank's bytes of ``state`` (:func:`state_leaves`): its slices of
    the sharded parameters, moments and EMA, and the whole of everything
    replicated: the number FSDP shrinks."""
    return sum(t.numel() * t.element_size() for t, _ in state_leaves(state).values())


def global_size_bytes(state) -> int:
    """The bytes of the whole state that :func:`sharded_size_bytes` holds a
    part of: each slice counted at its full size."""
    return sum(t.numel() * t.element_size() * (where.shards[0] if where is not None else 1)
               for t, where in state_leaves(state).values())
