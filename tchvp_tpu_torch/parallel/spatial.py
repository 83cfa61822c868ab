"""Spatial partitioning over the ``spatial`` mesh axis: image rows in blocks,
a halo exchange under every conv.

Counterpart of the ``sp_axis`` half of ``tchvp_tpu/parallel/tp.py::
conv_constrain``. JAX pins NHWC dim 1 of each conv stage's output onto the
axis and GSPMD inserts a collective-permute of a few boundary rows under
every conv; the stack never gathers the image. Here each rank holds its
contiguous block of the rows of every map of a conv stack (NCHW dim 2) and
exchanges the halos itself:

* a model's conv stack is entered through :func:`enter`, which slices this
  rank's rows of the whole map every rank holds (``replicated_to_varying``:
  the slice's backward sums the ranks' cotangents), and left through
  :func:`gather_rows` (``all_gather_dim_replicated``: the backward hands
  each rank its block of the replicated cotangent, not their sum, which
  would scale the gradient by the axis size);
* a conv (:func:`conv_rows`) takes ``top`` rows from the ranks above and
  ``bottom`` from the ranks below (``collectives.halo_exchange``, zeros past
  the global edges, where the conv pads), then convolves with no padding
  along H: rank i's output rows are exactly rows [i r / s, (i + 1) r / s) of
  the whole conv's. 1x1 stride-2 downsamples, 2x2 pools, nearest
  upsamples and the 2x2 stride-2 transposed convs need no halo;
* train-mode BatchNorm reduces over the axis (``ops/blocks.py``), and
  element-wise dropout draws the whole map's mask and keeps its rows
  (:func:`dropout_rows`), so a rank's masks are one process's.

The maps stay blocks from :func:`enter` to :func:`gather_rows`, inside the
scope of one stack (:func:`rows`), which decides by the rows of the map
that enters it. JAX's gate keeps a map whole where the axis does not
divide its rows; here a stack runs on row blocks only where every block
halves evenly at each of its stride-2 stages (``factor``), and otherwise
stays whole on every rank of the axis, the axis switched off inside
(``parallel/mesh.py::axes_off``): its convs exchange no halo, its
BatchNorm reduces over the other axes, its attention runs on the whole
sequence. Its entry then sums the ranks' cotangents and its exit hands
each rank 1/n of the cotangent, so that :func:`sum_gradients` gives its
parameters their whole gradient, as for a stack on row blocks.

Gradients: a parameter used on row blocks gets this rank's part of its
gradient. :func:`set_sp_axis` marks those parameters, and
:func:`sum_gradients` sums them over the axis before the data mean; the
parameters used on whole tensors (the flagship's temporal transformer,
which every rank of the axis computes alike) already hold the whole
gradient.

:data:`COUNTS` counts the halo exchanges, slices and gathers of row blocks
(the port's form of JAX's "no all-gather in the HLO" check).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.parallel.collectives import (
    all_gather_dim_replicated,
    all_reduce_sum_,
    halo_exchange,
    replicated_to_varying,
)
from tchvp_tpu_torch.parallel.mesh import axes_off, axis_group, axis_size, mesh_with_axis, switched_off

# Halo exchanges, entries (slices) and gathers of row blocks since the last
# reset_counts().
COUNTS = {"halo": 0, "slice": 0, "gather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def sp_shards(sp_axis: Optional[str]) -> Optional[Tuple[int, int, dist.ProcessGroup]]:
    """(n, i, group) of ``sp_axis`` on the ambient mesh, or None where the
    gate is off."""
    mesh = mesh_with_axis(sp_axis)
    if mesh is None:
        return None
    return axis_size(mesh, sp_axis), mesh.get_local_rank(sp_axis), axis_group(mesh, sp_axis)


@contextlib.contextmanager
def rows(sp_axis: Optional[str], whole_rows: int, factor: int = 1) -> Iterator[None]:
    """The scope of one conv stack over maps of ``whole_rows`` rows, from
    its :func:`enter` to its :func:`gather_rows`: on row blocks where the
    gate is on and each rank's block divides by ``factor`` (the product of
    the stack's strides); else, where the gate is on, the stack stays whole
    on every rank and ``sp_axis`` is off inside (module docstring)."""
    shards = sp_shards(sp_axis)
    if shards is None or whole_rows % (shards[0] * factor) == 0:
        yield
        return
    dispatch_trace.record("sp_whole")
    with axes_off((sp_axis,)):
        yield


def enter(x: torch.Tensor, sp_axis: Optional[str], factor: int = 1, dim: int = 2) -> torch.Tensor:
    """This rank's block of the rows (``dim``) of ``x``, the same on every
    rank, where the gate is on (JAX's ``sp_constrain_conv``); ``x`` where it
    is off; inside a stack kept whole (:func:`rows`), ``x`` entering a
    computation every rank makes alike, whose backward sums the ranks'
    cotangents. Each block must divide by ``factor``, the product of the
    strides of the stack it enters: a stack whose blocks do not is kept
    whole by its :func:`rows` scope."""
    mesh = switched_off(sp_axis)
    if mesh is not None:
        return replicated_to_varying(x, axis_group(mesh, sp_axis))
    shards = sp_shards(sp_axis)
    if shards is None:
        return x
    n, i, group = shards
    whole = x.shape[dim]
    if whole % (n * factor):
        raise ValueError(f"{whole} rows over {sp_axis}={n}: each rank's block must divide by {factor} "
                         f"(the stride-2 stages of the stack), so the rows by {n * factor}; enter the "
                         f"stack under spatial.rows, which keeps it whole")
    dispatch_trace.record("sp_constrain_conv")
    COUNTS["slice"] += 1
    per = whole // n
    return replicated_to_varying(x, group).narrow(dim, i * per, per)


class _ShareCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def gather_rows(x: torch.Tensor, sp_axis: Optional[str], dim: int = 2) -> torch.Tensor:
    """The whole map of this rank's row block ``x``, on every rank, for a
    computation every rank makes alike: the backward keeps this rank's
    block of the cotangent. ``x`` where the gate is off; inside a stack
    kept whole (:func:`rows`), ``x``, whose backward keeps 1/n of the
    cotangent (the ranks' parts sum to it)."""
    mesh = switched_off(sp_axis)
    if mesh is not None:
        return _ShareCotangent.apply(x, axis_size(mesh, sp_axis))
    shards = sp_shards(sp_axis)
    if shards is None:
        return x
    dispatch_trace.record("sp_gather")
    COUNTS["gather"] += 1
    return all_gather_dim_replicated(x, shards[2], dim)


def halo_rows(kernel: int, stride: int, dilation: int, top: int) -> int:
    """The rows a block needs from below for a conv padded ``top`` above,
    whose output keeps 1/stride of the block's rows."""
    return max(0, dilation * (kernel - 1) + 1 - stride - top)


def conv_rows(module: nn.Conv2d, x: torch.Tensor, shards: Tuple[int, int, dist.ProcessGroup],
              inner) -> torch.Tensor:
    """``module`` on this rank's row block ``x``: the halos its kernel,
    stride and padding need, the W padding, then ``inner`` (the module's
    own forward) with no padding at all; rank i's block of the whole conv's
    output."""
    n, _, group = shards
    k, s, d = module.kernel_size[0], module.stride[0], module.dilation[0]
    r = x.shape[2]
    if r % s:
        raise ValueError(f"a stride-{s} conv on a block of {r} rows under {module.sp_axis}={n}")
    top, left, right = module.spatial_pads(r * n, x.shape[3])
    bottom = halo_rows(k, s, d, top)
    if top or bottom:
        dispatch_trace.record("sp_halo")
        COUNTS["halo"] += 1
        x = halo_exchange(x, top, bottom, group)
    if left or right:
        x = F.pad(x, (left, right, 0, 0))
    module._pad_override = (0, 0)
    try:
        out = inner(x)
    finally:
        module._pad_override = None
    if out.shape[2] * s != r:
        raise ValueError(f"conv {tuple(module.kernel_size)}/{s} padded {top} above: {out.shape[2]} rows "
                         f"from a block of {r}")
    return out


def dropout_rows(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
                 shards: Tuple[int, int, dist.ProcessGroup]) -> torch.Tensor:
    """Element-wise inverted dropout of ``x``, this rank's row block of a
    map (``shards``: :func:`sp_shards`): the whole map's mask, drawn alike
    on every rank, this rank keeping its rows."""
    from tchvp_tpu_torch.ops.blocks import draw_keep, dropout

    n, i, _ = shards
    b, c, r, w = x.shape
    keep = draw_keep((b, c, r * n, w), rate, generator, x.device)
    return dropout(x, rate, None, keep=keep.narrow(2, i * r, r))


def set_sp_axis(module: nn.Module, sp_axis: Optional[str]) -> None:
    """Give every submodule that reads ``sp_axis`` (convs, BatchNorm, the
    stacks that enter and leave row blocks) the axis, and mark every
    parameter of ``module`` as used on row blocks (:func:`sum_gradients`)."""
    for m in module.modules():
        if hasattr(type(m), "sp_axis"):
            m.sp_axis = sp_axis
    for p in module.parameters():
        p.sp_axis = sp_axis


def sum_gradients(model: nn.Module) -> None:
    """Sum over the axis the gradient of every parameter marked by
    :func:`set_sp_axis` whose axis the ambient mesh carries: each rank's
    gradient is its rows' part. One all-reduce per group."""
    groups: dict = {}
    for p in model.parameters():
        shards = sp_shards(getattr(p, "sp_axis", None))
        if shards is not None and p.grad is not None:
            groups.setdefault(id(shards[2]), (shards[2], []))[1].append(p.grad)
    for group, grads in groups.values():
        all_reduce_sum_(grads, group)
