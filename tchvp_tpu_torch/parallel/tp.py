"""Tensor parallelism over the ``model`` axis.

Counterpart of ``tchvp_tpu/parallel/tp.py``. JAX constrains activations'
feature dims onto the axis (:func:`tp_constrain` for the transformer's
q/k/v heads and FFN hidden dim, :func:`conv_constrain` for the conv
stacks' channels after each stage) and GSPMD partitions the products that
make and take them. Here each rank holds its block of such an activation
and computes it itself from its slices of the full weights, which stay
replicated, as JAX keeps them:

* the transformer, Megatron's pair: q, k, v and ``ffn1`` are
  column-parallel (:func:`linear_columns`: the input enters through
  ``collectives.replicated_to_varying``), the output projection and
  ``ffn2`` row-parallel (:func:`linear_rows`: one sum over the group,
  ``collectives.all_reduce_sum_replicated``, the bias added once);
* the conv stacks (:func:`conv_forward`): a conv whose output channels the
  axis divides computes this rank's block of them from the whole input,
  gathered by ``collectives.all_gather_dim`` (its backward a
  reduce-scatter); a narrow one (the 3-channel image head, a 1-channel
  mask) computes all of them on every rank. BatchNorm on a channel block
  takes its statistics locally (``ops/blocks.py``).

The tensors between layers are thus either a rank's block (of the heads,
of the hidden dim, of the channels: "sharded", its gradient this rank's
alone) or the whole, the same on every rank ("replicated", its gradient
the whole one on every rank). A parameter used through a slice gets a
gradient only there; it carries ``tp_group``, and :func:`sum_gradients`
sums those over the group before the optimizer (JAX's note: each
replicated weight's gradient is summed over the model axis; the data mean
comes after, once). Every engagement records JAX's marker,
``tp_constrain`` or ``tp_constrain_conv``.

Gating goes through ``parallel.mesh.mesh_with_axis``: without an ambient
mesh carrying the axis with size > 1 every function here is the identity.
:func:`conv_constrain`'s ``sp_axis`` (spatial partitioning) slices the
rows of a whole map (``parallel/spatial.py::enter``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.ops.basic import add_bias, autocast_enabled
from tchvp_tpu_torch.parallel.collectives import (
    all_gather_dim,
    all_gather_dim_replicated,
    all_reduce_sum_,
    all_reduce_sum_replicated,
    reduce_scatter_dim,
    replicated_to_varying,
)
from tchvp_tpu_torch.parallel.mesh import axis_group, axis_size, mesh_with_axis


def tp_shards(tp_axis: Optional[str]) -> Optional[Tuple[int, int, dist.ProcessGroup]]:
    """(n, i, group) of ``tp_axis`` on the ambient mesh, or None where the
    gate is off."""
    mesh = mesh_with_axis(tp_axis)
    if mesh is None:
        return None
    return axis_size(mesh, tp_axis), mesh.get_local_rank(tp_axis), axis_group(mesh, tp_axis)


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    per = x.shape[dim] // n
    return x.narrow(dim, i * per, per)


def tp_constrain(x: torch.Tensor, tp_axis: Optional[str], marker: str = "tp_constrain",
                 require_divisible: bool = False) -> torch.Tensor:
    """JAX's constraint of ``x``'s trailing dim onto ``tp_axis``: this
    rank's block of it, ``x`` being the same on every rank. The identity
    where the gate is off or, with ``require_divisible``, where the axis
    does not divide the dim (an indivisible dim without it raises: JAX pads
    there, the port does not). The block's gradient is summed over the
    group into the whole one."""
    tp = tp_shards(tp_axis)
    if tp is None:
        return x
    n, i, group = tp
    if x.shape[-1] % n:
        if require_divisible:
            return x
        raise ValueError(f"dim {x.shape[-1]} not divisible by {tp_axis}={n}")
    dispatch_trace.record(marker)
    return _block(replicated_to_varying(x, group), x.dim() - 1, n, i)


def conv_constrain(x: torch.Tensor, tp_axis: Optional[str] = None,
                   sp_axis: Optional[str] = None) -> torch.Tensor:
    """JAX's conv-stage constraint on an NCHW ``x`` the same on every rank:
    its block of channels on ``tp_axis`` where the axis divides them
    (``tp_constrain_conv``), and its block of rows on ``sp_axis`` where the
    axis divides them (``sp_constrain_conv``); ``x`` where neither gate is
    on."""
    from tchvp_tpu_torch.parallel import spatial

    rows = spatial.sp_shards(sp_axis)
    if rows is not None and x.shape[2] % rows[0] == 0:
        x = spatial.enter(x, sp_axis)
    tp = tp_shards(tp_axis)
    if tp is None or x.shape[1] % tp[0]:
        return x
    n, i, group = tp
    dispatch_trace.record("tp_constrain_conv")
    return _block(replicated_to_varying(x, group), 1, n, i)


def conv_tp_constrain(x: torch.Tensor, tp_axis: Optional[str]) -> torch.Tensor:
    """The channel-only constraint (:func:`conv_constrain`)."""
    return conv_constrain(x, tp_axis=tp_axis)


def _sliced(p: torch.Tensor, dim: int, n: int, i: int, group, tp_axis: str) -> torch.Tensor:
    """This rank's block of parameter ``p``; ``p`` is marked so that
    :func:`sum_gradients` sums its gradient over the group."""
    p.tp_group, p.tp_axis = group, tp_axis
    return _block(p, dim, n, i)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.linear`` with ``ops/blocks.py::Dense``'s roundings under autocast."""
    if b is None or not autocast_enabled(x):
        return F.linear(x, w, b)
    return add_bias(F.linear(x, w), b, -1)


def linear_columns(layer: nn.Linear, x: torch.Tensor, tp_axis: str) -> torch.Tensor:
    """This rank's block of ``layer(x)``'s output features, ``x`` the same
    on every rank: x times the block's rows of the weight (the
    ``tp_constrain`` of the layer's output)."""
    n, i, group = tp_shards(tp_axis)
    if layer.out_features % n:
        raise ValueError(f"{layer.out_features} features not divisible by {tp_axis}={n}")
    dispatch_trace.record("tp_constrain")
    w = _sliced(layer.weight, 0, n, i, group, tp_axis)
    b = _sliced(layer.bias, 0, n, i, group, tp_axis) if layer.bias is not None else None
    return _linear(replicated_to_varying(x, group), w, b)


def linear_rows(layer: nn.Linear, x: torch.Tensor, tp_axis: str) -> torch.Tensor:
    """``layer`` of the whole input whose block of features ``x`` this rank
    holds: the block's product with its columns of the weight, summed over
    the group, then the bias, once; the same on every rank."""
    n, i, group = tp_shards(tp_axis)
    y = all_reduce_sum_replicated(F.linear(x, _sliced(layer.weight, 1, n, i, group, tp_axis)), group)
    if layer.bias is None:
        return y
    return add_bias(y, layer.bias, -1) if autocast_enabled(x) else y + layer.bias


def _conv(module: nn.Module, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``module``'s conv (or transposed conv) with weight ``w`` and bias
    ``b``, with ``ops/blocks.py``'s roundings under autocast."""
    if isinstance(module, nn.ConvTranspose2d):
        fn = lambda bias: F.conv_transpose2d(x, w, bias, module.stride, module.padding,  # noqa: E731
                                             module.output_padding, module.groups, module.dilation)
    else:
        fn = lambda bias: module._conv_forward(x, w, bias)  # noqa: E731
    if b is None or not autocast_enabled(x):
        return fn(b)
    return add_bias(fn(None), b, 1)


def conv_forward(module: nn.Module, x: torch.Tensor, tp_axis: str,
                 weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``module`` (a ``Conv2d`` or ``ConvTranspose2d``) on NCHW ``x``, which
    is this rank's block of the input channels or the whole input: where the
    axis divides the output channels, this rank's block of them
    (``tp_constrain_conv``), else all of them, the same on every rank.
    ``weight``: the whole kernel to slice in place of the module's (QAT's
    fake-quantized one, a function of it)."""
    n, i, group = tp_shards(tp_axis)
    if weight is None:
        weight = module.weight
    elif module.out_channels % n == 0:  # sliced below: its gradient is a block's
        module.weight.tp_group, module.weight.tp_axis = group, tp_axis
    return _conv_forward_with(module, x, tp_axis, n, i, group, weight)


def _conv_forward_with(module: nn.Module, x: torch.Tensor, tp_axis: str, n: int, i: int, group,
                       weight: torch.Tensor) -> torch.Tensor:
    cin = module.in_channels
    sharded_in = x.shape[1] != cin
    if sharded_in and x.shape[1] * n != cin:
        raise ValueError(f"input of {x.shape[1]} channels to a conv of {cin} under {tp_axis}={n}")
    transposed = isinstance(module, nn.ConvTranspose2d)
    if module.out_channels % n == 0:
        dispatch_trace.record("tp_constrain_conv")
        b = _sliced(module.bias, 0, n, i, group, tp_axis) if module.bias is not None else None
        if sharded_in and _output_numel(module, x, n) < x.numel() * n:
            # Row-parallel: this rank's input channels through their slice of
            # the weight, the partial outputs summed and scattered by channel,
            # so that the (smaller) output crosses instead of the input.
            y = reduce_scatter_dim(_conv(module, x, _sliced(weight, 0 if transposed else 1, n, i, group,
                                                            tp_axis), None), group, 1)
            return y if b is None else add_bias(y, b, 1)
        x = all_gather_dim(x, group, 1) if sharded_in else replicated_to_varying(x, group)
        return _conv(module, x, _sliced(weight, 1 if transposed else 0, n, i, group, tp_axis), b)
    if sharded_in:
        x = all_gather_dim_replicated(x, group, 1)
    return _conv(module, x, weight, module.bias)


def _output_numel(module: nn.Module, x: torch.Tensor, n: int) -> int:
    """The elements of ``module``'s whole output on ``x``, this rank's
    block of 1/n of the input channels."""
    size = []
    padding = getattr(module, "_pad_override", None) or module.padding
    for d in range(2):
        h, k, s, p, dil = (x.shape[2 + d], module.kernel_size[d], module.stride[d], padding[d],
                           module.dilation[d])
        if isinstance(module, nn.ConvTranspose2d):
            size.append((h - 1) * s - 2 * p + dil * (k - 1) + module.output_padding[d] + 1)
        else:
            size.append((h + 2 * p - dil * (k - 1) - 1) // s + 1)
    return x.shape[0] * module.out_channels * size[0] * size[1]


def to_replicated(x: torch.Tensor, tp_axis: Optional[str], channels: int, dim: int = 1) -> torch.Tensor:
    """``x`` whole on every rank: gathered along ``dim`` where it is this
    rank's block of ``channels``, as it is otherwise."""
    tp = tp_shards(tp_axis)
    if tp is None or x.shape[dim] == channels:
        return x
    return all_gather_dim_replicated(x, tp[2], dim)


def match_channels(x: torch.Tensor, like: torch.Tensor, tp_axis: Optional[str]) -> torch.Tensor:
    """``x`` (NCHW, a block of its channels or the whole) in the form of
    ``like``: a residual's two sides."""
    if x.shape[1] == like.shape[1]:
        return x
    if x.shape[1] > like.shape[1]:
        return conv_constrain(x, tp_axis)
    return all_gather_dim_replicated(x, tp_shards(tp_axis)[2], 1)


def sum_gradients(model: nn.Module) -> None:
    """Sum over its group the gradient of every parameter a tensor-parallel
    forward used through a slice (one all-reduce per group): each rank's
    gradient is zero outside its slice, so the sum is the whole one. Only
    the parameters marked under an axis the ambient mesh carries count."""
    groups: dict = {}
    for p in model.parameters():
        group = getattr(p, "tp_group", None)
        if group is not None and p.grad is not None and mesh_with_axis(p.tp_axis) is not None:
            groups.setdefault(id(group), (group, []))[1].append(p.grad)
    for group, grads in groups.values():
        all_reduce_sum_(grads, group)
