"""Collectives of the sequence-parallel path, differentiable where the
forward needs it.

* :func:`ppermute` — the halo exchange of ``sdpa_windowed_seq_sharded``:
  rank i's tensor goes to rank i + 1 of the group; rank 0, which has no
  source, receives zeros, as JAX's ``ppermute`` gives a device no pair
  names. Its backward is the reverse exchange: the halo's gradient goes
  back to its owner, where autograd adds it to the local one.
* :func:`all_reduce_sum` — the sum over the group, whose backward is the
  sum of the cotangents over the group (the statistics of train-mode
  BatchNorm, the gathered keys of full attention).
* :func:`all_reduce_mean_` — in place, not differentiable: the gradients'
  mean before the optimizer, in one flat buffer.
* :func:`equal_across` — whether tensors hold the same bits on every rank.

A ``gloo`` group carries CPU tensors only, so a CUDA tensor crosses through
host memory there: that is the transport of two ranks sharing one GPU (NCCL
refuses two ranks on one device), and the CPU tests'. An ``nccl`` group
carries device tensors.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _wire(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """A contiguous copy of ``x`` the group's backend can carry."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


def _shift(x: torch.Tensor, group: dist.ProcessGroup, step: int) -> torch.Tensor:
    """Rank i's ``x`` to rank i + step of ``group``; zeros where no rank
    sends."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    send = _wire(x, group)
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, i + step), group=group))
    if 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, i - step), group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ppermute(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """JAX's ``ppermute`` with the pairs ``[(i, i + 1)]`` over ``group``:
    rank i + 1 receives rank i's ``x``, rank 0 zeros; differentiable."""
    return _PPermute.apply(x, group)


def _all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    buf = _wire(x, group)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``, the same on every rank;
    differentiable (the adjoint sums the cotangents over the group)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Replace each tensor by its mean over ``group``, in place: one
    all-reduce of one flat buffer per dtype. Every rank ends with the same
    bits."""
    n = dist.get_world_size(group)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_ts])
        flat = _all_reduce(flat, group) / n
        for t, part in zip(group_ts, flat.split([t.numel() for t in group_ts])):
            t.copy_(part.view_as(t))


def equal_across(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> List[bool]:
    """For each tensor, whether every rank of ``group`` holds the same bits:
    the elementwise max and min over the ranks of its integer view agree."""
    out = []
    for t in tensors:
        bits = t.detach().contiguous().reshape(-1)
        if bits.element_size() > 1:
            bits = bits.view(torch.int16 if bits.element_size() == 2 else torch.int32)
        bits = bits.to(torch.int32)
        hi, lo = _wire(bits, group), _wire(bits, group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        out.append(bool(torch.equal(hi, lo)))
    return out
