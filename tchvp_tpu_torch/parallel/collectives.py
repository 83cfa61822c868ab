"""Collectives of the sequence-parallel path, differentiable where the
forward needs it.

* :func:`ppermute` — the halo exchange of ``sdpa_windowed_seq_sharded``:
  rank i's tensor goes to rank i + 1 of the group; rank 0, which has no
  source, receives zeros, as JAX's ``ppermute`` gives a device no pair
  names. Its backward is the reverse exchange: the halo's gradient goes
  back to its owner, where autograd adds it to the local one.
* :func:`ring_shift` — the cyclic hop of ring attention: rank i's tensor
  goes to rank (i + 1) mod n; its backward sends the cotangent one hop
  back.
* :func:`all_reduce_sum` — the sum over the group, whose backward is the
  sum of the cotangents over the group (the statistics of train-mode
  BatchNorm, the gathered keys of full attention).
* :func:`all_reduce_sum_replicated` and :func:`replicated_to_varying` —
  the pair of expert parallelism, where every rank computes the same thing
  outside its experts: the sum over the group whose backward passes the
  (replicated) cotangent through, and the identity whose backward sums the
  ranks' cotangents.
* :func:`all_gather_cat` — the ranks' tensors concatenated along a dim, not
  differentiable (whole expert checkpoints).
* :func:`all_reduce_mean_` — in place, not differentiable: the gradients'
  mean before the optimizer, in one flat buffer.
* :func:`broadcast_` — in place, one rank's tensors on every rank (the
  replicated start of data parallelism).
* :func:`equal_across` — whether tensors hold the same bits on every rank.

A ``gloo`` group carries CPU tensors only, so a CUDA tensor crosses through
host memory there: that is the transport of two ranks sharing one GPU (NCCL
refuses two ranks on one device), and the CPU tests'. An ``nccl`` group
carries tensors on this rank's card only, so a host tensor (a checkpoint's
copy) crosses through the card there. Every collective here hands the
backend :func:`_wire`'s copy and gives its result back on the caller's
device.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _carrier(group: dist.ProcessGroup) -> torch.device:
    """The device whose tensors ``group``'s backend carries: the host for
    gloo, this rank's current card for nccl."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _wire(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """A contiguous copy of ``x`` on the device the group's backend carries."""
    return x.detach().to(_carrier(group), copy=True).contiguous()


def _shift(x: torch.Tensor, group: dist.ProcessGroup, step: int, cyclic: bool = False) -> torch.Tensor:
    """Rank i's ``x`` to rank i + step of ``group`` (mod n when ``cyclic``);
    zeros where no rank sends."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    send = _wire(x, group)
    recv = torch.zeros_like(send)
    ops = []
    dst, src = i + step, i - step
    if cyclic:
        dst, src = dst % n, src % n
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group=group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group=group))
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


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1, cyclic=True)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1, cyclic=True), None


def ring_shift(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """JAX's ``ppermute`` with the pairs ``[(i, (i + 1) % n)]`` over
    ``group``: rank (i + 1) mod n receives rank i's ``x``; differentiable."""
    return _RingShift.apply(x, group)


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


class _AllReduceSumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum_replicated(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group`` where everything downstream is the
    same on every rank: the backward passes the cotangent through (JAX's
    ``psum`` into a replicated value). Summing the ranks' equal cotangents
    there would give the inputs n times their gradient."""
    return _AllReduceSumReplicated.apply(x, group)


class _ReplicatedToVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def replicated_to_varying(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``x``, the same on every rank of ``group``, entering a computation
    that differs by rank: the identity, whose backward sums the ranks'
    cotangents (JAX's ``pvary``)."""
    return _ReplicatedToVarying.apply(x, group)


def all_gather_cat(x: torch.Tensor, group: dist.ProcessGroup, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank; on x's device."""
    buf = _wire(x, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


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


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group: dist.ProcessGroup = None) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (one broadcast per
    tensor, through the backend's device)."""
    for t in tensors:
        buf = _wire(t, group or dist.group.WORLD)
        dist.broadcast(buf, src, group=group)
        t.copy_(buf.to(t.device))


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
