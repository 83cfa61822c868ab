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
* :func:`shift` — rank i's tensor to rank i + step, zeros where no rank
  sends (``ppermute`` is step 1); its backward is the shift by -step. The
  stage hops of the pipeline.
* :func:`halo_exchange` — the boundary rows of spatial partitioning: each
  rank's row block along a dim gains ``top`` rows of the ranks before it
  and ``bottom`` of the ranks after it, zeros past the global edges (the
  conv's own padding there). Its backward returns each halo's cotangent to
  its owner, added onto the owner's boundary rows.
* :func:`all_reduce_sum` — the sum over the group, whose backward is the
  sum of the cotangents over the group (the statistics of train-mode
  BatchNorm, the gathered keys of full attention).
* :func:`all_reduce_sum_replicated` and :func:`replicated_to_varying` —
  the pair of expert parallelism, where every rank computes the same thing
  outside its experts: the sum over the group whose backward passes the
  (replicated) cotangent through, and the identity whose backward sums the
  ranks' cotangents.
* :func:`all_gather_cat` — the ranks' tensors concatenated along a dim, not
  differentiable (the BatchNorm statistics of channel-sharded layers).
* :func:`all_gather_along` and :func:`reduce_scatter_mean` — not
  differentiable, one flat buffer per dtype: FSDP's gather of the
  parameters' slices before a step, and the gradients' mean over the group,
  each rank keeping its slice, after it.
* :func:`all_gather_dim` and :func:`all_gather_dim_replicated` — the ranks'
  blocks of a channel dim gathered, differentiable: the backward of the
  first is a reduce-scatter of the sum (the full tensor feeds a computation
  that differs by rank, each rank's cotangent a part), of the second this
  rank's block of the cotangent (it feeds one that every rank computes
  alike). Tensor parallelism's convs.
* :func:`all_reduce_mean_` and :func:`all_reduce_sum_` — in place, not
  differentiable: the gradients' mean (or sum) before the optimizer, in one
  flat buffer. :func:`all_reduce_max` — the elementwise max over a group,
  not differentiable (a fake-quant scale of a tensor held in blocks).
* :func:`broadcast_` — in place, one rank's tensors on every rank (the
  replicated start of data parallelism).
* :func:`equal_across` — whether tensors hold the same bits on every rank.
* :func:`barrier` — every rank of a group (or none, without one) waits for
  the others (a shard-wise checkpoint's directory made and renamed).

A ``gloo`` group carries CPU tensors only, so a CUDA tensor crosses through
host memory there: that is the transport of two ranks sharing one GPU (NCCL
refuses two ranks on one device), and the CPU tests'. An ``nccl`` group
carries tensors on this rank's card only, so a host tensor (a checkpoint's
copy) crosses through the card there. Every collective here hands the
backend :func:`_wire`'s copy and gives its result back on the caller's
device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.step), None, None


def shift(x: torch.Tensor, group: dist.ProcessGroup, step: int) -> torch.Tensor:
    """Rank i's ``x`` (the same shape on every rank) to rank i + ``step`` of
    ``group``; a rank no rank sends to receives zeros. Differentiable: the
    cotangent goes back by -``step``."""
    return _Shift.apply(x, group, step)


def ppermute(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """JAX's ``ppermute`` with the pairs ``[(i, i + 1)]`` over ``group``:
    rank i + 1 receives rank i's ``x``, rank 0 zeros; differentiable."""
    return _Shift.apply(x, group, 1)


def halo_exchange(x: torch.Tensor, top: int, bottom: int, group: dist.ProcessGroup,
                  dim: int = 2) -> torch.Tensor:
    """``x``, this rank's block of r rows along ``dim`` (the same r on every
    rank of ``group``), with the ``top`` rows before it and the ``bottom``
    rows after it in the global order: ``top + r + bottom`` rows. Rows past
    the first or the last rank are zeros. A halo wider than a block comes
    from as many neighbours as it spans, one shift a neighbour.
    Differentiable (the shifts' adjoints)."""
    r = x.shape[dim]
    parts = []
    for j in range(-(-top // r), 0, -1):  # the farthest neighbour above first
        rows = min(r, top - (j - 1) * r)
        parts.append(shift(x.narrow(dim, r - rows, rows), group, j))
    parts.append(x)
    for j in range(1, -(-bottom // r) + 1):
        parts.append(shift(x.narrow(dim, 0, min(r, bottom - (j - 1) * r)), group, -j))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


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


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """The indices of ``tensors``, grouped by dtype in order of appearance."""
    groups: dict = {}
    for j, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(j)
    return list(groups.values())


def _all_reduce_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup, divisor: int) -> None:
    for idx in _by_dtype(tensors):
        flat = torch.cat([tensors[j].reshape(-1) for j in idx])
        flat = _all_reduce(flat, group)
        if divisor != 1:
            flat = flat / divisor
        for j, part in zip(idx, flat.split([tensors[j].numel() for j in idx])):
            tensors[j].copy_(part.view_as(tensors[j]))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Replace each tensor by its mean over ``group``, in place: one
    all-reduce of one flat buffer per dtype. Every rank ends with the same
    bits."""
    _all_reduce_(tensors, group, dist.get_world_size(group))


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Replace each tensor by its sum over ``group``, in place, as
    :func:`all_reduce_mean_` does."""
    _all_reduce_(tensors, group, 1)


def all_reduce_max(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, the same on every rank;
    not differentiable."""
    buf = _wire(x, group)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(x.device)


# torch 2.13 renamed the flat collectives; the card's torch has the old names.
FLAT_ALL_GATHER = "all_gather_single" if hasattr(dist, "all_gather_single") else "all_gather_into_tensor"
FLAT_REDUCE_SCATTER = ("reduce_scatter_single" if hasattr(dist, "reduce_scatter_single")
                       else "reduce_scatter_tensor")


def _all_gather_flat(out: torch.Tensor, x: torch.Tensor, group: dist.ProcessGroup) -> None:
    getattr(dist, FLAT_ALL_GATHER)(out, x, group=group)


def _reduce_scatter_flat(out: torch.Tensor, x: torch.Tensor, group: dist.ProcessGroup) -> None:
    getattr(dist, FLAT_REDUCE_SCATTER)(out, x, group=group)


def all_gather_along(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                     group: dist.ProcessGroup) -> List[torch.Tensor]:
    """Each tensor's blocks on the ranks of ``group`` (equal shapes on every
    rank) concatenated along its dim in ``dims``, in rank order, on every
    rank, on the tensor's device: one all-gather of one flat buffer per
    dtype. Not differentiable."""
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore[list-item]
    for idx in _by_dtype(tensors):
        buf = _wire(torch.cat([tensors[j].reshape(-1) for j in idx]), group)
        gathered = buf.new_empty(n * buf.numel())
        _all_gather_flat(gathered, buf, group=group)
        parts = gathered.view(n, -1).to(tensors[idx[0]].device)
        off = 0
        for j in idx:
            t = tensors[j]
            blocks = [parts[r, off:off + t.numel()].view(t.shape) for r in range(n)]
            out[j] = torch.cat(blocks, dim=dims[j])
            off += t.numel()
    return out


def reduce_scatter_mean(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                        group: dist.ProcessGroup) -> List[torch.Tensor]:
    """This rank's block, along each tensor's dim in ``dims``, of the
    tensor's mean over ``group``, on the tensor's device: one reduce-scatter
    of one flat buffer per dtype, laid out rank by rank. The dims must divide
    by the group's size. Not differentiable."""
    return _reduce_scatter(tensors, dims, group, dist.get_world_size(group))


def _reduce_scatter(tensors: Sequence[torch.Tensor], dims: Sequence[int], group: dist.ProcessGroup,
                    divisor: int) -> List[torch.Tensor]:
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore[list-item]
    for idx in _by_dtype(tensors):
        blocks = [tensors[j].chunk(n, dims[j]) for j in idx]
        flat = _wire(torch.cat([b[r].reshape(-1) for r in range(n) for b in blocks]), group)
        mine = flat.new_empty(flat.numel() // n)
        _reduce_scatter_flat(mine, flat, group=group)
        if divisor != 1:
            mine = mine / divisor
        mine = mine.to(tensors[idx[0]].device)
        off = 0
        for j, b in zip(idx, blocks):
            out[j] = mine[off:off + b[0].numel()].view(b[0].shape)
            off += b[0].numel()
    return out


def _block_of(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


def _reduce_scatter_sum(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    return _reduce_scatter([x], [dim], group, 1)[0]


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return all_gather_along([x], [dim], group)[0]

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            return _reduce_scatter_sum(grad.contiguous(), ctx.group, ctx.dim), None, None, None
        return _block_of(grad, ctx.group, ctx.dim).contiguous(), None, None, None


def all_gather_dim(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    """The ranks' blocks ``x`` of ``dim`` gathered in rank order, where the
    whole feeds a computation that differs by rank: the backward
    reduce-scatters the sum of the ranks' cotangents (each is a part of the
    whole's gradient), each rank keeping its block."""
    return _AllGatherDim.apply(x, group, dim, True)


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_sum(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_along([grad.contiguous()], [ctx.dim], ctx.group)[0], None, None


def reduce_scatter_dim(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of the sum of the ranks' ``x`` (each a
    part of the whole); the backward all-gathers the blocks' cotangents,
    since every rank's ``x`` fed every block."""
    return _ReduceScatterDim.apply(x, group, dim)


def all_gather_dim_replicated(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    """The ranks' blocks ``x`` of ``dim`` gathered in rank order, where the
    whole feeds a computation every rank makes alike: each rank's cotangent
    is already the whole gradient, so the backward keeps this rank's block
    of it."""
    return _AllGatherDim.apply(x, group, dim, False)


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


def barrier(group: Optional[dist.ProcessGroup]) -> None:
    """Wait until every rank of ``group`` gets here; nothing for None."""
    if group is not None:
        dist.barrier(group=group)
