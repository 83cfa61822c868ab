"""Mixture-of-Experts FFN of the temporal transformer, with expert parallelism.

Counterpart of ``tchvp_tpu/ops/moe.py``. ``num_experts >= 2`` widens the
transformer's dense FFN (``Linear(d, H) -> ReLU -> Linear(H, d)``) into a
pool of such FFNs behind a router:

* **Top-k routing with static capacity** (:func:`_route`): every shape is
  static; dispatch and combine are one-hot (B, S, E, C) tensors, and the
  expert FFNs are four einsums (:func:`_expert_ffn`). A token past its
  expert's capacity is dropped: its FFN output is zero and the caller's
  residual carries it. Capacity groups are per batch row.
* **fp32 routing**: logits, softmax and the slot cumsum run in fp32 with
  autocast off, whatever the compute dtype (float64 tokens, which only the
  float64 checks make, route in float64, so that those checks hold to
  float64's precision); the expert products run in the module's compute
  dtype (autocast's, else the input's).
* **Expert parallelism** (:func:`_moe_ep`): under an ambient mesh whose
  ``ep_axis`` has size n > 1, each rank runs E/n experts. It routes every
  token with the full router, keeps its experts' dispatch and combine
  columns, runs their FFNs, and one all-reduce sums the disjoint parts.
  :func:`shard_experts` makes each rank hold only its experts' parameters
  (and so their optimizer state).
* **Data parallelism** (``data_axis``, JAX's ``ops/moe.py:206-250``): under
  a mesh carrying ``data`` (not the expert axis) each rank holds its block
  of the batch, dense or expert-parallel; routing and capacity are per
  batch row, so they are exact on the block, and the aux loss's per-expert
  fractions and router probabilities and the dropped fraction are averaged
  over the data group before the product (JAX's ``aux_mean_axis``), so
  they are the global batch's on every rank. JAX also ignores a data axis
  that does not divide the batch; here the batch is already cut, so the
  axis always holds.

Gradients under each mesh axis (the step's rule: ``train/steps.py::
_reduce_grads``):

* ``seq``: the layer gathers the sequence, so every seq rank routes and
  runs every token, and a rank's cotangent enters its own rows of the
  output only: the router's and the experts' gradients are the rank's
  rows' parts, which the step's mean over the axis sums once (each rank's
  loss is its frames' mean). The aux loss and the dropped fraction come
  from the gathered routing, the same on every seq rank: each rank's loss
  carries the aux loss, and the mean counts it once.
* ``expert``: a rank's experts' gradients are its own, never combined over
  the axis; the router's, computed alike on every expert rank, are
  averaged over it (they are equal).
* ``model``: the tokens reach the layer whole on every model rank and no
  parameter here is sliced (none carries ``tp_group``), so every model
  rank already holds the whole gradient: none is summed over the axis.
* ``spatial``: the tokens come from the conv stacks' gathered rows, whole
  on every spatial rank: none is summed over the axis.
* ``data``: each rank's block of the batch; the gradients' mean over the
  axis, and the aux loss's per-expert means over it (above).

JAX sows the load-balance loss and the dropped fraction; the port has no
``sow``. :meth:`MoEFFN.forward` takes a ``sink`` list and appends one
:class:`MoEStats` per call. The sink belongs to one forward pass: a caller
that checkpoints a region makes a fresh sink inside it and returns the
totals (:func:`total_load_balance_loss`, :func:`mean_dropped_fraction`)
as outputs of the region, so the aux loss's gradient reaches the router
and a recompute never appends to the sink the loss was read from.

Each call records ``moe_dense`` or ``moe_ep_shard_map``
(``ops/dispatch_trace.py``).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.parallel.collectives import all_reduce_sum, all_reduce_sum_replicated, replicated_to_varying
from tchvp_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_shards, axis_size, mesh_with_axis

# Flax's truncated-normal correction: the std of a unit normal cut at 2 sigma.
_TRUNC_STD = 0.87962566103423978
EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


class MoEStats(NamedTuple):
    """One MoE layer's telemetry of one forward: the Switch load-balance
    loss (fp32 scalar, differentiable through the router) and the fraction
    of (token, choice) assignments the capacity dropped."""

    aux: torch.Tensor
    dropped: torch.Tensor


def expert_capacity(tokens_per_group: int, num_experts: int, capacity_factor: float,
                    top_k: int = 1) -> int:
    """Static per-expert slot count, rounded up to a multiple of 8; ``top_k``
    scales the assignment count (each token claims k slots)."""
    c = math.ceil(tokens_per_group * top_k * capacity_factor / num_experts)
    return max(8, -(-c // 8) * 8)


def _route(tokens: torch.Tensor, router: torch.Tensor, capacity: int, top_k: int = 1,
           mean_group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k ``(dispatch, combine, aux, dropped)``, all fp32 (float64 for
    float64 tokens).

    tokens (B, S, d), router (d, E). dispatch (B, S, E, C) in {0, 1};
    combine = dispatch * gate; aux = E * sum_e(frac_e * prob_e) over first
    choices; dropped = the fraction of (token, choice) assignments past the
    capacity. With k > 1 the gates renormalise over the chosen k, and
    choice j queues behind every assignment of choices < j to the same
    expert in the same batch row. ``mean_group``: the data group whose mean
    the per-expert means and the dropped fraction take before the product
    (JAX's ``aux_mean_axis``)."""
    rdt = torch.promote_types(tokens.dtype, torch.float32)
    with torch.autocast(tokens.device.type, enabled=False):
        logits = torch.einsum("bsd,de->bse", tokens.to(rdt), router.to(rdt))
        e = logits.shape[-1]
        k = min(top_k, e)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = torch.topk(probs, k, dim=-1)  # (B, S, k)
        gates = top_p / top_p.sum(dim=-1, keepdim=True) if k > 1 else top_p
        b, s = tokens.shape[:2]
        dispatch = tokens.new_zeros((b, s, e, capacity), dtype=rdt)
        combine = torch.zeros_like(dispatch)
        kept_total = tokens.new_zeros((), dtype=rdt)
        prior = tokens.new_zeros((b, e), dtype=rdt)
        slots = torch.arange(capacity, device=tokens.device)
        onehot_first = None
        for j in range(k):
            oh = F.one_hot(top_i[..., j], e).to(rdt)  # (B, S, E)
            if j == 0:
                onehot_first = oh
            # 0-based slot in the expert's queue of this batch row, behind
            # the assignments of the earlier choices.
            pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1.0 + torch.einsum("bse,be->bs", oh, prior)
            keep = (pos < capacity).to(rdt)
            # A slot past the capacity one-hots to all zeros.
            slot = (pos.long()[..., None] == slots).to(rdt)
            dj = oh[..., :, None] * slot[..., None, :] * keep[..., None, None]
            dispatch = dispatch + dj
            combine = combine + dj * gates[..., j][..., None, None]
            kept_total = kept_total + keep.sum()
            prior = prior + oh.sum(dim=1)
        frac = onehot_first.mean(dim=(0, 1))
        prob = probs.mean(dim=(0, 1))
        dropped = 1.0 - kept_total / (b * s * k)
        if mean_group is not None:
            n = dist.get_world_size(mean_group)
            frac, prob = all_reduce_sum(frac, mean_group) / n, all_reduce_sum(prob, mean_group) / n
            dropped = all_reduce_sum(dropped.detach(), mean_group) / n
        aux = e * (frac * prob).sum()
    return dispatch, combine, aux, dropped


def _expert_ffn(dispatch: torch.Tensor, combine: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dispatch -> per-expert Linear/ReLU/Linear -> weighted combine, each
    einsum in ``dtype``. dispatch/combine (B, S, E, C), x (B, S, d), w1
    (E, d, H), w2 (E, H, d). Empty slots compute relu(b1) @ w2 + b2 under a
    zero combine weight."""
    dt = dtype
    with torch.autocast(x.device.type, enabled=False):
        xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x.to(dt))
        h = torch.relu(torch.einsum("ebcd,edh->ebch", xe, w1.to(dt)) + b1.to(dt)[:, None, None, :])
        ye = torch.einsum("ebch,ehd->ebcd", h, w2.to(dt)) + b2.to(dt)[:, None, None, :]
        return torch.einsum("ebcd,bsec->bsd", ye, combine.to(dt))


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype flax's ``MoEFFN(dtype)`` computes in: autocast's when it is
    on (the port's compute_dtype), else the input's."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


class MoEFFN(nn.Module):
    """Routed drop-in for the temporal transformer's dense FFN: ``num_experts``
    FFNs of the dense FFN's shape behind a (d, E) router.

    Parameters in JAX's layout: ``router (d, E)``, ``w1 (E, d, H)``, ``b1
    (E, H)``, ``w2 (E, H, d)``, ``b2 (E, d)``. :meth:`init_flax` draws them
    as flax does: the router lecun-normal on (d, E), the expert kernels
    ``variance_scaling(1.0, "fan_in", "truncated_normal")``, whose fan-in
    on (E, d, H) counts E as receptive field: E·d (and E·H for w2).

    ``ep_axis``: expert parallelism under a mesh carrying it (module
    docstring); the expert parameters may be the full E (each rank slices
    its E/n) or this rank's E/n (:func:`shard_experts`). ``seq_axis``: under
    a mesh carrying it the tokens are this rank's block of the sequence;
    routing and capacity are per batch row over the whole sequence, as
    JAX's global arrays have it, so the layer gathers the block's sequence,
    routes it, and keeps this rank's rows. ``data_axis`` (module
    docstring): ignored when it is ``ep_axis`` or absent from the mesh."""

    def __init__(self, dim: int, num_experts: int, hidden_dim: int, capacity_factor: float = 1.25,
                 top_k: int = 1, ep_axis: Optional[str] = None, seq_axis: Optional[str] = None,
                 data_axis: Optional[str] = DATA_AXIS):
        super().__init__()
        if num_experts < 2:
            raise ValueError(f"MoEFFN needs >= 2 experts, got {num_experts}")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, num_experts], got {top_k}")
        self.num_experts = num_experts
        self.hidden_dim = hidden_dim
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.ep_axis = ep_axis
        self.seq_axis = seq_axis
        self.data_axis = data_axis
        e, h = num_experts, hidden_dim
        self.router = nn.Parameter(torch.empty(dim, e))
        self.w1 = nn.Parameter(torch.empty(e, dim, h))
        self.b1 = nn.Parameter(torch.zeros(e, h))
        self.w2 = nn.Parameter(torch.empty(e, h, dim))
        self.b2 = nn.Parameter(torch.zeros(e, dim))

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """Flax's initialisers, in flax's order (router, w1, b1, w2, b2)."""
        for w in (self.router, self.w1, self.w2):
            std = math.sqrt(1.0 / w[..., 0].numel()) / _TRUNC_STD  # fan-in: every dim but the last
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def _ep(self) -> Optional[Tuple[int, int]]:
        """(n, index) along ``ep_axis`` when a mesh carries it, else None;
        raises JAX's error when the experts do not divide over it."""
        mesh = mesh_with_axis(self.ep_axis)
        if mesh is None:
            return None
        n = axis_size(mesh, self.ep_axis)
        if self.num_experts % n:
            raise ValueError(f"{self.num_experts} experts not divisible by ep axis "
                             f"'{self.ep_axis}' of size {n}")
        return axis_shards(self.ep_axis)

    def forward(self, x: torch.Tensor, sink: Optional[List[MoEStats]] = None) -> torch.Tensor:
        """(B, S, d) -> (B, S, d) in the compute dtype; appends this call's
        :class:`MoEStats` to ``sink`` when one is given."""
        seq_mesh = mesh_with_axis(self.seq_axis)
        if seq_mesh is not None:
            from tchvp_tpu_torch.ops.attention import _gather_seq

            n, i = axis_shards(self.seq_axis)
            s_local = x.shape[1]
            x = _gather_seq(x.unsqueeze(1), seq_mesh, self.seq_axis).squeeze(1)
        dt = _compute_dtype(x)
        cap = expert_capacity(x.shape[1], self.num_experts, self.capacity_factor, self.top_k)
        ep = self._ep()
        data = mesh_with_axis(self.data_axis) if self.data_axis != self.ep_axis else None
        mean_group = axis_group(data, self.data_axis) if data is not None else None
        if ep is None:
            dispatch_trace.record("moe_dense")
            dispatch, combine, aux, dropped = _route(x, self.router, cap, self.top_k, mean_group)
            out = _expert_ffn(dispatch, combine, x, self.w1, self.b1, self.w2, self.b2, dt)
        else:
            out, aux, dropped = _moe_ep(self, x, cap, dt, *ep, mean_group)
        if sink is not None:
            sink.append(MoEStats(aux, dropped))
        if seq_mesh is not None:
            out = out.narrow(1, i * s_local, s_local)
        return out.to(dt)


def _moe_ep(layer: MoEFFN, x: torch.Tensor, capacity: int, dtype: torch.dtype, n: int, idx: int,
            mean_group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank (JAX's ``_moe_ep_shard_map``): full
    routing, this rank's E/n experts, one all-reduce of the disjoint parts.

    Every rank holds the same x and router and computes the same routing,
    so what enters the local experts is replicated, and what leaves the
    all-reduce is replicated again. The adjoints follow JAX's varying-axis
    typing: :func:`replicated_to_varying` (identity forward) sums the
    ranks' cotangents in the backward where a replicated value enters the
    rank's own experts, and the output's all-reduce passes its (replicated)
    cotangent through unchanged. So x and the router get their gradient
    once, and the aux loss, computed from the replicated routing, adds its
    own once. Under a data x expert mesh x is this rank's data block, the
    same on the ranks of its expert group, and the aux loss's means take
    ``mean_group``'s, the data axis's."""
    dispatch_trace.record("moe_ep_shard_map")
    group = axis_group(mesh_with_axis(layer.ep_axis), layer.ep_axis)
    e_local = layer.num_experts // n
    lo = idx * e_local
    dispatch, combine, aux, dropped = _route(x, layer.router, capacity, layer.top_k, mean_group)
    xl = replicated_to_varying(x, group)
    combine = replicated_to_varying(combine, group)
    params = [getattr(layer, name) for name in EXPERT_PARAMS]
    if params[0].shape[0] == layer.num_experts:  # full weights: this rank's slice
        params = [p.narrow(0, lo, e_local) for p in params]
    part = _expert_ffn(dispatch.narrow(2, lo, e_local), combine.narrow(2, lo, e_local), xl, *params, dtype)
    return all_reduce_sum_replicated(part, group), aux, dropped


def total_load_balance_loss(sink: Sequence[MoEStats]) -> torch.Tensor:
    """The sum of every layer's load-balance loss in ``sink``; fp32 0.0 when
    no MoE layer ran (JAX's sum over the sown values)."""
    if not sink:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([s.aux.float() for s in sink]).sum()


def mean_dropped_fraction(sink: Sequence[MoEStats]) -> torch.Tensor:
    """The mean of every layer's dropped fraction in ``sink``; fp32 0.0 when
    no MoE layer ran."""
    if not sink:
        return torch.zeros((), dtype=torch.float32)
    return sum(s.dropped.float() for s in sink) / len(sink)


def moe_layers(model: nn.Module) -> List[MoEFFN]:
    return [m for m in model.modules() if isinstance(m, MoEFFN)]


def expert_param_names(model: nn.Module) -> List[str]:
    """The names (``model.named_parameters()``) of every MoE layer's expert
    parameters: what expert parallelism shards."""
    layers = {id(m) for m in moe_layers(model)}
    names = []
    for mod_name, mod in model.named_modules():
        if id(mod) in layers:
            names += [f"{mod_name}.{p}" if mod_name else p for p in EXPERT_PARAMS]
    return names


@torch.no_grad()
def shard_experts(model: nn.Module, ep_axis: str) -> List[str]:
    """Under the ambient mesh carrying ``ep_axis`` (size n), replace every
    MoE layer's expert parameters of ``model`` by this rank's E/n slice
    (before an optimizer is bound to them), so the rank holds only its
    experts and their optimizer state. Each new parameter carries the
    axis's process group as ``ep_group`` (which the optimizer's global-norm
    clip reads), the axis as ``ep_axis`` and the mesh as ``ep_mesh`` (which
    a shard-wise checkpoint reads). Returns the names of the sharded parameters; a no-op
    without such a mesh."""
    mesh = mesh_with_axis(ep_axis)
    if mesh is None:
        return []
    group = axis_group(mesh, ep_axis)
    for layer in moe_layers(model):
        n, idx = layer._ep()
        e_local = layer.num_experts // n
        for name in EXPERT_PARAMS:
            p = getattr(layer, name)
            if p.shape[0] == layer.num_experts:
                p = nn.Parameter(p.narrow(0, idx * e_local, e_local).clone())
                setattr(layer, name, p)
            p.ep_group, p.ep_axis, p.ep_mesh = group, ep_axis, mesh
    return expert_param_names(model)
