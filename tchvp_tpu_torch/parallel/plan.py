"""Sharding planner: where every byte of a training config lives, before a
card is committed.

Counterpart of ``tchvp_tpu/parallel/plan.py``: given a model, an optimizer,
a mesh's axis sizes and the parallelism knobs (data, ``--fsdp``, experts,
pipeline), it reports the placement and per-device bytes of every
parameter, gradient, optimizer-state and BatchNorm leaf, and the totals
against a memory budget.

Truthfulness contract, as in JAX: the planner calls the runtime's own rules
and re-implements none of them. FSDP placement is
:func:`tchvp_tpu_torch.parallel.fsdp.fsdp_leaf_spec`; the expert rule
follows the leaves ``ops/moe.py::shard_experts`` cuts
(:data:`~tchvp_tpu_torch.ops.moe.EXPERT_PARAMS`, expert dim first); the
pipe rule places every entry under ``stages.`` as
``parallel/pipeline.py::pipeline_state_shardings`` does; BatchNorm's
buffers stay whole, as ``fsdp.state_shardings`` keeps them.
``tests/test_torch_plan.py`` and the rank tests hold the plan's specs to
the live ``state_shardings`` and ``pipeline_state_shardings`` after a step.
JAX's rules name no ``model`` or ``spatial`` axis, so neither planner
slices a leaf over them.

Everything is abstract: the model is built on the ``meta`` device
(:func:`abstract_train_state`), so a plan allocates nothing and needs no
card. Paths are the port's ``state_dict`` names; an optimizer-state path is
``<moment>.<parameter name>`` (``exp_avg.encoder.stem_conv.weight``), the
EMA's ``ema.<parameter name>``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from tchvp_tpu_torch.ops import moe
from tchvp_tpu_torch.parallel.fsdp import MIN_SHARD_ELEMS, fsdp_leaf_spec

# The memory of the card the port runs on, in GiB: an NVIDIA H100 80GB
# HBM3's ``torch.cuda.get_device_properties(0).total_memory`` (power limit
# 700 W), read by chip_smoke.py; the default budget of the table.
CARD_MEMORY_GIB = 79.18

# The moments torch.optim keeps per parameter after its first step
# (train/state.py::_core): Adam's two and its step count, SGD's Nesterov
# momentum, the port's Lion's one.
_MOMENTS = {"adamw": ("exp_avg", "exp_avg_sq"), "adam": ("exp_avg", "exp_avg_sq"),
            "sgd": ("momentum_buffer",), "lion": ("mu",)}
_STEPPED = ("adamw", "adam")


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One tensor's placement: where it lives and what it costs."""

    section: str  # params | grads | opt_state | batch_stats | batch
    path: str
    shape: Tuple[int, ...]
    dtype: str
    spec: Tuple[Optional[str], ...]  # an axis per dim, None = whole
    bytes_global: int
    bytes_device: int
    origin: str  # fsdp | ep | pipe | batch | replicated

    @property
    def spec_str(self) -> str:
        if not any(self.spec):
            return "replicated"
        return "P(" + ", ".join(str(s) for s in self.spec) + ")"


@dataclasses.dataclass
class ShardingPlan:
    axes: Dict[str, int]
    rows: List[LeafPlan]
    notes: List[str] = dataclasses.field(default_factory=list)

    def section(self, name: str) -> List[LeafPlan]:
        return [r for r in self.rows if r.section == name]

    def totals(self) -> Dict[str, Tuple[int, int]]:
        """{section: (bytes_global, bytes_device)}."""
        out: Dict[str, Tuple[int, int]] = {}
        for r in self.rows:
            g, d = out.get(r.section, (0, 0))
            out[r.section] = (g + r.bytes_global, d + r.bytes_device)
        return out

    def device_total(self) -> int:
        return sum(r.bytes_device for r in self.rows)

    def table(self, top: int = 12, hbm_gb: float = CARD_MEMORY_GIB) -> str:
        mesh = " × ".join(f"{k}={v}" for k, v in self.axes.items()) or "1 device"
        lines = [f"Sharding plan — mesh {{{mesh}}} "
                 f"({max(1, math.prod(self.axes.values()))} devices)", ""]
        totals = self.totals()
        lines.append(f"{'section':<12} {'global':>12} {'per-device':>12}")
        for sec in ("params", "grads", "opt_state", "batch_stats", "batch"):
            if sec in totals:
                g, d = totals[sec]
                lines.append(f"{sec:<12} {_human(g):>12} {_human(d):>12}")
        dev = self.device_total()
        lines.append(f"{'TOTAL':<12} {_human(sum(g for g, _ in totals.values())):>12} {_human(dev):>12}")
        lines.append(f"\nper-device state = {_human(dev)} of {hbm_gb:g} GiB HBM "
                     f"({100 * dev / (hbm_gb * (1 << 30)):.1f}%) — activations/workspace NOT "
                     f"included (bound via remat_policy / accum_steps)")
        biggest = sorted(self.rows, key=lambda r: -r.bytes_device)[:top]
        lines.append(f"\nlargest {len(biggest)} leaves by per-device bytes:")
        lines.append(f"{'per-dev':>10} {'spec':<22} {'origin':<10} path")
        for r in biggest:
            path = r.path if len(r.path) <= 64 else "…" + r.path[-63:]
            lines.append(f"{_human(r.bytes_device):>10} {r.spec_str:<22} {r.origin:<10} {r.section}:{path}")
        if self.notes:
            lines.append("\nexpected collectives / placement notes:")
            lines.extend(f"  - {n}" for n in self.notes)
        return "\n".join(lines)


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _leaf_spec(path: str, shape: Tuple[int, ...], axes: Dict[str, int], fsdp_axis: Optional[str],
               ep_axis: Optional[str], num_experts: int, min_elems: int,
               pipe_axis: Optional[str] = None) -> Tuple[Tuple[Optional[str], ...], str]:
    """(spec, origin) of one leaf: the runtime's own rules."""
    name = path.rsplit(".", 1)[-1]
    if pipe_axis and axes.get(pipe_axis, 1) > 1 and "stages" in path.split(".") and shape:
        # pipeline_state_shardings: every entry under stages. has its
        # leading (stage) dim on the pipe axis, and its moments with it.
        return (pipe_axis,) + (None,) * (len(shape) - 1), "pipe"
    if (ep_axis and axes.get(ep_axis, 1) > 1 and num_experts > 1 and shape
            and shape[0] == num_experts and name in moe.EXPERT_PARAMS):
        # shard_experts: each rank keeps its block of the expert dim.
        return (ep_axis,) + (None,) * (len(shape) - 1), "ep"
    if fsdp_axis and axes.get(fsdp_axis, 1) > 1:
        spec = fsdp_leaf_spec(shape, fsdp_axis, axes[fsdp_axis], min_elems)
        if any(spec):
            return spec, "fsdp"
    return (None,) * len(shape), "replicated"


def _shard_factor(spec, axes: Dict[str, int]) -> int:
    return math.prod(axes.get(s, 1) for s in spec if s is not None)


def _row(section: str, path: str, leaf, spec, origin: str, axes: Dict[str, int]) -> LeafPlan:
    shape = tuple(leaf.shape)
    size = math.prod(shape) * leaf.dtype.itemsize
    return LeafPlan(section=section, path=path, shape=shape, dtype=str(leaf.dtype).replace("torch.", ""),
                    spec=spec, bytes_global=size, bytes_device=size // _shard_factor(spec, axes), origin=origin)


def plan_state(state: Any, axes: Dict[str, int], *, fsdp_axis: Optional[str] = None,
               ep_axis: Optional[str] = None, num_experts: int = 0, batch_axis: Optional[str] = None,
               batch_example: Optional[Dict[str, Any]] = None, min_elems: int = MIN_SHARD_ELEMS,
               pipe_axis: Optional[str] = None) -> ShardingPlan:
    """The placement of an (abstract) train state over a mesh of ``axes``
    (axis name -> size).

    ``state``: anything with ``params``, ``opt_state`` and ``batch_stats``
    dicts of tensors by path, typically :func:`abstract_train_state`'s.
    Gradients are planned from the parameters with their specs, as
    ``fsdp.constrain_gradients`` leaves each rank its slice of a sharded
    parameter's gradient. ``batch_example``: ``{name: tensor}`` of the
    global batch, dim 0 over ``batch_axis``.

    ``pipe_axis``: the state is in the pipelined layout
    (:func:`abstract_pipelined_train_state`); its stage entries lie on the
    pipe axis and ``fsdp_axis`` composes on the rest (pp x ZeRO).
    """
    rows: List[LeafPlan] = []

    def add(section: str, tree: Optional[Dict[str, Any]], fsdp: Optional[str]) -> None:
        for path, leaf in (tree or {}).items():
            spec, origin = _leaf_spec(path, tuple(leaf.shape), axes, fsdp, ep_axis, num_experts, min_elems,
                                      pipe_axis)
            rows.append(_row(section, path, leaf, spec, origin, axes))

    add("params", state.params, fsdp_axis)
    add("grads", state.params, fsdp_axis)
    add("opt_state", state.opt_state, fsdp_axis)
    add("batch_stats", getattr(state, "batch_stats", None), None)  # buffers stay whole

    for path, leaf in (batch_example or {}).items():
        spec: Tuple[Optional[str], ...] = (None,) * leaf.dim()
        if batch_axis and axes.get(batch_axis, 1) > 1:
            spec = (batch_axis,) + (None,) * (leaf.dim() - 1)
        rows.append(_row("batch", path, leaf, spec, "batch", axes))

    notes: List[str] = []
    dp = axes.get(batch_axis, 1) if batch_axis else 1
    if fsdp_axis and axes.get(fsdp_axis, 1) > 1:
        notes.append(f"FSDP over '{fsdp_axis}'({axes[fsdp_axis]}): all-gather the sharded params once a step, "
                     "before the forward; dp grad reduction lowers to reduce-scatter; optimizer update runs "
                     "on shards")
    elif dp > 1:
        notes.append(f"data-parallel over '{batch_axis}'({dp}): one grad all-reduce per step, params replicated")
    if ep_axis and axes.get(ep_axis, 1) > 1 and num_experts > 1:
        notes.append(f"expert-parallel over '{ep_axis}'({axes[ep_axis]}): {num_experts} experts resident "
                     f"{num_experts // axes[ep_axis]}/device, one all-reduce (sum) combines MoE layer outputs")
    if pipe_axis and axes.get(pipe_axis, 1) > 1:
        notes.append(f"pipeline-parallel over '{pipe_axis}'({axes[pipe_axis]}): stage params + moments live "
                     "stage-local; activations hop one ppermute per GPipe tick; 'rest' (CNN) leaves "
                     + ("ZeRO-shard over the data axis (pp x fsdp)"
                        if fsdp_axis and axes.get(fsdp_axis, 1) > 1
                        else "replicate (pass --fsdp to ZeRO-shard them)"))
    return ShardingPlan(axes=dict(axes), rows=rows, notes=notes)


@dataclasses.dataclass
class AbstractTrainState:
    """A train state's tensors on the ``meta`` device, by path: the
    parameters, the optimizer's state after its first step and BatchNorm's
    buffers."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _opt_state(params: Dict[str, torch.Tensor], tx) -> Dict[str, torch.Tensor]:
    """What ``train/state.py::Optimizer`` of ``tx`` (an ``OptimizerSpec``)
    holds after its first step: torch.optim makes its moments lazily, so
    they are reckoned from the parameters (each trainable one's moments,
    Adam's scalar step in torch's scalar dtype), then the EMA of every
    parameter when ``ema_decay`` > 0."""
    from torch.optim.optimizer import _get_scalar_dtype

    trainable = {n: p for n, p in params.items() if n.split(".")[0] not in tx.frozen_prefixes}
    out: Dict[str, torch.Tensor] = {}
    for moment in _MOMENTS[tx.optimizer]:
        out.update({f"{moment}.{n}": _meta(p) for n, p in trainable.items()})
    if tx.optimizer in _STEPPED:
        out.update({f"step.{n}": torch.empty((), dtype=_get_scalar_dtype(), device="meta") for n in trainable})
    if tx.ema_decay > 0.0:
        out.update({f"ema.{n}": _meta(p) for n, p in params.items()})
    return out


def abstract_train_state(model: nn.Module, tx) -> AbstractTrainState:
    """The state ``train/state.py::create_train_state`` makes of ``model``
    and ``tx`` (an ``OptimizerSpec``), as it stands after one step, with
    no tensor allocated: build ``model`` on the ``meta`` device
    (``with torch.device("meta"): ...``). Its generators (a ``torch.Generator``
    has no meta form) are left out: 16 bytes each on a CUDA device."""
    names = dict(model.named_parameters())
    entries = model.state_dict()
    params = {k: v for k, v in entries.items() if k in names}
    buffers = {k: v for k, v in entries.items() if k not in names}
    return AbstractTrainState(params=params, opt_state=_opt_state(params, tx), batch_stats=buffers)


def abstract_pipelined_train_state(model: nn.Module, tx, n_stages: int) -> AbstractTrainState:
    """:func:`abstract_train_state` in the pipelined layout of ``n_stages``
    stages (``rest.*`` and ``stages.*``, the temporal layers stacked and
    grouped by ``parallel/pipeline.py::pipelined_layout``, the shapes
    ``create_pipelined_train_state`` gives the whole pipeline), so
    ``shards --mesh data=K,pipe=N`` plans a pp(-x-ZeRO) run without a card."""
    from tchvp_tpu_torch.parallel.pipeline import TEMPORAL, pipelined_layout

    num_layers = model.config.temporal.num_layers
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} temporal layers over {n_stages} stages: "
                         f"num_layers must be a multiple of the stage count")
    names = dict(model.named_parameters())
    layout = pipelined_layout(model.state_dict(), num_layers, n_stages)

    def is_param(key: str) -> bool:  # rest.<name>, or stages.<name in a layer>
        part, _, name = key.partition(".")
        return (name if part == "rest" else f"{TEMPORAL}0.{name}") in names

    params = {k: v for k, v in layout.items() if is_param(k)}
    buffers = {k: v for k, v in layout.items() if not is_param(k)}
    return AbstractTrainState(params=params, opt_state=_opt_state(params, tx), batch_stats=buffers)
