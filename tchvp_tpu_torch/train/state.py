"""Train state: the model, its optimizer, the step count and the generators.

Counterpart of ``tchvp_tpu/train/state.py``. In JAX the state carries
params, batch stats, the optax state and a PRNG key; here the model holds
its parameters and BatchNorm running stats, :class:`Optimizer` holds the
optimizer state, and two ``torch.Generator``s on the model's device take
the key's place (one for input noise, one for dropout).

:func:`make_optimizer` mirrors the optax chain of the JAX package, with
its semantics kept where torch's defaults differ:

* ``clip_by_global_norm``: g * max_norm / ||g|| when ||g|| >= max_norm, the
  norm over every trainable gradient with nothing added to it
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
* AdamW decays every parameter, BatchNorm and biases included (one group);
* SGD is momentum 0.9 with Nesterov; Lion has no torch optimizer and is
  written out in :class:`Lion`;
* ``frozen_prefixes`` leaves the named top-level modules out of the
  optimizer (optax's ``set_to_zero``), and out of the clipping norm;
* ``skip_nonfinite_updates`` > 0 skips an update whose gradients are not
  all finite, up to that many in a row (``optax.apply_if_finite``); the
  learning-rate schedule and the EMA advance only on applied updates;
* ``ema_decay`` > 0 keeps an EMA of the parameters after each update.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

Schedule = Union[float, Callable[[int], float]]


def make_lr_schedule(
    lr: float,
    schedule: Optional[str] = None,
    warmup_steps: int = 0,
    total_steps: int = 0,
    min_lr_ratio: float = 0.0,
) -> Schedule:
    """A constant ``lr`` or a function of the update count, as optax's:

    * ``None``/``"constant"``: ``lr``, after a linear warmup from 0 over
      ``warmup_steps`` when that is > 0;
    * ``"cosine"``: linear warmup over ``warmup_steps``, then cosine decay
      to ``lr * min_lr_ratio`` at ``total_steps`` (required > 0).
    """
    if schedule in (None, "constant"):
        if warmup_steps > 0:
            return lambda count: lr * min(count, warmup_steps) / warmup_steps
        return lr
    if schedule == "cosine":
        if total_steps <= 0:
            raise ValueError("cosine schedule needs total_steps > 0")
        decay_steps = total_steps - warmup_steps
        if decay_steps <= 0:
            raise ValueError("cosine schedule needs total_steps > warmup_steps")
        alpha = 0.0 if lr == 0.0 else min_lr_ratio

        def cosine(count: int) -> float:
            if count < warmup_steps:
                return lr * count / warmup_steps
            t = min(count - warmup_steps, decay_steps)
            return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps)) + alpha)

        return cosine
    raise ValueError(f"unknown schedule {schedule!r}")


def lr_at(schedule: Schedule, step: int) -> float:
    """The learning rate of update number ``step`` (from 0)."""
    if callable(schedule):
        return float(schedule(step))
    return float(schedule)


class Lion(torch.optim.Optimizer):
    """Lion (Chen et al. 2023) as optax.lion computes it: u = -lr * (sign(
    (1 - b1) g + b1 m) + wd p), then m = b2 m + (1 - b2) g."""

    def __init__(self, params, lr: float, betas=(0.9, 0.99), weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, betas=betas, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            mus = []
            for p in params:
                if "mu" not in self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                mus.append(self.state[p]["mu"])
            directions = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(directions, torch._foreach_mul(mus, b1))
            directions = torch._foreach_sign(directions)
            torch._foreach_add_(directions, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_add_(params, directions, alpha=-group["lr"])
            torch._foreach_mul_(mus, b2)
            torch._foreach_add_(mus, grads, alpha=1.0 - b2)
        return None


def _core(name: str, params: List[torch.nn.Parameter], lr: float,
          weight_decay: float) -> torch.optim.Optimizer:
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True)
    if name == "lion":
        return Lion(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r} (adamw, adam, sgd, lion)")


def _shard_group(p: torch.Tensor):
    """The process group over which ``p`` is this rank's slice of a sharded
    tensor (FSDP's ``fsdp_group``, the experts' ``ep_group`` or a pipeline
    stage's ``pipe_group``), or None."""
    return getattr(p, "fsdp_group", None) or getattr(p, "ep_group", None) or getattr(p, "pipe_group", None)


def _by_shard_group(params) -> List[tuple]:
    """``[(group or None, [gradients])]`` of ``params`` by shard group, in
    order of first appearance."""
    out: Dict[int, tuple] = {}
    for p in params:
        group = _shard_group(p)
        out.setdefault(id(group), (group, []))[1].append(p.grad)
    return list(out.values())


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    from tchvp_tpu_torch.parallel.collectives import all_reduce_sum

    return all_reduce_sum(x, group)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` returns: the recipe, bound to a model's
    parameters by :meth:`init`, as an optax transformation is by ``init``."""

    lr: float
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = None
    frozen_prefixes: Sequence[str] = ()
    skip_nonfinite_updates: int = 0
    schedule: Optional[str] = None
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_ratio: float = 0.0
    ema_decay: float = 0.0
    optimizer: str = "adamw"

    def init(self, model: nn.Module) -> "Optimizer":
        return Optimizer(self, model)


class Optimizer:
    """An :class:`OptimizerSpec` bound to a model. :meth:`step` applies one
    update from the gradients in ``p.grad``; it syncs with the host only
    when ``skip_nonfinite_updates`` is set, to decide whether to skip."""

    def __init__(self, spec: OptimizerSpec, model: nn.Module):
        self.spec = spec
        self.named = dict(model.named_parameters())
        self.trainable = [p for n, p in self.named.items()
                          if n.split(".")[0] not in spec.frozen_prefixes]
        self.schedule = make_lr_schedule(spec.lr, spec.schedule, spec.warmup_steps,
                                         spec.total_steps, spec.min_lr_ratio)
        self.core = _core(spec.optimizer, self.trainable, lr_at(self.schedule, 0),
                          spec.weight_decay)
        self.count = 0  # applied updates: the schedule's step
        self.notfinite_count = 0
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if spec.ema_decay > 0.0:
            self.ema = {n: p.detach().clone() for n, p in self.named.items()}

    def _all_finite(self) -> bool:
        """Whether every gradient is finite. A rank holds only its slices of
        the sharded parameters' gradients (the experts, ``ops/moe.py``, and
        FSDP's, ``parallel/fsdp.py``), so the ranks decide together: the
        count of non-finite ones is summed over each shard group, and every
        rank skips or none does."""
        bad = torch.zeros((), device=next(iter(self.named.values())).device)
        for group, grads in _by_shard_group([p for p in self.named.values() if p.grad is not None]):
            count = (~torch.stack([torch.isfinite(g).all() for g in grads])).sum().float()
            bad = bad + (count if group is None else _group_sum(count, group))
        return not bool(bad)

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients ``grads`` (those of the trainable
        parameters). The squares of a shard group's slices are summed over
        the group; the replicated rest, the same on every rank, counts
        once."""
        ids = {id(g) for g in grads}
        params = [p for p in self.trainable if p.grad is not None and id(p.grad) in ids]
        groups = _by_shard_group(params)
        if len(groups) == 1 and groups[0][0] is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        sq = None
        for group, gs in groups:
            part = torch.stack(torch._foreach_norm(gs)).pow(2).sum()
            if group is not None:
                part = _group_sum(part.detach(), group)
            sq = part if sq is None else sq + part
        return sq.sqrt()

    @torch.no_grad()
    def step(self) -> bool:
        """Apply one update; returns False when it was skipped."""
        spec = self.spec
        if spec.skip_nonfinite_updates > 0:
            if self._all_finite():
                self.notfinite_count = 0
            else:
                self.notfinite_count += 1
                if self.notfinite_count <= spec.skip_nonfinite_updates:
                    return False
        grads = [p.grad for p in self.trainable if p.grad is not None]
        if spec.grad_clip_norm is not None and grads:
            norm = self._global_norm(grads)
            factor = torch.where(norm < spec.grad_clip_norm, 1.0, spec.grad_clip_norm / norm)
            torch._foreach_mul_(grads, factor)
        lr = lr_at(self.schedule, self.count)
        for group in self.core.param_groups:
            group["lr"] = lr
        self.core.step()
        self.count += 1
        if self.ema is not None:
            d = spec.ema_decay
            names = list(self.ema)
            emas = [self.ema[n] for n in names]
            torch._foreach_mul_(emas, d)
            torch._foreach_add_(emas, [self.named[n].detach() for n in names], alpha=1.0 - d)
        return True


def make_optimizer(
    lr: float,
    weight_decay: float = 0.01,
    grad_clip_norm: Optional[float] = None,
    frozen_prefixes: Sequence[str] = (),
    skip_nonfinite_updates: int = 0,
    schedule: Optional[str] = None,
    warmup_steps: int = 0,
    total_steps: int = 0,
    min_lr_ratio: float = 0.0,
    ema_decay: float = 0.0,
    optimizer: str = "adamw",
) -> OptimizerSpec:
    """AdamW by default, with optional global-norm clipping, frozen
    subtrees, non-finite skipping, a schedule and a parameter EMA; the
    arguments are those of the JAX package's ``make_optimizer``."""
    if optimizer not in ("adamw", "adam", "sgd", "lion"):
        raise ValueError(f"unknown optimizer {optimizer!r} (adamw, adam, sgd, lion)")
    if ema_decay > 0.0 and not ema_decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {ema_decay}")
    make_lr_schedule(lr, schedule, warmup_steps, total_steps, min_lr_ratio)  # validates
    return OptimizerSpec(lr, weight_decay, grad_clip_norm, tuple(frozen_prefixes),
                         skip_nonfinite_updates, schedule, warmup_steps, total_steps,
                         min_lr_ratio, ema_decay, optimizer)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm stats), its bound optimizer, the
    count of steps taken, and the generators of input noise and dropout."""

    model: nn.Module
    tx: Optimizer
    step: int
    noise_generator: torch.Generator
    dropout_generator: torch.Generator


def create_train_state(model: nn.Module, tx: OptimizerSpec, rng: int = 0) -> TrainState:
    """A state at step 0 for ``model`` (already initialised, on its
    device), with two generators on that device seeded from ``rng``."""
    device = next(model.parameters()).device
    noise_seed, dropout_seed = np.random.SeedSequence(rng).generate_state(2)
    return TrainState(
        model=model,
        tx=tx.init(model),
        step=0,
        noise_generator=torch.Generator(device).manual_seed(int(noise_seed)),
        dropout_generator=torch.Generator(device).manual_seed(int(dropout_seed)),
    )


def ema_params(state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA of the parameters by name, or None without ``ema_decay``."""
    return state.tx.ema


def ema_state_dict(state_dict: Dict[str, torch.Tensor],
                   ema: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state_dict`` with its parameters swapped for their EMA, its
    BatchNorm stats kept: what eval and serving load for ``--ema``, from a
    live state (:func:`with_ema_params`) or from a checkpoint."""
    return {**state_dict, **ema}


def with_ema_params(state: TrainState) -> TrainState:
    """A state whose model holds the parameter EMA (for eval and serving),
    or ``state`` itself when the optimizer keeps no EMA. The live model is
    left alone: the returned state holds a copy of it, with the BatchNorm
    stats of the live one, sharing the optimizer and the generators."""
    if state.tx.ema is None:
        return state
    model = copy.deepcopy(state.model)
    model.load_state_dict(ema_state_dict(state.model.state_dict(), state.tx.ema))
    return dataclasses.replace(state, model=model)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def human_param_count(n: int) -> str:
    """1234567 -> '1.23M'."""
    units = ["", "K", "M", "B", "T"]
    i = 0
    f = float(n)
    while f >= 1000 and i < len(units) - 1:
        f /= 1000.0
        i += 1
    return f"{f:.2f}{units[i]}"
