"""Training health monitoring + auto-recovery.

Counterpart of ``tchvp_tpu/train/health.py`` (build-new aux subsystem,
survey §5.3 — the reference's only resilience is resumable checkpoint
dicts and bare try/except around makedirs).

Two layers of protection:

* **In the optimizer**: ``make_optimizer(skip_nonfinite_updates=N)``
  skips an update whose gradients are not all finite, as
  ``optax.apply_if_finite`` does in the JAX package.
* **Host-side** (this module): :class:`HealthMonitor` watches the scalar
  loss stream for NaN/inf and spikes against an EMA; flows can consult it
  to stop early, and :func:`recover_latest` restores the last good
  step-tagged checkpoint into a train state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from tchvp_tpu_torch.train import checkpoint as ckpt


class TrainingDiverged(RuntimeError):
    """Raised by flows when the monitor reports unrecoverable divergence."""


@dataclass
class HealthMonitor:
    """Streaming loss-health check.

    ``check(loss)`` returns one of:
    * ``"ok"``    — finite and within ``spike_factor`` x EMA;
    * ``"spike"`` — finite but > ``spike_factor`` x EMA (post-warmup);
    * ``"nan"``   — non-finite.

    ``nan_tolerance`` consecutive ``"nan"`` results flip :attr:`diverged`,
    the signal for flows to stop/restore.
    """

    spike_factor: float = 10.0
    ema_decay: float = 0.9
    warmup_steps: int = 10
    nan_tolerance: int = 3

    steps: int = field(default=0, init=False)
    ema: Optional[float] = field(default=None, init=False)
    consecutive_nan: int = field(default=0, init=False)
    nan_steps: int = field(default=0, init=False)
    spike_steps: int = field(default=0, init=False)

    @property
    def diverged(self) -> bool:
        return self.consecutive_nan >= self.nan_tolerance

    def check(self, loss: float) -> str:
        self.steps += 1
        if not math.isfinite(loss):
            self.consecutive_nan += 1
            self.nan_steps += 1
            return "nan"
        self.consecutive_nan = 0
        status = "ok"
        if (
            self.ema is not None
            and self.steps > self.warmup_steps
            and loss > self.spike_factor * max(self.ema, 1e-12)
        ):
            self.spike_steps += 1
            status = "spike"
        self.ema = (
            loss
            if self.ema is None
            else self.ema_decay * self.ema + (1.0 - self.ema_decay) * loss
        )
        return status

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "nan_steps": self.nan_steps,
            "spike_steps": self.spike_steps,
            "loss_ema": self.ema,
            "diverged": self.diverged,
        }


def recover_latest(state, checkpoint_dir: str):
    """Restore the model, its BatchNorm stats and the optimizer state from
    the newest step-tagged checkpoint into ``state`` (in place); returns
    (state, restored_step) —
    (state, None) when no checkpoint exists (caller decides whether to
    abort). opt_state restore is load-bearing: after a real NaN-gradient
    divergence Adam's m/v moments are NaN, so restoring params alone would
    re-poison them on the first post-recovery update."""
    path = ckpt.latest_step_dir(checkpoint_dir)
    if path is None:
        return state, None
    state, raw = ckpt.restore_state_into(state, path)
    return state, int(raw.get("step", 0))
