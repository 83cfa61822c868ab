"""Tracing / profiling hooks.

Counterpart of ``tchvp_tpu/utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` window over host and device
  activity, written as a Chrome/Perfetto trace into ``log_dir``;
* :class:`StepTimer`: wall-clock per-step stats with warm-up exclusion,
  reporting p50/p90 latency and steps/frames per second; ``sync`` waits
  for the card with ``torch.cuda.synchronize`` on a CUDA tensor;
* :func:`annotate`: a named ``record_function`` scope on the timeline.

All hooks cost nothing when unused; ``StepTimer`` adds one synchronize per
timed step only when :meth:`StepTimer.sync` is called.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Any, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block into ``log_dir``
    (``trace.json``, viewable in Perfetto or chrome://tracing). Wrap a
    handful of steady-state steps."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named host-side scope visible on the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step wall-clock statistics.

    Usage::

        timer = StepTimer(skip=1)            # skip the warm-up step
        for batch in data:
            with timer.step():
                state, metrics = train_step(state, batch)
                timer.sync(metrics["loss"])  # wait for the card
        print(timer.summary(items_per_step=batch_frames))
    """

    def __init__(self, skip: int = 1):
        self.skip = skip
        self._seen = 0
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.skip:
            self.times.append(dt)

    @staticmethod
    def sync(x: Any) -> None:
        """Wait for the device work behind ``x`` so the step time includes it."""
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)

    def summary(self, items_per_step: Optional[int] = None) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        p50 = ts[len(ts) // 2]
        p90 = ts[min(len(ts) - 1, int(len(ts) * 0.9))]
        out = {
            "steps": len(ts),
            "mean_s": statistics.fmean(ts),
            "p50_s": p50,
            "p90_s": p90,
            "steps_per_s": 1.0 / statistics.fmean(ts),
        }
        if items_per_step:
            out["items_per_s"] = items_per_step / statistics.fmean(ts)
        return out

    def reset(self) -> None:
        self._seen = 0
        self.times.clear()
