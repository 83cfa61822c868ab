"""The device timer of the autotuner: the card's time per call of a function.

Counterpart of ``tchvp_tpu/utils/timing.py``'s ``timeit``, whose recipe is
one jitted loop read back once. Here the recipe is the spin-then-events one
of the repo's card scripts: the card first spins (``torch.cuda._sleep``),
the host queues every call behind the spin, and two events time the calls
back to back, so the host's time between launches is not counted. If the
host could not queue the calls within half the spin, the spin is made 4
times longer, up to 3 times; past that it raises. It times the card, never
the CPU: CPU tensors raise.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch


def _bump(t, i: int):
    """``t`` perturbed by loop index ``i``, so that no caching layer can skip
    a call: floats + i * 1e-6, integers + i % 2, bools flipped on odd i; a
    leaf that requires a gradient stays one."""
    if not isinstance(t, torch.Tensor):
        return t
    with torch.no_grad():
        if t.dtype == torch.bool:
            out = t ^ bool(i % 2)
        elif not t.is_floating_point():
            out = t + (i % 2)
        else:
            out = t + torch.tensor(i * 1e-6, dtype=t.dtype, device=t.device)
    return out.requires_grad_(t.requires_grad) if t.is_floating_point() else out


def device_ms(call: Callable[[int], object], iters: int) -> float:
    """Device ms per call of ``call(i)`` for i in 0..iters-1, queued behind a
    spin and timed between two events (module docstring)."""
    spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin_cycles = 20_000_000
    for _ in range(4):
        spin_start.record()
        t0 = time.perf_counter()
        torch.cuda._sleep(spin_cycles)
        start.record()
        for i in range(iters):
            call(i)
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin_start.elapsed_time(start)
        if issue_ms <= spin_ms / 2:
            return start.elapsed_time(end) / iters
        spin_cycles *= 4
    raise RuntimeError(f"timeit: issuing {iters} calls took {issue_ms:.3f} ms on the host, more than "
                       f"half of the card's {spin_ms:.3f} ms spin before them")


def timeit(fn: Callable, *args, iters: int = 20, perturb: Optional[int] = None) -> Tuple[float, float]:
    """(ms_per_call, first_call_seconds) of ``fn(*args)`` on the card.

    ``perturb``: how many leading args are bumped by the loop index (None:
    all); pass fewer where the rest must stay exact (calibrated scales,
    weights). The bumped copies are made before the timed calls. The first
    call (builds, allocator warm-up) is timed on the host, synchronised."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(not t.is_cuda for t in tensors):
        raise ValueError("timeit times the card: every tensor argument must be a CUDA tensor")
    n = len(args) if perturb is None else perturb
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    calls = [tuple(_bump(a, i) for a in args[:n]) + tuple(args[n:]) for i in range(iters)]
    return device_ms(lambda i: fn(*calls[i]), iters), first_s
