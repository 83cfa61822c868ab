"""The timers of the port's scripts on the card, one copy for all of them.

``chip_smoke.py``, ``attention_ab.py`` and the breakdown scripts import
them from here. ``attention_ab.py`` imports this module before it puts the
checkout under test first on the path, so that both checkouts of an A/B
are timed by the same code. Needs a CUDA device.
"""

from __future__ import annotations

import math
import time

import torch


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    by events around the loop: the host's time between launches counts."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``, without the host's time between
    launches: the card first spins (``torch.cuda._sleep`` of 2e7 clocks,
    ~10 ms), the host queues ``iters`` calls behind the spin, and two
    events time them back to back. The host's issue time, from the
    spin's launch to the last event's, is checked against the spin's own
    device time: it must be at most half of it, so that every call was
    queued before the card reached it. Otherwise the spin is made 4 times
    longer, up to 3 times; past that, as for a ``fn`` that waits on the
    card, it raises."""
    fn()
    torch.cuda.synchronize()
    spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin_cycles = 20_000_000
    for _ in range(4):
        spin_start.record()
        t0 = time.perf_counter()
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin_start.elapsed_time(start)
        if issue_ms <= spin_ms / 2:
            return start.elapsed_time(end) / iters
        spin_cycles *= 4
    raise RuntimeError(f"device_ms: issuing {iters} calls took {issue_ms:.3f} ms on the host, more than "
                       f"half of the card's {spin_ms:.3f} ms spin before them")


def host_ms(fn, calls: int = 200) -> float:
    """The host's time per call: the least over 5 turns of the wall time
    of issuing ``calls`` calls on an idle card, with the synchronize after
    them outside the timed loop (200 launches stay well inside the launch
    queue, so the host never waits for the device; the least of 5, as the
    host's clock is shared with other processes)."""
    fn()
    best = math.inf
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best * 1e3 / calls
