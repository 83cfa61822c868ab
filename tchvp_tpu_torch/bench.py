"""Benchmark: flagship video inference on the GPU.

Run as ``python -m tchvp_tpu_torch.bench``. Prints ONE JSON line with the
keys of the root ``bench.py``: frames/s of ``VideoHybridNet`` on 16-frame
224x224 clips, bf16, batch 8, with the uint8 -> float preprocessing inside
the timed region. Protocol: one warm-up call, then 3 repetitions of
``BENCH_ITERS`` forwards, each ended by ``torch.cuda.synchronize()``; the
median repetition is reported. Needs a CUDA device: there is no CPU path.

Environment: ``BENCH_BATCH`` (8), ``BENCH_FRAMES`` (16), ``BENCH_SIZE``
(224), ``BENCH_ATTN`` ("flash"), ``BENCH_ITERS`` (20). ``BENCH_PROFILE=1``
also writes one JSON line to stderr: device time per stage, and a
torch.profiler window's device idle share and heaviest kernels.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from tchvp_tpu_torch.config import flagship_video_config
from tchvp_tpu_torch.data.pipeline import preprocess_clip
from tchvp_tpu_torch.models.video import VideoHybridNet


def random_clip(batch: int, frames: int, size: int, seed: int = 0,
                device: str = "cuda") -> torch.Tensor:
    """A uint8 (B, T, H, W, 3) clip made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (batch, frames, size, size, 3), dtype=np.uint8)
    return torch.from_numpy(raw).to(device)


def time_clips(model: VideoHybridNet, clip_u8: torch.Tensor, size: int,
               dtype: torch.dtype, iters: int) -> Dict[str, float]:
    """The bench protocol: warm up, then 3 reps of ``iters`` forwards of
    preprocess + model; returns frames/s and the clip latency of the median
    rep, and the spread of the reps."""
    batch, frames = clip_u8.shape[0], clip_u8.shape[1]

    def run() -> None:
        with torch.inference_mode():
            model(preprocess_clip(clip_u8, size, dtype=dtype))

    run()
    torch.cuda.synchronize()
    reps: List[float] = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / iters)
    med = statistics.median(reps)
    return {
        "frames_per_s": batch * frames / med,
        "p50_clip_latency_ms": med / batch * 1000.0,
        "rep_spread_pct": 100.0 * (max(reps) - min(reps)) / med,
    }


def stage_ms(model: VideoHybridNet, clip_u8: torch.Tensor, size: int,
             dtype: torch.dtype, iters: int = 5) -> Dict[str, float]:
    """Mean device time per forward of each stage (preprocess, encode,
    temporal, decode), each between two CUDA events."""
    names = ("preprocess", "encode", "temporal", "decode")
    totals = dict.fromkeys(names, 0.0)
    with torch.inference_mode():
        for i in range(iters + 1):  # the first pass warms up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            clip = preprocess_clip(clip_u8, size, dtype=dtype)
            ev[1].record()
            tokens, hw = model.encode_clip(clip)
            ev[2].record()
            tokens = model.temporal_mix(tokens)
            ev[3].record()
            model.decode_tokens(tokens, hw)
            ev[4].record()
            torch.cuda.synchronize()
            if i:
                for j, name in enumerate(names):
                    totals[name] += ev[j].elapsed_time(ev[j + 1]) / iters
    return totals


def profile_kernels(model: VideoHybridNet, clip_u8: torch.Tensor, size: int,
                    dtype: torch.dtype, iters: int = 3, top: int = 15) -> Dict[str, object]:
    """torch.profiler over ``iters`` forwards: device busy time against the
    wall time of the same window, and the kernels with the most device
    time (ms per forward)."""
    from torch.profiler import ProfilerActivity, profile

    def run() -> None:
        with torch.inference_mode():
            model(preprocess_clip(clip_u8, size, dtype=dtype))

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "wall_ms_per_forward": wall_ms / iters,
        "device_busy_ms_per_forward": busy_ms / iters,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels_ms_per_forward": [
            [e.key[:90], e.self_device_time_total / 1000.0 / iters, e.count // iters] for e in kernels[:top]
        ],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tchvp_tpu_torch.bench needs a CUDA device")
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    frames = int(os.environ.get("BENCH_FRAMES", "16"))
    size = int(os.environ.get("BENCH_SIZE", "224"))
    attn = os.environ.get("BENCH_ATTN", "flash")
    iters = int(os.environ.get("BENCH_ITERS", "20"))

    cfg = flagship_video_config(image_size=size, attn_impl=attn)
    model = VideoHybridNet(cfg, device="cuda", dtype=torch.bfloat16).eval()
    clip_u8 = random_clip(batch, frames, size)
    t = time_clips(model, clip_u8, size, torch.bfloat16, iters)
    print(json.dumps({
        "metric": f"frames/sec/gpu {size}x{size}x{frames}f bf16 inference (batch {batch})",
        "value": t["frames_per_s"],
        "unit": "frames/s",
        # No H100 baseline exists; the root bench's 2,000 frames/s target
        # was set for a TPU chip and is not this card's.
        "vs_baseline": None,
        "p50_clip_latency_ms": t["p50_clip_latency_ms"],
        "rep_spread_pct": t["rep_spread_pct"],
        "device": torch.cuda.get_device_name(0),
        "attn_impl": attn,
    }))
    if os.environ.get("BENCH_PROFILE") == "1":
        print(json.dumps({"stage_ms": stage_ms(model, clip_u8, size, torch.bfloat16),
                          **profile_kernels(model, clip_u8, size, torch.bfloat16)}),
              file=sys.stderr)


if __name__ == "__main__":
    main()
