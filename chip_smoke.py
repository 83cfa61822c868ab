#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, one line each:
 1. device: the card's name and power limit (nvidia-smi) and torch's name;
 2. build: compiles the flash-attention kernel from the sources in this
    checkout (nvcc) and prints the seconds and the registers per kernel;
 3. kernel vs plain: the CUDA kernel against its plain PyTorch version on
    the card (out and lse), fp32 max abs 1e-4; bf16 against the fp32 plain
    version on the same bf16-rounded inputs, max abs 2e-2;
 4. flagship fp32: VideoHybridNet at 224^2, B=1, T=16, attn "flash" against
    the same weights on "xla" (the dense plain core), max abs 1e-3, TF32
    off; asserts the CUDA kernel ran;
 5. main path: bf16, B=8, T=16, 224^2, a uint8 clip through preprocess_clip
    and the model; kernel launch counts are set to 0 just before one forward
    and read just after; outputs must be finite; then the bench protocol
    (tchvp_tpu_torch/bench.py) times it, and CUDA events time its stages;
 6. kernel times at the flagship attention shape beside the plain version,
    F.scaled_dot_product_attention (a yardstick, never on the port's path)
    and the bound.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the exit
code is not 0. There is no CPU path: without a CUDA device it exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tchvp_tpu_torch.bench import random_clip, stage_ms, time_clips
from tchvp_tpu_torch.config import flagship_video_config
from tchvp_tpu_torch.data.pipeline import preprocess_clip
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.ops import dispatch_trace

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
            for _ in range(3)]


def flash_bound_ms(bh: int, s: int, dh: int):
    """Least time for the bf16 forward: q, k, v read once, out (bf16) and
    lse (fp32) written once, over HBM bandwidth; 4*BH*S^2*Dh flops over the
    bf16 tensor-core peak."""
    nbytes = 4 * bh * s * dh * 2 + bh * s * 4
    flops = 4 * bh * s * s * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    return name


def phase_build() -> None:
    build.load("flash_fwd", ["flash_fwd.cu"])
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in build.build_log["flash_fwd"].splitlines() if "Used " in line})
    print(f"[2 build] flash_fwd built in {build.build_seconds['flash_fwd']:.2f} s "
          f"(registers per instantiation: {regs})")


def phase_kernel_vs_plain() -> float:
    cases = [
        ((8, 8, 128, 392), torch.bfloat16, 1 / 56, 0.0, 0),
        ((1, 8, 128, 1152), torch.bfloat16, 1 / 96, 0.0, 0),
        ((2, 2, 4099, 8), torch.float32, None, 0.0, 0),
        ((2, 8, 200, 64), torch.float32, None, 0.1, 1234),
    ]
    flagship_err = None
    for i, ((b, h, s, dh), dtype, scale, rate, seed) in enumerate(cases):
        q, k, v = qkv((b * h, s, dh), dtype, seed=i)
        scale = 1 / math.sqrt(dh) if scale is None else scale
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, rate, seed)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        print(f"[3 kernel] {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: "
              f"out max abs {err:.3g}, lse max abs {lse_err:.3g} (tol {tol})")
        check(math.isfinite(err) and err <= tol and lse_err <= tol, f"kernel vs plain at {(b, h, s, dh)}")
        if flagship_err is None:
            flagship_err = err
    return flagship_err


def phase_flagship_fp32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clip = preprocess_clip(random_clip(1, 16, 224, seed=1), 224)
    outs = {}
    for impl in ("flash", "xla"):
        model = VideoHybridNet(flagship_video_config(224, attn_impl=impl), device="cuda",
                               generator=torch.Generator().manual_seed(0)).eval()
        with dispatch_trace.capture() as seen, torch.inference_mode():
            outs[impl] = model(clip)
        torch.cuda.synchronize()
        check(("flash_mha_cuda" in seen) == (impl == "flash"), f"{impl} run recorded {sorted(seen)}")
        del model
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs["flash"], outs["xla"])]
    finite = all(bool(torch.isfinite(t).all()) for t in outs["flash"])
    print(f"[4 flagship fp32] B=1 T=16 224^2 flash vs xla: tokens max abs {errs[0]:.3g}, "
          f"recon max abs {errs[1]:.3g} (tol 1e-3), finite {finite}")
    check(finite and max(errs) <= 1e-3, "flagship fp32 flash vs xla")
    torch.backends.cudnn.allow_tf32 = True


def phase_main_path() -> int:
    batch, frames, size = 8, 16, 224
    cfg = flagship_video_config(size, attn_impl="flash")
    model = VideoHybridNet(cfg, device="cuda", dtype=torch.bfloat16).eval()
    clip_u8 = random_clip(batch, frames, size, seed=2)
    fa.launches = 0
    with dispatch_trace.capture() as seen, torch.inference_mode():
        tokens, recon = model(preprocess_clip(clip_u8, size, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    launches = fa.launches
    check("flash_mha_cuda" in seen and "sdpa_xla" not in seen, f"main path recorded {sorted(seen)}")
    check(launches == cfg.temporal.num_layers, f"flash_fwd launched {launches} times")
    check(tokens.shape == (batch, frames * 8, (size // 4) ** 2), f"tokens {tuple(tokens.shape)}")
    check(recon.shape == (batch, frames, size, size, 3), f"recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(tokens).all() and torch.isfinite(recon).all()), "non-finite output")
    t = time_clips(model, clip_u8, size, torch.bfloat16, iters=10)
    print(f"[5 main path] bf16 B={batch} T={frames} {size}^2: flash_fwd launches {launches}, "
          f"{t['frames_per_s']:.1f} frames/s, p50 clip {t['p50_clip_latency_ms']:.3f} ms, "
          f"rep spread {t['rep_spread_pct']:.2f}%")
    stages = stage_ms(model, clip_u8, size, torch.bfloat16)
    print("[5 stages] device ms per forward: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return launches


def phase_kernel_times(launches: int, max_abs_err: float) -> dict:
    b, h, s, dh = 8, 8, 128, 392
    scale = 1 / 56
    q, k, v = qkv((b * h, s, dh), torch.bfloat16, seed=7)
    kernel_ms = cuda_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale, 0.0, 0))
    plain_ms = cuda_ms(lambda: fa.mha_reference(q, k, v, scale))
    q4, k4, v4 = (t.view(b, h, s, dh) for t in (q, k, v))
    backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(q4, k4, v4, scale=scale)).name
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
    bound_ms, bound_by = flash_bound_ms(b * h, s, dh)
    print(f"[6 times] flash_fwd {(b, h, s, dh)} bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "tchvp_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "tchvp_tpu/kernels/flash_attention.py:174",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here", file=sys.stderr)
        raise SystemExit(1)
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    err = phase_kernel_vs_plain()
    phase_flagship_fp32()
    launches = phase_main_path()
    record = phase_kernel_times(launches, err)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
