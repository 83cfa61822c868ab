#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, one or more lines each:
 1. device: the card's name and power limit (nvidia-smi) and torch's name;
 2. build: compiles the flash-attention forward, the flash backward and the
    banded-attention libraries from the sources in this checkout (one nvcc
    each, in parallel) and prints the seconds, the registers per kernel and
    the spill stores;
 3. forward kernel vs plain: out and lse against the plain PyTorch version
    on the card, fp32 max abs 1e-4; bf16 against the fp32 plain version on
    the same bf16-rounded inputs, max abs 2e-2; the dropout seed is a (1,)
    int32 device tensor;
 4. backward kernels vs plain: dq, dk, dv of the dq and dk/dv kernels
    against ``mha_bwd_reference`` on the phase-3 cases and the training
    shape, max abs <= 1e-4 (fp32) or 2e-2 (bf16) x max|reference|; a
    second launch must give the same bits;
 5. banded kernels vs plain: the forward, dq and dk/dv kernels of
    ``csrc/band_attention.cu`` against the windowed plain versions at
    config 2's shape (bf16, Dh 1152), the windowed training shape (fp32,
    dropout 0.1), a ragged S, a window that 16 does not divide, and one
    window (w >= S), where forward and backward equal the flash kernels'
    bit for bit; the phase-3/4 limits, backward bits equal on repeat;
 6. flagship fp32 inference: VideoHybridNet at 224^2, B=1, T=16, attn
    "flash" against the same weights on "xla" (the dense plain core), max
    abs 1e-3, TF32 off; asserts the CUDA kernel ran;
 7. flagship fp32 gradients: one train-mode forward and backward at 256^2,
    B=1, T=8, dropout off, TF32 off, "flash" against "xla" from the same
    weights; the largest gradient difference <= 1e-3 x the largest
    gradient; asserts the backward kernels ran;
 8. windowed flagship fp32, TF32 off: "flash" with window 64 (the banded
    kernels) against "windowed" (the dense band) from the same weights:
    the eval forward at 384^2, B=1, T=32, max abs 1e-3; train-mode
    gradients at 256^2, B=1, T=32, dropout off, <= 1e-3 x max|grad|;
 9. inference main path (config 1): bf16, B=8, T=16, 224^2, a uint8 clip
    through preprocess_clip and the model; the launch counts are set to 0
    just before one forward and read just after; outputs must be finite;
    then the bench protocol (tchvp_tpu_torch/bench.py) times it, and CUDA
    events time its stages;
10. config 2 inference: bf16, B=16, T=32, 384^2, window 64, through
    preprocess_clip and ``microbatched_infer(microbatch=4)``: the counts
    set to 0 before one call and read after it (8 banded forwards, no
    flash kernel); finite output; frames/s, p50 batch latency and spread
    (bench protocol), the stages of one group, peak memory, a profile;
11. training main path: the ``tchvp video`` defaults at 256^2, B=8, T=8,
    fp32 (mixed loss, noise 0.05, dropout on, AdamW lr 1e-4 wd 0.01, clip
    1.0): 5 steps of make_video_train_step from create_train_state, the
    counts set to 0 before each step and read after it (2 forward, 2 dq, 2
    dk/dv launches); finite loss and psnr, every parameter and every
    BatchNorm running stat moved; then steps/s and frames/s (bench
    protocol), the device ms of data, forward, backward and optimizer (CUDA
    events), peak memory, a torch.profiler window over one step, and one
    step with remat "stages" (4 forward launches);
12. windowed training: phase 11 with window 64 on B=2 of 32-frame clips
    (S 256 in 4 windows): 2 banded forward, 2 dq and 2 dk/dv launches per
    step and no flash kernel; remat "stages" launches 4 forwards;
13. config 4 streaming: stream_video of the flagship at 256^2 (attn "xla",
    bf16) over one 16-frame 1080x1920 clip in 40 tiles, chunk 8, 4 frames
    of carried context: finite output of the clip's shape, no kernel
    launched, frames/s and megapixels/s;
14. kernel times: each kernel at its main-path shape beside its plain
    version, F.scaled_dot_product_attention (a yardstick, never on the
    port's path; with the boolean band as attn_mask for the banded
    kernels) and its bound; the flash forward also at the training shape
    in fp32 (SDPA without dropout there), the flash backward kernels also
    at the inference shape in bf16, the banded backward also at config 2's.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the exit
code is not 0. There is no CPU path: without a CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tchvp_tpu_torch import losses
from tchvp_tpu_torch.bench import infer_fn, profile_window, random_clip, stage_ms, time_clips
from tchvp_tpu_torch.config import flagship_video_config
from tchvp_tpu_torch.data.pipeline import preprocess_clip
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa
from tchvp_tpu_torch.models.streaming import StreamingConfig, microbatched_infer, stream_video
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.train.state import create_train_state, make_optimizer
from tchvp_tpu_torch.train.steps import make_video_train_step

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
FP32_FLOP_PER_S = 67e12  # CUDA cores

LIBRARIES = {"flash_fwd": ["flash_fwd.cu"], "flash_bwd": ["flash_bwd.cu"],
             "band_attention": ["band_attention.cu"]}
COUNTERS = ("launches", "dq_launches", "dkv_launches",
            "band_fwd_launches", "band_dq_launches", "band_dkv_launches")


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


def device_seed(seed: int) -> torch.Tensor:
    return torch.tensor([seed], dtype=torch.int32).to("cuda")


def counts() -> dict:
    """The launch counters of the six kernels, by counter name."""
    return {name: getattr(fa, name) for name in COUNTERS}


def reset_counts() -> None:
    for name in COUNTERS:
        setattr(fa, name, 0)


def expect_counts(**nonzero) -> dict:
    """The counters as a run that launched only ``nonzero`` leaves them."""
    return {name: nonzero.get(name, 0) for name in COUNTERS}


def free_cuda() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# The kernel cases of the forward check: ((B, H, S, Dh), dtype, scale, dropout, seed).
KERNEL_CASES = [
    ((8, 8, 128, 392), torch.bfloat16, 1 / 56, 0.0, 0),
    ((1, 8, 128, 1152), torch.bfloat16, 1 / 96, 0.0, 0),
    ((2, 2, 4099, 8), torch.float32, None, 0.0, 0),
    ((2, 8, 200, 64), torch.float32, None, 0.1, 1234),
]
# The training main path's attention: 256^2 -> D 4096, 8 heads, S 64, scale 1/sqrt(D).
TRAIN_CASE = ((8, 8, 64, 512), torch.float32, 1 / 64, 0.1, 77)
INFER_BWD_CASE = ((8, 8, 128, 392), torch.bfloat16, 1 / 56, 0.0, 0)
# The banded cases: ((B, H, S, Dh), dtype, scale, window, dropout, seed).
# Config 2's attention: 384^2 -> D 9216, Dh 1152, S 32*8, window 64, a group of 4 clips.
BAND_CONFIG2 = ((4, 8, 256, 1152), torch.bfloat16, 1 / 96, 64, 0.0, 0)
# Windowed training: 256^2 -> D 4096, Dh 512, S 256, window 64, batch 2.
BAND_TRAIN = ((2, 8, 256, 512), torch.float32, 1 / 64, 64, 0.1, 77)
BAND_CASES = [
    BAND_CONFIG2,
    BAND_TRAIN,
    ((2, 4, 200, 64), torch.float32, None, 64, 0.1, 5),  # ragged S: a partial last window
    ((2, 4, 96, 64), torch.float32, None, 24, 0.0, 0),   # w not a multiple of 16 or 8
]
ONE_WINDOW_CASE = ((2, 4, 100, 64), torch.float32, None, 128, 0.1, 9)  # w >= S


def bwd_inputs(shape, dtype, scale, rate, seed, rng_seed, window=None):
    """q, k, v, do in ``dtype`` and the plain forward's lse and delta (fp32)
    on those values: the backward's inputs as the main path gives them."""
    b, h, s, dh = shape
    rng = np.random.default_rng(rng_seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b * h, s, dh), dtype=np.float32)).to("cuda", dtype)
                   for _ in range(4))
    if window is None:
        out, lse = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
    else:
        out, lse = fa.windowed_mha_reference(q.float(), k.float(), v.float(), scale, window, rate, seed)
    delta = (do.float() * out).sum(-1)
    return q, k, v, do, lse, delta


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_all(LIBRARIES)
    wall = time.perf_counter() - t0
    for name in LIBRARIES:
        log = build.build_log[name].splitlines()
        regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log if "Used " in line})
        spills = sorted({int(line.split(" bytes spill stores")[0].split()[-1])
                         for line in log if "bytes spill stores" in line})
        print(f"[2 build] {name} built in {build.build_seconds[name]:.2f} s "
              f"(registers per instantiation: {regs}; spill-store bytes: {spills})")
    print(f"[2 build] {len(LIBRARIES)} libraries in {wall:.2f} s wall (one nvcc each, in parallel)")


def phase_fwd_kernel() -> float:
    """Returns the max abs error at the first (inference flagship) case."""
    flagship_err = None
    for i, ((b, h, s, dh), dtype, scale, rate, seed) in enumerate(KERNEL_CASES):
        q, k, v = qkv((b * h, s, dh), dtype, seed=i)
        scale = 1 / math.sqrt(dh) if scale is None else scale
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, rate, device_seed(seed))
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        print(f"[3 fwd kernel] {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: "
              f"out max abs {err:.3g}, lse max abs {lse_err:.3g} (tol {tol})")
        check(math.isfinite(err) and err <= tol and lse_err <= tol, f"kernel vs plain at {(b, h, s, dh)}")
        if flagship_err is None:
            flagship_err = err
    return flagship_err


def check_bwd(tag: str, shape, dtype, got, again, want) -> list:
    """dq, dk, dv against the plain version (max abs <= tol x max|ref|) and
    bit equality of a second launch; returns the max abs errors."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    errs, rel = [], []
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        err = (g.float() - w).abs().max().item()
        ref = w.abs().max().item()
        errs.append(err)
        rel.append(err / ref)
        check(math.isfinite(err) and err <= tol * ref, f"{tag} {name} at {shape}: {err} > {tol} x {ref}")
        check(torch.equal(g, g2), f"{tag} {name} at {shape} differs between two launches")
    print(f"[{tag}] {shape} {str(dtype)[6:]}: max abs / max|ref| dq {rel[0]:.3g}, dk {rel[1]:.3g}, "
          f"dv {rel[2]:.3g} (tol {tol}); bits equal on repeat")
    return errs


def phase_bwd_kernels() -> dict:
    """dq, dk, dv of the two backward kernels against mha_bwd_reference on
    the same inputs; a second launch must give the same bits. Returns the
    max abs errors at the training shape."""
    errs = {}
    for i, case in enumerate(KERNEL_CASES + [TRAIN_CASE]):
        (b, h, s, dh), dtype, scale, rate, seed = case
        scale = 1 / math.sqrt(dh) if scale is None else scale
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 10 + i)
        got = fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate, device_seed(seed))
        again = fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate, device_seed(seed))
        torch.cuda.synchronize()
        want = fa.mha_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse, delta,
                                    scale, rate, seed)
        e = check_bwd(f"4 bwd kernels, dropout {rate}", (b, h, s, dh), dtype, got, again, want)
        if case is TRAIN_CASE:
            errs = {"flash_bwd_dq": e[0], "flash_bwd_dkv": max(e[1], e[2])}
    return errs


def band_bwd(q, k, v, do, lse, delta, scale, window, rate, seed):
    args = (q, k, v, do, lse, delta, scale, window, rate, seed)
    return (fa.band_bwd_dq_cuda(*args),) + fa.band_bwd_dkv_cuda(*args)


def phase_band_kernels() -> dict:
    """The banded forward, dq and dk/dv kernels against their plain
    versions; returns the max abs errors at config 2's shape (forward) and
    the training shape (backward)."""
    errs = {}
    for i, case in enumerate(BAND_CASES):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        scale = 1 / math.sqrt(dh) if scale is None else scale
        q, k, v = qkv((b * h, s, dh), dtype, seed=40 + i)
        out, lse = fa.band_fwd_cuda(q, k, v, scale, w, rate, device_seed(seed))
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.windowed_mha_reference(q.float(), k.float(), v.float(), scale, w, rate, seed)
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        print(f"[5 band fwd] {(b, h, s, dh)} {str(dtype)[6:]} window {w} dropout {rate}: "
              f"out max abs {err:.3g}, lse max abs {lse_err:.3g} (tol {tol})")
        check(math.isfinite(err) and err <= tol and lse_err <= tol, f"band fwd vs plain at {case}")

        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 50 + i, window=w)
        got = band_bwd(q, k, v, do, lse, delta, scale, w, rate, device_seed(seed))
        again = band_bwd(q, k, v, do, lse, delta, scale, w, rate, device_seed(seed))
        torch.cuda.synchronize()
        args = (q.float(), k.float(), v.float(), do.float(), lse, delta, scale, w, rate, seed)
        want = (fa.windowed_mha_bwd_dq_reference(*args),) + fa.windowed_mha_bwd_dkv_reference(*args)
        e = check_bwd(f"5 band bwd, window {w}, dropout {rate}", (b, h, s, dh), dtype, got, again, want)
        if case is BAND_CONFIG2:
            errs["band_fwd"] = err
        if case is BAND_TRAIN:
            errs["band_bwd_dq"], errs["band_bwd_dkv"] = e[0], max(e[1], e[2])

    # One window (w >= S): the band holds every pair, so the banded kernels
    # run the flash kernels' arithmetic in their order.
    (b, h, s, dh), dtype, _, w, rate, seed = ONE_WINDOW_CASE
    scale = 1 / math.sqrt(dh)
    q, k, v, do, _, _ = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 60)
    band = fa.band_fwd_cuda(q, k, v, scale, w, rate, device_seed(seed))
    flash = fa._flash_fwd_cuda(q, k, v, scale, rate, device_seed(seed))
    delta = (do.float() * flash[0]).sum(-1)
    band_g = band_bwd(q, k, v, do, flash[1], delta, scale, w, rate, device_seed(seed))
    flash_g = fa._flash_bwd_cuda(q, k, v, do, flash[1], delta, scale, rate, device_seed(seed))
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "lse", "dq", "dk", "dv"), band + band_g, flash + flash_g):
        check(torch.equal(x, y), f"one window {w} >= S {s}: band {name} differs from flash "
                                 f"by {(x - y).abs().max().item():.3g}")
    print(f"[5 band one window] {(b, h, s, dh)} window {w} >= S, dropout {rate}: out, lse, dq, dk, dv "
          f"equal the flash kernels' bit for bit")
    return errs


def phase_flagship_fp32() -> None:
    torch.backends.cudnn.allow_tf32 = False  # matmuls run without TF32 by default
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
    print(f"[6 flagship fp32] B=1 T=16 224^2 flash vs xla: tokens max abs {errs[0]:.3g}, "
          f"recon max abs {errs[1]:.3g} (tol 1e-3), finite {finite}")
    check(finite and max(errs) <= 1e-3, "flagship fp32 flash vs xla")
    torch.backends.cudnn.allow_tf32 = True


def no_dropout(cfg):
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout_rate=0.0),
                               temporal=dataclasses.replace(cfg.temporal, dropout_rate=0.0))


def compare_grads(tag: str, size: int, frames: int, impls, marker: str, window: int = 0) -> None:
    """Train-mode fp32 gradients of impls[0] (the kernels) against impls[1]
    (a dense core) from the same weights, dropout off, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    clip = preprocess_clip(random_clip(1, frames, size, seed=3), size)
    grads = {}
    for impl in impls:
        cfg = no_dropout(flagship_video_config(size, attn_impl=impl, window_size=window))
        model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).train()
        with dispatch_trace.capture() as seen:
            _, recon = model(clip)
            losses.mse(recon, clip).backward()
        torch.cuda.synchronize()
        check((marker in seen) == (impl == impls[0]), f"{impl} run recorded {sorted(seen)}")
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model
    gmax = max(g.abs().max().item() for g in grads[impls[1]].values())
    diffs = {n: (grads[impls[0]][n] - g).abs().max().item() for n, g in grads[impls[1]].items()}
    worst = max(diffs, key=diffs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads[impls[0]].values())
    print(f"[{tag}] fp32 B=1 T={frames} {size}^2 train mode, {impls[0]} vs {impls[1]}: max grad diff "
          f"{diffs[worst]:.3g} ({worst}), max |grad| {gmax:.3g}, ratio {diffs[worst] / gmax:.3g} "
          f"(tol 1e-3), finite {finite}")
    check(finite and diffs[worst] <= 1e-3 * gmax, f"flagship fp32 gradients {impls[0]} vs {impls[1]}")
    del grads
    free_cuda()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True


def phase_flagship_grads() -> None:
    compare_grads("7 flagship grads", 256, 8, ("flash", "xla"), "flash_mha_bwd_cuda")


def phase_windowed_flagship() -> None:
    torch.backends.cudnn.allow_tf32 = False
    clip = preprocess_clip(random_clip(1, 32, 384, seed=4), 384)
    outs = {}
    for impl, marker in (("flash", "flash_windowed_cuda"), ("windowed", "sdpa_windowed")):
        model = VideoHybridNet(flagship_video_config(384, attn_impl=impl, window_size=64), device="cuda",
                               generator=torch.Generator().manual_seed(0)).eval()
        with dispatch_trace.capture() as seen, torch.inference_mode():
            outs[impl] = model(clip)
        torch.cuda.synchronize()
        check(marker in seen and "flash_mha_cuda" not in seen, f"{impl} run recorded {sorted(seen)}")
        del model
        free_cuda()
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs["flash"], outs["windowed"])]
    finite = all(bool(torch.isfinite(t).all()) for t in outs["flash"])
    print(f"[8 windowed flagship fp32] B=1 T=32 384^2 window 64, flash vs windowed: tokens max abs "
          f"{errs[0]:.3g}, recon max abs {errs[1]:.3g} (tol 1e-3), finite {finite}")
    check(finite and max(errs) <= 1e-3, "windowed flagship fp32 flash vs windowed")
    del outs, clip
    free_cuda()
    torch.backends.cudnn.allow_tf32 = True
    compare_grads("8 windowed flagship grads", 256, 32, ("flash", "windowed"),
                  "flash_windowed_bwd_cuda", window=64)


def phase_infer_main_path() -> int:
    batch, frames, size = 8, 16, 224
    cfg = flagship_video_config(size, attn_impl="flash")
    model = VideoHybridNet(cfg, device="cuda", dtype=torch.bfloat16).eval()
    clip_u8 = random_clip(batch, frames, size, seed=2)
    reset_counts()
    with dispatch_trace.capture() as seen, torch.inference_mode():
        tokens, recon = model(preprocess_clip(clip_u8, size, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    launches = counts()
    check("flash_mha_cuda" in seen and "sdpa_xla" not in seen, f"main path recorded {sorted(seen)}")
    check(launches == expect_counts(launches=cfg.temporal.num_layers), f"launches {launches}")
    check(tokens.shape == (batch, frames * 8, (size // 4) ** 2), f"tokens {tuple(tokens.shape)}")
    check(recon.shape == (batch, frames, size, size, 3), f"recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(tokens).all() and torch.isfinite(recon).all()), "non-finite output")
    t = time_clips(model, clip_u8, size, torch.bfloat16, iters=10)
    print(f"[9 infer main path] bf16 B={batch} T={frames} {size}^2: flash_fwd launches "
          f"{launches['launches']}, {t['frames_per_s']:.1f} frames/s, p50 clip "
          f"{t['p50_clip_latency_ms']:.3f} ms, rep spread {t['rep_spread_pct']:.2f}%")
    stages = stage_ms(model, clip_u8, size, torch.bfloat16)
    print("[9 stages] device ms per forward: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    del model
    free_cuda()
    return launches["launches"]


def print_profile(tag: str, prof: dict) -> None:
    print(f"[{tag}] wall {prof['wall_ms_per_call']:.1f} ms, device busy "
          f"{prof['device_busy_ms_per_call']:.1f} ms, idle share {100 * prof['device_idle_share']:.2f}%")
    for name, ms, n in prof["top_kernels_ms_per_call"]:
        print(f"[{tag}]   {ms:9.3f} ms  x{n:<4d} {name}")


def phase_config2() -> int:
    """BASELINE config 2: the windowed flagship at 384^2 over batch 16 of
    32-frame clips in microbatches of 4."""
    batch, frames, size, window, micro = 16, 32, 384, 64, 4
    cfg = flagship_video_config(size, attn_impl="flash", window_size=window)
    model = VideoHybridNet(cfg, device="cuda", dtype=torch.bfloat16).eval()
    clip_u8 = random_clip(batch, frames, size, seed=0)
    per_call = cfg.temporal.num_layers * batch // micro
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with dispatch_trace.capture() as seen:
        recon = microbatched_infer(model, preprocess_clip(clip_u8, size, dtype=torch.bfloat16), micro)
    torch.cuda.synchronize()
    launches = counts()
    check("flash_windowed_cuda" in seen and not seen & {"flash_mha_cuda", "sdpa_xla", "sdpa_windowed"},
          f"config 2 recorded {sorted(seen)}")
    check(launches == expect_counts(band_fwd_launches=per_call), f"config 2 launches {launches}")
    check(recon.shape == (batch, frames, size, size, 3), f"recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(recon).all()), "non-finite config 2 output")
    del recon
    t = time_clips(model, clip_u8, size, torch.bfloat16, iters=2, microbatch=micro)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[10 config 2] bf16 B={batch} T={frames} {size}^2 window {window} microbatch {micro}: "
          f"band_fwd launches {launches['band_fwd_launches']} per call, flash launches "
          f"{launches['launches']}; {t['frames_per_s']:.1f} frames/s, p50 batch "
          f"{t['p50_batch_latency_ms']:.1f} ms, rep spread {t['rep_spread_pct']:.2f}%, "
          f"peak memory {peak_gb:.2f} GB")
    stages = stage_ms(model, clip_u8[:micro], size, torch.bfloat16)
    print(f"[10 config 2 stages] device ms per group of {micro}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    print_profile("10 config 2 profile", profile_window(
        infer_fn(model, clip_u8, size, torch.bfloat16, micro), iters=1, top=10))
    del model
    free_cuda()
    return launches["band_fwd_launches"]


def phase_train(tag: str, batch: int, frames: int, window: int = 0) -> dict:
    """The ``tchvp video`` training defaults on the flagship at 256^2, with
    flash attention or, with a window, the banded kernels. Returns the
    launch counts of the last main-path step."""
    size, steps = 256, 5
    cfg = flagship_video_config(size, attn_impl="flash", window_size=window)
    n = cfg.temporal.num_layers
    if window:
        kind, fwd, dq, dkv = "band", "band_fwd_launches", "band_dq_launches", "band_dkv_launches"
        markers = {"flash_windowed_cuda", "flash_windowed_bwd_cuda"}
    else:
        kind, fwd, dq, dkv = "flash", "launches", "dq_launches", "dkv_launches"
        markers = {"flash_mha_cuda", "flash_mha_bwd_cuda"}
    model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0),
                               rng=0)
    step = make_video_train_step(size, loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05)
    clips = [random_clip(batch, frames, size, seed=20 + i) for i in range(steps)]
    params0 = {n_: p.detach().clone() for n_, p in model.named_parameters()}
    stats0 = {n_: b.clone() for n_, b in model.named_buffers() if "running" in n_}
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for clip in clips:
        reset_counts()
        with dispatch_trace.capture() as seen:
            metrics.append(step(state, clip)[1])
        torch.cuda.synchronize()
        launches = counts()
        check(launches == expect_counts(**{fwd: n, dq: n, dkv: n}), f"train step launches {launches}")
        check(markers <= seen and not seen & {"sdpa_xla", "sdpa_windowed"},
              f"train step recorded {sorted(seen)}")
    step_counts = launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = torch.stack([m["loss"] for m in metrics]).tolist()
    psnr = torch.stack([m["psnr"] for m in metrics]).tolist()
    check(all(math.isfinite(x) for x in loss + psnr), f"loss {loss}, psnr {psnr}")
    still = [n_ for n_, p in model.named_parameters() if torch.equal(p.detach(), params0[n_])]
    check(not still, f"parameters unchanged after {steps} steps: {still[:5]}")
    still = [n_ for n_, b in model.named_buffers() if n_ in stats0 and torch.equal(b, stats0[n_])]
    check(not still, f"BatchNorm stats unchanged after {steps} steps: {still[:5]}")
    del params0, stats0
    print(f"[{tag}] fp32 B={batch} T={frames} {size}^2" + (f" window {window}" if window else "")
          + f" mixed loss, AdamW, dropout on: {steps} steps, {kind} launches per step fwd {n}, "
          f"dq {n}, dkv {n}, other kernels 0; loss {[round(x, 5) for x in loss]}, "
          f"psnr {[round(x, 3) for x in psnr]}; peak memory {peak_gb:.2f} GB")

    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for clip in clips[:2]:
            step(state, clip)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 2)
    med = statistics.median(reps)
    print(f"[{tag}] {1 / med:.3f} steps/s, {batch * frames / med:.1f} trained frames/s, "
          f"step {med * 1e3:.1f} ms (median of 3 reps of 2 steps), rep spread "
          f"{100 * (max(reps) - min(reps)) / med:.2f}%")

    split = {k: [] for k in ("data", "forward", "backward", "optimizer")}
    for clip in clips[:3]:
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        mark("start")
        step(state, clip, mark=mark)
        torch.cuda.synchronize()
        names = ["start", *split]
        for a, b in zip(names, names[1:]):
            split[b].append(events[a].elapsed_time(events[b]))
    split = {k: statistics.median(v) for k, v in split.items()}
    print(f"[{tag}] device ms per step (median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))

    print_profile(f"{tag} profile", profile_window(lambda: step(state, clips[0]), iters=1, top=10))

    stages = make_video_train_step(size, loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05,
                                   remat_policy="stages")
    reset_counts()
    _, m = stages(state, clips[1])
    torch.cuda.synchronize()
    launches = counts()
    check(launches == expect_counts(**{fwd: 2 * n, dq: n, dkv: n}), f"remat stages launches {launches}")
    check(math.isfinite(m["loss"].item()), "remat stages loss")
    print(f"[{tag}] remat 'stages' step: {kind} launches fwd {launches[fwd]}, dq {launches[dq]}, "
          f"dkv {launches[dkv]}, loss {m['loss'].item():.5f}")
    del model, state, clips
    free_cuda()
    return step_counts


def phase_streaming() -> None:
    """BASELINE config 4: 1080p through 256^2 tiles, chunk 8, 4 frames of context."""
    frames, (h, w) = 16, (1080, 1920)
    model = VideoHybridNet(flagship_video_config(256), device="cuda", dtype=torch.bfloat16).eval()
    scfg = StreamingConfig(tile=256, chunk_len=8, ctx_frames=4)
    clip = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, frames, h, w, 3)).astype(np.float32))
    clip = clip.to("cuda")
    reset_counts()
    with dispatch_trace.capture() as seen:
        recon = stream_video(model, clip, scfg)
    torch.cuda.synchronize()
    check(recon.shape == (1, frames, h, w, 3), f"streaming recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(recon).all()), "non-finite streaming output")
    check(counts() == expect_counts() and seen == {"sdpa_xla"}, f"streaming ran {counts()}, {sorted(seen)}")
    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream_video(model, clip, scfg)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    med = statistics.median(reps)
    tiles = math.ceil(h / 256) * math.ceil(w / 256)
    print(f"[13 config 4 streaming] bf16 1x{frames}x{h}x{w} in {tiles} tiles of 256^2, chunk 8, "
          f"context 4 frames ({(8 + 4) * 8} tokens per chunk): {frames / med:.2f} frames/s, "
          f"{frames * h * w / med / 1e6:.1f} megapixels/s (median of 3 clips, spread "
          f"{100 * (max(reps) - min(reps)) / med:.2f}%)")
    del model, clip, recon
    free_cuda()


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM
    bandwidth and the products over the peak of the dtype's units."""
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_backend(q4, k4, v4, scale, attn_mask=None) -> str:
    choice = torch._fused_sdp_choice(q4, k4, v4, attn_mask=attn_mask, scale=scale)
    name = torch.nn.attention.SDPBackend(choice).name
    return name if name != "MATH" else "MATH: no fused SDPA kernel at this dtype, head dim and mask"


def record(name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms):
    return {"name": name, "route": "cuda", "source": f"tchvp_tpu_torch/kernels/csrc/{source}",
            "replaces": f"tchvp_tpu/kernels/flash_attention.py:{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def time_flash(fwd_launches: int, fwd_err: float, bwd_launches: dict, bwd_errs: dict) -> list:
    # Forward at the inference main path's shape (bf16).
    b, h, s, dh = 8, 8, 128, 392
    scale = 1 / 56
    q, k, v = qkv((b * h, s, dh), torch.bfloat16, seed=7)
    kernel_ms = cuda_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale, 0.0, 0))
    plain_ms = cuda_ms(lambda: fa.mha_reference(q, k, v, scale))
    q4, k4, v4 = (t.view(b, h, s, dh) for t in (q, k, v))
    backend = sdpa_backend(q4, k4, v4, scale)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
    bh = b * h
    bound_ms, bound_by = bound(4 * bh * s * dh * 2 + bh * s * 4, 4 * bh * s * s * dh, torch.bfloat16)
    print(f"[14 times] flash_fwd {(b, h, s, dh)} bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # The forward on the training path: fp32 with dropout; SDPA without.
    (tb, th, ts, tdh), _, tscale, trate, tseed = TRAIN_CASE
    tq, tk, tv = qkv((tb * th, ts, tdh), torch.float32, seed=8)
    seed_t = device_seed(tseed)
    train_ms = cuda_ms(lambda: fa._flash_fwd_cuda(tq, tk, tv, tscale, trate, seed_t))
    train_plain_ms = cuda_ms(lambda: fa.mha_reference(tq, tk, tv, tscale, trate, tseed))
    tq4, tk4, tv4 = (t.view(tb, th, ts, tdh) for t in (tq, tk, tv))
    train_backend = sdpa_backend(tq4, tk4, tv4, tscale)
    train_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(tq4, tk4, tv4, scale=tscale))
    tbh = tb * th
    train_bound, train_by = bound(4 * tbh * ts * tdh * 4 + tbh * ts * 4, 4 * tbh * ts * ts * tdh,
                                  torch.float32)
    print(f"[14 times] flash_fwd {(tb, th, ts, tdh)} float32 dropout {trate}: kernel {train_ms:.4f} ms, "
          f"plain {train_plain_ms:.4f} ms, SDPA without dropout ({train_backend}) {train_lib_ms:.4f} ms, "
          f"bound {train_bound:.4f} ms ({train_by})")
    records = [record("flash_fwd", "flash_fwd.cu", 174, fwd_launches, fwd_err, kernel_ms, plain_ms,
                      bound_ms, bound_by, library_ms)]

    # Backward: the training shape (fp32, dropout 0.1, in the JSON), then the
    # inference shape in bf16.
    for case in (TRAIN_CASE, INFER_BWD_CASE):
        (b, h, s, dh), dtype, scale, rate, seed = case
        bh, esize = b * h, torch.finfo(dtype).bits // 8
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 30)
        args = (q, k, v, do, lse, delta, scale, rate, device_seed(seed))
        plain_args = (q, k, v, do, lse, delta, scale, rate, seed)
        q4, k4, v4 = (t.detach().view(b, h, s, dh).requires_grad_() for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        do4 = do.view(b, h, s, dh)
        backend = sdpa_backend(q4, k4, v4, scale)
        sdpa_ms = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True), 20)
        row_bytes, stats_bytes = bh * s * dh * esize, 2 * bh * s * 4
        times = {}
        for name, fn, plain, n_out, n_products in (
            ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa.mha_bwd_dq_reference, 1, 3),
            ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa.mha_bwd_dkv_reference, 2, 4),
        ):
            ms = cuda_ms(lambda: fn(*args), 20)
            p_ms = cuda_ms(lambda: plain(*plain_args), 20)
            # q, k, v, do, lse and delta read once, the outputs written once;
            # 2 flops per multiply-add of each S x S x Dh product.
            b_ms, b_by = bound((4 + n_out) * row_bytes + stats_bytes, n_products * 2 * bh * s * s * dh, dtype)
            times[name] = ms
            print(f"[14 times] {name} {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: kernel {ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if case is TRAIN_CASE:
                records.append(record(name, "flash_bwd.cu", 374 if name == "flash_bwd_dq" else 403,
                                      bwd_launches[name], bwd_errs[name], ms, p_ms, b_ms, b_by, sdpa_ms))
        pair_ms, pair_by = bound(7 * row_bytes + stats_bytes, 10 * bh * s * s * dh, dtype)
        print(f"[14 times] backward pair {(b, h, s, dh)} {str(dtype)[6:]}: dq + dk/dv "
              f"{times['flash_bwd_dq'] + times['flash_bwd_dkv']:.4f} ms, SDPA backward without dropout "
              f"({backend}) {sdpa_ms:.4f} ms, bound {pair_ms:.4f} ms ({pair_by})")
    return records


def time_band(band_launches: dict, band_errs: dict) -> list:
    """The banded kernels at config 2's shape (forward in the JSON, and the
    backward) and the training shape (backward in the JSON, and the
    forward). The bound counts the band's pairs of these shapes; SDPA gets
    the boolean band as ``attn_mask`` (and no dropout)."""
    records = []
    for case in (BAND_CONFIG2, BAND_TRAIN):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        bh, esize = b * h, torch.finfo(dtype).bits // 8
        mask = fa.band_mask(s, w, torch.device("cuda"))
        pairs = bh * int(mask.sum().item())
        row_bytes, stat_bytes = bh * s * dh * esize, bh * s * 4
        tag = f"{(b, h, s, dh)} {str(dtype)[6:]} window {w} dropout {rate}"
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 70, window=w)
        seed_t = device_seed(seed)
        q4, k4, v4 = (t.detach().view(b, h, s, dh).requires_grad_() for t in (q, k, v))
        backend = sdpa_backend(q4, k4, v4, scale, mask)

        fwd_ms = cuda_ms(lambda: fa.band_fwd_cuda(q, k, v, scale, w, rate, seed_t), 20)
        fwd_plain = cuda_ms(lambda: fa.windowed_mha_reference(q, k, v, scale, w, rate, seed), 20)
        with torch.no_grad():
            fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale), 20)
        fwd_bound, fwd_by = bound(4 * row_bytes + stat_bytes, 2 * 2 * pairs * dh, dtype)
        print(f"[14 times] band_fwd {tag}: kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, SDPA with the "
              f"band mask ({backend}) {fwd_lib:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by}); band pairs "
              f"{pairs // bh} per bh")
        if case is BAND_CONFIG2:
            records.append(record("band_fwd", "band_attention.cu", 611, band_launches["band_fwd"],
                                  band_errs["band_fwd"], fwd_ms, fwd_plain, fwd_bound, fwd_by, fwd_lib))

        out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale)
        do4 = do.view(b, h, s, dh)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True), 20)
        args = (q, k, v, do, lse, delta, scale, w, rate, seed_t)
        plain_args = (q, k, v, do, lse, delta, scale, w, rate, seed)
        times = {}
        for name, fn, plain, n_out, n_products, line in (
            ("band_bwd_dq", fa.band_bwd_dq_cuda, fa.windowed_mha_bwd_dq_reference, 1, 3, 657),
            ("band_bwd_dkv", fa.band_bwd_dkv_cuda, fa.windowed_mha_bwd_dkv_reference, 2, 4, 683),
        ):
            ms = cuda_ms(lambda: fn(*args), 20)
            p_ms = cuda_ms(lambda: plain(*plain_args), 20)
            b_ms, b_by = bound((4 + n_out) * row_bytes + 2 * stat_bytes, n_products * 2 * pairs * dh, dtype)
            times[name] = ms
            print(f"[14 times] {name} {tag}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if case is BAND_TRAIN:
                records.append(record(name, "band_attention.cu", line, band_launches[name],
                                      band_errs[name], ms, p_ms, b_ms, b_by, lib_ms))
        pair_ms, pair_by = bound(7 * row_bytes + 2 * stat_bytes, 10 * pairs * dh, dtype)
        print(f"[14 times] band backward pair {tag}: dq + dk/dv "
              f"{times['band_bwd_dq'] + times['band_bwd_dkv']:.4f} ms, SDPA backward with the band mask, "
              f"without dropout ({backend}) {lib_ms:.4f} ms, bound {pair_ms:.4f} ms ({pair_by})")
    return records


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here", file=sys.stderr)
        raise SystemExit(1)
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    fwd_err = phase_fwd_kernel()
    bwd_errs = phase_bwd_kernels()
    band_errs = phase_band_kernels()
    phase_flagship_fp32()
    phase_flagship_grads()
    phase_windowed_flagship()
    fwd_launches = phase_infer_main_path()
    band_fwd_launches = phase_config2()
    train = phase_train("11 train", batch=8, frames=8)
    windowed = phase_train("12 windowed train", batch=2, frames=32, window=64)
    phase_streaming()
    records = time_flash(fwd_launches, fwd_err, {"flash_bwd_dq": train["dq_launches"],
                                                 "flash_bwd_dkv": train["dkv_launches"]}, bwd_errs)
    records += time_band({"band_fwd": band_fwd_launches, "band_bwd_dq": windowed["band_dq_launches"],
                          "band_bwd_dkv": windowed["band_dkv_launches"]}, band_errs)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
