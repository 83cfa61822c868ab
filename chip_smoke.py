#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, one or more lines each:
 1. device: the card's name and power limit (nvidia-smi) and torch's name;
 2. build: compiles the flash-attention forward and backward libraries from
    the sources in this checkout (one nvcc each, in parallel) and prints
    the seconds, the registers per kernel and the spill stores;
 3. forward kernel vs plain: out and lse against the plain PyTorch version
    on the card, fp32 max abs 1e-4; bf16 against the fp32 plain version on
    the same bf16-rounded inputs, max abs 2e-2; the dropout seed is a (1,)
    int32 device tensor;
 4. backward kernels vs plain: dq, dk, dv of the dq and dk/dv kernels
    against ``mha_bwd_reference`` on the phase-3 cases and the training
    shape, max abs <= 1e-4 (fp32) or 2e-2 (bf16) x max|reference|; a
    second launch must give the same bits;
 5. flagship fp32 inference: VideoHybridNet at 224^2, B=1, T=16, attn
    "flash" against the same weights on "xla" (the dense plain core), max
    abs 1e-3, TF32 off; asserts the CUDA kernel ran;
 6. flagship fp32 gradients: one train-mode forward and backward at 256^2,
    B=1, T=8, dropout off, TF32 off, "flash" against "xla" from the same
    weights; the largest gradient difference <= 1e-3 x the largest
    gradient; asserts the backward kernels ran;
 7. inference main path: bf16, B=8, T=16, 224^2, a uint8 clip through
    preprocess_clip and the model; the launch counts are set to 0 just
    before one forward and read just after; outputs must be finite; then
    the bench protocol (tchvp_tpu_torch/bench.py) times it, and CUDA events
    time its stages;
 8. training main path: the ``tchvp video`` defaults at 256^2, B=8, T=8,
    fp32 (mixed loss, noise 0.05, dropout on, AdamW lr 1e-4 wd 0.01, clip
    1.0): 5 steps of make_video_train_step from create_train_state, the
    counts set to 0 before each step and read after it (2 forward, 2 dq, 2
    dk/dv launches); finite loss and psnr, every parameter and every
    BatchNorm running stat moved; then steps/s and frames/s (bench
    protocol), the device ms of data, forward, backward and optimizer (CUDA
    events), peak memory, a torch.profiler window over one step, and one
    step with remat "stages" (4 forward launches);
 9. kernel times: each kernel at its main-path shape beside its plain
    version, the F.scaled_dot_product_attention forward or backward (a
    yardstick, never on the port's path) and its bound; the forward also at
    the training shape in fp32, the backward kernels also at the inference
    shape in bf16.
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
from tchvp_tpu_torch.bench import profile_window, random_clip, stage_ms, time_clips
from tchvp_tpu_torch.config import flagship_video_config
from tchvp_tpu_torch.data.pipeline import preprocess_clip
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.train.state import create_train_state, make_optimizer
from tchvp_tpu_torch.train.steps import make_video_train_step

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
FP32_FLOP_PER_S = 67e12  # CUDA cores


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


def counts():
    return fa.launches, fa.dq_launches, fa.dkv_launches


def reset_counts() -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = 0


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


def bwd_inputs(shape, dtype, scale, rate, seed, rng_seed):
    """q, k, v, do in ``dtype`` and the plain forward's lse and delta (fp32)
    on those values: the backward's inputs as the main path gives them."""
    b, h, s, dh = shape
    rng = np.random.default_rng(rng_seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b * h, s, dh), dtype=np.float32)).to("cuda", dtype)
                   for _ in range(4))
    out, lse = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
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
    build.load_all({"flash_fwd": ["flash_fwd.cu"], "flash_bwd": ["flash_bwd.cu"]})
    wall = time.perf_counter() - t0
    for name in ("flash_fwd", "flash_bwd"):
        log = build.build_log[name].splitlines()
        regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log if "Used " in line})
        spills = sorted({int(line.split(" bytes spill stores")[0].split()[-1])
                         for line in log if "bytes spill stores" in line})
        print(f"[2 build] {name} built in {build.build_seconds[name]:.2f} s "
              f"(registers per instantiation: {regs}; spill-store bytes: {spills})")
    print(f"[2 build] both libraries in {wall:.2f} s wall (one nvcc each, in parallel)")


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
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        rel = []
        for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
            err = (g.float() - w).abs().max().item()
            ref = w.abs().max().item()
            rel.append(err / ref)
            if case is TRAIN_CASE:
                key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                errs[key] = max(errs.get(key, 0.0), err)
            check(math.isfinite(err) and err <= tol * ref, f"{name} at {(b, h, s, dh)}: {err} > {tol} x {ref}")
            check(torch.equal(g, g2), f"{name} at {(b, h, s, dh)} differs between two launches")
        print(f"[4 bwd kernels] {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: max abs / max|ref| "
              f"dq {rel[0]:.3g}, dk {rel[1]:.3g}, dv {rel[2]:.3g} (tol {tol}); bits equal on repeat")
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
    print(f"[5 flagship fp32] B=1 T=16 224^2 flash vs xla: tokens max abs {errs[0]:.3g}, "
          f"recon max abs {errs[1]:.3g} (tol 1e-3), finite {finite}")
    check(finite and max(errs) <= 1e-3, "flagship fp32 flash vs xla")
    torch.backends.cudnn.allow_tf32 = True


def phase_flagship_grads() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    clip = preprocess_clip(random_clip(1, 8, 256, seed=3), 256)
    grads = {}
    for impl in ("flash", "xla"):
        cfg = flagship_video_config(256, attn_impl=impl)
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout_rate=0.0),
                                  temporal=dataclasses.replace(cfg.temporal, dropout_rate=0.0))
        model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).train()
        with dispatch_trace.capture() as seen:
            _, recon = model(clip)
            losses.mse(recon, clip).backward()
        torch.cuda.synchronize()
        check(("flash_mha_bwd_cuda" in seen) == (impl == "flash"), f"{impl} run recorded {sorted(seen)}")
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model
    gmax = max(g.abs().max().item() for g in grads["xla"].values())
    diffs = {n: (grads["flash"][n] - g).abs().max().item() for n, g in grads["xla"].items()}
    worst = max(diffs, key=diffs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads["flash"].values())
    print(f"[6 flagship grads] fp32 B=1 T=8 256^2 train mode, flash vs xla: max grad diff "
          f"{diffs[worst]:.3g} ({worst}), max |grad| {gmax:.3g}, ratio {diffs[worst] / gmax:.3g} "
          f"(tol 1e-3), finite {finite}")
    check(finite and diffs[worst] <= 1e-3 * gmax, "flagship fp32 gradients flash vs xla")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True


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
    check(launches == (cfg.temporal.num_layers, 0, 0), f"launches (fwd, dq, dkv) {launches}")
    check(tokens.shape == (batch, frames * 8, (size // 4) ** 2), f"tokens {tuple(tokens.shape)}")
    check(recon.shape == (batch, frames, size, size, 3), f"recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(tokens).all() and torch.isfinite(recon).all()), "non-finite output")
    t = time_clips(model, clip_u8, size, torch.bfloat16, iters=10)
    print(f"[7 infer main path] bf16 B={batch} T={frames} {size}^2: flash_fwd launches {launches[0]}, "
          f"{t['frames_per_s']:.1f} frames/s, p50 clip {t['p50_clip_latency_ms']:.3f} ms, "
          f"rep spread {t['rep_spread_pct']:.2f}%")
    stages = stage_ms(model, clip_u8, size, torch.bfloat16)
    print("[7 stages] device ms per forward: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return launches[0]


def phase_train_main_path() -> dict:
    """The ``tchvp video`` training defaults on the flagship at 256^2."""
    batch, frames, size, steps = 8, 8, 256, 5
    cfg = flagship_video_config(size, attn_impl="flash")
    per_step = cfg.temporal.num_layers
    model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0),
                               rng=0)
    step = make_video_train_step(size, loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05)
    clips = [random_clip(batch, frames, size, seed=20 + i) for i in range(steps)]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for clip in clips:
        reset_counts()
        with dispatch_trace.capture() as seen:
            metrics.append(step(state, clip)[1])
        torch.cuda.synchronize()
        launches = counts()
        check(launches == (per_step, per_step, per_step), f"train step launches (fwd, dq, dkv) {launches}")
        check({"flash_mha_cuda", "flash_mha_bwd_cuda"} <= seen and "sdpa_xla" not in seen,
              f"train step recorded {sorted(seen)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = torch.stack([m["loss"] for m in metrics]).tolist()
    psnr = torch.stack([m["psnr"] for m in metrics]).tolist()
    check(all(math.isfinite(x) for x in loss + psnr), f"loss {loss}, psnr {psnr}")
    still = [n for n, p in model.named_parameters() if torch.equal(p.detach(), params0[n])]
    check(not still, f"parameters unchanged after {steps} steps: {still[:5]}")
    still = [n for n, b in model.named_buffers() if n in stats0 and torch.equal(b, stats0[n])]
    check(not still, f"BatchNorm stats unchanged after {steps} steps: {still[:5]}")
    del params0, stats0
    print(f"[8 train] fp32 B={batch} T={frames} {size}^2 mixed loss, AdamW, dropout on: {steps} steps, "
          f"launches per step fwd {per_step}, dq {per_step}, dkv {per_step}; "
          f"loss {[round(x, 5) for x in loss]}, psnr {[round(x, 3) for x in psnr]}; "
          f"peak memory {peak_gb:.2f} GB")

    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for clip in clips[:2]:
            step(state, clip)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 2)
    med = statistics.median(reps)
    print(f"[8 train] {1 / med:.3f} steps/s, {batch * frames / med:.1f} trained frames/s, "
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
    print("[8 train] device ms per step (median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))

    prof = profile_window(lambda: step(state, clips[0]), iters=1, top=10)
    print(f"[8 train profile] one step: wall {prof['wall_ms_per_call']:.1f} ms, device busy "
          f"{prof['device_busy_ms_per_call']:.1f} ms, idle share {100 * prof['device_idle_share']:.2f}%")
    for name, ms, n in prof["top_kernels_ms_per_call"]:
        print(f"[8 train profile]   {ms:9.3f} ms  x{n:<4d} {name}")

    stages = make_video_train_step(size, loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05,
                                   remat_policy="stages")
    reset_counts()
    _, m = stages(state, clips[1])
    torch.cuda.synchronize()
    launches = counts()
    check(launches == (2 * per_step, per_step, per_step), f"remat stages launches {launches}")
    check(math.isfinite(m["loss"].item()), "remat stages loss")
    print(f"[8 train] remat 'stages' step: launches fwd {launches[0]}, dq {launches[1]}, "
          f"dkv {launches[2]}, loss {m['loss'].item():.5f}")
    return {"flash_bwd_dq": per_step, "flash_bwd_dkv": per_step}


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM
    bandwidth and the products over the peak of the dtype's units."""
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_backend(q4, k4, v4, scale) -> str:
    name = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(q4, k4, v4, scale=scale)).name
    return name if name != "MATH" else "MATH: no fused SDPA kernel at this dtype and head dim"


def phase_kernel_times(fwd_launches: int, fwd_err: float, bwd_launches: dict, bwd_errs: dict) -> list:
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
    print(f"[9 times] flash_fwd {(b, h, s, dh)} bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # The forward on the training path: fp32 with dropout.
    (tb, th, ts, tdh), _, tscale, trate, tseed = TRAIN_CASE
    tq, tk, tv = qkv((tb * th, ts, tdh), torch.float32, seed=8)
    seed_t = device_seed(tseed)
    train_ms = cuda_ms(lambda: fa._flash_fwd_cuda(tq, tk, tv, tscale, trate, seed_t))
    train_plain_ms = cuda_ms(lambda: fa.mha_reference(tq, tk, tv, tscale, trate, tseed))
    tbh = tb * th
    train_bound, train_by = bound(4 * tbh * ts * tdh * 4 + tbh * ts * 4, 4 * tbh * ts * ts * tdh,
                                  torch.float32)
    print(f"[9 times] flash_fwd {(tb, th, ts, tdh)} float32 dropout {trate}: kernel {train_ms:.4f} ms, "
          f"plain {train_plain_ms:.4f} ms, bound {train_bound:.4f} ms ({train_by})")
    records = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tchvp_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "tchvp_tpu/kernels/flash_attention.py:174",
        "launches": fwd_launches, "max_abs_err": fwd_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }]

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
            print(f"[9 times] {name} {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: kernel {ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if case is TRAIN_CASE:
                records.append({
                    "name": name, "route": "cuda",
                    "source": "tchvp_tpu_torch/kernels/csrc/flash_bwd.cu",
                    "replaces": "tchvp_tpu/kernels/flash_attention.py:"
                                + ("374" if name == "flash_bwd_dq" else "403"),
                    "launches": bwd_launches[name], "max_abs_err": bwd_errs[name], "ms": ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": sdpa_ms,
                })
        pair_ms, pair_by = bound(7 * row_bytes + stats_bytes, 10 * bh * s * s * dh, dtype)
        print(f"[9 times] backward pair {(b, h, s, dh)} {str(dtype)[6:]}: dq + dk/dv "
              f"{times['flash_bwd_dq'] + times['flash_bwd_dkv']:.4f} ms, SDPA backward without dropout "
              f"({backend}) {sdpa_ms:.4f} ms, bound {pair_ms:.4f} ms ({pair_by})")
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
    phase_flagship_fp32()
    phase_flagship_grads()
    fwd_launches = phase_infer_main_path()
    bwd_launches = phase_train_main_path()
    records = phase_kernel_times(fwd_launches, fwd_err, bwd_launches, bwd_errs)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
