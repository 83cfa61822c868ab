"""Where the banded forward's time goes, on the card:
``python3 window_fwd_breakdown.py``.

Builds the two passes of ``csrc/window_fwd.cuh`` behind a launcher of its
own that runs one pass of the banded forward (bf16) at a time, and variants
of them with one part taken out (one ``nvcc`` each, in parallel, into
``tchvp_tpu_torch/_build/window_breakdown/``), then times each pass of each
on the device (``card_timing.device_ms``) at config 2's shape: BH 32, S
256, window 64, Dh 1152, bf16. The variants:

* ``kernel``: the source as it is (its output must equal the wrapper's);
* ``no_qk_loads`` / ``no_qk_products``: the logits pass without its Q and K
  chunk copies, or without its products;
* ``no_v_loads`` / ``no_logits_loads``: the P.V pass without its V block
  copies, or without its logits tile copies;
* ``no_pv_products``: the P.V pass without its mma (the ldmatrix kept);
* ``no_out_stores``: the P.V pass without its 16-byte output stores.

A variant without a part computes garbage; only its time is read. Needs a
CUDA device and ``nvcc``; there is no CPU path.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from card_timing import device_ms
from chip_smoke import BAND_CONFIG2, qkv
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa

LAUNCHER = """#include "window_fwd.cuh"
// Pass `pass` (1 logits, 2 P.V) of the bf16 banded forward, dropout off.
extern "C" int band_fwd_pass(const void* q, const void* k, const void* v, void* out, void* lse,
                             void* scratch, int bh, int s, int dh, int w, int span_cols,
                             int scratch_cols, float scale, void* stream, int pass) {
  const tchvp::WindowArgs a{q, k, v, out, lse, scratch, bh, s, dh, w, span_cols, scratch_cols,
                            scale, 0.f, 0u, nullptr, nullptr, static_cast<cudaStream_t>(stream)};
  return (int)(pass == 1 ? tchvp::launch_window_logits<__nv_bfloat16, tchvp::kBand>(a)
                         : tchvp::launch_window_pv<__nv_bfloat16, tchvp::kBand>(a));
}
"""
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P, _I]
# Each variant: (text of window_fwd.cuh, its replacement); the text must occur once.
QK_LOADS = "    if (chunk < n_chunks) {\n      T* st = ring"
VARIANTS = {
    "kernel": None,
    "no_qk_loads": (QK_LOADS, "    if (chunk < 0) {\n      T* st = ring"),
    "no_qk_products": ("    logits_chunk(part, st + rows * S, st + (kWinBlockQ + keys) * S, lane);\n",
                       "    part[0][0] = (float)st[lane];\n"),
    "no_v_loads": ("    load_tile<T, kWinBlockK, kWinBlockD, kWinStrideV, kWinThreads>(v_s + stage * kVStage, vb,",
                   "    if (tile < 0) load_tile<T, kWinBlockK, kWinBlockD, kWinStrideV, kWinThreads>("
                   "v_s + stage * kVStage, vb,"),
    "no_logits_loads": ("    load_logits_tile(p_s + stage * kPStage,",
                        "    if (tile < 0) load_logits_tile(p_s + stage * kPStage,"),
    "no_pv_products": ("      mma_bf16(acc[2 * jj], a, b);\n      mma_bf16(acc[2 * jj + 1], a, b + 2);\n",
                       "      acc[2 * jj][0] += __uint_as_float(a[0] ^ b[0] ^ b[2]);\n"),
    "no_out_stores": ("      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);\n",
                      "      if (src[0] == from_f32<T>(12345.f)) dst[0] = src[1];\n"),
}
OUT = build.BUILD_DIR / "window_breakdown"


def build_variant(name: str) -> ctypes.CDLL:
    src = (build.CSRC / "window_fwd.cuh").read_text()
    if VARIANTS[name] is not None:
        old, new = VARIANTS[name]
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in window_fwd.cuh once")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in ("flash_common.cuh", "mma_common.cuh"):
        (d / header).write_text((build.CSRC / header).read_text())
    (d / "window_fwd.cuh").write_text(src)
    (d / "launcher.cu").write_text(LAUNCHER)
    lib = d / "libwindow.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "launcher.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.band_fwd_pass.argtypes = ARGTYPES
    cdll.band_fwd_pass.restype = ctypes.c_int
    return cdll


def main() -> None:
    if not torch.cuda.is_available():
        print("window_fwd_breakdown: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs: Dict[str, ctypes.CDLL] = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    (b, h, s, dh), dtype, scale, w, _, _ = BAND_CONFIG2
    q, k, v = qkv((b * h, s, dh), dtype, seed=3)
    plan = fa.window_plan(s, w, False)
    out, lse = torch.empty_like(q), torch.empty((b * h, s), device="cuda")
    scratch = torch.empty((b * h, s, plan.scratch_cols), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, pass_):
        err = lib.band_fwd_pass(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                scratch.data_ptr(), b * h, s, dh, w, plan.span_cols, plan.scratch_cols,
                                scale, stream, pass_)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    want, _ = fa.band_fwd_cuda(q, k, v, scale, w, 0.0, 0)
    launch(libs["kernel"], 1)
    launch(libs["kernel"], 2)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise RuntimeError("the unchanged source does not give the wrapper's output")
    print(f"{torch.cuda.get_device_name(0)}; config 2's band forward {(b * h, s, dh)} bf16 window {w}; "
          "device ms per launch (20 launches queued behind a spin of the card)")
    for _ in range(2):  # two turns, to see the spread
        for name, lib in libs.items():
            a_ms = device_ms(lambda: launch(lib, 1))
            launch(lib, 1)
            b_ms = device_ms(lambda: launch(lib, 2))
            print(f"  {name:16s} logits pass {a_ms:.4f}  P.V pass {b_ms:.4f}")


if __name__ == "__main__":
    main()
