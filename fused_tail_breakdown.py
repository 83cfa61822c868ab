"""Where the fused tail kernel's time goes, on the card:
``python3 fused_tail_breakdown.py``.

Builds ``csrc/fused_tail.cu`` and variants of it (one ``nvcc`` each, in
parallel, into ``tchvp_tpu_torch/_build/breakdown/``), prints each one's
registers and spills, then times each in turns at config 1's decode shape:
bf16 (128, 112, 112, 384), the NHWC view of an NCHW tensor as on the decoder
path. The variants:

* ``kernel``: the source as it is (its output must equal the wrapper's);
* ``no_u_products`` / ``no_conv0_products``: the up-projection's or conv0's
  multiply-adds removed (their staging and epilogues kept);
* ``no_products``: both removed, leaving the staging, the epilogues, conv1
  and the head;
* ``plain_weight_loads``: w_up and w0 staged by plain loads in the K loop
  instead of ``cp.async`` one step ahead;
* ``batched_x_loads``: each K step's 18 x loads per thread issued together
  into registers before being stored.

A variant without products computes garbage; only its time is read. Needs a
CUDA device and ``nvcc``; there is no CPU path.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from card_timing import cuda_ms
from chip_smoke import seed_decoder
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import fused_tail as ft
from tchvp_tpu_torch.models.resnet_ae import Decoder32K
from tchvp_tpu_torch.ops.blocks import init_flax_default

U_PRODUCTS = "for (int j = 0; j < 8; ++j) accu[i][j] = fmaf(xv[i], wv[j], accu[i][j]);"
CONV0_PRODUCTS = """              acc0[r][j].x = fmaf(u, w.x, acc0[r][j].x);
              acc0[r][j].y = fmaf(u, w.y, acc0[r][j].y);
              acc0[r][j].z = fmaf(u, w.z, acc0[r][j].z);
              acc0[r][j].w = fmaf(u, w.w, acc0[r][j].w);"""
ASYNC_WEIGHTS = """      if (s + 1 < kSteps) stage_w_up(ws + ((s + 1) & 1) * kKC * 4 * kCC, w_up, s + 1, tid);
      if (k0 == 0) stage_w0(w0s, w0, ch, tid);
      cp_async_commit();
"""
PLAIN_WEIGHTS = """      for (int i = tid; i < kKC * 4 * kCC; i += kThreads) {
        const int c = i % kCC, ph = (i / kCC) % 4, k = i / (4 * kCC);
        ws[(s & 1) * kKC * 4 * kCC + i] = w_up[(k0 + k) * (4 * kC1) + ph * kC1 + ch * kCC + c];
      }
      if (k0 == 0)
        for (int i = tid; i < 9 * kCC * kC2; i += kThreads) {
          const int o = i % kC2, c = (i / kC2) % kCC, tap = i / (kC2 * kCC);
          w0s[i] = w0[(tap * kC1 + ch * kCC + c) * kC2 + o];
        }
"""
PROLOGUE = "  stage_w_up(ws, w_up, 0, tid);\n  cp_async_commit();\n"
WAIT = "      cp_async_wait<1>();"
X_LOOP = """      for (int i = tid; i < kKC * kInPix; i += kThreads) {
        const int k = sc == 1 ? i % kKC : i / kInPix;
        const int p = sc == 1 ? i / kKC : i % kInPix;
        const int gy = iy0 + p / kIn, gx = ix0 + p % kIn;
        xs[k * kInPix + p] = inside(gy, gx, in_h, in_w)
                                 ? to_f32(xb[gy * sh + gx * sw + (k0 + k) * sc])
                                 : 0.f;
      }
"""
X_BATCHED = """      float xr[kKC * kInPix / kThreads];
#pragma unroll
      for (int it = 0; it < kKC * kInPix / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int k = sc == 1 ? i % kKC : i / kInPix;
        const int p = sc == 1 ? i / kKC : i % kInPix;
        const int gy = iy0 + p / kIn, gx = ix0 + p % kIn;
        xr[it] = inside(gy, gx, in_h, in_w) ? to_f32(xb[gy * sh + gx * sw + (k0 + k) * sc]) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kKC * kInPix / kThreads; ++it) {
        const int i = tid + it * kThreads;
        xs[sc == 1 ? (i % kKC) * kInPix + i / kKC : i] = xr[it];
      }
"""


def _patch(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_tail.cu changed: cannot patch {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> Dict[str, str]:
    no_u = (U_PRODUCTS, "for (int j = 0; j < 8; ++j) accu[i][j] = accu[i][j];")
    no_c0 = (CONV0_PRODUCTS, "              (void)u; (void)w;")
    return {
        "kernel": src,
        "no_u_products": _patch(src, no_u),
        "no_conv0_products": _patch(src, no_c0),
        "no_products": _patch(src, no_u, no_c0),
        "plain_weight_loads": _patch(src, (ASYNC_WEIGHTS, PLAIN_WEIGHTS), (PROLOGUE, ""), (WAIT, "")),
        "batched_x_loads": _patch(src, (X_LOOP, X_BATCHED)),
    }


def _compile(name: str, source: str) -> ctypes.CDLL:
    out = build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(source)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log.splitlines() if "Used " in line})
    spills = sorted({int(line.split(" bytes spill stores")[0].split()[-1])
                     for line in log.splitlines() if "bytes spill stores" in line})
    print(f"[build] {name}: registers {regs}, spill-store bytes {spills}")
    return ctypes.CDLL(str(lib))


def main() -> None:
    if not torch.cuda.is_available():
        print("fused_tail_breakdown: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    srcs = variants((build.CSRC / "fused_tail.cu").read_text())
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(_compile, srcs, srcs.values())))
    for lib in libs.values():
        ft.bind(lib)

    decoder = seed_decoder(init_flax_default(Decoder32K(), torch.Generator().manual_seed(0)), 20)
    folded = ft.fold_tail_params(decoder.to("cuda", torch.bfloat16).eval())
    gen = torch.Generator(device="cuda").manual_seed(90)
    x = torch.randn((128, ft.CIN, 112, 112), generator=gen, device="cuda", dtype=torch.bfloat16)
    x = x.permute(0, 2, 3, 1)
    want = ft.fused_tail_cuda(x, folded)
    default_lib = ft._kernel_lib
    try:
        order = list(srcs) + ["kernel", "plain_weight_loads"]
        for name in order:
            ft._kernel_lib = lambda lib=libs[name]: lib
            got = ft.fused_tail_cuda(x, folded)
            if name == "kernel" and not torch.equal(got, want):
                raise RuntimeError("the breakdown's kernel differs from the wrapper's")
            ms = cuda_ms(lambda: ft.fused_tail_cuda(x, folded), 3)
            print(f"[time] {name}: {ms:.3f} ms")
    finally:
        ft._kernel_lib = default_lib


if __name__ == "__main__":
    main()
