"""Where the fused tail kernel's time and its bf16 error go, on the card:
``python3 fused_tail_breakdown.py [--baseline DIR]`` and
``python3 fused_tail_breakdown.py --rounding``.

Builds ``csrc/fused_tail.cu`` and variants of it with one part taken out (one
``nvcc`` each, in parallel, into ``tchvp_tpu_torch/_build/tail_breakdown/``),
prints each one's registers, spill stores and stack frame from ptxas, then
times each on the device (``card_timing.device_ms``: 20 launches queued
behind a spin of the card, two turns) at config 1's decode shape, bf16
(128, 112, 112, 384): the NHWC view of an NCHW tensor as on the decoder path
(``view``, pixel pairs staged into a channel-major tile), and the same
values contiguous (``nhwc``, 16-byte copies of channels). The variants:

* ``kernel``: the source as it is (its output must equal the wrapper's);
* ``no_u_products``: no up-projection mma (its fragments still loaded);
* ``no_conv0_products``: no conv0 mma (its fragments still loaded);
* ``no_products``: neither;
* ``no_waits``: no ``cp.async`` wait before a stage (the barrier kept);
* ``no_epilogue_stores``: no store of u, a0 or a1 to shared memory (the
  values still computed);
* ``baseline``: with ``--baseline DIR``, the ``fused_tail.cu`` and headers of
  DIR, another version of the kernel with this one's C interface and weight
  layouts, timed beside this one.

A variant without a part computes garbage; only its time is read.

``--rounding``: on the bodies of chip_smoke phase 5b's bf16 decoder-path
cases (config 1, config 2's group), the plain chain (``tail_chain``) with
each set of the intermediates u, a0, a1 rounded to bf16, on the folded
weights in fp32 and rounded to bf16, against the fp32 cuDNN chain: the
max abs error over max|ref| that each rounding costs. Needs a CUDA device
(and ``nvcc`` for the variants); there is no CPU path.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

import chip_smoke as c
from card_timing import device_ms
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import fused_tail as ft
from tchvp_tpu_torch.models.resnet_ae import Decoder32K
from tchvp_tpu_torch.ops.blocks import init_flax_default

OUT = build.BUILD_DIR / "tail_breakdown"
HEADERS = ("flash_common.cuh", "mma_common.cuh")
U_MMA = "mma<T>(accu[mi][ni], af[mi & 1], bf[ni]);"
C0_MMA = ("mma<T>(acc0[mi][ni], af[mi & 1], bf[ni]);", "if (ni == warp) mma<T>(accx, af[mi & 1], bf[ni]);")
STORES = ("store_pair(us + ", "store_pair(a0s + ", "store_pair(a1s + ")
# Each variant: (text of fused_tail.cu, its replacement) pairs; each text must occur once.
VARIANTS = {
    "kernel": (),
    "no_u_products": ((U_MMA, "(void)af;"),),
    "no_conv0_products": ((C0_MMA[0], "(void)af;"), (C0_MMA[1], "(void)af;")),
    "no_products": ((U_MMA, "(void)af;"), (C0_MMA[0], "(void)af;"), (C0_MMA[1], "(void)af;")),
    "no_waits": (("    cp_async_wait<kRing - 2>();\n", ""),),
    "no_epilogue_stores": tuple((s, "if (p.sigmoid > 1) " + s) for s in STORES),
}


def build_variant(name: str, baseline: Optional[Path]):
    """(library, ptxas log) of one variant."""
    src_dir = baseline if name == "baseline" else build.CSRC
    src = (src_dir / "fused_tail.cu").read_text()
    for old, new in VARIANTS.get(name, ()):
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in fused_tail.cu once: {old!r}")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in HEADERS:
        (d / header).write_text((src_dir / header).read_text())
    (d / "fused_tail.cu").write_text(src)
    lib = d / "libfused_tail.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "fused_tail.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return ft.bind(ctypes.CDLL(str(lib))), proc.stdout + proc.stderr


def rounding() -> None:
    """The plain chain's distance from the fp32 chain on the decoder path,
    for each set of intermediates rounded to bf16."""
    from tchvp_tpu_torch.bench import random_clip
    from tchvp_tpu_torch.data.pipeline import preprocess_clip

    subsets = ((), ("u",), ("a0",), ("a1",), ("u", "a0"), ("u", "a1"), ("a0", "a1"), ("u", "a0", "a1"))
    for tag, size, batch, frames, window, dtype, _ in c.DECODER_CASES:
        if dtype != torch.bfloat16:
            continue
        model = c.decoder_model(size, window, dtype)
        clip = preprocess_clip(random_clip(batch, frames, size, seed=5), size, dtype=dtype)
        body = c.decoder_body(model, clip)
        exact = c.fp32_tail(model.decoder, body)
        scale = exact.abs().max().item()
        folded = ft.fold_tail_params(model.decoder)
        torch.backends.cudnn.allow_tf32 = False  # the plain chain's convs and matmul in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        for weights in (torch.float32, torch.bfloat16):
            packed = ft.pack_tail_weights(folded, weights)
            line = []
            for stages in subsets:
                with torch.inference_mode():
                    out = torch.cat([ft.tail_chain(part.permute(0, 2, 3, 1), packed, model.config.output_type,
                                                   torch.bfloat16, stages) for part in body.split(32)])
                line.append(f"{'+'.join(stages) or 'none'} {(out.float() - exact).abs().max().item() / scale:.4g}")
                del out
            print(f"  {tag}: folded weights in {str(weights)[6:]}, rounded to bf16: " + ", ".join(line))
        torch.backends.cudnn.allow_tf32 = True
        del model, clip, body, exact
        c.free_cuda()


def main() -> None:
    if not torch.cuda.is_available():
        print("fused_tail_breakdown: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if "--rounding" in sys.argv:
        print("max abs error / max|ref| against the fp32 cuDNN chain (TF32 off), by the intermediates rounded")
        rounding()
        return
    baseline = Path(sys.argv[sys.argv.index("--baseline") + 1]) if "--baseline" in sys.argv else None
    names = list(VARIANTS) + (["baseline"] if baseline else [])
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build_variant(n, baseline), names)))
    for name, (_, log) in built.items():
        for kernel, (regs, spill, stack) in sorted(c.kernel_resources(log).items()):
            print(f"  {name:18s} {kernel}: {regs} registers, {spill} B spill stores, {stack} B stack frame")

    decoder = c.seed_decoder(init_flax_default(Decoder32K(), torch.Generator().manual_seed(0)), 20)
    folded = ft.fold_tail_params(decoder.to("cuda", torch.bfloat16).eval())
    gen = torch.Generator(device="cuda").manual_seed(90)
    view = torch.randn((128, ft.CIN, 112, 112), generator=gen, device="cuda", dtype=torch.bfloat16)
    view = view.permute(0, 2, 3, 1)
    inputs = {"view": view, "nhwc": view.contiguous()}
    default_lib = ft._kernel_lib
    print("device ms per launch (20 launches queued behind a spin of the card), two turns")
    try:
        for layout, x in inputs.items():
            ft._kernel_lib = default_lib
            want = ft.fused_tail_cuda(x, folded)
            times: Dict[str, list] = {name: [] for name in names}
            for turn in range(2):
                for name in names:
                    ft._kernel_lib = lambda lib=built[name][0]: lib
                    if turn == 0 and name == "kernel" and not torch.equal(ft.fused_tail_cuda(x, folded), want):
                        raise RuntimeError("the unchanged source does not give the wrapper's output")
                    times[name].append(device_ms(lambda: ft.fused_tail_cuda(x, folded)))
            print(f"  c1 {layout} {tuple(x.shape)} bf16: " + ", ".join(
                f"{name} {'/'.join(f'{t:.3f}' for t in ts)}" for name, ts in times.items()))
    finally:
        ft._kernel_lib = default_lib


if __name__ == "__main__":
    main()
