"""Where the flash forward's time goes, on the card:
``python3 flash_fwd_breakdown.py [--baseline DIR]``.

Builds ``csrc/flash_fwd.cu`` and variants of it with one part taken out (one
``nvcc`` each, in parallel, into ``tchvp_tpu_torch/_build/flash_breakdown/``),
then times each on the device (``card_timing.device_ms``: 20 launches
queued behind a spin of the card, two turns) at the five shapes of
``attention_ab.FWD_SHAPES``: the inference and training paths and FCT's
three. The variants:

* ``kernel``: the source as it is (its output must equal the wrapper's);
* ``no_loads``: no copy of Q, K or V into shared memory;
* ``no_qk_products``: no Q K^T mma (the logits read one element of Q);
* ``no_exp``: the weights without their ex2 (the row maxima and sums kept);
* ``no_dropout_hash``: every weight kept, no hash (a dropout shape only);
* ``no_pv_products``: no P.V mma (the weights summed into the accumulator);
* ``baseline``: with ``--baseline DIR``, the ``flash_fwd.cu`` and headers of
  DIR (another version of the kernel, timed beside this one).

A variant without a part computes garbage; only its time is read. It
prints each variant's registers, spill stores and stack frame from ptxas.
Needs a CUDA device and ``nvcc``; there is no CPU path.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

from attention_ab import FWD_SHAPES
from card_timing import device_ms
from chip_smoke import device_seed, kernel_resources, qkv
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa

HEADERS = ("flash_common.cuh", "mma_common.cuh", "flash_tiles.cuh")  # those DIR has, with --baseline
# Each variant: (text of flash_fwd.cu, its replacement) pairs; each text must occur once.
VARIANTS = {
    "kernel": (),
    "no_loads": (("    if (i_tile < n_tiles) {\n", "    if (i_tile < 0) {\n"),),
    "no_qk_products": (("        qk_chunk<KC>(s_acc, q_s, k_s, lane);\n",
                        "        s_acc[0][0] += to_f32(q_s[lane]);\n"),
                       ("        qk_chunk<KC>(part, q_s, k_s, lane);\n",
                        "        part[0][0] = to_f32(q_s[lane]);\n")),
    "no_exp": (("        float w = fast_exp2(s_acc[j][e] - m[e >> 1]);\n",
                "        float w = s_acc[j][e] - m[e >> 1];\n"),),
    "no_dropout_hash": (("keep_hashed(row_h[e >> 1], k0 + 8 * j + 2 * t + (e & 1), threshold)",
                         "(row_h[e >> 1] != 7u)"),),
    "no_pv_products": (("    pv_tile<NT>(o_acc, s_acc, v_ring + (two_v ? kt & 1 : 0) * kFlashBlockK * SV, lane);\n",
                        "#pragma unroll\n    for (int j = 0; j < 8; ++j)\n#pragma unroll\n"
                        "      for (int e = 0; e < 4; ++e) o_acc[0][0] += s_acc[j][e];\n"),),
}
OUT = build.BUILD_DIR / "flash_breakdown"


def build_variant(name: str, baseline: Optional[Path]):
    """(library, ptxas log) of one variant."""
    src_dir = baseline if name == "baseline" else build.CSRC
    src = (src_dir / "flash_fwd.cu").read_text()
    for old, new in VARIANTS.get(name, ()):
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in flash_fwd.cu once: {old!r}")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in HEADERS:
        if (src_dir / header).exists():
            (d / header).write_text((src_dir / header).read_text())
    (d / "flash_fwd.cu").write_text(src)
    lib = d / "libflash_fwd.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "flash_fwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.tchvp_flash_fwd.argtypes = fa._LAUNCHERS["flash_fwd"]["tchvp_flash_fwd"]
    cdll.tchvp_flash_fwd.restype = ctypes.c_int
    return cdll, proc.stdout + proc.stderr


def main() -> None:
    if not torch.cuda.is_available():
        print("flash_fwd_breakdown: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    baseline = Path(sys.argv[sys.argv.index("--baseline") + 1]) if "--baseline" in sys.argv else None
    names = list(VARIANTS) + (["baseline"] if baseline else [])
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build_variant(n, baseline), names)))
    print(torch.cuda.get_device_name(0))
    for name, (_, log) in built.items():
        for kernel, (regs, spill, stack) in sorted(kernel_resources(log).items()):
            print(f"  {name:16s} {kernel[:60]}: {regs} registers, {spill} B spill stores, {stack} B stack frame")
    stream = torch.cuda.current_stream().cuda_stream
    print("device ms per launch (20 launches queued behind a spin of the card), two turns")
    for i, (shape_name, (b, h, s, dh), dtype, scale, rate, seed) in enumerate(FWD_SHAPES):
        q, k, v = qkv((b * h, s, dh), getattr(torch, dtype), seed=150 + i)
        out, lse = torch.empty_like(q), torch.empty((b * h, s), device="cuda")
        seed_t = device_seed(seed)
        strides = (0, s * dh, dh) * 4

        def launch(lib):
            err = lib.tchvp_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                      1, b * h, s, dh, *strides, int(q.dtype == torch.bfloat16), scale, rate,
                                      fa._drop_threshold(rate), seed_t.data_ptr() if rate else 0, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        want, _ = fa._flash_fwd_cuda(q, k, v, scale, rate, seed_t)
        launch(built["kernel"][0])
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"{shape_name}: the unchanged source does not give the wrapper's output")
        times: Dict[str, list] = {name: [] for name in names}
        for _ in range(2):
            for name in names:
                if name == "no_dropout_hash" and not rate:
                    continue
                times[name].append(device_ms(lambda: launch(built[name][0])))
        print(f"  {shape_name} {(b, h, s, dh)} {dtype} dropout {rate}: " + ", ".join(
            f"{name} {'/'.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items() if ts))
        del q, k, v, out, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
