"""Where the flash backward pair's time goes, on the card:
``python3 flash_bwd_breakdown.py``.

Builds ``csrc/flash_bwd.cu`` and variants of it with one part taken out (one
``nvcc`` each, in parallel, into ``tchvp_tpu_torch/_build/flash_bwd_breakdown/``),
then times the dq and the dk/dv kernel of each on the device
(``card_timing.device_ms``: 20 launches queued behind a spin of the card, two
turns) at the five shapes of ``attention_ab.FWD_SHAPES``: the inference and
training paths and FCT's three. The variants:

* ``kernel``: the source as it is (its gradients must equal the wrapper's);
* ``no_loads``: no copy of Q, dO, K or V into shared memory;
* ``no_qk_products``: no S or dP mma (each chunk reads one element of A);
* ``no_exp``: the weights without their ex2;
* ``no_dropout_hash``: every weight kept, no hash (a dropout shape only);
* ``no_second_products``: no dS K, P_drop^T dO or dS^T Q mma (the weights
  summed into the accumulator);
* ``groups_1``, ``groups_4``: where S <= 64 past Dh 64, one block (or 4)
  per batch-head taking the column blocks in turn, in place of SMs / BH;
* ``column_per_block``: one column block per block at every S, each
  recomputing the logits.

A variant without a part computes garbage; only its time is read. It prints
each variant's registers, spill stores and stack frame from ptxas. Needs a
CUDA device and ``nvcc``; there is no CPU path.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from attention_ab import FWD_SHAPES
from card_timing import device_ms
from chip_smoke import bwd_inputs, device_seed, kernel_resources
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa

HEADERS = ("flash_common.cuh", "mma_common.cuh", "flash_tiles.cuh")
FAKE_PV = """namespace tchvp {
template <int NT, typename T>
__device__ __forceinline__ void fake_pv(float (&acc)[NT][4], const float (&p)[8][4], const T*, int) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][0] += p[j][e];
}
"""
GROUPS = "  const int groups = imin(total, imax(1, sms / batch_heads));\n"
# Each variant: (text of flash_bwd.cu, its replacement, occurrences) triples.
VARIANTS = {
    "kernel": (),
    "no_loads": (("    if (i_tile < n_tiles) {\n", "    if (i_tile < 0) {\n", 2),),
    "no_qk_products": (("    qk_chunk<KC>(acc, a_s, b_s, lane);\n", "    acc[0][0] += to_f32(a_s[lane]);\n", 1),
                       ("    qk_chunk<KC>(part, a_s, b_s, lane);\n", "    part[0][0] = to_f32(a_s[lane]);\n", 1)),
    "no_exp": (("fast_exp2(s_acc[j][e] * scale_log2 - lse_log2[e >> 1])",
                "(s_acc[j][e] * scale_log2 - lse_log2[e >> 1])", 1),
               ("fast_exp2(s_acc[j][e] * scale_log2 - lse_s[buf + qc])",
                "(s_acc[j][e] * scale_log2 - lse_s[buf + qc])", 1)),
    "no_dropout_hash": (("keep_hashed(row_h[e >> 1], col, threshold)", "(row_h[e >> 1] != 7u)", 1),
                        ("keep_hashed(hash_s[buf + qc], key[e >> 1], threshold)", "(hash_s[buf + qc] != 7u)", 1)),
    "no_second_products": (("namespace tchvp {\n", FAKE_PV, 1), ("pv_tile<NT>(", "fake_pv<NT>(", 6)),
    "groups_1": ((GROUPS, "  const int groups = 1;\n", 1),),
    "groups_4": ((GROUPS, "  const int groups = imin(total, 4);\n", 1),),
    "column_per_block": (("  if (seq_len > kFlashBlockQ) return 1;\n", "  return 1;\n", 1),),
}
OUT = build.BUILD_DIR / "flash_bwd_breakdown"


def build_variant(name: str):
    """(library, ptxas log) of one variant."""
    src = (build.CSRC / "flash_bwd.cu").read_text()
    for old, new, count in VARIANTS[name]:
        if src.count(old) != count:
            raise RuntimeError(f"{name}: the text to replace is not in flash_bwd.cu {count} times: {old!r}")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in HEADERS:
        (d / header).write_text((build.CSRC / header).read_text())
    (d / "flash_bwd.cu").write_text(src)
    lib = d / "libflash_bwd.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "flash_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for fn, argtypes in fa._LAUNCHERS["flash_bwd"].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll, proc.stdout + proc.stderr


def main() -> None:
    if not torch.cuda.is_available():
        print("flash_bwd_breakdown: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    names = list(VARIANTS)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(build_variant, names)))
    print(torch.cuda.get_device_name(0))
    for name, (_, log) in built.items():
        for kernel, (regs, spill, stack) in sorted(kernel_resources(log).items()):
            print(f"  {name:18s} {kernel[:64]}: {regs} registers, {spill} B spill stores, {stack} B stack frame")
    stream = torch.cuda.current_stream().cuda_stream
    print("device ms per launch, dq + dk/dv (20 launches queued behind a spin of the card), two turns")
    for shape_name, (b, h, s, dh), dtype, scale, rate, seed in FWD_SHAPES:
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), getattr(torch, dtype), scale, rate, seed, 30)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        seed_t = device_seed(seed)
        strides = (0, s * dh, dh)

        def launch(lib, which):
            outs = (dq,) if which == "dq" else (dk, dv)
            err = getattr(lib, f"tchvp_flash_bwd_{which}")(
                *(t.data_ptr() for t in (q, k, v, do, lse, delta) + outs), 1, b * h, s, dh,
                *strides * (4 + len(outs)), int(q.dtype == torch.bfloat16), scale, rate,
                fa._drop_threshold(rate), seed_t.data_ptr() if rate else 0, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        want = fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate, seed_t)
        launch(built["kernel"][0], "dq")
        launch(built["kernel"][0], "dkv")
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), want)):
            raise RuntimeError(f"{shape_name}: the unchanged source does not give the wrapper's gradients")
        times: Dict[str, list] = {name: [] for name in names}
        for _ in range(2):
            for name in names:
                if (name == "no_dropout_hash" and not rate) or (name.startswith(("groups", "column")) and s > 64):
                    continue
                lib = built[name][0]
                times[name].append((device_ms(lambda: launch(lib, "dq")), device_ms(lambda: launch(lib, "dkv"))))
        print(f"  {shape_name} {(b, h, s, dh)} {dtype} dropout {rate}: " + ", ".join(
            f"{name} {'/'.join(f'{a:.4f}+{c:.4f}' for a, c in ts)}" for name, ts in times.items() if ts))
        del q, k, v, do, lse, delta, dq, dk, dv, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
