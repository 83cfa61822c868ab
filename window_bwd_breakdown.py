"""Where the banded backward's time goes, on the card:
``python3 window_bwd_breakdown.py``.

Builds ``csrc/band_attention.cu`` with ``csrc/window_bwd.cuh`` as it is and
in variants with one part taken out (one ``nvcc`` each, in parallel, into
``tchvp_tpu_torch/_build/window_bwd_breakdown/``), then times each of the
backward's three launches on the device (``card_timing.device_ms``) at
config 2's shape (BH 32, S 256, window 64, Dh 1152, bf16) and the windowed
training shape (BH 16, S 256, window 64, Dh 512, fp32, dropout 0.1):
pass A (P_drop and dS into the scratch), pass B's dq and pass B's dk/dv.
The variants:

* ``kernel``: the source as it is (its outputs must equal the wrappers');
* ``a_no_loads`` / ``a_no_products`` / ``a_no_hash`` / ``a_no_stores``:
  pass A without its Q, dO, K, V chunk copies, without its S and dP
  products, without the dropout hash, or without its scratch stores;
* ``b_no_loads`` / ``b_no_products``: both pass-B kernels without their
  copies (K and the dS tile; the scratch tiles, Q and dO), or without their
  products.

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
from chip_smoke import BAND_CONFIG2, BAND_TRAIN, bwd_inputs, device_seed
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa

# Each variant: a list of (text of window_bwd.cuh, its replacement); each text must occur once.
VARIANTS = {
    "kernel": [],
    "a_no_loads": [("    if (chunk < n_chunks) {\n      T* st = ring + (chunk % kStages) * kStage;",
                    "    if (chunk < 0) {\n      T* st = ring + (chunk % kStages) * kStage;")],
    "a_no_products": [
        ("      logits_chunk(s_acc, st + rows * S, st + 2 * kTile + keys * S, lane);\n"
         "      logits_chunk(dp_acc, st + kTile + rows * S, st + 3 * kTile + keys * S, lane);\n",
         "      s_acc[0][0] += to_f32(st[lane]);\n"),
        ("      float part[4][4];\n      zero_acc(part);\n"
         "      logits_chunk(part, st + rows * S, st + 2 * kTile + keys * S, lane);\n      add_acc(s_acc, part);\n"
         "      zero_acc(part);\n      logits_chunk(part, st + kTile + rows * S, st + 3 * kTile + keys * S, lane);\n"
         "      add_acc(dp_acc, part);\n",
         "      s_acc[0][0] += to_f32(st[lane]);\n")],
    "a_no_hash": [("  const bool dropout = p.dropout_rate > 0.f;", "  const bool dropout = false;")],
    "a_no_stores": [("      store_pair(ds_out + at + 8 * j, ds[0], ds[1]);\n"
                     "      store_pair(pd_out + at + 8 * j, pd[0], pd[1]);\n",
                     "      if (ds[0] == 12345.f) store_pair(ds_out + at + 8 * j, ds[1], pd[0] + pd[1]);\n")],
    "b_no_loads": [("    load_rows<T, kWbTile, D, SV, kWbThreadsB>(st, kb,",
                    "    if (tile < 0) load_rows<T, kWbTile, D, SV, kWbThreadsB>(st, kb,"),
                   ("    load_rows<T, kWbTile, kWbTile, SP, kWbThreadsB>(st + kWbTile * SV, ds_in,",
                    "    if (tile < 0) load_rows<T, kWbTile, kWbTile, SP, kWbThreadsB>(st + kWbTile * SV, ds_in,"),
                   ("    if (c >= 0) {\n      T* st = ring + (i & 1) * kStage;",
                    "    if (c < -1) {\n      T* st = ring + (i & 1) * kStage;")],
    "b_no_products": [("    dq_tile<D, SP, SV>(acc, st + kWbTile * SV + warp * 16 * SP, st, lane);\n",
                       "    acc[0][0] += to_f32(st[lane]);\n"),
                      ("      dkv_tile<D, SP, SV>(dk, dv, st, st + kWbTile * SP, st + 2 * kWbTile * SP,\n"
                       "                          st + 2 * kWbTile * SP + kWbTile * SV, warp * 16, lane);\n",
                       "      dk[0][0] += to_f32(st[lane]);\n")],
}
OUT = build.BUILD_DIR / "window_bwd_breakdown"


def build_variant(name: str) -> ctypes.CDLL:
    src = (build.CSRC / "window_bwd.cuh").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in window_bwd.cuh once:\n{old}")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for path in build.CSRC.glob("*.cuh"):
        (d / path.name).write_text(path.read_text())
    (d / "window_bwd.cuh").write_text(src)
    (d / "band_attention.cu").write_text((build.CSRC / "band_attention.cu").read_text())
    lib = d / "libband.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "band_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for fn, argtypes in fa._LAUNCHERS["band_attention"].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def main() -> None:
    if not torch.cuda.is_available():
        print("window_bwd_breakdown: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs: Dict[str, ctypes.CDLL] = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    stream = torch.cuda.current_stream().cuda_stream
    print(f"{torch.cuda.get_device_name(0)}; the banded backward's launches, device ms per launch (20 launches "
          "queued behind a spin of the card)")
    for tag, case in (("c2", BAND_CONFIG2), ("wtrain", BAND_TRAIN)):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 70, window=w)
        seed_t = device_seed(seed)
        plan = fa.window_bwd_plan(s, w, False)
        scratch = torch.empty((2, b * h, s, plan.scratch_cols), dtype=dtype, device="cuda")
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ints = (b * h, s, dh, w, *plan, int(dtype == torch.bfloat16))

        def launch(lib, which):
            if which == "A":
                err = lib.tchvp_band_bwd_ds(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                            delta.data_ptr(), scratch.data_ptr(), *ints, scale, rate,
                                            fa._drop_threshold(rate), seed_t.data_ptr(), stream)
            elif which == "dq":
                err = lib.tchvp_band_bwd_dq(scratch.data_ptr(), k.data_ptr(), dq.data_ptr(), *ints, stream)
            else:
                err = lib.tchvp_band_bwd_dkv(scratch.data_ptr(), q.data_ptr(), do.data_ptr(), dk.data_ptr(),
                                             dv.data_ptr(), *ints, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        want = fa.band_bwd_ds_cuda(q, k, v, do, lse, delta, scale, w, rate, seed_t)
        want_g = (fa.band_bwd_dq_cuda(want, k, w),) + fa.band_bwd_dkv_cuda(want, q, do, w)
        for which in ("A", "dq", "dkv"):
            launch(libs["kernel"], which)
        torch.cuda.synchronize()
        if not (torch.equal(scratch, want) and all(torch.equal(x, y) for x, y in zip((dq, dk, dv), want_g))):
            raise RuntimeError(f"{tag}: the unchanged source does not give the wrappers' outputs")
        print(f"{tag} {(b * h, s, dh)} {str(dtype)[6:]} window {w} dropout {rate} (scratch {tuple(scratch.shape)}):")
        for turn in range(2):  # two turns, to see the spread
            for name, lib in libs.items():
                times = []
                for which in ("A", "dq", "dkv"):
                    launch(libs["kernel"], "A")  # pass B reads a scratch of the unchanged pass A
                    times.append(device_ms(lambda: launch(lib, which)))
                print(f"  turn {turn} {name:14s} pass A {times[0]:.4f}  dq {times[1]:.4f}  dk/dv {times[2]:.4f}  "
                      f"sum {sum(times):.4f}")
        del q, k, v, do, lse, delta, scratch, dq, dk, dv, want, want_g
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
