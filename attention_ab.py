"""The attention kernels of two checkouts side by side, on the card.

Run ``run`` from the root of each checkout (this file may live in another
one), then ``compare`` once::

    python3 attention_ab.py run TAG DIR       # outputs to DIR/TAG.pt, times to stdout
    python3 attention_ab.py compare DIR A B [C ...]   # bits of B, C, ... against A

``run`` imports the checkout's own ``chip_smoke`` and kernels, launches the
flash forward and backward at the training and inference shapes, the banded
backward at config 2's and the windowed-training shape and the halo backward
at both shard shapes (has_prev 1), saves every output, and prints
``chip_smoke``'s phase-14 times of the flash, banded and halo kernels. An
A/B in one call runs parent, change, change, parent, so that the card's own
drift shows beside the change. Needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def run(tag: str, out_dir: Path) -> None:
    sys.path.insert(0, os.getcwd())  # the checkout under test, not this file's
    import torch

    import chip_smoke as c
    from tchvp_tpu_torch.kernels import flash_attention as fa

    c.phase_device()
    c.phase_build()
    outs = {}
    for name, case in (("train", c.TRAIN_CASE), ("infer", c.INFER_BWD_CASE)):
        (b, h, s, dh), dtype, scale, rate, seed = case
        q, k, v, do, lse, delta = c.bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 30)
        outs[f"flash_fwd_{name}"] = fa._flash_fwd_cuda(q, k, v, scale, rate, c.device_seed(seed))
        outs[f"flash_bwd_{name}"] = fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate,
                                                       c.device_seed(seed))
    for name, case in (("c2", c.BAND_CONFIG2), ("wtrain", c.BAND_TRAIN)):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        q, k, v, do, lse, delta = c.bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 70, window=w)
        outs[f"band_bwd_{name}"] = c.band_bwd(q, k, v, do, lse, delta, scale, w, rate, c.device_seed(seed))
    prev = torch.ones(1, dtype=torch.int32, device="cuda")
    for name, case in (("c2s", c.HALO_CONFIG2), ("wts", c.HALO_TRAIN)):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        q, k, v, do, lse, delta = c.halo_inputs((b, h, s, dh), dtype, scale, w, rate, seed, 1, 110)
        outs[f"halo_bwd_{name}"] = c.halo_bwd(q, k, v, do, lse, delta, scale, w, prev, rate,
                                              c.device_seed(seed))
    torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save({key: [t.cpu() for t in ts] for key, ts in outs.items()}, out_dir / f"{tag}.pt")
    del outs
    zeros = dict.fromkeys(("band_fwd", "band_bwd_dq", "band_bwd_dkv", "halo_fwd_launches",
                           "halo_dq_launches", "halo_dkv_launches", "halo_fwd", "halo_bwd_dq",
                           "halo_bwd_dkv", "flash_bwd_dq", "flash_bwd_dkv"), 0)
    print(f"[ab {tag}] times")
    c.time_flash(0, 0.0, zeros, zeros)
    c.time_band(zeros, zeros)
    c.time_halo(zeros, zeros)


def compare(out_dir: Path, first: str, others) -> None:
    import torch

    want = torch.load(out_dir / f"{first}.pt")
    for tag in others:
        got = torch.load(out_dir / f"{tag}.pt")
        differ = [key for key in want if not all(torch.equal(x, y) for x, y in zip(want[key], got[key]))]
        print(f"[ab bits] {first} vs {tag}: {len(want) - len(differ)} of {len(want)} kernel outputs "
              f"equal bit for bit; differ: {differ}")


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "run":
        run(sys.argv[2], Path(sys.argv[3]))
    elif len(sys.argv) >= 5 and sys.argv[1] == "compare":
        compare(Path(sys.argv[2]), sys.argv[3], sys.argv[4:])
    else:
        raise SystemExit(__doc__)
