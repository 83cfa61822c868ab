"""The attention kernels and the fused decoder tail of two checkouts side by
side, on the card.

Run ``run`` from the root of each checkout (this file may live in another
one), then ``compare`` once::

    python3 attention_ab.py run TAG DIR       # outputs to DIR/TAG.pt, times to stdout
    python3 attention_ab.py compare DIR A B [C ...]   # bits of B, C, ... against A

``run`` imports the checkout's own ``chip_smoke`` and kernels. It launches
the flash forward at the inference and training shapes and at FCT's three
(``FWD_SHAPES``), the flash backward at the training and inference shapes
and at FCT's three (``chip_smoke.FCT_CASES``),
the banded forward and backward at config 2's and the windowed-training
shape, the halo forward and backward at both shard shapes (has_prev 1) and
the fused decoder tail at config 1's decode shape (bf16 (128, 112, 112,
384), the NHWC view of an NCHW tensor, on seeded weights), and saves every
output. Beside the band and halo backward it times SDPA's
backward with the band as its boolean mask (a yardstick, not saved: its
bits need not repeat). It prints each of these calls' times, by events
around 20 calls and on the device (a call longer than 50 ms, such as an
older checkout's CUDA-core backward at FCT's S 16384, once by events and not
on the device), then the host's time per call of ``mha``
at the inference shape on the transformer's ``_split_heads`` views under
``no_grad`` and of the pieces of its host path. The timers are those of
``card_timing.py`` beside this file, for both checkouts alike. An A/B in
one call runs parent, change, change, parent, so that the card's own drift
shows beside the change. Needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import functools
import os
import sys
from pathlib import Path

from card_timing import cuda_ms, device_ms, host_ms  # this checkout's, before the path changes

# The flash forward's shapes: (name, (B, H, S, Dh), dtype, scale, dropout, seed):
# config 1 inference, the training path, FCT's (tchvp_tpu/kernels/flash_attention.py:38-45).
FWD_SHAPES = (
    ("inf", (8, 8, 128, 392), "bfloat16", 1 / 56, 0.0, 0),
    ("train", (8, 8, 64, 512), "float32", 1 / 64, 0.1, 77),
    ("fct_16k_4", (2, 2, 16384, 4), "bfloat16", 4 ** -0.5, 0.0, 0),
    ("fct_4k_8", (2, 2, 4096, 8), "bfloat16", 8 ** -0.5, 0.1, 31),
    ("fct_4k_64", (2, 8, 4096, 64), "bfloat16", 64 ** -0.5, 0.0, 0),
)


def host_times(c, fa) -> None:
    """The host's time per call of mha at the inference shape and of the
    pieces of its path that the checkout has."""
    import torch

    b, h, s, dh = 8, 8, 128, 392
    scale, dev = 1 / 56, torch.device("cuda", torch.cuda.current_device())
    views = [t.view(b, s, h, dh).transpose(1, 2) for t in c.qkv((b, s, h * dh), torch.bfloat16, 17)]
    flat = [t.reshape(b * h, s, dh).contiguous() for t in views]
    tiny = c.qkv((1, 16, 8), torch.bfloat16, 3)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "mha on _split_heads views": lambda: fa.mha(*views, scale=scale),
        "_flash_fwd_cuda at BH 1, S 16, Dh 8": lambda: fa._flash_fwd_cuda(*tiny, 0.5, 0.0, 0),
        "_flat_inputs": lambda: fa._flat_inputs(*views, scale, 0.0, None),
        "_FlashAttention.apply on (BH, S, Dh)": lambda: fa._FlashAttention.apply(*flat, scale, 0.0, 0),
        "_check_inputs": lambda: fa._check_inputs(flat[0], None, q=flat[0], k=flat[1], v=flat[2]),
        "_seed_arg": lambda: fa._seed_arg(0, 0.0, dev),
        "two torch.empty": lambda: (torch.empty((b, s, h, dh), dtype=torch.bfloat16, device=dev),
                                    torch.empty((b * h, s), dtype=torch.float32, device=dev)),
        "torch.cuda.device(...)": device_ctx,
        "current_stream(...).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_kernel_lib lookup": lambda: fa._kernel_lib("flash_fwd"),
    }
    if hasattr(fa, "_check_flash_inputs"):
        pieces["_check_flash_inputs"] = lambda: fa._check_flash_inputs(*views)
        pieces["_cuda_stream"] = lambda: fa._cuda_stream(dev)
    with torch.no_grad():
        for name, fn in pieces.items():
            print(f"[ab host] {name}: {host_ms(fn) * 1e3:.2f} us per call")


def tail_call(c):
    """The fused tail at config 1's decode shape as phase 14 of the
    checkout's chip_smoke makes it, its output in a tuple."""
    import torch

    from tchvp_tpu_torch.kernels import fused_tail as ft
    from tchvp_tpu_torch.models.resnet_ae import Decoder32K
    from tchvp_tpu_torch.ops.blocks import init_flax_default

    decoder = c.seed_decoder(init_flax_default(Decoder32K(), torch.Generator().manual_seed(0)), 20)
    folded = ft.fold_tail_params(decoder.to("cuda", torch.bfloat16).eval())
    gen = torch.Generator(device="cuda").manual_seed(90)
    x = torch.randn((128, ft.CIN, 112, 112), generator=gen, device="cuda", dtype=torch.bfloat16)
    x = x.permute(0, 2, 3, 1)
    return lambda: (ft.fused_tail_cuda(x, folded),)


def run(tag: str, out_dir: Path) -> None:
    sys.path.insert(0, os.getcwd())  # the checkout under test, not this file's
    import torch

    import chip_smoke as c
    from tchvp_tpu_torch.kernels import flash_attention as fa

    c.phase_device()
    c.phase_build()
    outs, calls = {}, {}
    for i, (name, (b, h, s, dh), dtype, scale, rate, seed) in enumerate(FWD_SHAPES):
        q, k, v = c.qkv((b * h, s, dh), getattr(torch, dtype), seed=150 + i)
        seed_t = c.device_seed(seed)
        calls[f"flash_fwd_{name} {(b, h, s, dh)} {dtype} dropout {rate}"] = (
            f"flash_fwd_{name}", functools.partial(fa._flash_fwd_cuda, q, k, v, scale, rate, seed_t))
    for name, case in (("train", c.TRAIN_CASE), ("infer", c.INFER_BWD_CASE)):
        (b, h, s, dh), dtype, scale, rate, seed = case
        args = c.bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 30) + (scale, rate, c.device_seed(seed))
        calls[f"flash_bwd_{name} (dq, dk/dv) {(b, h, s, dh)}"] = (
            f"flash_bwd_{name}", functools.partial(fa._flash_bwd_cuda, *args))
    for i, ((b, h, s, dh), dtype, _, rate, seed) in enumerate(c.FCT_CASES):
        name = FWD_SHAPES[2 + i][0]
        scale = dh ** -0.5
        args = c.bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 130) + (scale, rate, c.device_seed(seed))
        calls[f"flash_bwd_{name} (dq, dk/dv) {(b, h, s, dh)} dropout {rate}"] = (
            f"flash_bwd_{name}", functools.partial(fa._flash_bwd_cuda, *args))
    yardsticks = {}

    def sdpa_bwd(q, k, v, do, mask, scale, b_, h_):
        """SDPA's backward with the boolean ``mask``, without dropout, on
        (B * H, S, Dh) tensors viewed as (B, H, S, Dh)."""
        q4, k4, v4 = (t.detach().view(b_, h_, *t.shape[1:]).requires_grad_() for t in (q, k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale)
        do4 = do.view(b_, h_, *do.shape[1:])
        return functools.partial(torch.autograd.grad, out4, (q4, k4, v4), do4, retain_graph=True)

    for name, case in (("c2", c.BAND_CONFIG2), ("wtrain", c.BAND_TRAIN)):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        q, k, v, do, lse, delta = c.bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 70, window=w)
        seed_t = c.device_seed(seed)
        yardsticks[f"SDPA backward, band mask, {name} (without dropout)"] = sdpa_bwd(
            q, k, v, do, fa.band_mask(s, w, q.device), scale, b, h)
        calls[f"band_fwd_{name} {(b, h, s, dh)} w {w}"] = (
            f"band_fwd_{name}", functools.partial(fa.band_fwd_cuda, q, k, v, scale, w, rate, seed_t))
        calls[f"band_bwd_{name} (dq, dk/dv)"] = (
            f"band_bwd_{name}", functools.partial(c.band_bwd, q, k, v, do, lse, delta, scale, w, rate, seed_t))
    prev = torch.ones(1, dtype=torch.int32, device="cuda")
    for name, case in (("c2s", c.HALO_CONFIG2), ("wts", c.HALO_TRAIN)):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        q, k, v, do, lse, delta = c.halo_inputs((b, h, s, dh), dtype, scale, w, rate, seed, 1, 110)
        seed_t = c.device_seed(seed)
        yardsticks[f"SDPA backward, halo band mask, {name} (without dropout)"] = sdpa_bwd(
            q, k, v, do, fa.halo_band_mask(s, w, 1, q.device), scale, b, h)
        calls[f"halo_fwd_{name} {(b * h, s, s + w, dh)}"] = (
            f"halo_fwd_{name}", functools.partial(fa.halo_fwd_cuda, q, k, v, scale, w, prev, rate, seed_t))
        calls[f"halo_bwd_{name} (dq, dk/dv)"] = (
            f"halo_bwd_{name}",
            functools.partial(c.halo_bwd, q, k, v, do, lse, delta, scale, w, prev, rate, seed_t))
    calls["fused_tail_c1 (128, 112, 112, 384) bf16 view"] = ("fused_tail_c1", tail_call(c))
    for key, fn in calls.values():
        outs[key] = fn()
    torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save({key: [t.cpu() for t in ts] for key, ts in outs.items()}, out_dir / f"{tag}.pt")
    del outs
    for label, (_, fn) in calls.items():
        once = cuda_ms(fn, 1)
        if once > 50:
            print(f"[ab {tag}] {label}: {once:.4f} ms (events, one call)")
        else:
            print(f"[ab {tag}] {label}: {cuda_ms(fn, 20):.4f} ms (events), {device_ms(fn):.4f} ms (device)")
    for label, fn in yardsticks.items():
        print(f"[ab {tag}] {label}: {cuda_ms(fn, 20):.4f} ms (events), {device_ms(fn):.4f} ms (device)")
    host_times(c, fa)


def compare(out_dir: Path, first: str, others) -> None:
    import torch

    want = torch.load(out_dir / f"{first}.pt")
    for tag in others:
        got = torch.load(out_dir / f"{tag}.pt")
        differ = [key for key in want if not all(torch.equal(x, y) for x, y in zip(want[key], got[key]))]
        print(f"[ab bits] {first} vs {tag}: {len(want) - len(differ)} of {len(want)} kernel outputs "
              f"equal bit for bit; differ: {differ}")
        for key in differ:
            ratio = max((x.float() - y.float()).abs().max().item() / x.float().abs().max().item()
                        for x, y in zip(want[key], got[key]))
            print(f"[ab bits] {first} vs {tag}: {key} max abs difference / max|{first}| {ratio:.4g}")


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "run":
        run(sys.argv[2], Path(sys.argv[3]))
    elif len(sys.argv) >= 5 and sys.argv[1] == "compare":
        compare(Path(sys.argv[2]), sys.argv[3], sys.argv[4:])
    else:
        raise SystemExit(__doc__)
