"""Phase 18's FCT forward (a) and segment step (d) of ``chip_smoke.py``, and
the host's time per call of the attention forward, from several checkouts
side by side on the card.

    python3 phase_ab.py TAG=DIR [TAG=DIR ...]

Each ``TAG=DIR`` runs in its own process from the root of checkout ``DIR``
(this file may live in another one), in the order given, so an A/B reads
``parent=P change=C change=C parent=P`` and the card's drift shows beside
the change. A run imports the checkout's own ``chip_smoke`` and kernels:
it builds them, runs ``phase_fct_forward`` and ``phase_fct_step``, then
times on the host ``mha`` on ``_split_heads`` views under no_grad at config
1's inference shape and ``_flash_fwd`` at BH 1, S 16, Dh 8 (the least of
5 turns of 200 calls on an idle card, ``card_timing.host_ms`` of the
checkout). It prints each run's lines under ``[ab TAG]`` and then one
table: (a)'s ms per forward, its profile's wall, device busy and idle
share, (d)'s step ms, and the two host times.

    python3 phase_ab.py --dispatch

times, in one process from this checkout, (a)'s forward and (d)'s step
with the attention forward through the ``tchvp::flash_fwd`` operator and
with ``_flash_fwd_cuda`` called directly (the path before the operator),
in turns over 4 rounds, so that the host's drift between processes does
not enter. Needs a CUDA device.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

RUN = r"""
import torch
import chip_smoke as c
from card_timing import host_ms
from tchvp_tpu_torch.kernels import flash_attention as fa
c.phase_device()
c.phase_build()
c.phase_fct_forward()
c.phase_fct_step()
b, h, s, dh = 8, 8, 128, 392
views = [t.view(b, s, h, dh).transpose(1, 2) for t in c.qkv((b, s, h * dh), torch.bfloat16, 17)]
tiny = c.qkv((1, 16, 8), torch.bfloat16, 3)
with torch.no_grad():
    print(f"[ab host] mha {host_ms(lambda: fa.mha(*views, scale=1 / 56)) * 1e3:.2f} us per call")
    print(f"[ab host] _flash_fwd {host_ms(lambda: fa._flash_fwd(*tiny, 0.5)) * 1e3:.2f} us per call")
"""

DISPATCH = r"""
import torch
import chip_smoke as c
from tchvp_tpu_torch.kernels import flash_attention as fa
c.phase_device()
c.phase_build()
via_op = fa._flash_fwd


def direct(q, k, v, scale, dropout_rate=0.0, seed=0):
    fa.dispatch_trace.record("flash_mha_cuda")
    return fa._flash_fwd_cuda(q, k, v, scale, dropout_rate, seed)


images_u8 = c.fct_batches(2, 1, 50)[0][0]
fwd_model = c.fct_model(compute_dtype=torch.bfloat16).eval()


def forward(_s, _b):
    with torch.inference_mode():
        return fwd_model(c.pipeline.preprocess_images(images_u8, c.FCT_SIZE))


model = c.fct_model()
state = c.create_train_state(model, c.make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0), rng=0)
step = c.make_segmentation_train_step(c.FCT_SIZE)
batches = c.fct_batches(8, 2, 53)
times = {"operator": ([], []), "direct": ([], [])}
for rnd in range(4):
    order = ("operator", "direct") if rnd % 2 == 0 else ("direct", "operator")
    for name in order:
        fa._flash_fwd = via_op if name == "operator" else direct
        c.reset_counts()
        step(state, batches[0])
        forward(None, None)
        torch.cuda.synchronize()
        c.check(c.counts()["launches"] == 2 * c.FCT_FLASH, f"{name}: {c.counts()}")
        f_ms, f_spread = c.fct_step_ms(forward, None, [None] * 10)
        s_ms, s_spread = c.fct_step_ms(step, state, batches)
        times[name][0].append(f_ms)
        times[name][1].append(s_ms)
        print(f"[ab dispatch] round {rnd} {name}: (a) forward {f_ms:.3f} ms (spread {f_spread:.2f}%), "
              f"(d) step {s_ms:.2f} ms (spread {s_spread:.2f}%)", flush=True)
for name, (f, s) in times.items():
    print(f"[ab dispatch] {name}: (a) forward median {sorted(f)[1]:.3f}-{sorted(f)[2]:.3f} ms, "
          f"(d) step median {sorted(s)[1]:.2f}-{sorted(s)[2]:.2f} ms over 4 rounds")
"""

PATTERNS = {
    "(a) ms": r"\[18 FCT \(a\) forward\] .*?; ([0-9.]+) ms per forward",
    "(a) wall ms": r"\[18 FCT \(a\) forward profile\] wall ([0-9.]+) ms",
    "(a) busy ms": r"\[18 FCT \(a\) forward profile\] .*device busy ([0-9.]+) ms",
    "(a) idle %": r"\[18 FCT \(a\) forward profile\] .*idle share ([0-9.]+)%",
    "(d) step ms": r"\[18 FCT \(d\) step\] .*; step ([0-9.]+) ms",
    "mha host us": r"\[ab host\] mha ([0-9.]+) us",
    "_flash_fwd host us": r"\[ab host\] _flash_fwd ([0-9.]+) us",
}


def main(pairs) -> int:
    rows = []
    for pair in pairs:
        tag, _, root = pair.partition("=")
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=Path(root).resolve(), capture_output=True,
                              text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith(("[18 FCT (a)", "[18 FCT (d) step]", "[ab host]", "[1 device]", "NVIDIA")):
                print(f"[ab {tag}] {line}", flush=True)
        if proc.returncode != 0:
            print(f"[ab {tag}] exit {proc.returncode}\n{proc.stderr[-4000:]}", flush=True)
            return 1
        found = {k: re.search(p, proc.stdout) for k, p in PATTERNS.items()}
        rows.append((tag, {k: m.group(1) if m else "?" for k, m in found.items()}))
    print("tag | " + " | ".join(PATTERNS))
    for tag, vals in rows:
        print(f"{tag} | " + " | ".join(vals[k] for k in PATTERNS))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dispatch"]:
        sys.exit(subprocess.run([sys.executable, "-c", DISPATCH], cwd=Path(__file__).resolve().parent).returncode)
    if len(sys.argv) < 2 or any("=" not in a for a in sys.argv[1:]):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
