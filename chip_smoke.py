#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, one or more lines each:
 1. device: the card's name and power limit (nvidia-smi) and torch's name;
 2. build: compiles the flash-attention forward, the flash backward, the
    banded-attention, the halo-attention and the fused decoder tail
    libraries from the sources in this checkout (one nvcc each, in
    parallel) and prints the seconds, the registers per kernel and the
    spill stores, and each tensor-core kernel's own (the flash forward's
    and backward's per (KC, NT) tiling, the window forwards' and
    backward's per pass);
 3. forward kernel vs plain: out and lse against the plain PyTorch version
    on the card, fp32 max abs 1e-4; bf16 against the fp32 plain version on
    the same bf16-rounded inputs, out max abs 1e-2 x max|ref| and lse 1e-4;
    each limit must sit 10 times below what the plain version reads with V
    one key row off; bits equal on repeat; the dropout seed is a (1,) int32
    device tensor. The main path's shapes, Dh 8 over S 4099 and Dh 64 with
    dropout, FCT's (2, 2, 16384, 4), (2, 2, 4096, 8) with dropout 0.1 and
    (2, 8, 4096, 64) in bf16, and over ragged S the narrower loads: Dh 98
    fp32 (8-byte copies), Dh 7 and 99 bf16 (element loads and stores); q,
    k, v one element past a 16-byte boundary (bf16 with dropout, fp32):
    within the limits and bit-equal to the aligned inputs'; then q, k, v as
    ``_split_heads`` views of (B, S, D) tokens with out into a (B, S, H,
    Dh) buffer (the inference and training shapes, Dh 8 and Dh 98): within
    the limits, bits equal to the launch on contiguous copies, and
    ``mha``'s merged heads a view of the kernel's buffer;
 4. backward kernels vs plain: dq, dk, dv of the tensor-core dq and dk/dv
    kernels against ``mha_bwd_reference`` on phase 3's main-path cases, the
    training shape, FCT's three shapes, the narrower loads (Dh 98 fp32,
    Dh 7 and 99 bf16) and one-tile sequences whose blocks take several
    head-dim column blocks in turn (S 50 Dh 520 bf16, S 37 Dh 98 fp32), max abs <= 1e-4 (fp32) or 1.5e-2 (bf16) x
    max|reference|, each limit 10 times below what the plain version reads
    with K one key row off; a second launch must give the same bits; then
    q, k, v, do one element past a 16-byte boundary (within the limits,
    bit-equal to the aligned inputs'), and ``_split_heads`` views of (B, S,
    D) tokens with the gradients into (B, S, H, Dh) buffers: bit-equal to
    the launch on contiguous copies, and ``mha``'s autograd gradients the
    kernels' views, bit-equal to a direct launch on its residuals;
 5. banded kernels vs plain: the forward (two tensor-core passes) and the
    backward (three tensor-core launches: pass A's P_drop and dS scratch,
    pass B's dq and dk/dv) of ``csrc/band_attention.cu`` against the
    windowed plain versions at config 2's shape (bf16, Dh 1152), the
    windowed training shape (fp32, dropout 0.1), a ragged S, a window that
    16 does not divide, a span wider than a tile (w 200 at S 256, Dh 1152,
    bf16, dropout 0.1), head dims whose rows are not a multiple of 16
    bytes (Dh 100 bf16, Dh 98 fp32: element loads and stores), and one
    window (w >= S), where the forward and the backward equal the flash
    kernels within the fp32 limits (1e-4, and 1e-4 x max|grad|); the
    forward at 2e-2 (bf16) and 1e-4; the backward at phase 4's limits
    (1.5e-2 x max|ref| in bf16, 1e-4 in fp32), each pass against its own
    plain version (pass B on the kernel's own scratch) and dq, dk, dv
    against the windowed plain versions, each limit 10 times below what
    they read with K one key row off; bits equal on repeat; the forward
    and the backward on q, k, v (and do) one element past a 16-byte
    boundary (element loads) against plain and bit-equal to the aligned
    inputs' (fp32 and bf16);
5c. halo kernels vs plain: the forward, dq and dk/dv kernels of
    ``csrc/halo_attention.cu`` (one shard of sequence-parallel windowed
    attention: k and v carry the left neighbour's last window) against
    their plain versions at the windowed-training shard (BH 16, S 128,
    k_ext 192, Dh 512, fp32, dropout 0.1), the config-2 shard (BH 32, S
    128, k_ext 192, Dh 1152, bf16), a ragged case (S 72, w 24), a span
    wider than a tile (S 200, w 200, k_ext 400, Dh 1152, bf16) and Dh 100
    bf16 and 98 fp32, each with has_prev 0 and 1: phase 5's limits and
    checks, bits equal on repeat; the misaligned forward and backward as
    in phase 5; with has_prev 0 against the banded kernels on the local
    sequence, the backward's dq, dk, dv bit for bit; and a
    one-process emulation of n = 2 and 4 shards (halos cut from the
    neighbours, dk/dv assembled from dk_ext[w:] and the next shard's
    dk_ext[:w]) against windowed_mha over the whole sequence;
5d. head dims past 1280 (images 416, 512 and 768: Dh 1352, 2048, 4608): all
    attention kernels (flash, band, halo: forward and backward) against
    their plain versions on small shapes, fp32 with dropout 0.1 and bf16
    without, at phase 5's limits (the band and halo backward with phase
    5's checks), bits equal on repeat;
5b. fused decoder tail (``csrc/fused_tail.cu``, on the tensor cores, off
    the default path): (a) the kernel against ``fused_tail_reference``
    on the weights folded from a Decoder32K with seeded BN, at (2, 8, 8),
    (1, 9, 9), (1, 16, 24) and (2, 56, 56) x 384, both heads: fp32 with TF32
    off, max abs <= 1e-4 x max|ref|; bf16 against the fp32 plain version on
    the same bf16-rounded inputs and weights, <= 2e-2 x max|ref|, printed
    beside the plain chain with u rounded to bf16 as the kernel stores it
    (``tail_chain``); each limit must sit 10 times below what
    the plain version reads with x one input row off; bits equal on repeat
    and for the NHWC view of an NCHW input; unsupported dtype or widths
    raise. (b) the decoder path: flagship tokens from one forward, then
    ``decoder.body`` + ``fused_decoder_tail`` on the NHWC view of the body's
    output against the fp32 cuDNN chain (TF32 off) on the same body: config
    1 bf16 B=8 T=16 <= 2e-2 x max|ref|, fp32 B=1 T=16 with TF32 off <= 1e-3
    x max|ref|, config 2's group (384^2, 4 clips of 32 frames) bf16 <= 2e-2
    x max|ref|, in bf16 no farther from it than the bf16 cuDNN chain
    (``Decoder32K.tail``); each limit 10 times below what the fp32 chain
    reads on the body one row off; exactly one fused-tail launch per call;
 6. flagship fp32 inference: VideoHybridNet at 224^2, B=1, T=16, attn
    "flash" against the same weights on "xla" (the dense plain core), max
    abs 1e-3, TF32 off; asserts the CUDA kernel ran;
 7. flagship fp32 gradients: one train-mode forward and backward at 256^2,
    B=1, T=8, dropout off, TF32 off, "flash" against "xla" from the same
    weights; the largest gradient difference <= 1e-3 x the largest
    gradient; asserts the backward kernels ran;
7b. the flagship at 416^2 (Dh 1352), fp32, TF32 off, B=1, T=16: phase 6's
    eval forward and phase 7's train-mode gradients, "flash" against "xla";
 8. windowed flagship fp32, TF32 off: "flash" with window 64 (the banded
    kernels) against "windowed" (the dense band) from the same weights:
    the eval forward at 384^2, B=1, T=32, max abs 1e-3; train-mode
    gradients at 256^2, B=1, T=32, dropout off, <= 1e-3 x max|grad|;
 9. inference main path (config 1): bf16, B=8, T=16, 224^2, a uint8 clip
    through preprocess_clip and the model; the launch counts are set to 0
    just before one forward and read just after (no fused-tail launch:
    the decoder keeps its cuDNN chain); outputs must be finite; then the
    bench protocol (tchvp_tpu_torch/bench.py) times it, and CUDA
    events time its stages;
10. config 2 inference: bf16, B=16, T=32, 384^2, window 64, through
    preprocess_clip and ``microbatched_infer(microbatch=4)``: the counts
    set to 0 before one call and read after it (8 banded forwards, no
    flash kernel, no fused tail); finite output; frames/s, p50 batch latency and spread
    (bench protocol), the stages of one group, peak memory, a profile;
11. training main path: the ``tchvp video`` defaults at 256^2, B=8, T=8,
    fp32 (mixed loss, noise 0.05, dropout on, AdamW lr 1e-4 wd 0.01, clip
    1.0): 5 steps of make_video_train_step from create_train_state, the
    counts set to 0 before each step and read after it (2 forward, 2 dq, 2
    dk/dv launches); finite loss and psnr, every parameter and every
    BatchNorm running stat moved; then steps/s and frames/s (bench
    protocol), the device ms of data, forward, backward and optimizer (CUDA
    events), peak memory, a torch.profiler window over one step, and one
    step with remat "stages" (4 forward launches);
12. windowed training: phase 11 with window 64 on B=2 of 32-frame clips
    (S 256 in 4 windows): 2 banded forward, 2 pass-A, 2 dq and 2 dk/dv
    launches per step and no flash kernel; remat "stages" launches 4
    forwards;
12b. sequence parallelism, two ranks sharing this one card over gloo
    (NCCL refuses two ranks on one device; the halo and the reductions
    cross through host memory), spawned with a file:// rendezvous and a
    process-group timeout: (a) the fp32 eval forward at config 2's
    geometry (384^2, B 1, T 32, w 64, TF32 off) on a mesh ("seq",) of 2,
    each rank's frames against phase 8's single-process forward, max abs
    1e-3; (b) one step of the windowed-training cell (256^2, B 2, T 32, w
    64, fp32, dropout off, TF32 off, SGD lr 1 so the update is the
    gradient) against the single-process step from the same weights: loss
    rtol 1e-5, parameters within 1.9 x 2e-2 x the largest gradient (the
    limit of tests/test_torch_train.py), BatchNorm stats 1e-5; parameters
    and stats bit-equal across the ranks; per rank 2 halo forward, 2
    pass-A, 2 dq, 2 dk/dv launches and no band or flash launch; (c) 3 steps with dropout
    on at the cell's AdamW: finite loss, every parameter moved. Each rank's
    step ms and peak memory, which are not a scaling number;
13. config 4 streaming: stream_video of the flagship at 256^2 (attn "xla",
    bf16) over one 16-frame 1080x1920 clip in 40 tiles, chunk 8, 4 frames
    of carried context: finite output of the clip's shape, no kernel
    launched, frames/s and megapixels/s;
15. data path (after 13, before 14): (a) 24 clips of 8 x 256^2 x 3 made
    from a numpy seed packed into a clippack in a temporary directory,
    opened natively (``native/clippack.cc`` built with g++ into
    ``tchvp_tpu_torch/_build/``; the build seconds printed) and with
    ``prefer_native=False``: bit-equal batches over two shuffled epochs and
    after a seek to mid-epoch, and each reader's host ms per batch; (b)
    ``DevicePrefetch(size=2, device="cuda")`` over the native dataset:
    every batch a CUDA uint8 tensor bit-equal to the host batch, and
    ``position()`` the inner position minus the batches held; (c) the
    augmentations on an fp32 (8, 8, 256, 256, 3) clip on the card
    (``augment_geometric`` with rot90, crop and jitter at 0.5,
    ``augment_denoising`` at its defaults, and each augmentation alone)
    under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync
    fails the phase; their draw-taking forms on given draws against the
    same functions on the CPU (flip, rot90 and blackout bit for bit,
    crop-resize and jitter within 1e-5); their device ms; (d) 5 steps of
    phase 11's cell with (c)'s ``AugmentConfig``, fed by (b)'s prefetcher:
    flash launches fwd 2, dq 2, dkv 2 per step, finite loss and PSNR,
    parameters and BN stats moved; the median step ms over 3 reps of 2
    steps fed from host memory beside the step on batches already on the
    card and phase 11's; the H2D ms of one batch from pinned memory on the
    copy stream and from pageable memory with ``.to("cuda")``, by events;
    the device idle share over a profile window of 3 steps with the
    prefetcher and with synchronous pageable placement;
16. the run-time through ``cli.main`` (in this process, so the launch
    counters can be read; in a temporary working directory), at phase 11's
    cell (256^2, B 8 of 8-frame clips, fp32, ``--attn-impl flash``, AdamW
    1e-4, ``--ema-decay 0.999``, ``--keep-checkpoints 1``): (a) ``video
    --synthetic 3 --epochs 2 --save-every 1``: flash launches 2/2/2 per
    step and no other kernel, the tag ``step_2``, ``TAG_SCHEME``
    "epochs", ``run.json`` naming this card, one event file with
    Loss/PSNR at epochs 1 and 2; (b) ``step_2`` restored into a fresh flow
    and saved again: every tensor of the payload (model, moments, EMA,
    generators) bit-equal; ``--resume --epochs 3`` prints only epoch 3,
    and its ``step_3`` equals that of 3 straight epochs, bit for bit, with
    ``cudnn.deterministic`` and deterministic algorithms (warn-only: an op
    without a deterministic kernel is named, and then the limit is 1e-5 x
    max|p|); (c) a clippack of phase 15's 24 clips with
    ``--save-every-steps 2``: tags step_2 and step_3; step_3 removed (a
    preemption), ``--resume --epochs 2`` runs 4 steps (flash launches
    4 x 2/2/2), tags step_2, step_5, step_6, step_5's data position epoch 1
    batch 2; (d) the full state's size on disk and the ms of a save, of an
    async save's blocking part and its writer, and of a restore, twice
    each; (e) ``VideoFlow.train`` at the cell on host batches through
    DevicePrefetch, saves left out: step ms from the epochs' start times
    against phase 11's bare step, and the idle share over one epoch; (f)
    ``video --window 64`` (B 2, T 32, 2 steps): band launches 2/2/2/2 per
    step; (g) ``video --mesh seq=2 --window 64`` as two ranks sharing this
    card over gloo, as phase 12b spawns them: halo launches 2/2/2/2 per rank,
    rank 0's checkpoint; (h) on (b)'s ``step_3``: ``infer`` (bf16, frames/s
    and PSNR), ``eval``, ``stream`` of one 16-frame 1080p clip, ``summary``,
    ``doctor --smoke``. Each kernel's record gains ``cli_launches``: its
    launches in (a), (f) and (g)'s rank 0;
17. BASELINE config 3: the flagship at 224^2, "xla" attention, bf16
    compute over fp32 parameters (``compute_dtype``), B 8 of 16-frame
    clips, MSE, noise 0.05, AdamW 1e-4 clipped at 1.0: finite loss over 3
    steps, no hand-written kernel launched, every parameter and BatchNorm
    stat fp32 and moved; step ms (phase 11's protocol), trained frames/s,
    peak memory and a profile;
18. FCT (``models/fct.py``), the segmentation family, at 256^2, after 17:
    (a) ``FCTConfig()`` with bf16 ``compute_dtype`` over fp32 parameters,
    "auto" attention, batch 2 (``benchmarks/fct_forward_bench.py``'s
    shape): the counts set to 0 before one forward and read after it (9
    flash forwards, no other kernel: "auto" takes the kernel on the card);
    bits equal on repeat; within 2e-2 x max|ref| of the same weights in
    fp32 on "xla" (the plain path, TF32 off); ms per forward (phase 9's
    protocol, preprocess included), images/s, peak memory, a profile; (b)
    one fp32 segment step's gradients at batch 2, dropout off, TF32 off,
    flash (9/9/9 launches) against "xla": the largest difference <= 1e-3 x
    the largest gradient; (c) ``segment --synthetic 3 --epochs 2`` through
    ``cli.main`` at the CLI defaults (256^2, batch 8, fp32, dice, AdamW 1e-4
    clipped at 1.0) in a temporary working directory: flash launches 9/9/9
    a step plus 9 forwards a sneak peek and no other kernel, a finite dice
    loss and IoU per epoch, the best-loss checkpoint with its loss history;
    that checkpoint restored into a fresh ``SegmentationFlow`` and trained
    to epoch 3 prints only the epochs after its tag and keeps the history;
    ``SegmentationFlow.infer`` gives masks and Sobel edges in [0, 1] and its
    dumps; ``eval --model fct`` (9 forwards a batch) and ``summary --model
    fct``; (d) the bare step at the CLI defaults, dropout on: 9/9/9 launches
    a step, finite loss and IoU, every parameter moved; step ms (phase 11's
    protocol), trained images/s, peak memory, the device ms of data,
    forward, backward and optimizer, a profile window (idle share, top
    kernels, the flash kernels' share of the step); then the flash forward
    and pair at the step's five attention shapes (batch 8, 2 heads, fp32)
    by device time beside SDPA's and their bounds. The flash records of the
    JSON gain ``fct_launches`` ((a) and (c)) and ``fct_step`` (those times);
19. the conv families (no hand-written kernel on their paths), after 18:
    (a) UNet, AutoEncoder, Image2Image2Mask, Autoencoder32K (image and mask
    heads) and Autoencoder4K at their default widths, every dropout off,
    BN and biases seeded, B 2 at 64^2: the fp32 eval forward on the card
    (TF32 off) against the same weights on the CPU, <= 1e-4 x max|ref|;
    the train-mode gradients of sum(out * w) in float64 on the card
    against float64 on the CPU, <= 1e-3 x max|grad|; in fp32, chains of
    train-mode BN leave any implementation 0.1-5 % of the largest gradient
    from float64, the CPU's too, by the luck of each kernel's reduction
    order, so the card's and the CPU's fp32 distances are printed and held
    only to 0.1 (a wrong map reads O(1)); (b)
    ``denoise --synthetic 3 --epochs 2`` at the defaults (256^2, batch 8,
    mixed loss), its best-val weights file, ``eval --model ae`` on it; (c)
    ``port --model ae32k`` of a seeded AE_32K-layout state_dict this phase
    writes (every BN-followed conv with a bias to fold), the ported
    state_dict equal to the source; ``transfer --pretrained`` on it
    (``--epochs 2``), then ``TransferFlow`` resumed to epoch 3 and
    ``test_a_sample``: the encoder's parameters bit-equal to the ported ones
    throughout, its BN stats moved from (0, 1); (d) ``video --model ae32k``
    (256^2, batch 8 x 8 frames) and ``--model ae4k --image-size 64``, then
    ``infer`` and ``eval --model`` on their ``step_2``; (e) ``port --model
    unet`` of a seeded UNet.py-layout state_dict, ``eval --model unet`` on
    it and ``eval --model combined``. Every run of (a)-(e) launches no
    hand-written kernel (counted into each record's
    ``conv_family_launches``). The bare step of each training path (the
    denoise, transfer and both video steps): finite metrics, trainable
    parameters moved, step ms (phase 11's protocol, spread), trained
    images or frames/s, peak memory, the device ms of data, forward,
    backward and optimizer, and a profile window's idle share;
14. kernel times: each kernel at its main-path shape beside its plain
    version, F.scaled_dot_product_attention (a yardstick, never on the
    port's path; with the boolean band as attn_mask for the banded
    kernels) and its bound; the flash forward also at the training shape
    in fp32 (SDPA without dropout there), by events and by device time
    (``card_timing.device_ms``: 20 calls queued behind a ~10 ms spin of the
    card, the host's issue time checked to end well inside the spin, so no
    host gap between them), SDPA beside it both ways, and the host's time
    per call of ``mha`` on ``_split_heads`` views under no_grad (the least
    of 5 turns of 200 calls issued on an idle card); the flash forward and
    the backward pair at FCT's three shapes beside SDPA's forward and
    backward, the forward's bound the
    larger of bytes, products and the BH x S^2 exponentials at 16 fp32 ex2
    per clock per SM at the card's maximum SM clock, the bf16x2 rate's time
    beside it (``fct`` in the JSON); the
    flash backward kernels also at the inference shape in bf16, each
    kernel, the pair and SDPA's backward (``autograd.grad``) by events and
    by device time, the pair's bound the larger of bytes, 5 products and
    the 2 x BH x S^2 exponentials; the banded
    backward at config 2's and the training shape, each of its three
    launches, the three together and SDPA's backward with the band mask by
    events and by device time, each launch's bound (its inputs, the
    scratch included, read once and its outputs written once, or its
    products) and the pair's (7 rows of q, k, v, do, dq, dk, dv and 5
    products);
    the halo kernels at the two shard shapes of phase 5c (has_prev 1), SDPA
    with the (S, S + w) halo band as a boolean mask beside them, the
    backward as the band's; every
    kernel's ``ms`` (and SDPA's) is events around a loop of calls, the
    host's launch time included; the band and halo kernels and their SDPA
    also by device time (``device_ms`` and ``library_device_ms`` in the
    JSON);
    the fused tail at config 1's and config 2's decode shapes in bf16,
    checked against its plain version there (<= 2e-2 x max|ref|), by
    events and by device time, beside ``Decoder32K.tail`` in eval mode (the
    cuDNN chain it replaces) and the same chain with the BNs folded into its
    convs, channels-last, bf16 (``folded_cudnn_tail``; within 5e-2 x
    max|ref| of the plain version), both yardsticks timed both ways and
    never on the port's path, and its bound.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the exit
code is not 0. There is no CPU path: without a CUDA device it exits 1.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from card_timing import cuda_ms, device_ms, host_ms
from tchvp_tpu_torch import cli, losses, parallel
from tchvp_tpu_torch.bench import infer_fn, profile_window, random_clip, stage_ms, time_clips
from tchvp_tpu_torch.config import (
    AugmentConfig,
    AutoEncoderConfig,
    FCTConfig,
    ResNetAEConfig,
    TrainConfig,
    flagship_video_config,
)
from tchvp_tpu_torch.data import pipeline
from tchvp_tpu_torch.data.clippack import ClipPackDataset, pack_clips
from tchvp_tpu_torch.data.device_prefetch import DevicePrefetch
from tchvp_tpu_torch.data.pipeline import preprocess_clip
from tchvp_tpu_torch.data.synthetic import SyntheticClips, SyntheticImageMasks, SyntheticImages
from tchvp_tpu_torch.kernels import build
from tchvp_tpu_torch.kernels import flash_attention as fa
from tchvp_tpu_torch.kernels import fused_tail as ft
from tchvp_tpu_torch.models.autoencoder import AutoEncoder
from tchvp_tpu_torch.models.combined import Image2Image2Mask
from tchvp_tpu_torch.models.fct import FCT
from tchvp_tpu_torch.models.frame_ae import FrameAE
from tchvp_tpu_torch.models.resnet_ae import Autoencoder4K, Autoencoder32K, Decoder32K, tokens_to_latent
from tchvp_tpu_torch.models.streaming import StreamingConfig, microbatched_infer, stream_video
from tchvp_tpu_torch.models.unet import UNet
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.ops.attention import _merge_heads, _split_heads
from tchvp_tpu_torch.ops.blocks import init_flax_default
from tchvp_tpu_torch.ops.conv_attention import WideFocus
from tchvp_tpu_torch.ops.sobel import sobel_edges
from tchvp_tpu_torch.parallel import collectives
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train.loops import SegmentationFlow, TransferFlow, VideoFlow
from tchvp_tpu_torch.train.state import create_train_state, make_optimizer
from tchvp_tpu_torch.train.steps import (
    make_denoising_train_step,
    make_segmentation_train_step,
    make_video_train_step,
)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
FP32_FLOP_PER_S = 67e12  # CUDA cores

LIBRARIES = build.LIBRARIES
# Each kernel's launch counter: (key, module, attribute).
COUNTERS = tuple((name, fa, name) for name in (
    "launches", "dq_launches", "dkv_launches",
    "band_fwd_launches", "band_ds_launches", "band_dq_launches", "band_dkv_launches",
    "halo_fwd_launches", "halo_ds_launches", "halo_dq_launches", "halo_dkv_launches")) + (
    ("fused_tail_launches", ft, "launches"),)
FLASH_PY = "tchvp_tpu/kernels/flash_attention.py"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
            for _ in range(3)]


def device_seed(seed: int) -> torch.Tensor:
    return torch.tensor([seed], dtype=torch.int32).to("cuda")


def counts() -> dict:
    """The launch counters of the twelve kernels, by key."""
    return {key: getattr(module, attr) for key, module, attr in COUNTERS}


def reset_counts() -> None:
    for _, module, attr in COUNTERS:
        setattr(module, attr, 0)


def expect_counts(**nonzero) -> dict:
    """The counters as a run that launched only ``nonzero`` leaves them."""
    return {key: nonzero.get(key, 0) for key, _, _ in COUNTERS}


def free_cuda() -> None:
    # torch.optim's constructor leaves its frames in a reference cycle that
    # holds the caller's locals (the model, via create_train_state) until the
    # cycle collector runs: collect, so a phase's models leave the card with
    # it and later phases do not allocate on a full card.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# The kernel cases of the forward check: ((B, H, S, Dh), dtype, scale, dropout, seed).
KERNEL_CASES = [
    ((8, 8, 128, 392), torch.bfloat16, 1 / 56, 0.0, 0),
    ((1, 8, 128, 1152), torch.bfloat16, 1 / 96, 0.0, 0),
    ((2, 2, 4099, 8), torch.float32, None, 0.0, 0),
    ((2, 8, 200, 64), torch.float32, None, 0.1, 1234),
]
# FCT's attention (tchvp_tpu/kernels/flash_attention.py:38-45, BENCHES.md's block
# sweep): Dh 4-64 over up to 16K spatial tokens, bf16, scale 1/sqrt(Dh).
FCT_CASES = [
    ((2, 2, 16384, 4), torch.bfloat16, None, 0.0, 0),
    ((2, 2, 4096, 8), torch.bfloat16, None, 0.1, 31),
    ((2, 8, 4096, 64), torch.bfloat16, None, 0.0, 0),
]
# The forward's narrower loads and stores over a ragged S: rows of 8 bytes (Dh 98
# fp32: 8-byte copies in and out) and of an odd number of elements (Dh 7 and 99
# bf16: element loads and stores, in the (16, 2) and (64, 16) tilings).
LOAD_CASES = [
    ((1, 3, 203, 98), torch.float32, None, 0.1, 41),
    ((2, 3, 201, 7), torch.bfloat16, None, 0.1, 43),
    ((1, 4, 190, 99), torch.bfloat16, None, 0.0, 0),
]
# q, k, v one element past a 16-byte boundary (element loads), over a ragged S.
MISALIGNED_CASES = [
    ((2, 2, 150, 64), torch.bfloat16, None, 0.1, 45),
    ((1, 3, 133, 32), torch.float32, None, 0.0, 0),
]
# One 64-row tile of S and several head-dim column blocks per backward block
# (the training shape's path, S <= 64 past Dh 64), over a ragged S: Dh 520 bf16
# (16-byte copies; dq 3, dk/dv 5 column blocks per block at BH 66) and Dh 98 fp32
# (8-byte copies; 2 per block at BH 132).
SHORT_CASES = [
    ((6, 11, 50, 520), torch.bfloat16, None, 0.1, 47),
    ((4, 33, 37, 98), torch.float32, None, 0.0, 0),
]
# The training main path's attention: 256^2 -> D 4096, 8 heads, S 64, scale 1/sqrt(D).
TRAIN_CASE = ((8, 8, 64, 512), torch.float32, 1 / 64, 0.1, 77)
INFER_BWD_CASE = ((8, 8, 128, 392), torch.bfloat16, 1 / 56, 0.0, 0)
# The banded cases: ((B, H, S, Dh), dtype, scale, window, dropout, seed).
# Config 2's attention: 384^2 -> D 9216, Dh 1152, S 32*8, window 64, a group of 4 clips.
BAND_CONFIG2 = ((4, 8, 256, 1152), torch.bfloat16, 1 / 96, 64, 0.0, 0)
# Windowed training: 256^2 -> D 4096, Dh 512, S 256, window 64, batch 2.
BAND_TRAIN = ((2, 8, 256, 512), torch.float32, 1 / 64, 64, 0.1, 77)
BAND_CASES = [
    BAND_CONFIG2,
    BAND_TRAIN,
    ((2, 4, 200, 64), torch.float32, None, 64, 0.1, 5),  # ragged S: a partial last window
    ((2, 4, 96, 64), torch.float32, None, 24, 0.0, 0),   # w not a multiple of 16 or 8
    ((1, 4, 256, 1152), torch.bfloat16, 1 / 96, 200, 0.1, 3),  # a span of 4 key tiles
    # Rows of Dh elements that are not a multiple of 16 bytes: element loads.
    ((1, 4, 128, 100), torch.bfloat16, None, 64, 0.1, 11),
    ((2, 2, 96, 98), torch.float32, None, 32, 0.0, 12),
]
ONE_WINDOW_CASE = ((2, 4, 100, 64), torch.float32, None, 128, 0.1, 9)  # w >= S


def bwd_inputs(shape, dtype, scale, rate, seed, rng_seed, window=None):
    """q, k, v, do in ``dtype`` and the plain forward's lse and delta (fp32)
    on those values: the backward's inputs as the main path gives them."""
    b, h, s, dh = shape
    rng = np.random.default_rng(rng_seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b * h, s, dh), dtype=np.float32)).to("cuda", dtype)
                   for _ in range(4))
    if window is None:
        out, lse = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
    else:
        out, lse = fa.windowed_mha_reference(q.float(), k.float(), v.float(), scale, window, rate, seed)
    delta = (do.float() * out).sum(-1)
    return q, k, v, do, lse, delta


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    return name


def kernel_resources(log: str) -> dict:
    """{mangled kernel name: (registers, spill-store bytes, stack-frame
    bytes)} from ptxas -v."""
    found, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("Compiling entry function '")[1].split("'")[0]
        elif name and "bytes spill stores" in line:
            spill = int(line.split(" bytes spill stores")[0].split()[-1])
            stack = int(line.split(" bytes stack frame")[0].split()[-1]) if "stack frame" in line else 0
            found[name] = (found.get(name, (0, 0, 0))[0], spill, stack)
        elif name and "Used " in line:
            found[name] = (int(line.split("Used ")[1].split()[0]),) + found.get(name, (0, 0, 0))[1:]
    return found


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_all(LIBRARIES)
    wall = time.perf_counter() - t0
    for name in LIBRARIES:
        log = build.build_log[name].splitlines()
        regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log if "Used " in line})
        spills = sorted({int(line.split(" bytes spill stores")[0].split()[-1])
                         for line in log if "bytes spill stores" in line})
        print(f"[2 build] {name} built in {build.build_seconds[name]:.2f} s "
              f"(registers per instantiation: {regs}; spill-store bytes: {spills})")
    for kernel, (regs, spill, stack) in sorted(kernel_resources(build.build_log["flash_fwd"]).items()):
        tiles = re.search(r"flash_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", kernel)
        if tiles:
            dtype = "bf16" if tiles.group(1) != "f" else "fp32"
            print(f"[2 build] flash_fwd {dtype} (KC {tiles.group(2)}, NT {tiles.group(3)}): {regs} registers, "
                  f"{spill} bytes spill stores, {stack} bytes stack frame")
    for kernel, (regs, spill, stack) in sorted(kernel_resources(build.build_log["flash_bwd"]).items()):
        tiles = re.search(r"flash_bwd_(dq|dkv)_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb(\d)E", kernel)
        if tiles:
            dtype = "bf16" if tiles.group(2) != "f" else "fp32"
            print(f"[2 build] flash_bwd {tiles.group(1)} {dtype} (KC {tiles.group(3)}, NT {tiles.group(4)}"
                  f"{', resident' if tiles.group(5) == '1' else ''}): {regs} registers, {spill} bytes spill stores, "
                  f"{stack} bytes stack frame")
    kinds = {"window_logits": "forward logits (pass A)", "window_pv": "forward P.V (pass B)",
             "window_ds": "backward P_drop, dS (pass A)", "window_dq": "backward dq (pass B)",
             "window_dkv": "backward dk/dv (pass B)"}
    for name in ("band_attention", "halo_attention"):
        for kernel, (regs, spill, stack) in sorted(kernel_resources(build.build_log[name]).items()):
            kind = next((v for k_, v in kinds.items() if f"{k_}_kernel" in kernel), None)
            if kind:
                dtype = "bf16" if "nv_bfloat16" in kernel else "fp32"
                print(f"[2 build] {name} {kind} {dtype}: {regs} registers, {spill} bytes spill stores, "
                      f"{stack} bytes stack frame")
    print(f"[2 build] {len(LIBRARIES)} libraries in {wall:.2f} s wall (one nvcc each, in parallel)")


def fwd_limits(dtype: torch.dtype, ref_out: torch.Tensor) -> tuple:
    """Phase 3's (out, lse) limits on max abs error: fp32 1e-4 and 1e-4;
    bf16 1e-2 x max|ref| for out (rounding out to bf16 alone moves it by up
    to 2^-8 x |out|) and 1e-4 for the lse, which the kernel forms in fp32
    from the bf16 inputs as the plain version does."""
    if dtype != torch.bfloat16:
        return 1e-4, 1e-4
    return 1e-2 * ref_out.abs().max().item(), 1e-4


def phase_fwd_kernel() -> float:
    """The flash forward against its plain version at the main path's
    shapes, FCT's shapes and the narrower loads' cases, bits equal on
    repeat, each limit shown to sit far below what the plain version reads
    with V one key row off (a P.V or tiling fault); then on q, k, v off a
    16-byte boundary and on strided views. Returns the max abs error at the
    first (inference flagship) case."""
    flagship_err = None
    for i, ((b, h, s, dh), dtype, scale, rate, seed) in enumerate(KERNEL_CASES + FCT_CASES + LOAD_CASES):
        q, k, v = qkv((b * h, s, dh), dtype, seed=i)
        scale = 1 / math.sqrt(dh) if scale is None else scale
        got = fa._flash_fwd_cuda(q, k, v, scale, rate, device_seed(seed))
        again = fa._flash_fwd_cuda(q, k, v, scale, rate, device_seed(seed))
        torch.cuda.synchronize()
        want = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
        tol, lse_tol = fwd_limits(dtype, want[0])
        fault = fa.mha_reference(q.float(), k.float(), v.float().roll(1, dims=1), scale, rate, seed)[0]
        fault_err = (fault - want[0]).abs().max().item()
        del fault
        check(fault_err > 10 * tol, f"3 fwd kernel at {(b, h, s, dh)}: V one key row off reads {fault_err}, "
                                    f"not 10 x the limit {tol}")
        lse_err = (got[1] - want[1]).abs().max().item()
        err = check_fwd(f"3 fwd kernel at {(b, h, s, dh)}", got, again, want, tol, lse_tol)
        print(f"[3 fwd kernel] {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: out max abs {err:.3g} "
              f"({err / want[0].abs().max().item():.3g} x max|ref|), lse max abs {lse_err:.3g} (limits "
              f"{tol:.3g}, {lse_tol}); V one key row off reads {fault_err:.3g}; bits equal on repeat")
        if flagship_err is None:
            flagship_err = err
        del q, k, v, got, again, want
        free_cuda()
    for i, ((b, h, s, dh), dtype, scale, rate, seed) in enumerate(MISALIGNED_CASES):
        q, k, v = qkv((b * h, s, dh), dtype, seed=90 + i)
        scale, seed_t = 1 / math.sqrt(dh) if scale is None else scale, device_seed(seed)
        want = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
        check_misaligned(f"3 fwd kernel {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}",
                         lambda *t: fa._flash_fwd_cuda(*t, scale, rate, seed_t), q, k, v, want,
                         *fwd_limits(dtype, want[0]))
    phase_fwd_strided()
    return flagship_err


# The strided cases: the main path's inference and training attention and FCT's Dh 8.
STRIDED_CASES = [KERNEL_CASES[0], TRAIN_CASE, ((2, 2, 300, 8), torch.bfloat16, None, 0.1, 5),
                 ((1, 3, 100, 98), torch.float32, None, 0.0, 0)]


def phase_fwd_strided() -> None:
    """q, k, v as ``_split_heads`` views of (B, S, D) tokens and out into a
    (B, S, H, Dh) buffer, as ``mha`` launches the kernel on the main path:
    against the plain version at phase 3's limits, bits equal to the launch
    on contiguous (BH, S, Dh) copies; ``mha``'s merged heads a view of that
    buffer."""
    for i, ((b, h, s, dh), dtype, scale, rate, seed) in enumerate(STRIDED_CASES):
        scale = 1 / math.sqrt(dh) if scale is None else scale
        rng = np.random.default_rng(60 + i)
        tokens = [torch.from_numpy(rng.standard_normal((b, s, h * dh), dtype=np.float32)).to("cuda", dtype)
                  for _ in range(3)]
        q4, k4, v4 = (_split_heads(t, h) for t in tokens)
        seed_t = device_seed(seed)
        out4, lse4 = fa._flash_fwd_cuda(q4, k4, v4, scale, rate, seed_t)
        flat = [t.reshape(b * h, s, dh).contiguous() for t in (q4, k4, v4)]
        out, lse = fa._flash_fwd_cuda(*flat, scale, rate, seed_t)
        with torch.no_grad():
            merged = _merge_heads(fa.mha(q4, k4, v4, scale=scale, dropout_rate=rate, dropout_seed=seed_t))
        want = fa.mha_reference(*(t.float() for t in flat), scale, rate, seed)
        tol, lse_tol = fwd_limits(dtype, want[0])
        err = (out4.reshape(b * h, s, dh).float() - want[0]).abs().max().item()
        lse_err = (lse4 - want[1]).abs().max().item()
        check(not q4.is_contiguous() and out4.transpose(1, 2).is_contiguous(), "the strided case is not strided")
        check(math.isfinite(err) and err <= tol and lse_err <= lse_tol,
              f"strided views at {(b, h, s, dh)}: out {err} > {tol} or lse {lse_err} > {lse_tol}")
        check(torch.equal(out4.reshape(b * h, s, dh), out) and torch.equal(lse4, lse),
              f"strided views at {(b, h, s, dh)} change the bits")
        check(torch.equal(merged, out4.transpose(1, 2).reshape(b, s, h * dh)) and merged._base is not None,
              f"mha's merged heads at {(b, h, s, dh)}: not the kernel's buffer")
        print(f"[3 fwd strided] {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: _split_heads views in, "
              f"(B, S, H, Dh) out: out max abs {err:.3g}, lse max abs {lse_err:.3g} (limits {tol:.3g}, "
              f"{lse_tol}); bits equal to the contiguous launch; the merged heads a view")


def check_bwd(tag: str, shape, dtype, got, again, want, tol=None, fault=None) -> list:
    """dq, dk, dv against the plain version (max abs <= tol x max|ref|; tol
    1e-4 in fp32, 2e-2 in bf16 unless given) and bit equality of a second
    launch (``again`` None: none); with ``fault``, the plain version on a
    broken input, each gradient's fault must read > 10 x the limit. Returns
    the max abs errors."""
    if tol is None:
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    errs, rel, faults = [], [], []
    for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        err = (g.float() - w).abs().max().item()
        ref = w.abs().max().item()
        errs.append(err)
        rel.append(err / ref)
        check(math.isfinite(err) and err <= tol * ref, f"{tag} {name} at {shape}: {err} > {tol} x {ref}")
        if again is not None:
            check(torch.equal(g, again[i]), f"{tag} {name} at {shape} differs between two launches")
        if fault is not None:
            faults.append((fault[i] - w).abs().max().item() / ref)
            check(faults[-1] > 10 * tol, f"{tag} {name} at {shape}: the fault reads {faults[-1]:.3g} x max|ref|, "
                                         f"not 10 x the limit {tol}")
    seen = f"; K one key row off reads {', '.join(f'{f:.3g}' for f in faults)}" if fault is not None else ""
    print(f"[{tag}] {shape} {str(dtype)[6:]}: max abs / max|ref| dq {rel[0]:.3g}, dk {rel[1]:.3g}, "
          f"dv {rel[2]:.3g} (tol {tol}){seen}{'; bits equal on repeat' if again is not None else ''}")
    return errs


def bwd_limit(dtype: torch.dtype) -> float:
    """Phase 4's limit on each gradient's max abs error, x max|ref|: fp32
    1e-4; bf16 1.5e-2, 2.6 x the largest error of the first chip run of the
    tensor-core pair (5.7e-3, dq at FCT's (2, 2, 16384, 4); P_drop and dS
    are rounded to bf16 for the second products)."""
    return 1.5e-2 if dtype == torch.bfloat16 else 1e-4


def phase_bwd_kernels() -> dict:
    """dq, dk, dv of the two backward kernels against mha_bwd_reference on
    the same inputs, each limit shown to sit 10 x below what the plain
    version reads with K one key row off; a second launch must give the
    same bits. Then misaligned inputs and strided views. Returns the max
    abs errors at the training shape."""
    errs = {}
    for i, case in enumerate(KERNEL_CASES + [TRAIN_CASE] + FCT_CASES + LOAD_CASES + SHORT_CASES):
        (b, h, s, dh), dtype, scale, rate, seed = case
        scale = 1 / math.sqrt(dh) if scale is None else scale
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 10 + i)
        got = fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate, device_seed(seed))
        again = fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate, device_seed(seed))
        torch.cuda.synchronize()
        plain = (q.float(), k.float(), v.float(), do.float(), lse, delta, scale, rate, seed)
        want = fa.mha_bwd_reference(*plain)
        fault = fa.mha_bwd_reference(plain[0], plain[1].roll(1, dims=1), *plain[2:])
        e = check_bwd(f"4 bwd kernels, dropout {rate}", (b, h, s, dh), dtype, got, again, want,
                      bwd_limit(dtype), fault)
        if case is TRAIN_CASE:
            errs = {"flash_bwd_dq": e[0], "flash_bwd_dkv": max(e[1], e[2])}
        del q, k, v, do, lse, delta, got, again, plain, want, fault
        free_cuda()
    for i, ((b, h, s, dh), dtype, _, rate, seed) in enumerate(MISALIGNED_CASES):
        scale, seed_t = 1 / math.sqrt(dh), device_seed(seed)
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 95 + i)
        copies = [misaligned(t) for t in (q, k, v, do)]
        check(all(t.data_ptr() % 16 for t in copies), "4 bwd misaligned: the copies are 16-byte aligned")
        got = fa._flash_bwd_cuda(*copies, lse, delta, scale, rate, seed_t)
        aligned = fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate, seed_t)
        want = fa.mha_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse, delta, scale, rate, seed)
        tag = f"4 bwd kernels misaligned, dropout {rate}"
        check_bwd(tag, (b, h, s, dh), dtype, got, None, want, bwd_limit(dtype))
        check(all(torch.equal(x, y) for x, y in zip(got, aligned)), f"{tag}: misaligned inputs change the bits")
        print(f"[{tag}] q, k, v, do one element past a 16-byte boundary: bits equal to the aligned inputs'")
    phase_bwd_strided()
    return errs


def phase_bwd_strided() -> None:
    """q, k, v, do as ``_split_heads`` views of (B, S, D) tokens, as ``mha``'s
    backward launches the kernels: within phase 4's limits, gradients the
    (B, H, S, Dh) views of (B, S, H, Dh) buffers, bit-equal to the launch on
    contiguous copies; ``mha``'s autograd gradients bit-equal to a direct
    launch on its own residuals (the forward's out and lse on the same
    views), so ``_residuals`` passes the views without a copy."""
    for i, ((b, h, s, dh), dtype, scale, rate, seed) in enumerate(STRIDED_CASES):
        scale = 1 / math.sqrt(dh) if scale is None else scale
        rng = np.random.default_rng(70 + i)
        tokens = [torch.from_numpy(rng.standard_normal((b, s, h * dh), dtype=np.float32)).to("cuda", dtype)
                  for _ in range(4)]
        q4, k4, v4, do4 = (_split_heads(t, h) for t in tokens)
        flat = [t.reshape(b * h, s, dh).contiguous() for t in (q4, k4, v4, do4)]
        seed_t = device_seed(seed)
        out, lse = fa.mha_reference(*(t.float() for t in flat[:3]), scale, rate, seed)
        delta = (flat[3].float() * out).sum(-1)
        got = fa._flash_bwd_cuda(q4, k4, v4, do4, lse, delta, scale, rate, seed_t)
        contiguous = fa._flash_bwd_cuda(*flat, lse, delta, scale, rate, seed_t)
        want = fa.mha_bwd_reference(*(t.float() for t in flat), lse, delta, scale, rate, seed)
        tag = f"4 bwd strided, dropout {rate}"
        check_bwd(tag, (b, h, s, dh), dtype, [g.reshape(b * h, s, dh) for g in got], None, want, bwd_limit(dtype))
        check(all(g.shape == q4.shape and g.transpose(1, 2).is_contiguous() for g in got),
              f"{tag} at {(b, h, s, dh)}: the gradients are not views of (B, S, H, Dh) buffers")
        check(all(torch.equal(g.reshape(b * h, s, dh), c) for g, c in zip(got, contiguous)),
              f"{tag} at {(b, h, s, dh)}: strided views change the bits")
        # Through mha's autograd Function, against a direct launch on its residuals.
        leaves = [t.detach().requires_grad_() for t in tokens[:3]]
        views = [_split_heads(t, h) for t in leaves]
        tracked = fa.mha(*views, scale=scale, dropout_rate=rate, dropout_seed=seed_t)
        grads = torch.autograd.grad(tracked, views, do4)
        out4, lse4 = fa._flash_fwd_cuda(q4, k4, v4, scale, rate, seed_t)
        delta4 = (do4.float() * out4.float()).sum(-1).reshape(b * h, s).contiguous()
        direct = fa._flash_bwd_cuda(q4, k4, v4, do4, lse4, delta4, scale, rate, seed_t)
        check(all(torch.equal(g, d) and g.transpose(1, 2).is_contiguous() for g, d in zip(grads, direct)),
              f"{tag} at {(b, h, s, dh)}: mha's gradients are not the kernels' views")
        print(f"[{tag}] {(b, h, s, dh)} {str(dtype)[6:]}: _split_heads views in, (B, S, H, Dh) buffers out; "
              f"bits equal to the contiguous launch; mha's autograd gradients the kernels' views")
        del tokens, q4, k4, v4, do4, flat, got, contiguous, want, leaves, views, tracked, grads, direct
        free_cuda()


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary, so that the window forwards take their element loads."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


def check_misaligned(tag: str, fwd, q, k, v, want, tol=None, lse_tol=None) -> None:
    """``fwd(q, k, v)`` on misaligned copies against the plain ``want`` at
    ``tol`` and ``lse_tol`` (the dtype's absolute limit when None), and
    bit-equal to its output on the aligned inputs."""
    if tol is None:
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    lse_tol = tol if lse_tol is None else lse_tol
    copies = [misaligned(t) for t in (q, k, v)]
    check(all(t.data_ptr() % 16 for t in copies), f"{tag}: the copies are 16-byte aligned")
    got, aligned = fwd(*copies), fwd(q, k, v)
    torch.cuda.synchronize()
    err = (got[0].float() - want[0]).abs().max().item()
    lse_err = (got[1] - want[1]).abs().max().item()
    check(math.isfinite(err) and err <= tol and lse_err <= lse_tol, f"{tag} misaligned: out {err}, lse {lse_err}")
    check(torch.equal(got[0], aligned[0]) and torch.equal(got[1], aligned[1]),
          f"{tag}: misaligned inputs change the bits")
    print(f"[{tag} misaligned] q, k, v one element past a 16-byte boundary: out max abs {err:.3g}, lse max "
          f"abs {lse_err:.3g} (limits {tol:.3g}, {lse_tol:.3g}); bits equal to the aligned inputs'")


def band_bwd(q, k, v, do, lse, delta, scale, window, rate, seed):
    """(dq, dk, dv) of the banded backward's three passes (``attention_ab.py``
    times ``band_bwd`` and ``halo_bwd`` by these names in every checkout)."""
    return window_passes(q, k, v, do, lse, delta, scale, window, rate, seed)[1:]


def window_passes(q, k, v, do, lse, delta, scale, w, rate, seed_t, prev=None):
    """(scratch, dq, dk, dv) of the banded (``prev`` None) or halo
    backward's three passes."""
    if prev is None:
        scratch = fa.band_bwd_ds_cuda(q, k, v, do, lse, delta, scale, w, rate, seed_t)
        return (scratch, fa.band_bwd_dq_cuda(scratch, k, w)) + fa.band_bwd_dkv_cuda(scratch, q, do, w)
    scratch = fa.halo_bwd_ds_cuda(q, k, v, do, lse, delta, scale, w, prev, rate, seed_t)
    return (scratch, fa.halo_bwd_dq_cuda(scratch, k, w, prev)) + fa.halo_bwd_dkv_cuda(scratch, q, do, w, prev)


def check_window_bwd(tag: str, shape, q, k, v, do, lse, delta, scale, w, rate, seed, has_prev=None,
                     misaligned_too=False):
    """The banded (``has_prev`` None) or halo backward against its plain
    versions, at phase 4's limits (:func:`bwd_limit` x max|ref|): pass A's
    scratch (dS, P_drop) against ``window_bwd_scratch_reference``; pass B's
    dq and dk/dv against their plain versions on the kernel's own scratch;
    dq, dk, dv against the windowed plain versions, each limit 10 x below
    what they read with K one key row off; bits equal on repeat. With
    ``misaligned_too``, q, k, v, do one element past a 16-byte boundary
    (element loads): bits equal to the aligned launch. Returns the max abs
    errors {"ds": the scratch's, "dq", "dkv"} and the gradients."""
    dtype, tol = q.dtype, bwd_limit(q.dtype)
    seed_t = device_seed(seed)
    prev = None if has_prev is None else torch.tensor([has_prev], dtype=torch.int32, device="cuda")
    got = window_passes(q, k, v, do, lse, delta, scale, w, rate, seed_t, prev)
    again = window_passes(q, k, v, do, lse, delta, scale, w, rate, seed_t, prev)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)), f"{tag} at {shape}: differs between two launches")
    plain = (q.float(), k.float(), v.float(), do.float(), lse, delta, scale, w)
    want_scratch = fa.window_bwd_scratch_reference(*plain, rate, seed, has_prev)
    rel, ds_err = {}, 0.0
    for half, name in enumerate(("dS", "P_drop")):
        err = (got[0][half].float() - want_scratch[half]).abs().max().item()
        ds_err = max(ds_err, err)
        rel[name] = err / want_scratch[half].abs().max().item()
    pass_b = (fa.window_bwd_dq_reference(got[0], k, w, has_prev),) + fa.window_bwd_dkv_reference(got[0], q, do, w,
                                                                                                has_prev)
    for name, x, y in zip(("pass B dq", "pass B dk", "pass B dv"), got[1:], pass_b):
        rel[name] = (x.float() - y.float()).abs().max().item() / y.float().abs().max().item()
    for name, r in rel.items():
        check(math.isfinite(r) and r <= tol, f"{tag} {name} at {shape}: {r} x max|ref| > {tol}")
    if has_prev is None:
        refs = (fa.windowed_mha_bwd_dq_reference, fa.windowed_mha_bwd_dkv_reference)
        extra = (rate, seed)
    else:
        refs = (fa.windowed_mha_halo_bwd_dq_reference, fa.windowed_mha_halo_bwd_dkv_reference)
        extra = (has_prev, rate, seed)
    want = (refs[0](*plain, *extra),) + refs[1](*plain, *extra)
    broken = (plain[0], plain[1].roll(1, dims=1)) + plain[2:]
    fault = (refs[0](*broken, *extra),) + refs[1](*broken, *extra)
    print(f"[{tag}] {shape} {str(dtype)[6:]}: pass A dS, P_drop and pass B (on the kernel's scratch) max abs / "
          f"max|ref| " + ", ".join(f"{n} {r:.3g}" for n, r in rel.items()) + f" (tol {tol})")
    errs = check_bwd(tag, shape, dtype, got[1:], again[1:], want, tol, fault)
    if misaligned_too:
        copies = [misaligned(t) for t in (q, k, v, do)]
        check(all(t.data_ptr() % 16 for t in copies), f"{tag}: the copies are 16-byte aligned")
        moved = window_passes(*copies, lse, delta, scale, w, rate, seed_t, prev)
        check(all(torch.equal(x, y) for x, y in zip(moved, got)), f"{tag} at {shape}: misaligned inputs change the bits")
        print(f"[{tag} misaligned] q, k, v, do one element past a 16-byte boundary: scratch, dq, dk, dv bits equal "
              f"to the aligned inputs'")
    return {"ds": ds_err, "dq": errs[0], "dkv": max(errs[1], errs[2])}, got[1:]


def phase_band_kernels() -> dict:
    """The banded forward, dq and dk/dv kernels against their plain
    versions; returns the max abs errors at config 2's shape (forward) and
    the training shape (backward)."""
    errs = {}
    for i, case in enumerate(BAND_CASES):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        scale = 1 / math.sqrt(dh) if scale is None else scale
        q, k, v = qkv((b * h, s, dh), dtype, seed=40 + i)
        out, lse = fa.band_fwd_cuda(q, k, v, scale, w, rate, device_seed(seed))
        again = fa.band_fwd_cuda(q, k, v, scale, w, rate, device_seed(seed))
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.windowed_mha_reference(q.float(), k.float(), v.float(), scale, w, rate, seed)
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        print(f"[5 band fwd] {(b, h, s, dh)} {str(dtype)[6:]} window {w} dropout {rate}: "
              f"out max abs {err:.3g}, lse max abs {lse_err:.3g} (tol {tol}); bits equal on repeat")
        check(math.isfinite(err) and err <= tol and lse_err <= tol, f"band fwd vs plain at {case}")
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]), f"band fwd at {case} differs on repeat")

        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 50 + i, window=w)
        e, _ = check_window_bwd(f"5 band bwd, window {w}, dropout {rate}", (b, h, s, dh), q, k, v, do, lse, delta,
                                scale, w, rate, seed)
        if case is BAND_CONFIG2:
            errs["band_fwd"] = err
        if case is BAND_TRAIN:
            errs.update({f"band_bwd_{k_}": v_ for k_, v_ in e.items()})

    # One window (w >= S): the band holds every pair. Both banded passes are
    # held to the flash kernels at the fp32 limits (two bodies, in another
    # order of sums).
    (b, h, s, dh), dtype, _, w, rate, seed = ONE_WINDOW_CASE
    scale = 1 / math.sqrt(dh)
    q, k, v, do, _, _ = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 60)
    band = fa.band_fwd_cuda(q, k, v, scale, w, rate, device_seed(seed))
    flash = fa._flash_fwd_cuda(q, k, v, scale, rate, device_seed(seed))
    delta = (do.float() * flash[0]).sum(-1)
    band_g = band_bwd(q, k, v, do, flash[1], delta, scale, w, rate, device_seed(seed))
    flash_g = fa._flash_bwd_cuda(q, k, v, do, flash[1], delta, scale, rate, device_seed(seed))
    torch.cuda.synchronize()
    fwd_err = max((x - y).abs().max().item() for x, y in zip(band, flash))
    check(fwd_err <= 1e-4, f"one window {w} >= S {s}: band forward vs flash {fwd_err}")
    bwd_rel = [(x - y).abs().max().item() / y.abs().max().item() for x, y in zip(band_g, flash_g)]
    check(max(bwd_rel) <= 1e-4, f"one window {w} >= S {s}: band dq, dk, dv vs flash {bwd_rel} x max|grad|")
    print(f"[5 band one window] {(b, h, s, dh)} window {w} >= S, dropout {rate}: out, lse max abs "
          f"{fwd_err:.3g} from the flash forward (tol 1e-4); dq, dk, dv max abs / max|flash| "
          f"{', '.join(f'{r:.3g}' for r in bwd_rel)} (tol 1e-4)")

    # Element loads with a head dim of 64: misaligned q, k, v (ragged S), and
    # q, k, v, do for the backward.
    (b, h, s, dh), _, _, w, rate, seed = BAND_CASES[2]
    scale, seed_t = 1 / math.sqrt(dh), device_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv((b * h, s, dh), dtype, seed=45)
        want = fa.windowed_mha_reference(q.float(), k.float(), v.float(), scale, w, rate, seed)
        check_misaligned(f"5 band fwd {(b, h, s, dh)} {str(dtype)[6:]} window {w} dropout {rate}",
                         lambda q_, k_, v_: fa.band_fwd_cuda(q_, k_, v_, scale, w, rate, seed_t), q, k, v, want)
        bwd = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 46, window=w)
        check_window_bwd(f"5 band bwd, window {w}, dropout {rate}", (b, h, s, dh), *bwd, scale, w, rate, seed,
                         misaligned_too=True)
    free_cuda()
    return errs


# The halo cases: ((B, H, S, Dh) of one shard, dtype, scale, window, dropout, seed).
# The windowed-training cell on 2 ranks: B 2, 8 heads, 256 / 2 = 128 tokens, Dh 512.
HALO_TRAIN = ((2, 8, 128, 512), torch.float32, 1 / 64, 64, 0.1, 77)
# Config 2's group of 4 clips on 2 ranks: 8 heads, 128 tokens, Dh 1152.
HALO_CONFIG2 = ((4, 8, 128, 1152), torch.bfloat16, 1 / 96, 64, 0.0, 0)
HALO_CASES = [
    HALO_TRAIN,
    HALO_CONFIG2,
    ((2, 4, 72, 64), torch.float32, None, 24, 0.1, 5),  # S not a multiple of 16, w not of 16 or 8
    ((1, 4, 200, 1152), torch.bfloat16, 1 / 96, 200, 0.0, 0),  # a k_ext span of 7 key tiles
    ((1, 4, 128, 100), torch.bfloat16, None, 64, 0.1, 13),  # element loads, as in phase 5
    ((2, 2, 72, 98), torch.float32, None, 24, 0.0, 14),
]


def halo_inputs(shape, dtype, scale, w, rate, seed, has_prev, rng_seed):
    """q, k_ext, v_ext, do in ``dtype`` (k_ext, v_ext: S + w rows) and the
    plain forward's lse and delta on those values."""
    b, h, s, dh = shape
    rng = np.random.default_rng(rng_seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b * h, rows, dh), dtype=np.float32)).to("cuda", dtype)
                   for rows in (s, s + w, s + w, s))
    out, lse = fa.windowed_mha_halo_reference(q.float(), k.float(), v.float(), scale, w, has_prev, rate, seed)
    delta = (do.float() * out).sum(-1)
    return q, k, v, do, lse, delta


def halo_bwd(q, k, v, do, lse, delta, scale, w, has_prev, rate, seed):
    """(dq, dk_ext, dv_ext) of the halo backward's three passes."""
    return window_passes(q, k, v, do, lse, delta, scale, w, rate, seed, has_prev)[1:]


def halo_emulation(n: int) -> None:
    """n shards of the windowed-training sequence in one process: each
    shard's halo is its left neighbour's last window (zeros and has_prev 0
    on shard 0); the concatenated outputs, dq and the dk/dv assembled from
    each shard's dk_ext[w:] plus the next shard's dk_ext[:w] against
    windowed_mha (the banded kernels) over the whole sequence, dropout off."""
    (b, h, s_local, dh), _, scale, w, _, _ = HALO_TRAIN
    s = 2 * s_local
    rng = np.random.default_rng(90 + n)
    q, k, v, ct = (torch.from_numpy(rng.standard_normal((b, h, s, dh), dtype=np.float32)).cuda()
                   for _ in range(4))
    qw, kw, vw = (t.clone().requires_grad_() for t in (q, k, v))
    want = fa.windowed_mha(qw, kw, vw, window_size=w, scale=scale)
    want.backward(ct)
    chunk = s // n
    outs, dq, dk, dv = [], [], torch.zeros_like(k), torch.zeros_like(v)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        prev = slice(i * chunk - w, i * chunk) if i else slice(0, 0)
        halo_k = k[:, :, prev] if i else torch.zeros_like(k[:, :, :w])
        halo_v = v[:, :, prev] if i else torch.zeros_like(v[:, :, :w])
        qi = q[:, :, part].clone().requires_grad_()
        ki = torch.cat([halo_k, k[:, :, part]], 2).requires_grad_()
        vi = torch.cat([halo_v, v[:, :, part]], 2).requires_grad_()
        out = fa.windowed_mha_halo(qi, ki, vi, window_size=w, has_prev=int(i > 0), scale=scale)
        out.backward(ct[:, :, part])
        outs.append(out.detach())
        dq.append(qi.grad)
        dk[:, :, part] += ki.grad[:, :, w:]
        dv[:, :, part] += vi.grad[:, :, w:]
        if i:
            dk[:, :, prev] += ki.grad[:, :, :w]
            dv[:, :, prev] += vi.grad[:, :, :w]
    torch.cuda.synchronize()
    err = (torch.cat(outs, 2) - want.detach()).abs().max().item()
    check(err <= 1e-4, f"{n}-shard emulation out: {err}")
    rel = []
    for name, got, ref in (("dq", torch.cat(dq, 2), qw.grad), ("dk", dk, kw.grad), ("dv", dv, vw.grad)):
        e, m = rel_err(got, ref)
        check(e <= 1e-4 * m, f"{n}-shard emulation {name}: {e} > 1e-4 x {m}")
        rel.append(e / m)
    print(f"[5c halo emulation] {n} shards of {(b, h, s, dh)} fp32 window {w}: out max abs {err:.3g}, max abs / "
          f"max|ref| dq {rel[0]:.3g}, dk {rel[1]:.3g}, dv {rel[2]:.3g} against windowed_mha (tol 1e-4)")


def phase_halo_kernels() -> dict:
    """The halo forward, dq and dk/dv kernels against their plain versions
    and the banded kernels; the shard emulation. Returns the max abs errors
    at the config-2 shard (forward) and the training shard (backward), with
    has_prev 1."""
    errs = {}
    for i, case in enumerate(HALO_CASES):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        scale = 1 / math.sqrt(dh) if scale is None else scale
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        seed_t = device_seed(seed)
        for has_prev in (0, 1):
            prev = torch.tensor([has_prev], dtype=torch.int32).cuda()
            q, k, v, do, lse, delta = halo_inputs((b, h, s, dh), dtype, scale, w, rate, seed, has_prev, 100 + i)
            out, lse_k = fa.halo_fwd_cuda(q, k, v, scale, w, prev, rate, seed_t)
            again = fa.halo_fwd_cuda(q, k, v, scale, w, prev, rate, seed_t)
            torch.cuda.synchronize()
            check(torch.equal(out, again[0]) and torch.equal(lse_k, again[1]), f"halo fwd at {case} differs on repeat")
            ref_out, ref_lse = fa.windowed_mha_halo_reference(q.float(), k.float(), v.float(), scale, w,
                                                              has_prev, rate, seed)
            err = (out.float() - ref_out).abs().max().item()
            lse_err = (lse_k - ref_lse).abs().max().item()
            tag = f"{(b * h, s, s + w, dh)} {str(dtype)[6:]} window {w} dropout {rate} has_prev {has_prev}"
            print(f"[5c halo fwd] {tag}: out max abs {err:.3g}, lse max abs {lse_err:.3g} (tol {tol}); "
                  f"bits equal on repeat")
            check(math.isfinite(err) and err <= tol and lse_err <= tol, f"halo fwd vs plain at {tag}")
            e, got = check_window_bwd(f"5c halo bwd, window {w}, dropout {rate}, has_prev {has_prev}",
                                      (b * h, s, s + w, dh), q, k, v, do, lse, delta, scale, w, rate, seed,
                                      has_prev)
            if has_prev and case is HALO_CONFIG2:
                errs["halo_fwd"] = err
            if has_prev and case is HALO_TRAIN:
                errs.update({f"halo_bwd_{k_}": v_ for k_, v_ in e.items()})
            if has_prev:
                continue
            # has_prev 0: the banded kernels on the local sequence (k_ext[w:]).
            kl, vl = k[:, w:].contiguous(), v[:, w:].contiguous()
            band_out, band_lse = fa.band_fwd_cuda(q, kl, vl, scale, w, rate, seed_t)
            band_g = band_bwd(q, kl, vl, do, lse, delta, scale, w, rate, seed_t)
            torch.cuda.synchronize()
            pairs = [("out", out, band_out), ("lse", lse_k, band_lse), ("dq", got[0], band_g[0]),
                     ("dk", got[1][:, w:], band_g[1]), ("dv", got[2][:, w:], band_g[2])]
            bits = all(torch.equal(x, y) for _, x, y in pairs)
            worst = max(rel_err(x, y)[0] / max(rel_err(x, y)[1], 1e-30) for _, x, y in pairs)
            check(worst <= tol and not got[1][:, :w].any() and not got[2][:, :w].any(),
                  f"halo has_prev 0 vs band at {tag}: {worst}")
            check(all(torch.equal(x, y) for _, x, y in pairs[2:]),
                  f"halo has_prev 0 vs band at {tag}: the backward's bits differ")
            print(f"[5c halo vs band] {tag}: max abs / max|band| {worst:.3g} over out, lse, dq, dk, dv "
                  f"(tol {tol}); dq, dk, dv bits equal; out and lse bits equal {bits}; dk_ext, dv_ext of the "
                  f"masked halo window all 0")
    # Element loads with a head dim of 64: misaligned q, k_ext, v_ext.
    (b, h, s, dh), _, _, w, rate, seed = HALO_CASES[2]
    scale, seed_t = 1 / math.sqrt(dh), device_seed(seed)
    prev = torch.ones(1, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, lse, delta = halo_inputs((b, h, s, dh), dtype, scale, w, rate, seed, 1, 105)
        want = fa.windowed_mha_halo_reference(q.float(), k.float(), v.float(), scale, w, 1, rate, seed)
        check_misaligned(f"5c halo fwd {(b * h, s, s + w, dh)} {str(dtype)[6:]} window {w} dropout {rate}",
                         lambda q_, k_, v_: fa.halo_fwd_cuda(q_, k_, v_, scale, w, prev, rate, seed_t),
                         q, k, v, want)
        check_window_bwd(f"5c halo bwd, window {w}, dropout {rate}, has_prev 1", (b * h, s, s + w, dh), q, k, v,
                         do, lse, delta, scale, w, rate, seed, 1, misaligned_too=True)
    for n in (2, 4):
        halo_emulation(n)
    free_cuda()
    return errs

# Head dims past 1280: the flagship at 416^2, 512^2 and 768^2 ((size/4)^2 / 8 heads).
F1_HEAD_DIMS = (1352, 2048, 4608)


def check_fwd(tag: str, got, again, want, tol: float, lse_tol=None) -> float:
    """out and lse against the plain version (max abs <= tol, and <=
    ``lse_tol`` for the lse when given) and bit equality of a second
    launch; returns the out error."""
    err = (got[0].float() - want[0]).abs().max().item()
    lse_err = (got[1] - want[1]).abs().max().item()
    lse_tol = tol if lse_tol is None else lse_tol
    check(math.isfinite(err) and err <= tol and lse_err <= lse_tol,
          f"{tag}: out {err} > {tol} or lse {lse_err} > {lse_tol}")
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), f"{tag} differs on repeat")
    return err


def phase_head_dims() -> None:
    """The attention kernels past the old Dh limit of 1280 against their
    plain versions: flash at S 72, band at S 80 w 32, halo at S 64 w 32
    (k_ext 96, has_prev 1); fp32 with dropout 0.1, bf16 without."""
    for dh in F1_HEAD_DIMS:
        scale = 1 / math.sqrt(dh)
        for dtype, rate in ((torch.float32, 0.1), (torch.bfloat16, 0.0)):
            tol, seed, seed_t = (2e-2 if dtype == torch.bfloat16 else 1e-4), 21, device_seed(21)
            tag = f"Dh {dh} {str(dtype)[6:]} dropout {rate}"
            errs = {}
            # Flash: BH 2, S 72.
            q, k, v, do, lse, delta = bwd_inputs((1, 2, 72, dh), dtype, scale, rate, seed, 200 + dh)
            want = fa.mha_reference(q.float(), k.float(), v.float(), scale, rate, seed)
            errs["flash fwd"] = check_fwd(f"5d flash fwd {tag}", fa._flash_fwd_cuda(q, k, v, scale, rate, seed_t),
                                          fa._flash_fwd_cuda(q, k, v, scale, rate, seed_t), want, tol)
            got, again = (fa._flash_bwd_cuda(q, k, v, do, lse, delta, scale, rate, seed_t) for _ in range(2))
            want = fa.mha_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse, delta, scale, rate, seed)
            e = check_bwd(f"5d flash bwd {tag}", (1, 2, 72, dh), dtype, got, again, want)
            errs["flash dq, dk/dv"] = max(e)
            # Band: BH 2, S 80 (a partial last window), w 32.
            w = 32
            q, k, v, do, lse, delta = bwd_inputs((1, 2, 80, dh), dtype, scale, rate, seed, 300 + dh, window=w)
            want = fa.windowed_mha_reference(q.float(), k.float(), v.float(), scale, w, rate, seed)
            errs["band fwd"] = check_fwd(f"5d band fwd {tag}", fa.band_fwd_cuda(q, k, v, scale, w, rate, seed_t),
                                         fa.band_fwd_cuda(q, k, v, scale, w, rate, seed_t), want, tol)
            e, _ = check_window_bwd(f"5d band bwd {tag}", (1, 2, 80, dh), q, k, v, do, lse, delta, scale, w,
                                    rate, seed)
            errs["band dq, dk/dv"] = max(e["dq"], e["dkv"])
            # Halo: BH 2, S 64, w 32, k_ext 96, has_prev 1.
            prev = torch.ones(1, dtype=torch.int32, device="cuda")
            q, k, v, do, lse, delta = halo_inputs((1, 2, 64, dh), dtype, scale, w, rate, seed, 1, 400 + dh)
            want = fa.windowed_mha_halo_reference(q.float(), k.float(), v.float(), scale, w, 1, rate, seed)
            errs["halo fwd"] = check_fwd(f"5d halo fwd {tag}",
                                         fa.halo_fwd_cuda(q, k, v, scale, w, prev, rate, seed_t),
                                         fa.halo_fwd_cuda(q, k, v, scale, w, prev, rate, seed_t), want, tol)
            e, _ = check_window_bwd(f"5d halo bwd {tag}", (2, 64, 96, dh), q, k, v, do, lse, delta, scale, w,
                                    rate, seed, 1)
            errs["halo dq, dk/dv"] = max(e["dq"], e["dkv"])
            print(f"[5d head dims] {tag}: max abs " + ", ".join(f"{k_} {e_:.3g}" for k_, e_ in errs.items())
                  + f" (tol {tol}; the band and halo backward {bwd_limit(dtype)} x max|ref|); bits equal on repeat")
            del q, k, v, do, lse, delta, want
    free_cuda()


def seed_decoder(decoder: Decoder32K, seed: int) -> Decoder32K:
    """Non-trivial eval BN (scale, shift, running mean and variance) and
    conv biases from ``seed``, so that folding them is exercised."""
    rng = np.random.default_rng(seed)

    def draw(t, lo_or_mean, hi_or_std, uniform):
        v = rng.uniform(lo_or_mean, hi_or_std, t.shape) if uniform else rng.normal(lo_or_mean, hi_or_std, t.shape)
        t.copy_(torch.from_numpy(v.astype(np.float32)))

    with torch.no_grad():
        for m in decoder.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                draw(m.weight, 0.5, 1.5, True)
                draw(m.bias, 0.0, 0.2, False)
                draw(m.running_mean, 0.0, 0.2, False)
                draw(m.running_var, 0.5, 1.5, True)
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and m.bias is not None:
                draw(m.bias, 0.0, 0.2, False)
    return decoder


TAIL_SHAPES = [(2, 8, 8), (1, 9, 9), (1, 16, 24), (2, 56, 56)]  # (B, H, W) of the 384-channel input


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    """(max abs error, max|ref|)."""
    return (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()


# Phase 5b's fault: x (or the decoder's body) one input row off, rolled along H.
def shifted_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.roll(x, 1, dims=dim)


def phase_fused_tail_kernel() -> None:
    """The fused tail kernel against its plain version, both heads. Each
    case also runs the plain version on x one input row off, which must read
    more than 10x the case's limit, and prints beside its ratio the
    bf16-rounding budget: the plain chain with u rounded to bf16 as the
    kernel stores it, its output in x's dtype (``tail_chain``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for h_i, output_type in enumerate(("image", "mask")):
        decoder = Decoder32K(output_type=output_type)
        init_flax_default(decoder, torch.Generator().manual_seed(h_i))
        folded = ft.fold_tail_params(seed_decoder(decoder, 10 + h_i).to("cuda").eval())
        for i, (b, h, w) in enumerate(TAIL_SHAPES):
            x32 = torch.from_numpy(np.random.default_rng(80 + i).standard_normal((b, h, w, ft.CIN),
                                                                                  dtype=np.float32)).cuda()
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x = x32.to(dtype)
                got = ft.fused_tail_cuda(x, folded, output_type)
                again = ft.fused_tail_cuda(x, folded, output_type)
                strided = ft.fused_tail_cuda(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                                             folded, output_type)
                torch.cuda.synchronize()
                plain_folded = {k: v.to(dtype).float() for k, v in folded.items()}
                with torch.no_grad():
                    ref = ft.fused_tail_reference(x.float(), plain_folded, output_type)
                    fault = ft.fused_tail_reference(shifted_rows(x.float(), 1), plain_folded, output_type)
                    budget = ft.tail_chain(x, ft.pack_tail_weights(folded, dtype), output_type,
                                           round_to=dtype if dtype != torch.float32 else None)
                err, scale = rel_err(got, ref)
                fault_ratio, budget_ratio = rel_err(fault, ref)[0] / scale, rel_err(budget, ref)[0] / scale
                print(f"[5b fused tail] {(b, h, w, ft.CIN)} {str(dtype)[6:]} {output_type}: max abs {err:.3g}, "
                      f"max|ref| {scale:.3g}, ratio {err / scale:.3g} (tol {tol}; the plain chain with u in "
                      f"{str(dtype)[6:]}: {budget_ratio:.3g}; x one row off: {fault_ratio:.3g}); bits equal "
                      f"on repeat and for the NHWC view of an NCHW input")
                check(got.shape == (b, 2 * h, 2 * w, 1 if output_type == "mask" else 3), f"shape {got.shape}")
                check(math.isfinite(err) and err <= tol * scale, f"fused tail vs plain at {(b, h, w)} {dtype}")
                check(fault_ratio > 10 * tol, f"fused tail at {(b, h, w)} {dtype}: x one row off reads "
                      f"{fault_ratio} x max|ref|, not 10 x the limit {tol}")
                check(torch.equal(got, again) and torch.equal(got, strided),
                      f"fused tail at {(b, h, w)} {dtype} differs between launches or layouts")
    x = torch.zeros(1, 2, 2, ft.CIN, device="cuda")
    for bad_x, bad_folded, exc in ((x.half(), folded, TypeError), (x[..., :256], folded, ValueError),
                                   (x, dict(folded, w0=folded["w0"][:, :, :, :32]), ValueError)):
        try:
            ft.fused_tail_cuda(bad_x, bad_folded, "mask")
        except exc:
            continue
        raise RuntimeError("chip_smoke check failed: the fused tail took what it does not take")
    print("[5b fused tail] fp16 input, 256 input channels and a 32-channel conv0 raise")
    torch.backends.cudnn.allow_tf32 = True


# Phase 5b's decoder path: (tag, size, batch, frames, window, dtype, tol).
DECODER_CASES = (
    ("config 1", 224, 8, 16, 0, torch.bfloat16, 2e-2),
    ("fp32, TF32 off", 224, 1, 16, 0, torch.float32, 1e-3),
    ("config 2 group", 384, 4, 32, 64, torch.bfloat16, 2e-2),
)


def decoder_model(size: int, window: int, dtype: torch.dtype) -> VideoHybridNet:
    """Phase 5b's flagship (seed 0, decoder BN and biases seeded), in eval mode."""
    cfg = flagship_video_config(size, attn_impl="flash", window_size=window)
    model = VideoHybridNet(cfg, device="cuda", dtype=dtype, generator=torch.Generator().manual_seed(0))
    seed_decoder(model.decoder, 30)
    return model.eval()


def decoder_body(model: VideoHybridNet, clip: torch.Tensor) -> torch.Tensor:
    """The decoder's body (NCHW) on the latent of one forward's tokens."""
    b, t = clip.shape[:2]
    with torch.inference_mode():
        tokens, hw = model.encode_clip(clip)
        tokens = model.temporal_mix(tokens)
        latent = tokens_to_latent(tokens.reshape(b * t, model.config.tokens_per_frame, tokens.shape[-1]), hw)
        return model.decoder.body(latent)


def fp32_tail(decoder: Decoder32K, body: torch.Tensor) -> torch.Tensor:
    """``decoder.tail`` in fp32 with TF32 off on ``body``, 32 frames at a
    time, NHWC: the decoder path's reference."""
    decoder32 = copy.deepcopy(decoder).float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        out = torch.cat([decoder32.tail(part.float()) for part in body.split(32)]).permute(0, 2, 3, 1)
    torch.backends.cudnn.allow_tf32 = tf32
    return out


def fused_decode(model: VideoHybridNet, clip: torch.Tensor):
    """Tokens of one forward over ``clip``, the decoder's body on their
    latent, then its tail three ways on that body: the fused kernel
    (counted), ``Decoder32K.tail`` (the cuDNN chain) in the model's dtype,
    and the same chain in fp32 with TF32 off, the reference, also on the
    body one row off. Returns (fused, chain, fp32 chain, fp32 chain one row
    off) NHWC and the launch counts of the fused call."""
    body = decoder_body(model, clip)
    with torch.inference_mode():
        folded = ft.fold_tail_params(model.decoder)
        torch.cuda.synchronize()
        reset_counts()
        got = ft.fused_decoder_tail(body.permute(0, 2, 3, 1), folded, model.config.output_type)
        torch.cuda.synchronize()
        launches = counts()
        chain = torch.cat([model.decoder.tail(part) for part in body.split(32)]).permute(0, 2, 3, 1)
    exact = fp32_tail(model.decoder, body)
    fault = fp32_tail(model.decoder, shifted_rows(body, 2))
    torch.cuda.synchronize()
    return got, chain, exact, fault, launches


def phase_decoder_path() -> dict:
    """The flagship decoder through body + the fused tail; returns the
    fused-tail launches of each call, by tag. The kernel is held to the fp32
    chain on the same body; in bf16 it must also be no farther from it than
    the bf16 cuDNN chain it replaces, which rounds u, a0 and a1 to bf16."""
    tail_launches = {}
    for tag, size, batch, frames, window, dtype, tol in DECODER_CASES:
        torch.backends.cudnn.allow_tf32 = dtype != torch.float32
        model = decoder_model(size, window, dtype)
        clip = preprocess_clip(random_clip(batch, frames, size, seed=5), size, dtype=dtype)
        got, chain, exact, fault, launches = fused_decode(model, clip)
        err, scale = rel_err(got, exact)
        chain_err, _ = rel_err(chain, exact)
        fault_ratio = rel_err(fault, exact)[0] / scale
        print(f"[5b decoder path] {tag}: {str(dtype)[6:]} B={batch} T={frames} {size}^2, body + fused tail "
              f"{tuple(got.shape)} vs the fp32 chain (TF32 off): max abs {err:.3g}, max|ref| {scale:.3g}, "
              f"ratio {err / scale:.3g} (tol {tol}); Decoder32K.tail (cuDNN, {str(dtype)[6:]}) vs the fp32 "
              f"chain {chain_err:.3g} (ratio {chain_err / scale:.3g}), vs the kernel "
              f"{rel_err(got, chain)[0]:.3g}; the fp32 chain on the body one row off {fault_ratio:.3g}; "
              f"fused_tail launches {launches['fused_tail_launches']}")
        check(got.shape == exact.shape == (batch * frames, size, size, 3), f"decoder path shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"non-finite fused tail output ({tag})")
        check(err <= tol * scale, f"decoder path {tag}: {err} > {tol} x {scale}")
        check(fault_ratio > 10 * tol, f"decoder path {tag}: the body one row off reads {fault_ratio} x max|ref|, "
              f"not 10 x the limit {tol}")
        check(dtype == torch.float32 or err <= chain_err,
              f"decoder path {tag}: the kernel ({err}) is farther from the fp32 chain than cuDNN ({chain_err})")
        check(launches == expect_counts(fused_tail_launches=1), f"decoder path {tag} launches {launches}")
        tail_launches[tag] = launches["fused_tail_launches"]
        del model, clip, got, chain, exact, fault
        free_cuda()
    torch.backends.cudnn.allow_tf32 = True
    return tail_launches


def phase_flagship_fp32(tag: str = "6 flagship fp32", size: int = 224) -> None:
    torch.backends.cudnn.allow_tf32 = False  # matmuls run without TF32 by default
    clip = preprocess_clip(random_clip(1, 16, size, seed=1), size)
    outs = {}
    for impl in ("flash", "xla"):
        model = VideoHybridNet(flagship_video_config(size, attn_impl=impl), device="cuda",
                               generator=torch.Generator().manual_seed(0)).eval()
        with dispatch_trace.capture() as seen, torch.inference_mode():
            outs[impl] = model(clip)
        torch.cuda.synchronize()
        check(("flash_mha_cuda" in seen) == (impl == "flash"), f"{impl} run recorded {sorted(seen)}")
        del model
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs["flash"], outs["xla"])]
    finite = all(bool(torch.isfinite(t).all()) for t in outs["flash"])
    print(f"[{tag}] B=1 T=16 {size}^2 flash vs xla: tokens max abs {errs[0]:.3g}, "
          f"recon max abs {errs[1]:.3g} (tol 1e-3), finite {finite}")
    check(finite and max(errs) <= 1e-3, f"flagship fp32 flash vs xla at {size}^2")
    del outs, clip
    free_cuda()
    torch.backends.cudnn.allow_tf32 = True


def no_dropout(cfg):
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout_rate=0.0),
                               temporal=dataclasses.replace(cfg.temporal, dropout_rate=0.0))


def compare_grads(tag: str, size: int, frames: int, impls, marker: str, window: int = 0) -> None:
    """Train-mode fp32 gradients of impls[0] (the kernels) against impls[1]
    (a dense core) from the same weights, dropout off, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    clip = preprocess_clip(random_clip(1, frames, size, seed=3), size)
    grads = {}
    for impl in impls:
        cfg = no_dropout(flagship_video_config(size, attn_impl=impl, window_size=window))
        model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).train()
        with dispatch_trace.capture() as seen:
            _, recon = model(clip)
            losses.mse(recon, clip).backward()
        torch.cuda.synchronize()
        check((marker in seen) == (impl == impls[0]), f"{impl} run recorded {sorted(seen)}")
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model
    gmax = max(g.abs().max().item() for g in grads[impls[1]].values())
    diffs = {n: (grads[impls[0]][n] - g).abs().max().item() for n, g in grads[impls[1]].items()}
    worst = max(diffs, key=diffs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads[impls[0]].values())
    print(f"[{tag}] fp32 B=1 T={frames} {size}^2 train mode, {impls[0]} vs {impls[1]}: max grad diff "
          f"{diffs[worst]:.3g} ({worst}), max |grad| {gmax:.3g}, ratio {diffs[worst] / gmax:.3g} "
          f"(tol 1e-3), finite {finite}")
    check(finite and diffs[worst] <= 1e-3 * gmax, f"flagship fp32 gradients {impls[0]} vs {impls[1]}")
    del grads
    free_cuda()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True


def phase_flagship_grads() -> None:
    compare_grads("7 flagship grads", 256, 8, ("flash", "xla"), "flash_mha_bwd_cuda")


def phase_flagship_416() -> None:
    """Dh 1352 (past the old limit of 1280) through the whole flagship."""
    phase_flagship_fp32("7b flagship 416^2 fp32, Dh 1352", 416)
    compare_grads("7b flagship 416^2 grads, Dh 1352", 416, 16, ("flash", "xla"), "flash_mha_bwd_cuda")


def phase_windowed_flagship():
    """Returns the "flash" eval forward's (tokens, recon) on the CPU: the
    reference of phase 12b (a)."""
    torch.backends.cudnn.allow_tf32 = False
    clip = preprocess_clip(random_clip(1, 32, 384, seed=4), 384)
    outs = {}
    for impl, marker in (("flash", "flash_windowed_cuda"), ("windowed", "sdpa_windowed")):
        model = VideoHybridNet(flagship_video_config(384, attn_impl=impl, window_size=64), device="cuda",
                               generator=torch.Generator().manual_seed(0)).eval()
        with dispatch_trace.capture() as seen, torch.inference_mode():
            outs[impl] = model(clip)
        torch.cuda.synchronize()
        check(marker in seen and "flash_mha_cuda" not in seen, f"{impl} run recorded {sorted(seen)}")
        del model
        free_cuda()
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs["flash"], outs["windowed"])]
    finite = all(bool(torch.isfinite(t).all()) for t in outs["flash"])
    print(f"[8 windowed flagship fp32] B=1 T=32 384^2 window 64, flash vs windowed: tokens max abs "
          f"{errs[0]:.3g}, recon max abs {errs[1]:.3g} (tol 1e-3), finite {finite}")
    check(finite and max(errs) <= 1e-3, "windowed flagship fp32 flash vs windowed")
    eval_ref = tuple(t.float().cpu() for t in outs["flash"])
    del outs, clip
    free_cuda()
    torch.backends.cudnn.allow_tf32 = True
    compare_grads("8 windowed flagship grads", 256, 32, ("flash", "windowed"),
                  "flash_windowed_bwd_cuda", window=64)
    return eval_ref


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
    check(launches == expect_counts(launches=cfg.temporal.num_layers), f"launches {launches}")
    check(tokens.shape == (batch, frames * 8, (size // 4) ** 2), f"tokens {tuple(tokens.shape)}")
    check(recon.shape == (batch, frames, size, size, 3), f"recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(tokens).all() and torch.isfinite(recon).all()), "non-finite output")
    t = time_clips(model, clip_u8, size, torch.bfloat16, iters=10)
    print(f"[9 infer main path] bf16 B={batch} T={frames} {size}^2: flash_fwd launches "
          f"{launches['launches']}, {t['frames_per_s']:.1f} frames/s, p50 clip "
          f"{t['p50_clip_latency_ms']:.3f} ms, rep spread {t['rep_spread_pct']:.2f}%")
    stages = stage_ms(model, clip_u8, size, torch.bfloat16)
    print("[9 stages] device ms per forward: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    del model
    free_cuda()
    return launches["launches"]


def print_profile(tag: str, prof: dict) -> None:
    print(f"[{tag}] wall {prof['wall_ms_per_call']:.1f} ms, device busy "
          f"{prof['device_busy_ms_per_call']:.1f} ms, idle share {100 * prof['device_idle_share']:.2f}%")
    for name, ms, n in prof["top_kernels_ms_per_call"]:
        print(f"[{tag}]   {ms:9.3f} ms  x{n:<4d} {name}")


def phase_config2() -> int:
    """BASELINE config 2: the windowed flagship at 384^2 over batch 16 of
    32-frame clips in microbatches of 4."""
    batch, frames, size, window, micro = 16, 32, 384, 64, 4
    cfg = flagship_video_config(size, attn_impl="flash", window_size=window)
    model = VideoHybridNet(cfg, device="cuda", dtype=torch.bfloat16).eval()
    clip_u8 = random_clip(batch, frames, size, seed=0)
    per_call = cfg.temporal.num_layers * batch // micro
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with dispatch_trace.capture() as seen:
        recon = microbatched_infer(model, preprocess_clip(clip_u8, size, dtype=torch.bfloat16), micro)
    torch.cuda.synchronize()
    launches = counts()
    check("flash_windowed_cuda" in seen and not seen & {"flash_mha_cuda", "sdpa_xla", "sdpa_windowed"},
          f"config 2 recorded {sorted(seen)}")
    check(launches == expect_counts(band_fwd_launches=per_call), f"config 2 launches {launches}")
    check(recon.shape == (batch, frames, size, size, 3), f"recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(recon).all()), "non-finite config 2 output")
    del recon
    t = time_clips(model, clip_u8, size, torch.bfloat16, iters=2, microbatch=micro)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[10 config 2] bf16 B={batch} T={frames} {size}^2 window {window} microbatch {micro}: "
          f"band_fwd launches {launches['band_fwd_launches']} per call, flash launches "
          f"{launches['launches']}; {t['frames_per_s']:.1f} frames/s, p50 batch "
          f"{t['p50_batch_latency_ms']:.1f} ms, rep spread {t['rep_spread_pct']:.2f}%, "
          f"peak memory {peak_gb:.2f} GB")
    stages = stage_ms(model, clip_u8[:micro], size, torch.bfloat16)
    print(f"[10 config 2 stages] device ms per group of {micro}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    print_profile("10 config 2 profile", profile_window(
        infer_fn(model, clip_u8, size, torch.bfloat16, micro), iters=1, top=10))
    del model
    free_cuda()
    return launches["band_fwd_launches"]


def step_split(step, state, batches) -> dict:
    """Median device ms of a step's data, forward, backward and optimizer
    phases (CUDA events at the step's marks) over ``batches``."""
    split = {k: [] for k in ("data", "forward", "backward", "optimizer")}
    for b in batches:
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        mark("start")
        step(state, b, mark=mark)
        torch.cuda.synchronize()
        names = ["start", *split]
        for a, z in zip(names, names[1:]):
            split[z].append(events[a].elapsed_time(events[z]))
    return {k: statistics.median(v) for k, v in split.items()}


def phase_train(tag: str, batch: int, frames: int, window: int = 0) -> dict:
    """The ``tchvp video`` training defaults on the flagship at 256^2, with
    flash attention or, with a window, the banded kernels. Returns the
    launch counts of the last main-path step and the median step ms."""
    size, steps = 256, 5
    cfg = flagship_video_config(size, attn_impl="flash", window_size=window)
    n = cfg.temporal.num_layers
    if window:  # the banded backward's pass A, then pass B's dq and dk/dv
        kind, fwd, dq, dkv = "band", "band_fwd_launches", "band_dq_launches", "band_dkv_launches"
        bwd = {"band_ds_launches": n, dq: n, dkv: n}
        markers = {"flash_windowed_cuda", "flash_windowed_bwd_cuda"}
    else:
        kind, fwd, dq, dkv = "flash", "launches", "dq_launches", "dkv_launches"
        bwd = {dq: n, dkv: n}
        markers = {"flash_mha_cuda", "flash_mha_bwd_cuda"}
    model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0),
                               rng=0)
    step = make_video_train_step(size, loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05)
    clips = [random_clip(batch, frames, size, seed=20 + i) for i in range(steps)]
    params0 = {n_: p.detach().clone() for n_, p in model.named_parameters()}
    stats0 = {n_: b.clone() for n_, b in model.named_buffers() if "running" in n_}
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for clip in clips:
        reset_counts()
        with dispatch_trace.capture() as seen:
            metrics.append(step(state, clip)[1])
        torch.cuda.synchronize()
        launches = counts()
        check(launches == expect_counts(**{fwd: n}, **bwd), f"train step launches {launches}")
        check(markers <= seen and not seen & {"sdpa_xla", "sdpa_windowed"},
              f"train step recorded {sorted(seen)}")
    step_counts = launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = torch.stack([m["loss"] for m in metrics]).tolist()
    psnr = torch.stack([m["psnr"] for m in metrics]).tolist()
    check(all(math.isfinite(x) for x in loss + psnr), f"loss {loss}, psnr {psnr}")
    still = [n_ for n_, p in model.named_parameters() if torch.equal(p.detach(), params0[n_])]
    check(not still, f"parameters unchanged after {steps} steps: {still[:5]}")
    still = [n_ for n_, b in model.named_buffers() if n_ in stats0 and torch.equal(b, stats0[n_])]
    check(not still, f"BatchNorm stats unchanged after {steps} steps: {still[:5]}")
    del params0, stats0
    print(f"[{tag}] fp32 B={batch} T={frames} {size}^2" + (f" window {window}" if window else "")
          + f" mixed loss, AdamW, dropout on: {steps} steps, {kind} launches per step fwd {n}, "
          + (f"ds (pass A) {n}, " if window else "") + f"dq {n}, dkv {n}, other kernels 0; loss {[round(x, 5) for x in loss]}, "
          f"psnr {[round(x, 3) for x in psnr]}; peak memory {peak_gb:.2f} GB")

    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for clip in clips[:2]:
            step(state, clip)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 2)
    med = statistics.median(reps)
    print(f"[{tag}] {1 / med:.3f} steps/s, {batch * frames / med:.1f} trained frames/s, "
          f"step {med * 1e3:.1f} ms (median of 3 reps of 2 steps), rep spread "
          f"{100 * (max(reps) - min(reps)) / med:.2f}%")

    split = step_split(step, state, clips[:3])
    print(f"[{tag}] device ms per step (median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))

    print_profile(f"{tag} profile", profile_window(lambda: step(state, clips[0]), iters=1, top=10))

    stages = make_video_train_step(size, loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05,
                                   remat_policy="stages")
    reset_counts()
    _, m = stages(state, clips[1])
    torch.cuda.synchronize()
    launches = counts()
    check(launches == expect_counts(**{fwd: 2 * n}, **bwd), f"remat stages launches {launches}")
    check(math.isfinite(m["loss"].item()), "remat stages loss")
    print(f"[{tag}] remat 'stages' step: {kind} launches fwd {launches[fwd]}, "
          + (f"ds {launches['band_ds_launches']}, " if window else "")
          + f"dq {launches[dq]}, dkv {launches[dkv]}, loss {m['loss'].item():.5f}")
    del model, state, clips
    free_cuda()
    return step_counts, med * 1e3


SEQ_DIR = build.BUILD_DIR / "seq_smoke"  # rendezvous, references, results: ignored by git
SEQ_RANKS = 2
SEQ_LABEL = "2 ranks sharing one H100, gloo host-staged halo"
# The windowed-training cell of phase 12: 256^2, B 2 of 32-frame clips, window 64.
SEQ_TRAIN = dict(size=256, batch=2, frames=32, window=64)


def seq_train_setup(dropout: bool, sgd: bool, seq_axis=None):
    """The windowed-training cell's model (seed 0), state and step; SGD lr 1
    (the update is 1.9 x the gradient) or the cell's AdamW."""
    cfg = flagship_video_config(SEQ_TRAIN["size"], attn_impl="flash", window_size=SEQ_TRAIN["window"],
                                seq_axis=seq_axis)
    model = VideoHybridNet(cfg if dropout else no_dropout(cfg), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    tx = make_optimizer(1.0, optimizer="sgd") if sgd else make_optimizer(1e-4, weight_decay=0.01,
                                                                          grad_clip_norm=1.0)
    state = create_train_state(model, tx, rng=0)
    step = make_video_train_step(SEQ_TRAIN["size"], loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05)
    return model, state, step


def seq_clip(seed: int) -> torch.Tensor:
    return random_clip(SEQ_TRAIN["batch"], SEQ_TRAIN["frames"], SEQ_TRAIN["size"], seed=seed)


def seq_rank(rank: int, world: int) -> None:
    """One rank of phase 12b; writes its results to SEQ_DIR/rank<r>.json."""
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    parallel.init_distributed(f"file://{SEQ_DIR / 'rendezvous'}", world, rank, timeout_s=180)
    build.load_all(LIBRARIES)  # built by the parent: loads, compiles nothing
    mesh = parallel.make_mesh(("seq",), (world,))
    group = parallel.axis_group(mesh, "seq")
    eval_ref = torch.load(SEQ_DIR / "eval_ref.pt", weights_only=False)
    got = {}
    with parallel.activate_mesh(mesh):
        # (a) the fp32 eval forward at config 2's geometry, this rank's frames.
        cfg = flagship_video_config(384, attn_impl="flash", window_size=64, seq_axis="seq")
        model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).eval()
        clip = parallel.shard_frames(preprocess_clip(random_clip(1, 32, 384, seed=4), 384), mesh, "seq")
        reset_counts()
        with torch.inference_mode():
            tokens, recon = model(clip)
        torch.cuda.synchronize()
        got["a_counts"] = counts()
        check(got["a_counts"] == expect_counts(halo_fwd_launches=2), f"(a) launches {got['a_counts']}")
        # This rank's rows of phase 8's single-process tokens and frames.
        errs = [(x.float().cpu() - ref.narrow(1, rank * x.shape[1], x.shape[1])).abs().max().item()
                for x, ref in zip((tokens, recon), eval_ref)]
        got["a_err"] = max(errs)
        check(bool(torch.isfinite(recon).all()) and got["a_err"] <= 1e-3,
              f"(a) rank {rank} eval forward vs single process: tokens, recon max abs {errs}")
        del model, tokens, recon, clip, eval_ref
        free_cuda()

        # (b) one step of the cell, dropout off, SGD lr 1.
        model, state, step = seq_train_setup(dropout=False, sgd=True, seq_axis="seq")
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        reset_counts()
        with dispatch_trace.capture() as seen:
            _, m = step(state, seq_clip(21))
        torch.cuda.synchronize()
        got["b_counts"] = counts()
        check(got["b_counts"] == expect_counts(halo_fwd_launches=2, halo_ds_launches=2, halo_dq_launches=2,
                                               halo_dkv_launches=2), f"(b) launches {got['b_counts']}")
        check({"seq_sharded_shard_map", "windowed_mha_halo", "flash_halo_cuda", "flash_halo_bwd_cuda"} <= seen
              and not seen & {"flash_windowed_cuda", "flash_mha_cuda", "sdpa_xla", "sdpa_windowed"},
              f"(b) recorded {sorted(seen)}")
        got["b_loss"] = m["loss"].item()
        stats = {n: b for n, b in model.named_buffers() if "running" in n}
        named = dict(model.named_parameters())
        equal = collectives.equal_across(list(named.values()) + list(stats.values()), group)
        check(all(equal), f"(b) {equal.count(False)} parameters or stats differ across ranks")
        if rank == 0:
            ref = torch.load(SEQ_DIR / "step_ref.pt", map_location="cpu", weights_only=False)
            got["b_loss_ref"] = ref["loss"]
            check(abs(got["b_loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]), f"(b) loss {got['b_loss']} vs {ref['loss']}")
            g_ref = {n: (p0[n] - ref["params"][n].cuda()) / 1.9 for n in named}
            gmax = max(g.abs().max().item() for g in g_ref.values())
            worst = max(((named[n].detach() - ref["params"][n].cuda()).abs().max().item(), n) for n in named)
            got["b_param_err"], got["b_gmax"] = worst[0], gmax
            check(worst[0] <= 1.9 * 2e-2 * gmax, f"(b) parameter {worst[1]}: {worst[0]} > 1.9 x 2e-2 x {gmax}")
            stat_err = max((b - ref["stats"][n].cuda()).abs().max().item() / max(1.0, ref["stats"][n].abs().max().item())
                           for n, b in stats.items())
            got["b_stat_err"] = stat_err
            check(stat_err <= 1e-5, f"(b) BatchNorm stats: {stat_err}")
        del model, state, step, p0, named, stats
        free_cuda()

        # (c) 3 steps with dropout on at the cell's AdamW: the per-rank times.
        model, state, step = seq_train_setup(dropout=True, sgd=False, seq_axis="seq")
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        times, losses_ = [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, seq_clip(30 + i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses_.append(m["loss"].item())
        still = [n for n, p in model.named_parameters() if torch.equal(p.detach(), p0[n])]
        check(all(math.isfinite(x) for x in losses_) and not still, f"(c) loss {losses_}, unmoved {still[:5]}")
        got["c_loss"], got["c_step_ms"] = losses_, times
        got["c_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    (SEQ_DIR / f"rank{rank}.json").write_text(json.dumps(got))
    torch.distributed.destroy_process_group()


def phase_seq_two_ranks(eval_ref) -> dict:
    """Phase 12b: the references in this process, then SEQ_RANKS ranks on
    this card. Returns rank 0's launch counts of the main-path step."""
    import torch.multiprocessing as mp

    shutil.rmtree(SEQ_DIR, ignore_errors=True)
    SEQ_DIR.mkdir(parents=True)
    torch.backends.cudnn.allow_tf32 = False
    model, state, step = seq_train_setup(dropout=False, sgd=True)
    _, m = step(state, seq_clip(21))
    torch.cuda.synchronize()
    torch.save(eval_ref, SEQ_DIR / "eval_ref.pt")
    torch.save({"loss": m["loss"].item(),
                "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                "stats": {n: b.cpu() for n, b in model.named_buffers() if "running" in n}},
               SEQ_DIR / "step_ref.pt")
    del model, state, step
    free_cuda()
    t0 = time.perf_counter()
    mp.spawn(seq_rank, args=(SEQ_RANKS,), nprocs=SEQ_RANKS, join=True)
    wall = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True
    ranks = [json.loads((SEQ_DIR / f"rank{r}.json").read_text()) for r in range(SEQ_RANKS)]
    r0 = ranks[0]
    print(f"[12b seq parallel] {SEQ_LABEL}, mesh ('seq',) of {SEQ_RANKS}, spawned in {wall:.1f} s: "
          f"(a) fp32 eval 384^2 B 1 T 32 w 64, each rank's frames vs phase 8: max abs "
          f"{[round(r['a_err'], 7) for r in ranks]} (tol 1e-3), "
          f"halo fwd launches {r0['a_counts']['halo_fwd_launches']} per rank")
    print(f"[12b seq parallel] (b) 256^2 B 2 T 32 w 64 fp32, SGD lr 1: loss {r0['b_loss']:.7f} vs single process "
          f"{r0['b_loss_ref']:.7f}; parameters max abs {r0['b_param_err']:.3g} (tol 1.9 x 2e-2 x max|g| "
          f"{r0['b_gmax']:.3g}); BN stats {r0['b_stat_err']:.3g} (tol 1e-5); bit-equal across ranks; halo launches "
          f"per rank fwd {r0['b_counts']['halo_fwd_launches']}, ds {r0['b_counts']['halo_ds_launches']}, "
          f"dq {r0['b_counts']['halo_dq_launches']}, dkv "
          f"{r0['b_counts']['halo_dkv_launches']}, band and flash 0")
    for r, got in enumerate(ranks):
        print(f"[12b seq parallel] (c) rank {r} ({SEQ_LABEL}; not a scaling number), dropout on, AdamW: loss "
              f"{[round(x, 5) for x in got['c_loss']]}, step ms {[round(x, 1) for x in got['c_step_ms']]}, "
              f"peak memory {got['c_peak_gb']:.2f} GB")
    return r0["b_counts"]


def phase_streaming() -> None:
    """BASELINE config 4: 1080p through 256^2 tiles, chunk 8, 4 frames of context."""
    frames, (h, w) = 16, (1080, 1920)
    model = VideoHybridNet(flagship_video_config(256), device="cuda", dtype=torch.bfloat16).eval()
    scfg = StreamingConfig(tile=256, chunk_len=8, ctx_frames=4)
    clip = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, frames, h, w, 3)).astype(np.float32))
    clip = clip.to("cuda")
    reset_counts()
    with dispatch_trace.capture() as seen:
        recon = stream_video(model, clip, scfg)
    torch.cuda.synchronize()
    check(recon.shape == (1, frames, h, w, 3), f"streaming recon {tuple(recon.shape)}")
    check(bool(torch.isfinite(recon).all()), "non-finite streaming output")
    check(counts() == expect_counts() and seen == {"sdpa_xla"}, f"streaming ran {counts()}, {sorted(seen)}")
    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream_video(model, clip, scfg)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    med = statistics.median(reps)
    tiles = math.ceil(h / 256) * math.ceil(w / 256)
    print(f"[13 config 4 streaming] bf16 1x{frames}x{h}x{w} in {tiles} tiles of 256^2, chunk 8, "
          f"context 4 frames ({(8 + 4) * 8} tokens per chunk): {frames / med:.2f} frames/s, "
          f"{frames * h * w / med / 1e6:.1f} megapixels/s (median of 3 clips, spread "
          f"{100 * (max(reps) - min(reps)) / med:.2f}%)")
    del model, clip, recon
    free_cuda()


DATA_CLIPS, DATA_SEED = 24, 15
DATA_AUG = AugmentConfig(rot90_prob=0.5, crop_prob=0.5, jitter_prob=0.5)


def endless(data):
    """``data``'s epochs one after another."""
    while True:
        yield from data


def check_packed_readers(native: ClipPackDataset, plain: ClipPackDataset) -> None:
    """(a): bit-equal batches over two epochs and after a seek to mid-epoch."""
    for epoch in range(2):
        got, want = list(native), list(plain)
        check(len(got) == len(want) == len(native)
              and all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"native and numpy clippack batches differ in epoch {epoch}")
    for ds in (native, plain):
        ds.seek(3, 1)
    got, want = list(native), list(plain)
    check(len(got) == len(native) - 1 and all(np.array_equal(a, b) for a, b in zip(got, want)),
          "native and numpy clippack batches differ after a seek to epoch 3, batch 1")
    check(native.position() == plain.position() == {"epoch": 4, "batch": 0},
          f"positions {native.position()}, {plain.position()}")


def host_ms_per_batch(ds: ClipPackDataset, epochs: int = 2) -> float:
    t0 = time.perf_counter()
    n = sum(1 for _ in range(epochs) for _ in ds)
    return (time.perf_counter() - t0) * 1e3 / n


def check_prefetch(native: ClipPackDataset, plain: ClipPackDataset) -> None:
    """(b): every prefetched batch a CUDA uint8 tensor equal to the host
    batch; position() the inner position minus the held batches."""
    pf = DevicePrefetch(native, size=2, device="cuda")
    spe = len(native)
    epoch = native.position()["epoch"]
    for i, (dev, host) in enumerate(zip(pf, plain)):
        check(dev.is_cuda and dev.dtype == torch.uint8 and tuple(dev.shape) == host.shape,
              f"prefetched batch {dev.device} {dev.dtype} {tuple(dev.shape)}")
        check(torch.equal(dev.cpu(), torch.from_numpy(host)), f"prefetched batch {i} differs from the host's")
        inner = native.position()
        held = pf._held()
        want = {"epoch": epoch + (i + 1) // spe, "batch": (i + 1) % spe}
        check(pf.position() == want and inner["epoch"] * spe + inner["batch"] - held
              == want["epoch"] * spe + want["batch"],
              f"prefetch position {pf.position()} (inner {inner}, {held} held), want {want}")
        if i == 0:
            check(held == min(2, spe - 1), f"{held} batches held after the first")
            print(f"[15 data path] (b) after batch 0 of epoch {epoch}: inner position {inner}, "
                  f"{held} held, DevicePrefetch.position() {pf.position()}")


AUG_CHECKS = (  # (name, draws, draw-taking form, exact)
    ("hflip", lambda g, x: (torch.tensor(True),), pipeline.hflip_with, True),
    ("rot90", lambda g, x: pipeline.rot90_draws(g, x, 0.5), pipeline.rot90_with, True),
    ("blackout", lambda g, x: pipeline.blackout_draws(g, x, 3, 16),
     lambda x, *d: pipeline.blackout_with(x, *d, 16), True),
    ("crop-resize", lambda g, x: pipeline.crop_draws(g, x, 0.5, DATA_AUG.crop_frac),
     lambda x, *d: pipeline.crop_resize_with(x, *d, DATA_AUG.crop_frac), False),
    ("jitter", lambda g, x: pipeline.jitter_draws(g, x, 0.5, DATA_AUG.jitter_strength),
     pipeline.jitter_with, False),
)


def phase_augmentations(x: torch.Tensor) -> None:
    """(c): the augmentations on the card without a host sync, against the
    CPU on given draws, and their device ms."""
    gen = torch.Generator("cuda").manual_seed(DATA_SEED)
    public = {
        "augment_geometric": lambda: pipeline.augment_geometric(gen, x, DATA_AUG),
        "augment_denoising": lambda: pipeline.augment_denoising(gen, x, AugmentConfig()),
        "random_hflip": lambda: pipeline.random_hflip(gen, x),
        "random_rot90": lambda: pipeline.random_rot90(gen, x, 0.5),
        "random_blackout": lambda: pipeline.random_blackout(gen, x),
        "random_crop_resize": lambda: pipeline.random_crop_resize(gen, x, 0.5, DATA_AUG.crop_frac),
        "color_jitter": lambda: pipeline.color_jitter(gen, x, 0.5, DATA_AUG.jitter_strength),
        "corrupt_for_test": lambda: pipeline.corrupt_for_test(gen, x),
    }
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {name: fn() for name, fn in public.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for name, y in outs.items():
        check(y.shape == x.shape and y.dtype == x.dtype and bool(torch.isfinite(y).all()),
              f"{name}: {tuple(y.shape)} {y.dtype}")
    print(f"[15 data path] (c) {', '.join(public)} ran on the card under sync debug mode "
          f"'error' on fp32 {tuple(x.shape)}: no host sync")

    x_cpu = x.cpu()
    cpu_gen = torch.Generator().manual_seed(DATA_SEED)
    errs = []
    for name, draws_fn, apply, exact in AUG_CHECKS:
        draws = draws_fn(cpu_gen, x_cpu)
        want = apply(x_cpu, *draws)
        got = apply(x, *(d.cuda() for d in draws)).cpu()
        err = (got - want).abs().max().item()
        check(not torch.equal(want, x_cpu), f"{name}: the draws changed nothing")
        check(torch.equal(got, want) if exact else err <= 1e-5,
              f"{name} on the card against the CPU: max abs {err:.3e} ({'bits' if exact else '1e-5'})")
        errs.append(f"{name} {err:.3e}")
    print("[15 data path] (c) draw-taking forms on the card against the CPU, max abs: " + ", ".join(errs)
          + " (limits: hflip, rot90, blackout bit for bit; crop-resize, jitter 1e-5)")
    # 4 calls queued behind the spin: 20 calls of up to ~50 launches each
    # would fill the launch queue, and the host would wait for the spin.
    ms = {name: device_ms(fn, iters=4) for name, fn in public.items()}
    print("[15 data path] (c) device ms per call (card_timing.device_ms, 4 calls): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))


def h2d_ms(host: np.ndarray, reps: int = 10) -> tuple:
    """Median event ms of one batch's copy: pinned on a copy stream, and
    pageable with a plain ``.to("cuda")``."""
    stream = torch.cuda.Stream()
    pinned = torch.from_numpy(host).pin_memory()
    times = {"pinned": [], "pageable": []}
    for _ in range(reps):
        for kind in times:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            if kind == "pinned":
                with torch.cuda.stream(stream):
                    start.record(stream)
                    pinned.to("cuda", non_blocking=True)
                    end.record(stream)
            else:
                start.record()
                torch.from_numpy(host).to("cuda")
                end.record()
            torch.cuda.synchronize()
            times[kind].append(start.elapsed_time(end))
    return statistics.median(times["pinned"]), statistics.median(times["pageable"])


def phase_data_path(train_ms: float) -> None:
    """Phase 15: packed clips -> ClipPackDataset (native) -> DevicePrefetch
    -> augmentations on the card -> make_video_train_step, at phase 11's
    cell; module docstring, item 15."""
    tag = "15 data path"
    size, batch, frames, steps = 256, 8, 8, 5
    clips = np.random.default_rng(DATA_SEED).integers(0, 256, (DATA_CLIPS, frames, size, size, 3),
                                                      dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "clips.cpk")
        pack_clips(path, clips)
        native = ClipPackDataset(path, batch, seed=DATA_SEED)
        plain = ClipPackDataset(path, batch, seed=DATA_SEED, prefer_native=False)
        check(native._native and not plain._native, "clippack readers")
        check_packed_readers(native, plain)
        host = {"native": host_ms_per_batch(native), "numpy": host_ms_per_batch(plain)}
        print(f"[{tag}] (a) clippack of {DATA_CLIPS} clips {frames}x{size}^2x3 uint8, batch {batch}: "
              f"native library built (g++) in {build.build_seconds['clippack']:.2f} s (0 when cached); "
              f"native and numpy batches "
              f"bit-equal over 2 shuffled epochs and after seek(3, 1); host ms per batch: native "
              f"{host['native']:.2f}, numpy {host['numpy']:.2f}")
        check_prefetch(native, plain)
        print(f"[{tag}] (b) DevicePrefetch(size=2, device='cuda'): every batch a CUDA uint8 tensor, "
              f"bit-equal to the host batch; position() the inner position minus the held batches")

        x = pipeline.normalize_uint8(torch.from_numpy(clips[:batch]).cuda())
        phase_augmentations(x)
        del x

        cfg = flagship_video_config(size, attn_impl="flash")
        n = cfg.temporal.num_layers
        model = VideoHybridNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0),
                                   rng=0)
        step = make_video_train_step(size, loss="mixed", alpha=0.3, beta=0.7, noise_std=0.05,
                                     aug=DATA_AUG)
        fed = endless(DevicePrefetch(native, size=2, device="cuda"))
        params0 = {n_: p.detach().clone() for n_, p in model.named_parameters()}
        stats0 = {n_: b.clone() for n_, b in model.named_buffers() if "running" in n_}
        metrics = []
        for _ in range(steps):
            reset_counts()
            with dispatch_trace.capture() as seen:
                metrics.append(step(state, next(fed))[1])
            torch.cuda.synchronize()
            launches = counts()
            check(launches == expect_counts(launches=n, dq_launches=n, dkv_launches=n),
                  f"data-path step launches {launches}")
            check({"flash_mha_cuda", "flash_mha_bwd_cuda"} <= seen and "sdpa_xla" not in seen,
                  f"data-path step recorded {sorted(seen)}")
        loss = torch.stack([m["loss"] for m in metrics]).tolist()
        psnr = torch.stack([m["psnr"] for m in metrics]).tolist()
        check(all(math.isfinite(v) for v in loss + psnr), f"loss {loss}, psnr {psnr}")
        still = [n_ for n_, p in model.named_parameters() if torch.equal(p.detach(), params0[n_])]
        check(not still, f"parameters unchanged after {steps} steps: {still[:5]}")
        still = [n_ for n_, b in model.named_buffers() if n_ in stats0 and torch.equal(b, stats0[n_])]
        check(not still, f"BatchNorm stats unchanged after {steps} steps: {still[:5]}")
        del params0, stats0
        print(f"[{tag}] (d) {steps} steps of phase 11's cell with {DATA_AUG}, fed from host memory "
              f"through DevicePrefetch: flash launches per step fwd {n}, dq {n}, dkv {n}, other kernels 0; "
              f"loss {[round(v, 5) for v in loss]}, psnr {[round(v, 3) for v in psnr]}")

        placed = [torch.from_numpy(clips[i * batch:(i + 1) * batch]).cuda() for i in range(2)]

        ring = endless(placed)
        # A second dataset on the file: ``fed`` holds ``native``'s iterator open.
        pageable = ClipPackDataset(path, batch, seed=DATA_SEED + 1)
        host_it = endless(pageable)
        feeds = {"prefetched": lambda: next(fed), "on the card": lambda: next(ring),
                 "pageable": lambda: torch.from_numpy(next(host_it)).to("cuda")}
        reps = {k: [] for k in feeds}
        for _ in range(3):  # the three feeds in turns, 2 steps each
            for kind, next_batch in feeds.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2):
                    step(state, next_batch())
                torch.cuda.synchronize()
                reps[kind].append((time.perf_counter() - t0) / 2 * 1e3)
        med = {k: statistics.median(v) for k, v in reps.items()}
        print(f"[{tag}] (d) step ms (median of 3 reps of 2 steps, the feeds in turns; spread): "
              + ", ".join(f"{k} {med[k]:.1f} ({100 * (max(v) - min(v)) / med[k]:.2f}%)" for k, v in reps.items())
              + f"; phase 11 (no augmentations, clips on the card) {train_ms:.1f}")
        nbytes = clips[:batch].nbytes
        pinned_ms, pageable_ms = h2d_ms(clips[:batch])
        print(f"[{tag}] (d) H2D of one batch ({nbytes / 1e6:.1f} MB uint8), by events, median of 10: pinned "
              f"on the copy stream {pinned_ms:.3f} ms ({nbytes / pinned_ms / 1e6:.1f} GB/s), pageable "
              f".to('cuda') {pageable_ms:.3f} ms ({nbytes / pageable_ms / 1e6:.1f} GB/s)")
        for kind, next_batch in feeds.items():
            prof = profile_window(lambda: step(state, next_batch()), iters=3, top=5)
            print(f"[{tag}] (d) profile window of 3 steps, batches {kind}: wall "
                  f"{prof['wall_ms_per_call']:.1f} ms/step, device busy {prof['device_busy_ms_per_call']:.1f} "
                  f"ms/step, idle share {100 * prof['device_idle_share']:.2f}%")
        del fed, host_it, feeds
        native.close()
        pageable.close()
        del model, state, placed
    free_cuda()


# ---------------------------------------------------------------- phase 16

CLI_CELL = ["--synthetic", "3", "--batch-size", "8", "--clip-len", "8", "--image-size", "256",
            "--attn-impl", "flash", "--ema-decay", "0.999", "--keep-checkpoints", "1"]
FLASH3 = ("launches", "dq_launches", "dkv_launches")


def run_cli(argv: list) -> str:
    """``python -m tchvp_tpu_torch.cli <argv>`` in this process (so the
    launch counters can be read), its models freed after it; returns what
    it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    free_cuda()
    return out.getvalue()


def step_tags(d: Path) -> list:
    return sorted((p.name for p in d.iterdir() if re.fullmatch(r"step_\d+", p.name)),
                  key=lambda n: int(n[5:]))


def state_tensors(raw: dict) -> dict:
    """Every tensor of a checkpoint payload by name: the model, the
    moments, the EMA and the generators' states."""
    out = {f"model.{k}": v for k, v in raw["model"].items()}
    for n, st in raw["opt_state"]["moments"].items():
        out.update({f"moment.{n}.{k}": v for k, v in st.items()})
    out.update({f"ema.{k}": v for k, v in raw["opt_state"]["ema"].items()})
    out.update({f"generator.{k}": v for k, v in raw["generators"].items()})
    return out


def unequal(a: dict, b: dict) -> list:
    check(a.keys() == b.keys(), f"payload keys {sorted(set(a) ^ set(b))[:5]}")
    return [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]


def cli_state(path: Path):
    """A VideoFlow of the CLI cell on the card with the checkpoint at
    ``path`` restored into it; returns (state, raw payload, restore ms)."""
    model = VideoHybridNet(flagship_video_config(256, attn_impl="flash"), device="cuda",
                           generator=torch.Generator().manual_seed(1))
    flow = VideoFlow(model, cfg=TrainConfig(model_name="video", loss="mixed", lr=1e-4, ema_decay=0.999),
                     image_size=256)
    flow.init_state(8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, raw = ckpt.restore_state_into(flow.state, str(path))
    torch.cuda.synchronize()
    return state, raw, (time.perf_counter() - t0) * 1e3


class TimedData:
    """Host batches whose epochs are timed: the flow reads the metric sums
    once per epoch, after its last step, then asks for the next epoch."""

    def __init__(self, batches):
        self.batches, self.starts = batches, []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        self.starts.append(time.perf_counter())
        return iter(self.batches)


def cli_rank(rank: int, world: int, rendezvous: str, argv: list) -> None:
    """One rank of ``video --mesh seq=2`` (phase 16 (g)) on this card;
    writes its launch counts to SEQ_DIR/cli_rank<r>.json."""
    reset_counts()
    run_cli(argv + ["--coordinator", f"file://{rendezvous}", "--num-processes", str(world),
                    "--process-id", str(rank)])
    (SEQ_DIR / f"cli_rank{rank}.json").write_text(json.dumps(counts()))


def nondeterministic_ops(caught) -> list:
    """The ops that warned, under ``use_deterministic_algorithms(True,
    warn_only=True)``, that they have no deterministic kernel."""
    names = set()
    for w in caught:
        msg = str(w.message)
        if "does not have a deterministic implementation" in msg:
            names.add(msg.split(" does not have a deterministic")[0])
        elif "CuBLAS" in msg and "deterministic" in msg:
            names.add("cuBLAS without CUBLAS_WORKSPACE_CONFIG")
    return sorted(names)


def counter_of(record_name: str) -> str:
    """The launch counter of a kernel's JSON record."""
    if record_name == "flash_fwd":
        return "launches"
    if record_name.startswith("flash_bwd_"):
        return record_name[len("flash_bwd_"):] + "_launches"
    if record_name.startswith("fused_tail"):
        return "fused_tail_launches"
    kind, _, part = record_name.partition("_bwd_")
    return f"{kind}_{part}_launches" if part else f"{record_name}_launches"


INFER_BATCHES, STREAM_CLIPS = 60, 3  # timed after the CLI's one warm-up batch or clip


def profiled(fn) -> float:
    """Device busy ms (the profiler's kernel and copy time) of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def phase_infer(tag: str, served: str) -> str:
    """Phase 16 (h)'s ``infer``: three runs of INFER_BATCHES timed batches
    at the training cell's shape, then where a batch's time goes: the
    device's busy time per batch from two profiled runs (INFER_BATCHES + 1
    and 1 batch, so that the restore and the warm-up batch cancel), and the
    host's time to make a synthetic batch. Returns the last run's output."""
    argv = ["infer", "--checkpoint", served, "--batch-size", "8", "--clip-len", "8", "--image-size", "256"]
    rates = []
    for _ in range(3):
        text = run_cli(argv + ["--synthetic", str(INFER_BATCHES + 1)])
        rates.append(float(re.search(r"([0-9.]+) frames/s", text).group(1)))
    med = statistics.median(rates)
    wall_ms = 8 * 8 / med * 1e3
    busy = [profiled(lambda n=n: run_cli(argv + ["--synthetic", str(n)])) for n in (INFER_BATCHES + 1, 1)]
    busy_ms = (busy[0] - busy[1]) / INFER_BATCHES
    t0 = time.perf_counter()
    for _ in SyntheticClips(8, 8, 256, INFER_BATCHES):
        pass
    make_ms = (time.perf_counter() - t0) / INFER_BATCHES * 1e3
    print(f"[{tag}] (h) infer --batch-size 8 --clip-len 8 --image-size 256 (bf16, 'xla' attention, "
          f"{INFER_BATCHES} timed batches a run, 3 runs): frames/s {[round(r, 1) for r in rates]}, median "
          f"{med:.1f} (spread {100 * (max(rates) - min(rates)) / med:.2f}%), {wall_ms:.2f} ms a batch; the "
          f"device busy {busy_ms:.2f} ms a batch (profiled, {100 * (1 - busy_ms / wall_ms):.1f}% idle); "
          f"the host makes a synthetic batch in {make_ms:.2f} ms (SyntheticClips alone)")
    return text


def phase_runtime(train_ms: float) -> dict:
    """Phase 16: the run-time through ``cli.main``; module docstring.
    Returns the launches of its three training commands by counter: (a)'s
    flash run, (f)'s windowed run and (g)'s rank 0."""
    import warnings

    import torch.multiprocessing as mp

    tag = "16 run-time"
    n = flagship_video_config(256).temporal.num_layers
    cwd = os.getcwd()
    det = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)  # runs/ (the event files) goes here
        try:
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                # (a) 2 epochs of 3 steps, a checkpoint per epoch, the newest kept.
                a_dir = tmp / "a"
                reset_counts()
                t0 = time.perf_counter()
                text = run_cli(["video", *CLI_CELL, "--epochs", "2", "--save-every", "1",
                                "--checkpoint-dir", str(a_dir)])
                torch.cuda.synchronize()
                a_s = time.perf_counter() - t0
                launches = a_counts = counts()
                check(launches == expect_counts(**{k: n * 6 for k in FLASH3}),
                      f"(a) launches over 6 steps {launches}")
                check(re.findall(r"Video epoch \d+", text) == ["Video epoch 1", "Video epoch 2"], text)
                check(step_tags(a_dir) == ["step_2"] and (a_dir / "TAG_SCHEME").read_text() == "epochs",
                      f"(a) tags {step_tags(a_dir)}")
                rec = json.loads((a_dir / "run.json").read_text())
                check(rec["command"] == "video" and rec["environment"]["device_name"]
                      == torch.cuda.get_device_name(0), f"(a) run.json {rec['environment']}")
                events = list((tmp / "runs" / "video").glob("events.out.tfevents.*"))
                scalars = [json.loads(x) for x in (tmp / "runs" / "video" / "metrics.jsonl").open()]
                check(len(events) == 1 and [(s["tag"], s["step"]) for s in scalars] == [
                    ("Loss/Train", 1), ("PSNR/Train", 1), ("Loss/Train", 2), ("PSNR/Train", 2)],
                    f"(a) event files {events}, scalars {scalars}")
                print(f"[{tag}] (a) video {' '.join(CLI_CELL)} --epochs 2 --save-every 1 (fp32, AdamW 1e-4, "
                      f"mixed loss, DevicePrefetch 2) in {a_s:.1f} s: flash launches over 6 steps fwd "
                      f"{launches['launches']}, dq {launches['dq_launches']}, dkv {launches['dkv_launches']} "
                      f"(2/2/2 per step), other kernels 0; tags {step_tags(a_dir)}, TAG_SCHEME epochs, "
                      f"run.json, 1 event file with Loss/PSNR at epochs 1-2; "
                      + "; ".join(re.findall(r"Video epoch \d+: [^\n]*", text)))

                # (b) restore bit-equal, then resume for epoch 3 against 3 straight epochs.
                state, raw, restore_ms = cli_state(a_dir / "step_2")
                ckpt.save_state(str(tmp / "again"), 2, state, extra=raw.get("extra"))
                again = ckpt.restore_state(str(tmp / "again" / "step_2"))
                bad = unequal(state_tensors(raw), state_tensors(again))
                check(not bad, f"(b) restored state differs from the saved one: {bad[:5]}")
                check((again["opt_state"]["count"], again["train_step"]) == (6, 6),
                      f"(b) count {again['opt_state']['count']}, step {again['train_step']}")
                n_tensors = len(state_tensors(raw))
                del state, again
                free_cuda()
                text = run_cli(["video", *CLI_CELL, "--epochs", "3", "--save-every", "1", "--resume",
                                "--checkpoint-dir", str(a_dir)])
                check(re.findall(r"Video epoch \d+", text) == ["Video epoch 3"], f"(b) resume printed {text}")
                straight = tmp / "straight"
                run_cli(["video", *CLI_CELL, "--epochs", "3", "--save-every", "10",
                         "--checkpoint-dir", str(straight)])
                resumed = state_tensors(ckpt.restore_state(str(a_dir / "step_3")))
                ref = state_tensors(ckpt.restore_state(str(straight / "step_3")))
                bad = unequal(resumed, ref)
                nondet = nondeterministic_ops(caught)
            if bad:
                pmax = max(v.abs().max().item() for k, v in ref.items() if k.startswith("model.")
                           and v.is_floating_point())
                worst = max((resumed[k].double() - ref[k].double()).abs().max().item() for k in bad
                            if ref[k].is_floating_point())
                check(worst <= 1e-5 * pmax, f"(b) resumed vs straight: {len(bad)} tensors differ, "
                      f"max abs {worst} > 1e-5 x {pmax}; ops without a deterministic kernel: {nondet}")
                b_line = (f"{len(bad)} of {len(ref)} tensors differ, max abs {worst:.3g} <= 1e-5 x max|p| "
                          f"{pmax:.3g}; ops without a deterministic kernel: {nondet}")
            else:
                b_line = f"all {len(ref)} tensors bit-equal (model, moments, EMA, generators)"
            print(f"[{tag}] (b) step_2 restored into a fresh flow: {n_tensors} tensors bit-equal to the saved "
                  f"payload (model, moments, EMA, generators), count 6; --resume --epochs 3 started at epoch 3; "
                  f"2 + 1 epochs against 3 straight (cudnn.deterministic, deterministic algorithms "
                  f"warn-only): {b_line}")
            del resumed, ref
            torch.backends.cudnn.deterministic = det
            torch.use_deterministic_algorithms(False)

            # (c) a mid-epoch resume from a clippack.
            clips = np.random.default_rng(DATA_SEED).integers(0, 256, (DATA_CLIPS, 8, 256, 256, 3),
                                                              dtype=np.uint8)
            pack = str(tmp / "clips.cpk")
            pack_clips(pack, clips)
            del clips
            c_dir = tmp / "c"
            flags = ["--clippack", pack, "--batch-size", "8", "--clip-len", "8", "--image-size", "256",
                     "--attn-impl", "flash", "--save-every-steps", "2", "--checkpoint-dir", str(c_dir)]
            run_cli(["video", *flags, "--epochs", "1"])
            check(step_tags(c_dir) == ["step_2", "step_3"], f"(c) tags {step_tags(c_dir)}")
            shutil.rmtree(c_dir / "step_3")  # preempted before the clean-shutdown save
            reset_counts()
            text = run_cli(["video", *flags, "--epochs", "2", "--resume"])
            launches = counts()
            check(launches == expect_counts(**{k: n * 4 for k in FLASH3}),
                  f"(c) launches {launches} (expected 4 steps)")
            extra = ckpt.restore_state(str(c_dir / "step_5"))["extra"]
            check(step_tags(c_dir) == ["step_2", "step_5", "step_6"]
                  and extra == {"train_epoch": 2, "data_position": {"epoch": 1, "batch": 2}},
                  f"(c) tags {step_tags(c_dir)}, step_5 extra {extra}")
            print(f"[{tag}] (c) clippack of {DATA_CLIPS} clips, batch 8, --save-every-steps 2: tags step_2, "
                  f"step_3; step_3 dropped (a preemption); --resume --epochs 2 sought epoch 0 batch 2 and ran "
                  f"4 steps (flash launches {launches['launches']}/{launches['dq_launches']}/"
                  f"{launches['dkv_launches']}): the epoch's last batch, then epoch 2; tags "
                  f"{step_tags(c_dir)}, step_5 at epoch 1 batch 2")

            # (d) the full state's save, async save and restore.
            state, raw, restore_ms = cli_state(a_dir / "step_3")
            d_dir = tmp / "d"
            save_ms, block_ms, wait_ms = [], [], []
            for i in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save_state(str(d_dir), 10 + i, state)
                save_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                ckpt.save_state(str(d_dir), 20 + i, state, async_write=True)
                t1 = time.perf_counter()
                ckpt.wait_for_async_saves()
                block_ms.append((t1 - t0) * 1e3)
                wait_ms.append((time.perf_counter() - t1) * 1e3)
            nbytes = (d_dir / "step_10" / ckpt.PAYLOAD).stat().st_size
            restores = []
            for i in range(2):
                del state
                free_cuda()
                state, _, ms = cli_state(d_dir / f"step_{20 + i}")
                restores.append(ms)
            n_params = sum(p.numel() for p in state.model.parameters())
            print(f"[{tag}] (d) full state ({n_params / 1e6:.1f} M parameters; model, AdamW moments, EMA, "
                  f"generators) {nbytes / 1e9:.3f} GB on disk: save {[round(x, 1) for x in save_ms]} ms; "
                  f"async save blocking {[round(x, 1) for x in block_ms]} ms, then the writer "
                  f"{[round(x, 1) for x in wait_ms]} ms; restore_state_into {[round(x, 1) for x in restores]} "
                  f"ms (first restore {restore_ms:.1f})")
            del state, raw
            free_cuda()
            shutil.rmtree(d_dir)

            # (e) the flow's step against phase 11's bare step; saves left out (timed in (d)).
            model = VideoHybridNet(flagship_video_config(256, attn_impl="flash"), device="cuda",
                                   generator=torch.Generator().manual_seed(0))
            flow = VideoFlow(model, cfg=TrainConfig(model_name="video", loss="mixed", lr=1e-4,
                                                    device_prefetch=2, checkpoint_dir=str(tmp / "e")),
                             image_size=256)
            flow._save = lambda *a, **k: None
            data = TimedData([random_clip(8, 8, 256, seed=20 + i, device="cpu").numpy() for i in range(4)])
            flow.train(data, epochs=4, clip_len=8, save_every=100)
            per_step = [(b - a) / len(data) * 1e3 for a, b in zip(data.starts[1:], data.starts[2:])]
            epoch = [4]

            def one_epoch():
                flow.train(data, epochs=epoch[0] + 1, clip_len=8, start_epoch=epoch[0], save_every=100)
                epoch[0] += 1

            prof = profile_window(one_epoch, iters=1, top=5)
            flow_ms = statistics.median(per_step)
            print(f"[{tag}] (e) VideoFlow.train at phase 11's cell (host batches through DevicePrefetch 2, "
                  f"4 steps per epoch, saves left out): step ms {[round(x, 1) for x in per_step]} (epochs 2-3), "
                  f"median {flow_ms:.1f} against phase 11's bare step {train_ms:.1f} "
                  f"({100 * (flow_ms / train_ms - 1):+.2f}%); profile of one epoch: wall "
                  f"{prof['wall_ms_per_call'] / len(data):.1f} ms/step, device busy "
                  f"{prof['device_busy_ms_per_call'] / len(data):.1f} ms/step, idle share "
                  f"{100 * prof['device_idle_share']:.2f}%")
            del flow, model, data
            free_cuda()

            # (f) windowed training through the CLI: the banded kernels.
            reset_counts()
            run_cli(["video", "--synthetic", "2", "--batch-size", "2", "--clip-len", "32", "--image-size",
                     "256", "--attn-impl", "flash", "--window", "64", "--epochs", "1",
                     "--checkpoint-dir", str(tmp / "f")])
            band = counts()
            check(band == expect_counts(band_fwd_launches=2 * n,
                                        band_ds_launches=2 * n, band_dq_launches=2 * n,
                                        band_dkv_launches=2 * n), f"(f) launches {band}")
            print(f"[{tag}] (f) video --window 64 --batch-size 2 --clip-len 32 --synthetic 2 --epochs 1: band "
                  f"launches over 2 steps fwd {band['band_fwd_launches']}, ds {band['band_ds_launches']}, dq "
                  f"{band['band_dq_launches']}, dkv {band['band_dkv_launches']} (2/2/2/2 per step), other 0")
            free_cuda()

            # (g) --mesh seq=2 on two ranks sharing this card (gloo), one step.
            shutil.rmtree(SEQ_DIR, ignore_errors=True)
            SEQ_DIR.mkdir(parents=True)
            argv = ["video", "--synthetic", "1", "--batch-size", "2", "--clip-len", "32", "--image-size",
                    "256", "--attn-impl", "flash", "--window", "64", "--mesh", "seq=2", "--epochs", "1",
                    "--device-prefetch", "0", "--checkpoint-dir", str(tmp / "g")]
            t0 = time.perf_counter()
            mp.spawn(cli_rank, args=(2, str(SEQ_DIR / "cli_rendezvous"), argv), nprocs=2, join=True)
            wall = time.perf_counter() - t0
            halo = [json.loads((SEQ_DIR / f"cli_rank{r}.json").read_text()) for r in range(2)]
            want = expect_counts(halo_fwd_launches=n, halo_ds_launches=n, halo_dq_launches=n,
                                 halo_dkv_launches=n)
            check(all(h == want for h in halo), f"(g) launches per rank {halo}")
            check(step_tags(tmp / "g") == ["step_1"], f"(g) tags {step_tags(tmp / 'g')}")
            print(f"[{tag}] (g) video --mesh seq=2 --window 64 (B 2, T 32) as 2 ranks sharing this card over gloo, "
                  f"spawned in {wall:.1f} s: halo launches per rank fwd {halo[0]['halo_fwd_launches']}, ds "
                  f"{halo[0]['halo_ds_launches']}, dq {halo[0]['halo_dq_launches']}, dkv "
                  f"{halo[0]['halo_dkv_launches']}, band and flash 0; rank 0 wrote step_1")

            # (h) serving the checkpoint of (b).
            served = str(a_dir / "step_3")
            out = {"infer": phase_infer(tag, served)}
            out["eval"] = run_cli(["eval", "--checkpoint", served, "--synthetic", "2", "--batch-size", "8",
                                   "--clip-len", "8", "--image-size", "256"])
            out["stream"] = run_cli(["stream", "--checkpoint", served, "--synthetic", str(STREAM_CLIPS + 1),
                                     "--batch-size", "1", "--clip-len", "16", "--height", "1080",
                                     "--width", "1920"])
            out["summary"] = run_cli(["summary", "--image-size", "256", "--depth", "1"])
            out["doctor"] = run_cli(["doctor", "--smoke"])
            for k in ("infer", "eval"):
                psnr = float(re.search(r"PSNR (-?[0-9.]+) dB", out[k]).group(1))
                check(math.isfinite(psnr), f"(h) {k}: {out[k]}")
            check(f"streamed {16 * STREAM_CLIPS} frames @ 1080x1920" in out["stream"],
                  f"(h) stream: {out['stream']}")
            check("parameters (" in out["summary"], f"(h) summary: {out['summary']}")
            check("smoke flash forward" in out["doctor"], f"(h) doctor: {out['doctor']}")
            for k, v in out.items():
                lines = v.strip().splitlines()
                shown = [ln for ln in lines if not re.match(r"^\S+\s+\S+\s+[0-9,]+$", ln)] if k == "summary" \
                    else lines
                print(f"[{tag}] (h) {k}: " + " | ".join(shown[-6:]))
        finally:
            os.chdir(cwd)
            torch.backends.cudnn.deterministic = det
            torch.use_deterministic_algorithms(False)
    free_cuda()
    return {k: a_counts[k] + band[k] + halo[0][k] for k in a_counts}


# ---------------------------------------------------------------- phase 17


def phase_config3() -> None:
    """Phase 17: BASELINE config 3's bf16 training step; module docstring."""
    tag = "17 config 3"
    size, batch, frames = 224, 8, 16
    model = VideoHybridNet(flagship_video_config(size), device="cuda", compute_dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(1e-4, grad_clip_norm=1.0), rng=0)
    step = make_video_train_step(size, loss="mse")
    clips = [random_clip(batch, frames, size, seed=40 + i) for i in range(2)]
    p0 = {n_: p.detach().clone() for n_, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses_ = [step(state, clips[i % 2])[1]["loss"] for i in range(3)]
    torch.cuda.synchronize()
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses_ = [x.item() for x in losses_]
    check(launches == expect_counts(), f"config 3 launches {launches} (attn 'xla': no kernel)")
    check(all(math.isfinite(x) for x in losses_), f"config 3 loss {losses_}")
    check({p.dtype for p in model.parameters()} == {torch.float32}
          and {b.dtype for n_, b in model.named_buffers() if "running" in n_} == {torch.float32},
          "config 3: a parameter or a BatchNorm stat left fp32")
    still = [n_ for n_, p in model.named_parameters() if torch.equal(p.detach(), p0[n_])]
    check(not still, f"config 3: parameters unchanged: {still[:5]}")
    del p0
    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for clip in clips:
            step(state, clip)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 2)
    med = statistics.median(reps)
    print(f"[{tag}] flagship {size}^2 attn 'xla', compute bf16 over fp32 parameters (autocast), B={batch} "
          f"T={frames}, mse, noise 0.05, AdamW 1e-4 clip 1.0: loss {[round(x, 5) for x in losses_]}, every "
          f"parameter and BN stat fp32 and moved, no hand-written kernel launched; step {med * 1e3:.1f} ms "
          f"(median of 3 reps of 2 steps, spread {100 * (max(reps) - min(reps)) / med:.2f}%), "
          f"{batch * frames / med:.1f} trained frames/s, peak memory {peak_gb:.2f} GB")
    prof = profile_window(lambda: step(state, clips[0]), iters=1, top=5)
    print_profile(f"{tag} profile", prof)
    # CUDA's autocast hands LayerNorm on in fp32; the port rounds it back
    # to bf16 as flax does, so the residual stream stays bf16.
    tokens = torch.zeros(1, 8 * frames, (size // 4) ** 2, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        mixed = model.eval().temporal_mix(tokens)
    check(mixed.dtype == torch.bfloat16, f"config 3: the temporal stage hands on {mixed.dtype}")
    print(f"[{tag}] the temporal stage's output under autocast: {mixed.dtype}")
    del model, state, clips, tokens, mixed
    free_cuda()


# Phase 18: FCT (tchvp_tpu/models/fct.py), the segmentation family, at 256^2.
FCT_SIZE = 256
# The (S, Dh) of FCT's attention at 256^2, 2 heads: blocks 1 and 9, 2 and 8,
# 3 and 7, 4 and 6, the bottleneck.
FCT_ATTN = ((16384, 4), (4096, 8), (1024, 16), (256, 32), (64, 64))
FCT_FLASH = len(FCT_ATTN) * 2 - 1  # 9 flash forwards a forward, 9 dq and 9 dk/dv a step


def fct_model(attn: str = "auto", compute_dtype=None, dropout: bool = True) -> FCT:
    """``FCTConfig()`` on the card, weights from seed 0; without dropout
    every rate is 0 (the blocks', each Wide-Focus branch's)."""
    model = FCT(FCTConfig(attn_impl=attn, dropout_rate=0.3 if dropout else 0.0), device="cuda",
                generator=torch.Generator().manual_seed(0), compute_dtype=compute_dtype)
    if not dropout:
        for m in model.modules():
            if isinstance(m, WideFocus):
                m.dropout_rate = 0.0
    return model


def fct_batches(batch: int, n: int, seed: int) -> list:
    """``n`` (images, masks) uint8 batches of SyntheticImageMasks on the card."""
    return [tuple(torch.from_numpy(t).to("cuda") for t in pair)
            for pair in SyntheticImageMasks(batch, FCT_SIZE, n, seed)]


def fct_step_ms(step, state, batches, reps: int = 3) -> tuple:
    """Phase 11's protocol: (median ms per step over ``reps`` reps of
    len(batches) steps, the reps' spread in %)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / len(batches))
    med = statistics.median(times)
    return med * 1e3, 100 * (max(times) - min(times)) / med


def phase_fct_forward() -> dict:
    """Phase 18 (a): the bf16 forward of fct_forward_bench.py's shape."""
    tag, batch = "18 FCT (a) forward", 2
    images_u8 = fct_batches(batch, 1, 50)[0][0]
    x = pipeline.preprocess_images(images_u8, FCT_SIZE)
    model = fct_model(compute_dtype=torch.bfloat16).eval()
    reset_counts()
    with dispatch_trace.capture() as seen, torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == expect_counts(launches=FCT_FLASH), f"(a) launches {launches}")
    check("flash_mha_cuda" in seen and "sdpa_xla" not in seen, f"(a) recorded {sorted(seen)}")
    with torch.no_grad():
        again = model(x)
    check(torch.equal(out, again), "(a) bits differ on repeat")
    check(out.shape == (batch, FCT_SIZE, FCT_SIZE, 1) and out.dtype == torch.bfloat16
          and bool(torch.isfinite(out).all()), f"(a) out {tuple(out.shape)} {out.dtype}")
    torch.backends.cudnn.allow_tf32 = False
    plain = fct_model("xla").eval()
    plain.load_state_dict(model.state_dict())
    with dispatch_trace.capture() as seen_plain, torch.no_grad():
        ref = plain(x)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = True
    check("sdpa_xla" in seen_plain and "flash_mha_cuda" not in seen_plain, f"plain {sorted(seen_plain)}")
    err, top = (out.float() - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 2e-2 * top, f"(a) bf16 flash forward vs plain fp32: {err:.3g} > 2e-2 x {top:.3g}")
    del plain, ref, again, out
    free_cuda()

    def run():
        with torch.inference_mode():
            return model(pipeline.preprocess_images(images_u8, FCT_SIZE))

    run()
    torch.cuda.reset_peak_memory_stats()
    ms, spread = fct_step_ms(lambda _s, _b: run(), None, [None] * 10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] FCTConfig() bf16 compute over fp32 parameters, attn 'auto', B={batch} {FCT_SIZE}^2: "
          f"flash_fwd launches {launches['launches']} (other kernels 0), bits equal on repeat, max abs "
          f"{err:.3g} against the plain fp32 path ('xla', TF32 off; limit 2e-2 x {top:.3g}); "
          f"{ms:.3f} ms per forward (median of 3 reps of 10, preprocess included, spread {spread:.2f}%), "
          f"{batch / ms * 1e3:.1f} images/s, peak memory {peak_gb:.3f} GB")
    print_profile(f"{tag} profile", profile_window(run, iters=3, top=5))
    del model
    free_cuda()
    return launches


def phase_fct_grads() -> None:
    """Phase 18 (b): one fp32 segment step's gradients, flash against the
    plain path, dropout off, TF32 off."""
    tag = "18 FCT (b) gradients"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batch = fct_batches(2, 1, 51)[0]
    grads = {}
    for impl in ("flash", "xla"):
        model = fct_model(impl, dropout=False)
        state = create_train_state(model, make_optimizer(1e-4, grad_clip_norm=1.0), rng=0)

        def mark(name, model=model):
            if name == "backward":
                grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()}

        reset_counts()
        make_segmentation_train_step(FCT_SIZE)(state, batch, mark=mark)
        torch.cuda.synchronize()
        n = FCT_FLASH if impl == "flash" else 0
        launches = counts()
        check(launches == expect_counts(launches=n, dq_launches=n, dkv_launches=n),
              f"(b) {impl} launches {launches}")
        del model, state
        free_cuda()
    gmax = max(g.abs().max().item() for g in grads["xla"].values())
    diffs = {n: (grads["flash"][n] - g).abs().max().item() for n, g in grads["xla"].items()}
    worst = max(diffs, key=diffs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads["flash"].values())
    print(f"[{tag}] fp32 B=2 {FCT_SIZE}^2 dice loss, dropout off: flash launches {FCT_FLASH}/{FCT_FLASH}/"
          f"{FCT_FLASH}; max grad diff {diffs[worst]:.3g} ({worst}) against 'xla', max |grad| {gmax:.3g}, "
          f"ratio {diffs[worst] / gmax:.3g} (tol 1e-3), finite {finite}")
    check(finite and diffs[worst] <= 1e-3 * gmax, "(b) FCT gradients flash vs xla")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    del grads
    free_cuda()


SEG_EPOCH = re.compile(r"Epoch (\d+): dice loss ([0-9.naif]+) IoU ([0-9.naif]+)")


def phase_fct_cli() -> dict:
    """Phase 18 (c): ``segment``, ``eval --model fct`` and ``summary --model
    fct`` through ``cli.main`` at the CLI defaults (256^2, batch 8, fp32),
    restore and resume, ``SegmentationFlow.infer``. Returns the segment
    run's launches."""
    tag = "18 FCT (c) CLI"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)  # runs/ and saved_samples/ go here
        try:
            d = tmp / "ck"
            reset_counts()
            t0 = time.perf_counter()
            text = run_cli(["segment", "--synthetic", "3", "--epochs", "2", "--checkpoint-dir", str(d)])
            seconds = time.perf_counter() - t0
            seg = counts()
            # 3 steps an epoch, and one eval forward an epoch for the sneak peek.
            steps, peeks = 6, 2
            check(seg == expect_counts(launches=FCT_FLASH * (steps + peeks), dq_launches=FCT_FLASH * steps,
                                       dkv_launches=FCT_FLASH * steps), f"(c) segment launches {seg}")
            epochs = [(int(e), float(lo), float(iou)) for e, lo, iou in SEG_EPOCH.findall(text)]
            check([e for e, _, _ in epochs] == [1, 2] and all(math.isfinite(v) for _, lo, iou in epochs
                                                               for v in (lo, iou)), text)
            tags = step_tags(d)
            check(tags and tags[0] == "step_1" and set(tags) <= {"step_1", "step_2"}, f"(c) tags {tags}")
            check(len(list((tmp / "saved_samples" / "FCT").glob("*_predicted.jpg"))) == 2, "(c) sneak peeks")
            latest = ckpt.latest_step_dir(str(d))
            best = int(Path(latest).name[5:])
            raw = ckpt.restore_state(latest)
            hist = raw["extra"]["loss_history"].tolist()
            check(len(hist) == best, f"(c) loss history {hist} in step_{best}")

            flow = SegmentationFlow(fct_model(), cfg=TrainConfig(model_name="FCT", loss="dice", lr=1e-4,
                                                                checkpoint_dir=str(d)),
                                    image_size=FCT_SIZE)
            flow.restore(latest)
            check(flow.start_epoch == best and flow.loss_history == hist,
                  f"(c) restore: epoch {flow.start_epoch}, history {flow.loss_history}")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                flow.train(SyntheticImageMasks(8, FCT_SIZE, 3, 0), epochs=3)
            resumed = [int(e) for e, _, _ in SEG_EPOCH.findall(out.getvalue())]
            check(resumed == list(range(best + 1, 4)) and len(flow.loss_history) == 3
                  and flow.loss_history[:best] == hist, f"(c) resume printed {resumed}, "
                  f"history {flow.loss_history}")
            images = np.random.default_rng(52).integers(0, 256, (2, FCT_SIZE, FCT_SIZE, 3), dtype=np.uint8)
            masks = flow.infer(images, out_dir=str(tmp / "inferred"))
            edges = sobel_edges(torch.from_numpy(masks).to("cuda"))
            check(masks.shape == (2, FCT_SIZE, FCT_SIZE, 1) and masks.min() >= 0 and masks.max() <= 1,
                  f"(c) infer masks {masks.shape} in [{masks.min()}, {masks.max()}]")
            check(edges.min().item() >= 0 and edges.max().item() <= 1, "(c) Sobel edges outside [0, 1]")
            check(len(list((tmp / "inferred").glob("image_*.jpg"))) == 2, "(c) infer side-by-side dumps")
            del flow
            free_cuda()

            reset_counts()
            text_eval = run_cli(["eval", "--model", "fct", "--synthetic", "2", "--checkpoint", latest])
            ev = re.search(r"eval fct: dice loss ([0-9.]+), IoU ([0-9.]+)", text_eval)
            check(ev is not None and counts() == expect_counts(launches=2 * FCT_FLASH), text_eval)
            text_sum = run_cli(["summary", "--model", "fct"])
            n_params = re.search(r"FCT: \S+ parameters \(([0-9,]+)\)", text_sum)
            check(n_params is not None, text_sum)
        finally:
            os.chdir(cwd)
    print(f"[{tag}] segment --synthetic 3 --epochs 2 (256^2, batch 8, fp32, dice, AdamW 1e-4, clip 1.0) in "
          f"{seconds:.1f} s: epochs {epochs}; flash launches fwd {seg['launches']} ({FCT_FLASH} x {steps} steps "
          f"+ {FCT_FLASH} x {peeks} sneak peeks), dq {seg['dq_launches']}, dkv {seg['dkv_launches']}, other "
          f"kernels 0; tags {tags}; restored step_{best} (history {[round(v, 5) for v in hist]}) and "
          f"trained to epoch 3: printed epochs {resumed}; eval --model fct on step_{best}: dice loss "
          f"{ev.group(1)}, IoU {ev.group(2)} ({2 * FCT_FLASH} flash forwards); summary: {n_params.group(1)} "
          f"parameters; infer: masks in [{masks.min():.4f}, {masks.max():.4f}], Sobel edges in "
          f"[{edges.min().item():.4f}, {edges.max().item():.4f}]")
    return seg


def fct_attention_errors(q, k, v, do, delta, got, scale: float) -> dict:
    """out, lse, dq, dk, dv of the flash kernels (``got``) against their
    plain versions on the same inputs (the backward's from the kernel's lse
    and delta), over chunks of batch x heads so that each chunk's (S, S)
    scores fit; beside each, what the plain version reads with v (forward)
    or k (backward) one batch-head off, a batch x heads indexing fault.
    Returns name -> (max abs error, max|ref|, max abs of the fault)."""
    b, h, s, dh = q.shape
    bh = b * h
    flat = [t.reshape(bh, s, dh) for t in (q, k, v, do)]  # copies of the views
    out, lse, dq, dk, dv = (t.reshape(bh, *t.shape[-2:]) if t.dim() == 4 else t for t in got)
    seen = {name: [0.0, 0.0, 0.0] for name in ("out", "lse", "dq", "dk", "dv")}
    chunk = max(1, min(bh, 2 ** 30 // (s * s)))  # 4 GiB of fp32 scores a chunk
    for i in range(0, bh, chunk):
        j = min(i + chunk, bh)
        off = (torch.arange(i, j, device=q.device) - 1) % bh
        qc, kc, vc, doc = (t[i:j] for t in flat)
        stats = (lse[i:j], delta[i:j], scale)
        ref = fa.mha_reference(qc, kc, vc, scale)
        fault = fa.mha_reference(qc, kc, flat[2][off], scale)[0]
        refs = (*ref, *fa.mha_bwd_reference(qc, kc, vc, doc, *stats))
        faults = (fault, None, *fa.mha_bwd_reference(qc, flat[1][off], vc, doc, *stats))
        for name, g, r, f in zip(seen, (out[i:j], lse[i:j], dq[i:j], dk[i:j], dv[i:j]), refs, faults):
            acc = seen[name]
            acc[0] = max(acc[0], (g - r).abs().max().item())
            acc[1] = max(acc[1], r.abs().max().item())
            if f is not None:
                acc[2] = max(acc[2], (f - r).abs().max().item())
        del ref, fault, refs, faults
    return {name: tuple(acc) for name, acc in seen.items()}


def fct_attention_times() -> list:
    """The flash forward and backward pair at the segment step's five
    attention shapes (batch 8, 2 heads, fp32, no dropout; q, k, v and do
    the (B, H, S, Dh) views of (B, S, H * Dh) tokens, as ``mha`` takes
    them from ``_split_heads``), each held against its plain version on the
    same inputs at phases 3 and 4's limits, then timed beside SDPA by
    device time, with their bounds."""
    rows = []
    for s, dh in FCT_ATTN:
        b, h = 8, 2
        bh, scale = b * h, 1 / math.sqrt(dh)
        rng = np.random.default_rng(s + dh)
        q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h * dh), dtype=np.float32)).to("cuda")
                       .view(b, s, h, dh).transpose(1, 2) for _ in range(4))
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, 0.0, 0)
        delta = (do * out).sum(-1).reshape(bh, s).contiguous()
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, 0.0, 0)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, 0.0, 0)
        errs = fct_attention_errors(q, k, v, do, delta, (out, lse, dq, dk, dv), scale)
        del dq, dk, dv
        tol, lse_tol = fwd_limits(torch.float32, out)
        gtol = bwd_limit(torch.float32)
        shape = (b, h, s, dh)
        for name, (err, top, fault) in errs.items():
            limit = {"out": tol, "lse": lse_tol}.get(name, gtol * top)
            check(math.isfinite(err) and err <= limit,
                  f"18 FCT attention {shape} fp32 {name}: max abs {err:.3g} > {limit:.3g} (max|ref| {top:.3g})")
            if name != "lse":
                check(fault > 10 * limit, f"18 FCT attention {shape} {name}: one batch-head off reads "
                                          f"{fault:.3g}, not 10 x the limit {limit:.3g}")
        print(f"[18 FCT attention check] {shape} fp32, (B, H, S, Dh) views of (B, S, H * Dh) tokens: max abs "
              + ", ".join(f"{n} {e:.3g} ({e / t:.3g} x max|ref|)" for n, (e, t, _) in errs.items())
              + f"; limits out {tol}, lse {lse_tol}, gradients {gtol} x max|ref|; one batch-head off reads "
              + ", ".join(f"{n} {f / t:.3g}" for n, (_, t, f) in errs.items() if n != "lse") + " x max|ref|")
        backend = sdpa_backend(q, k, v, scale)
        fwd = lambda: fa._flash_fwd_cuda(q, k, v, scale, 0.0, 0)  # noqa: E731
        pair = lambda: (fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, 0.0, 0),  # noqa: E731
                        fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, 0.0, 0))
        row = {"shape": list(shape), "device_ms": device_ms(fwd), "bwd_pair_device_ms": device_ms(pair),
               "library": backend, "library_device_ms": None, "library_bwd_device_ms": None,
               "max_abs_err": {n: e for n, (e, _, _) in errs.items()}}
        row["bound_ms"], row["bound_by"] = flash_fwd_bound(bh, s, dh, torch.float32)
        row["bwd_bound_ms"], row["bwd_bound_by"] = flash_bwd_bound(bh, s, dh, torch.float32, 3, 5, 2)
        if not backend.startswith("MATH") or bh * s * s * 4 < 1e9:  # MATH holds the (S, S) weights
            q4, k4, v4 = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)  # noqa: E731
            with torch.no_grad():
                row["library_device_ms"] = device_ms(sdpa)
            o4 = sdpa()
            row["library_bwd_device_ms"] = device_ms(
                lambda: torch.autograd.grad(o4, (q4, k4, v4), do, retain_graph=True))
            del q4, k4, v4, o4
        rows.append(row)
        del q, k, v, do, out, lse, delta
        free_cuda()
    return rows


def phase_fct_step() -> dict:
    """Phase 18 (d): the bare segment step at the CLI defaults (256^2,
    batch 8, fp32, dropout on), its time, memory and profile; the flash
    kernels at its shapes."""
    tag, batch = "18 FCT (d) step", 8
    model = fct_model()
    state = create_train_state(model, make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0), rng=0)
    step = make_segmentation_train_step(FCT_SIZE)
    batches = fct_batches(batch, 4, 53)
    p0 = {n_: p.detach().clone() for n_, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for b in batches:
        reset_counts()
        metrics.append(step(state, b)[1])
        torch.cuda.synchronize()
        launches = counts()
        check(launches == expect_counts(launches=FCT_FLASH, dq_launches=FCT_FLASH, dkv_launches=FCT_FLASH),
              f"(d) step launches {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = [m["loss"].item() for m in metrics]
    iou = [m["iou"].item() for m in metrics]
    check(all(math.isfinite(v) for v in loss + iou), f"(d) loss {loss}, IoU {iou}")
    still = [n_ for n_, p in model.named_parameters() if torch.equal(p.detach(), p0[n_])]
    check(not still, f"(d) parameters unchanged: {still[:5]}")
    del p0
    ms, spread = fct_step_ms(step, state, batches[:2])
    split = step_split(step, state, batches[:3])
    print(f"[{tag}] fp32 B={batch} {FCT_SIZE}^2 dice, AdamW 1e-4 clip 1.0, dropout on: flash launches "
          f"{FCT_FLASH}/{FCT_FLASH}/{FCT_FLASH} per step, other kernels 0; loss {[round(v, 5) for v in loss]}, "
          f"IoU {[round(v, 4) for v in iou]}; step {ms:.2f} ms (median of 3 reps of 2 steps, spread "
          f"{spread:.2f}%), {batch / ms * 1e3:.1f} trained images/s, peak memory {peak_gb:.3f} GB; device ms "
          f"per step (median of 3): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    prof = profile_window(lambda: step(state, batches[0]), iters=2, top=400)
    busy = prof["device_busy_ms_per_call"]
    flash_ms = sum(ms_ for name, ms_, _ in prof["top_kernels_ms_per_call"] if "flash_" in name)
    prof["top_kernels_ms_per_call"] = prof["top_kernels_ms_per_call"][:10]
    print_profile(f"{tag} profile", prof)
    print(f"[{tag} profile] the flash kernels: {flash_ms:.2f} of {busy:.2f} device ms a step "
          f"({100 * flash_ms / busy:.1f}%)")
    del model, state, batches
    free_cuda()
    rows = fct_attention_times()
    for r in rows:
        lib = (f"SDPA {r['library_device_ms']:.4f} / backward {r['library_bwd_device_ms']:.4f} ms "
               f"({r['library']})" if r["library_device_ms"] is not None else f"SDPA not timed ({r['library']})")
        print(f"[{tag} attention] {tuple(r['shape'])} fp32: flash_fwd {r['device_ms']:.4f} ms, pair "
              f"{r['bwd_pair_device_ms']:.4f} ms (device); bounds {r['bound_ms']:.4f} ({r['bound_by']}), "
              f"{r['bwd_bound_ms']:.4f} ({r['bwd_bound_by']}); {lib}")
    fwd_sum = 2 * sum(r["device_ms"] for r in rows[:-1]) + rows[-1]["device_ms"]
    pair_sum = 2 * sum(r["bwd_pair_device_ms"] for r in rows[:-1]) + rows[-1]["bwd_pair_device_ms"]
    print(f"[{tag} attention] a step's 9 forwards {fwd_sum:.3f} ms and 9 pairs {pair_sum:.3f} ms by these "
          f"times: {100 * (fwd_sum + pair_sum) / ms:.1f}% of the step")
    return {"step_ms": ms, "attention": rows}


def phase_fct() -> dict:
    """Phase 18: FCT; module docstring. Returns each flash kernel's
    launches in (a) and (c), by counter, and (d)'s attention times."""
    a = phase_fct_forward()
    phase_fct_grads()
    c = phase_fct_cli()
    d = phase_fct_step()
    return {"launches": {k: {"a": a[k], "c": c[k]} for k in FLASH3}, "step": d}


# ------------------------------------------------------------------ phase 19

CONV_SIZE = 64  # (a): every family takes 64^2 (the AutoEncoder needs a multiple of 32)
CONV_FAMILIES = ("unet", "autoencoder", "combined", "ae32k_image", "ae32k_mask", "ae4k")
TRAIN_EPOCH = re.compile(r"Epoch (\d+): loss ([0-9.naif-]+) train PSNR ([0-9.naif-]+) val PSNR ([0-9.naif-]+)")
TRANSFER_EPOCH = re.compile(r"Transfer epoch (\d+): dice ([0-9.naif-]+)")
VIDEO_EPOCH = re.compile(r"Video epoch (\d+): loss ([0-9.naif-]+) PSNR ([0-9.naif-]+)")
CONV_LAUNCHES = dict.fromkeys((key for key, _, _ in COUNTERS), 0)  # every launch of phase 19's runs


def no_launches(what: str) -> None:
    """Add the counters to CONV_LAUNCHES and check they are all 0."""
    for key, n in counts().items():
        CONV_LAUNCHES[key] += n
    check(counts() == expect_counts(), f"{what} launched {counts()}")


def conv_family(name: str) -> torch.nn.Module:
    """A conv family at its default widths on the CPU, every dropout off,
    weights from seed 0, BatchNorm and biases seeded (seed_decoder)."""
    g = torch.Generator().manual_seed(0)
    if name == "unet":
        model = UNet(device="cpu", generator=g)
    elif name == "autoencoder":
        model = AutoEncoder(AutoEncoderConfig(dropout_rate=0.0), device="cpu", generator=g)
    elif name == "combined":
        model = Image2Image2Mask(AutoEncoderConfig(dropout_rate=0.0), device="cpu", generator=g)
    elif name == "ae4k":
        model = Autoencoder4K(device="cpu", generator=g)
        model.encoder.config = dataclasses.replace(model.encoder.config, dropout_rate=0.0)
    else:
        cfg = ResNetAEConfig(output_type=name.split("_")[1], dropout_rate=0.0)
        model = Autoencoder32K(cfg, device="cpu", generator=g)
    return seed_decoder(model, 19)


def as_outputs(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def family_grads(model: torch.nn.Module, x: torch.Tensor, ws: list, device: str, dtype: torch.dtype) -> dict:
    """The train-mode gradients of sum_i sum(out_i * w_i) of a copy of
    ``model`` in ``dtype`` on ``device``, by name, float64 on the CPU."""
    m = copy.deepcopy(model).to(device=device, dtype=dtype).train()
    outs = as_outputs(m(x.to(device, dtype)))
    sum((o * w.to(device, dtype)).sum() for o, w in zip(outs, ws)).backward()
    return {n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}


def rel_dist(a: dict, b: dict) -> float:
    top = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k] - b[k]).abs().max()) for k in b) / top


def phase_conv_parity() -> None:
    """Phase 19 (a): each family's eval forward (fp32, TF32 off) and
    train-mode gradients on the card against the port's CPU path."""
    tag = "19 conv families (a) card vs CPU"
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.uniform(0, 1, (2, CONV_SIZE, CONV_SIZE, 3)).astype(np.float32))
    reset_counts()
    for name in CONV_FAMILIES:
        cpu = conv_family(name).eval()
        card = copy.deepcopy(cpu).to("cuda").eval()
        with torch.no_grad():
            ref, got = as_outputs(cpu(x)), as_outputs(card(x.cuda()))
        top = max(float(r.abs().max()) for r in ref)
        fwd = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref)) / top
        ws = [torch.from_numpy(rng.standard_normal(tuple(r.shape)).astype(np.float32)) for r in ref]
        g64_cpu = family_grads(cpu, x, ws, "cpu", torch.float64)
        g64_card = family_grads(cpu, x, ws, "cuda", torch.float64)
        g32_cpu = family_grads(cpu, x, ws, "cpu", torch.float32)
        g32_card = family_grads(cpu, x, ws, "cuda", torch.float32)
        d64, e_cpu, e_card = rel_dist(g64_card, g64_cpu), rel_dist(g32_cpu, g64_cpu), rel_dist(g32_card, g64_cpu)
        d32 = rel_dist(g32_card, g32_cpu)
        print(f"[{tag}] {name} B=2 {CONV_SIZE}^2: eval forward max abs {fwd:.3g} x max|ref| (limit 1e-4); "
              f"train-mode gradients, float64 card vs CPU {d64:.3g} x max|grad| (limit 1e-3); fp32 from "
              f"the float64 gradients: card {e_card:.3g}, CPU {e_cpu:.3g} (limit 0.1); fp32 card vs fp32 "
              f"CPU {d32:.3g}")
        check(fwd <= 1e-4, f"(a) {name} eval forward {fwd:.3g}")
        check(d64 <= 1e-3, f"(a) {name} float64 gradients {d64:.3g}")
        check(max(e_card, e_cpu) <= 0.1, f"(a) {name} fp32 gradients {e_card:.3g} (CPU {e_cpu:.3g})")
        del cpu, card
    no_launches("(a)")
    free_cuda()
    torch.backends.cudnn.allow_tf32 = True


def conv_step(tag: str, step, state, batches: list, items: int, unit: str) -> dict:
    """A training path's bare step: finite metrics, trainable parameters
    moved, no hand-written kernel; step ms (phase 11's protocol), ``items``
    ``unit`` a step per second, peak memory, the device ms split and the
    idle share of a profile window."""
    trainable = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    p0 = {n: p.detach().clone() for n, p in trainable}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics = [step(state, b)[1] for b in batches]
    torch.cuda.synchronize()
    no_launches(tag)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vals = {k: [m[k].item() for m in metrics] for k in metrics[0]}
    check(all(math.isfinite(v) for vs in vals.values() for v in vs), f"{tag} metrics {vals}")
    still = [n for n, p in trainable if torch.equal(p.detach(), p0[n])]
    check(not still, f"{tag} parameters unchanged: {still[:5]}")
    del p0
    ms, spread = fct_step_ms(step, state, batches[:2])
    split = step_split(step, state, batches[:3])
    prof = profile_window(lambda: step(state, batches[0]), iters=2, top=5)
    print(f"[{tag}] " + ", ".join(f"{k} {[round(v, 4) for v in vs]}" for k, vs in vals.items())
          + f"; no hand-written kernel; step {ms:.2f} ms (median of 3 reps of 2 steps, spread {spread:.2f}%), "
          f"{items / ms * 1e3:.1f} trained {unit}/s, peak memory {peak_gb:.3f} GB; device ms per step "
          f"(median of 3): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    print_profile(f"{tag} profile", prof)
    return {"ms": ms, "spread": spread, "per_s": items / ms * 1e3, "peak_gb": peak_gb,
            "idle": prof["device_idle_share"], "split": split}


def cli_zero(argv: list) -> str:
    """``run_cli(argv)``, checked to launch no hand-written kernel."""
    reset_counts()
    text = run_cli(argv)
    no_launches(argv[0])
    return text


def finite_epochs(pattern, text: str, want: list) -> list:
    rows = [tuple(float(v) for v in row) for row in pattern.findall(text)]
    check([int(r[0]) for r in rows] == want and all(math.isfinite(v) for r in rows for v in r[1:]), text)
    return rows


def phase_denoise(tmp: Path) -> dict:
    """Phase 19 (b): ``denoise`` at the defaults, ``eval --model ae`` on its
    best-val weights, and the bare step."""
    tag = "19 conv families (b) denoise"
    d = tmp / "denoise"
    t0 = time.perf_counter()
    text = cli_zero(["denoise", "--synthetic", "3", "--epochs", "2", "--checkpoint-dir", str(d)])
    seconds = time.perf_counter() - t0
    epochs = finite_epochs(TRAIN_EPOCH, text, [1, 2])
    check((d / "IMAGE2IMAGE" / ckpt.PAYLOAD).is_file(), "(b) no best-val weights file")
    text_eval = cli_zero(["eval", "--model", "ae", "--synthetic", "2", "--checkpoint", str(d / "IMAGE2IMAGE")])
    psnr = re.search(r"eval ae: reconstruction PSNR ([0-9.-]+) dB", text_eval)
    check(psnr is not None and math.isfinite(float(psnr.group(1))), text_eval)
    print(f"[{tag}] denoise --synthetic 3 --epochs 2 (256^2, batch 8, mixed loss, AdamW 1e-4, clip 1.0) in "
          f"{seconds:.1f} s: epochs (epoch, loss, train PSNR, val PSNR) {epochs}; best-val weights "
          f"{d.name}/IMAGE2IMAGE; eval --model ae on them: PSNR {psnr.group(1)} dB; no hand-written kernel")
    model = AutoEncoder(device="cuda", generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0), rng=0)
    step = make_denoising_train_step(256, AugmentConfig(), "mixed", 0.5, 0.5)
    batches = [torch.from_numpy(b).to("cuda") for b in SyntheticImages(8, 256, 4, 60)]
    out = conv_step(f"{tag} step", step, state, batches, 8, "images")
    del model, state
    free_cuda()
    return out


AE32K_REFERENCE = [  # (the port's module path regex, the reference's), the folded BN's or None
    (r"encoder\.stem_conv", "encoder.conv1", "encoder.bn1"),
    (r"encoder\.stem_bn", "encoder.bn1", None),
    (r"encoder\.blocks\.layer(\d+)_block(\d+)\.conv(\d)", r"encoder.layer\1.\2.conv\3", r"encoder.layer\1.\2.bn\3"),
    (r"encoder\.blocks\.layer(\d+)_block(\d+)\.bn(\d)", r"encoder.layer\1.\2.bn\3", None),
    (r"encoder\.blocks\.layer(\d+)_block(\d+)\.downsample_conv", r"encoder.layer\1.\2.downsample.0",
     r"encoder.layer\1.\2.downsample.1"),
    (r"encoder\.blocks\.layer(\d+)_block(\d+)\.downsample_bn", r"encoder.layer\1.\2.downsample.1", None),
    (r"decoder\.upconvs\.(\d)", lambda m: f"decoder.transConv{int(m[1]) + 1}", None),
    (r"decoder\.up_bns\.(\d)", lambda m: f"decoder.dbn{int(m[1]) + 2}", None),
    (r"decoder\.head_conv", "decoder.outputDeterminerConv", None),
    (r"decoder\.head_bn", "decoder.outputDeterminerNorm", None),
]


def _ae32k_reference_name(module: str):
    """(the reference's module name, the BN a conv bias folds into) of a
    module of the port's Autoencoder32K."""
    m = re.fullmatch(r"encoder\.squeeze\.(\d+)", module)
    if m:
        i, r = divmod(int(m[1]), 3)
        return (f"encoder.conv{i + 2}", f"encoder.bn{i + 2}") if r == 0 else (f"encoder.bn{i + 2}", None)
    m = re.fullmatch(r"decoder\.(convs|conv_bns|post_convs|post_bns)\.(\d)", module)
    if m:
        n = int(m[2]) + (1 if m[1].startswith("conv") else 5)
        return (f"decoder.bn{n}", None) if m[1].endswith("bns") else (f"decoder.conv{n}", f"decoder.bn{n}")
    for pattern, name, fold in AE32K_REFERENCE:
        m = re.fullmatch(pattern, module)
        if m:
            expand = (lambda t: t(m) if callable(t) else m.expand(t))
            return expand(name), expand(fold) if fold else None
    raise KeyError(module)


def reference_state_dict(model: torch.nn.Module, seed: int, kind: str) -> dict:
    """``model``'s weights in the reference's layout and names: an
    ``Autoencoder32K`` as AE_32K's (every BN-followed conv given a seeded
    bias, which the importer folds back into the BN's running mean) or a
    UNet as UNet.py's. torch's layouts are the reference's, so only names
    (and the folds) change."""
    rng = np.random.default_rng(seed)
    sd = {}
    folds = {}
    for key, value in model.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        if kind == "unet":
            m = re.fullmatch(r"(encoder|decoder)(\d)\.(conv|norm)(\d)", module) or re.fullmatch(
                r"(bottleneck)()\.(conv|norm)(\d)", module)
            pre = {"encoder": "enc", "decoder": "dec", "bottleneck": "bottleneck"}
            name = f"{m[1]}{m[2]}.{pre[m[1]]}{m[2]}{m[3]}{m[4]}" if m else module
            sd[f"{name}.{leaf}"] = value.clone()
            continue
        name, fold = _ae32k_reference_name(module)
        sd[f"{name}.{leaf}"] = value.clone()
        if fold is not None:
            bias = torch.from_numpy(rng.normal(0, 0.1, value.shape[0]).astype(np.float32))
            sd[f"{name}.bias"] = bias
            folds[fold] = bias
    for bn, bias in folds.items():
        sd[f"{bn}.running_mean"] = sd[f"{bn}.running_mean"] + bias
    return sd


def check_ported(tag: str, path: str, src: torch.nn.Module) -> dict:
    """The ``port`` output at ``path`` holds ``src``'s state_dict: running
    means within 1e-6 (a folded bias added and taken away), the rest bit
    for bit."""
    ported = ckpt.restore_state(path)["model"]
    want = src.state_dict()
    check(ported.keys() == want.keys(), f"{tag} ported keys {sorted(set(ported) ^ set(want))[:5]}")
    bad = [k for k in want if not (torch.allclose(ported[k], want[k], atol=1e-6, rtol=0) if "running_mean" in k
                                   else torch.equal(ported[k], want[k]))]
    check(not bad, f"{tag} ported tensors differ: {bad[:5]}")
    return ported


def phase_transfer(tmp: Path) -> dict:
    """Phase 19 (c): ``port --model ae32k`` of a seeded reference-layout
    state_dict, ``transfer --pretrained`` at the defaults, resumed once
    through ``TransferFlow``, and the bare step."""
    tag = "19 conv families (c) transfer"
    src = seed_decoder(Autoencoder32K(device="cpu", generator=torch.Generator().manual_seed(3)), 30)
    torch.save(reference_state_dict(src, 31, "ae32k"), tmp / "AE_32K.tar")
    text_port = cli_zero(["port", "--model", "ae32k", "--checkpoint", str(tmp / "AE_32K.tar"),
                          "--out", str(tmp / "ported")])
    path = str(tmp / "ported" / "step_0")
    check(text_port.strip().endswith(path), text_port)
    ported = check_ported(tag, path, src)
    encoder = [k for k, _ in src.named_parameters() if k.startswith("encoder.")]
    d = tmp / "transfer"
    t0 = time.perf_counter()
    text = cli_zero(["transfer", "--synthetic", "3", "--epochs", "2", "--pretrained", path,
                     "--checkpoint-dir", str(d)])
    seconds = time.perf_counter() - t0
    epochs = finite_epochs(TRANSFER_EPOCH, text, [1, 2])
    tags = step_tags(d)
    check(tags and tags[0] == "step_1" and set(tags) <= {"step_1", "step_2"}, f"(c) tags {tags}")
    latest = ckpt.latest_step_dir(str(d))
    raw = ckpt.restore_state(latest)["model"]
    check(all(torch.equal(raw[k], ported[k]) for k in encoder), "(c) the frozen encoder moved")
    stats = [k for k in raw if k.startswith("encoder.") and ("running_mean" in k or "running_var" in k)]
    moved = [k for k in stats if not torch.equal(raw[k], torch.zeros_like(raw[k]) if "mean" in k
                                                  else torch.ones_like(raw[k]))]
    check(len(moved) == len(stats), f"(c) encoder BN stats left at (0, 1): {sorted(set(stats) - set(moved))[:5]}")
    flow = TransferFlow(cfg=TrainConfig(model_name="latent_to_mask", loss="dice", lr=1e-4,
                                        checkpoint_dir=str(d), sample_dir=str(tmp / "samples"),
                                        log_dir=str(tmp / "runs")), image_size=256, device="cuda")
    flow.init_from_pretrained(path, lr=1e-4)
    start = flow.resume()
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        flow.train(SyntheticImageMasks(8, 256, 3, 0), epochs=3, start_epoch=start)
    no_launches("(c) resumed transfer")
    resumed = [int(r[0]) for r in finite_epochs(TRANSFER_EPOCH, out.getvalue(), list(range(start + 1, 4)))]
    live = flow.state.model.state_dict()
    check(all(torch.equal(live[k].cpu(), ported[k]) for k in encoder), "(c) the frozen encoder moved on resume")
    masks = flow.test_a_sample(SyntheticImageMasks(8, 256, 1, 5), batch_size=4, out_dir=str(tmp / "preview"))
    check(masks.shape == (4, 256, 256, 1) and masks.min() >= 0 and masks.max() <= 1, "(c) test_a_sample")
    print(f"[{tag}] port --model ae32k: {text_port.split(':')[1].split('->')[0].strip()}, the ported "
          f"state_dict equal to the source's; transfer --synthetic 3 --epochs 2 (256^2, batch 8, dice, AdamW "
          f"1e-4, clip 1.0) in {seconds:.1f} s: epochs {epochs}, tags {tags}; resumed from step_{start} to "
          f"epoch 3: printed epochs {resumed}; the encoder's {len(encoder)} parameters bit-equal to the "
          f"ported ones after both runs, its {len(stats)} BN stats moved; no hand-written kernel")
    step = make_segmentation_train_step(256, "dice", output_index=1)
    result = conv_step(f"{tag} step", step, flow.state, fct_batches(8, 4, 61), 8, "images")
    del flow
    free_cuda()
    return result


def phase_frame_aes(tmp: Path) -> dict:
    """Phase 19 (d): ``video --model ae32k`` at the defaults and ``--model
    ae4k --image-size 64``, ``infer`` and ``eval`` on their checkpoints, and
    each bare step."""
    out = {}
    for name, size in (("ae32k", 256), ("ae4k", 64)):
        tag = f"19 conv families (d) video --model {name}"
        d = tmp / name
        common = ["--model", name, "--image-size", str(size)]
        t0 = time.perf_counter()
        text = cli_zero(["video", "--synthetic", "3", "--epochs", "2", "--checkpoint-dir", str(d), *common])
        seconds = time.perf_counter() - t0
        epochs = finite_epochs(VIDEO_EPOCH, text, [1, 2])
        check(step_tags(d) == ["step_2"], f"(d) {name} tags {step_tags(d)}")
        keys = ckpt.restore_state(str(d / "step_2"))["model"]
        check(all(k.startswith("ae.") for k in keys), f"(d) {name} checkpoint keys")
        text_infer = cli_zero(["infer", "--checkpoint", str(d / "step_2"), "--synthetic", "3", *common])
        inf = re.search(r"mean PSNR ([0-9.-]+) dB, ([0-9.]+) frames/s", text_infer)
        text_eval = cli_zero(["eval", "--checkpoint", str(d / "step_2"), "--synthetic", "2", *common])
        ev = re.search(r"reconstruction PSNR ([0-9.-]+) dB", text_eval)
        check(inf is not None and ev is not None and math.isfinite(float(ev.group(1))), text_infer + text_eval)
        print(f"[{tag}] video --synthetic 3 --epochs 2 (batch 8 x 8 frames at {size}^2, fp32, "
              f"{'mixed loss' if size > 160 else 'MSE'}, AdamW 1e-4, clip 1.0, noise 0.05, Dropout2d on) in "
              f"{seconds:.1f} s: epochs {epochs}, tag step_2, keys under ae.; infer (bf16) on it: PSNR "
              f"{inf.group(1)} dB, {inf.group(2)} frames/s; eval: PSNR {ev.group(1)} dB; no hand-written kernel")
        ae = (Autoencoder32K if name == "ae32k" else Autoencoder4K)(
            device="cuda", generator=torch.Generator().manual_seed(0))
        state = create_train_state(FrameAE(ae), make_optimizer(1e-4, weight_decay=0.01, grad_clip_norm=1.0),
                                   rng=0)
        step = make_video_train_step(size, loss="mixed" if size > 160 else "mse", alpha=0.3, beta=0.7,
                                     noise_std=0.05)
        clips = [random_clip(8, 8, size, seed=70 + i) for i in range(4)]
        out[name] = conv_step(f"{tag} step", step, state, clips, 64, "frames")
        del ae, state, clips
        free_cuda()
    return out


def phase_unet(tmp: Path) -> None:
    """Phase 19 (e): ``port --model unet`` of a seeded reference-layout
    state_dict, ``eval --model unet`` on it and ``eval --model combined``."""
    tag = "19 conv families (e) unet, combined"
    src = seed_decoder(UNet(device="cpu", generator=torch.Generator().manual_seed(4)), 40)
    torch.save(reference_state_dict(src, 41, "unet"), tmp / "unet.pth")
    cli_zero(["port", "--model", "unet", "--checkpoint", str(tmp / "unet.pth"), "--out", str(tmp / "unet")])
    path = str(tmp / "unet" / "step_0")
    check_ported(tag, path, src)
    texts = [cli_zero(["eval", "--model", "unet", "--synthetic", "2", "--checkpoint", path]),
             cli_zero(["eval", "--model", "combined", "--synthetic", "2", "--checkpoint-dir", str(tmp / "none")])]
    for text in texts:
        vals = [float(v) for v in re.findall(r"(?:dice|iou|psnr) ([0-9.-]+)", text)]
        check(vals and all(math.isfinite(v) for v in vals), text)
    print(f"[{tag}] port --model unet: the ported state_dict equal to the source's; "
          + "; ".join(t.strip() for t in texts) + "; no hand-written kernel")


def phase_conv_families() -> dict:
    """Phase 19: the conv families; module docstring. Returns (b)-(d)'s
    step records."""
    for key in CONV_LAUNCHES:
        CONV_LAUNCHES[key] = 0
    phase_conv_parity()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)  # runs/ and saved_samples/ go here
        try:
            steps = {"denoise": phase_denoise(tmp), "transfer": phase_transfer(tmp)}
            steps.update(phase_frame_aes(tmp))
            phase_unet(tmp)
        finally:
            os.chdir(cwd)
    print("[19 conv families] per training path (step ms, spread %, trained images or frames/s, peak GB, "
          "idle share %): " + "; ".join(
              f"{k} {v['ms']:.2f}, {v['spread']:.2f}, {v['per_s']:.1f}, {v['peak_gb']:.3f}, "
              f"{100 * v['idle']:.1f}" for k, v in steps.items())
          + f"; hand-written kernel launches in (a)-(e): {sum(CONV_LAUNCHES.values())}")
    return steps


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM
    bandwidth and the products over the peak of the dtype's units."""
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def window_fwd_times(fwd, sdpa) -> dict:
    """A band or halo forward ``fwd`` and ``sdpa`` timed as every kernel of
    phase 14 is, by events around 20 calls, the host's launch time included
    ("ms", "sdpa_ms"), and by :func:`device_ms` ("device", "sdpa_device").
    Each pass's own time: ``window_fwd_breakdown.py``."""
    t = {"ms": cuda_ms(fwd, 20), "device": device_ms(fwd)}
    with torch.no_grad():
        t["sdpa_ms"], t["sdpa_device"] = cuda_ms(sdpa, 20), device_ms(sdpa)
    return t


def window_fwd_line(t: dict) -> str:
    return f"kernel {t['ms']:.4f} ms (events), device {t['device']:.4f} ms"


def sdpa_backend(q4, k4, v4, scale, attn_mask=None) -> str:
    choice = torch._fused_sdp_choice(q4, k4, v4, attn_mask=attn_mask, scale=scale)
    name = torch.nn.attention.SDPBackend(choice).name
    return name if name != "MATH" else "MATH: no fused SDPA kernel at this dtype, head dim and mask"


def record(name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra):
    """One kernel's JSON record; ``replaces`` is the TPU kernel's "file:line";
    ``extra``: further measured fields."""
    return {"name": name, "route": "cuda", "source": f"tchvp_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra}


# MUFU's fp32 ex2 results per clock of an H100 SM (ex2.approx.ftz.bf16x2 gives twice
# as many); SMs of the SXM card.
EX2_PER_CLOCK_PER_SM, SMS = 16, 132


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def exp_ms(bh: int, s: int, per_clock: int = EX2_PER_CLOCK_PER_SM) -> float:
    """The BH x S^2 exponentials of one pass over the (S, S) weights (a
    flash forward, or one backward kernel) at ``per_clock`` ex2 per clock
    per SM on every SM at the maximum SM clock, in ms."""
    return bh * s * s / (per_clock * SMS * sm_clock_hz()) * 1e3


def flash_fwd_bound(bh: int, s: int, dh: int, dtype: torch.dtype):
    """(ms, "bytes" or "operations") of the flash forward: the larger of q,
    k, v and out once (and the lse), the products (2 flops per multiply-add
    of Q K^T and P V), and the exponentials at the fp32 ex2 rate, the one
    that l and the lse, summed in fp32, take."""
    esize = torch.finfo(dtype).bits // 8
    ms, by = bound(4 * bh * s * dh * esize + bh * s * 4, 4 * bh * s * s * dh, dtype)
    return (exp_ms(bh, s), "operations") if exp_ms(bh, s) > ms else (ms, by)


def flash_bwd_bound(bh: int, s: int, dh: int, dtype: torch.dtype, n_out: int, n_products: int,
                    n_exp: int):
    """(ms, "bytes" or "operations") of flash backward work: q, k, v, do,
    lse and delta read once and ``n_out`` gradients written once,
    ``n_products`` S x S x Dh products (2 flops per multiply-add), and
    ``n_exp`` x BH x S^2 exponentials at the fp32 ex2 rate; the largest."""
    esize = torch.finfo(dtype).bits // 8
    ms, by = bound((4 + n_out) * bh * s * dh * esize + 2 * bh * s * 4, n_products * 2 * bh * s * s * dh, dtype)
    e_ms = n_exp * exp_ms(bh, s)
    return (e_ms, "operations") if e_ms > ms else (ms, by)


def time_bwd_pair(args, q4, k4, v4, do4, scale) -> dict:
    """The flash backward pair on ``args`` and SDPA's backward
    (``autograd.grad`` through it, without dropout) on the same inputs, by
    events around 20 calls ("ms", "sdpa_ms") and by :func:`device_ms`
    ("device", "sdpa_device")."""
    pair = lambda: (fa.flash_bwd_dq_cuda(*args), fa.flash_bwd_dkv_cuda(*args))  # noqa: E731
    out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    sdpa = lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)  # noqa: E731
    return {"ms": cuda_ms(pair, 20), "device": device_ms(pair), "sdpa_ms": cuda_ms(sdpa, 20),
            "sdpa_device": device_ms(sdpa)}


def bwd_pair_line(t: dict) -> str:
    return (f"pair dq + dk/dv {t['ms']:.4f} ms (events), device {t['device']:.4f} ms; SDPA backward "
            f"{t['sdpa_ms']:.4f} ms (events), device {t['sdpa_device']:.4f} ms")


def time_fwd(fwd, sdpa) -> dict:
    """A forward and SDPA on the same inputs, as every kernel of phase 14 is
    timed (events around 20 calls, the host's time per call included: "ms",
    "sdpa_ms") and by :func:`device_ms` ("device", "sdpa_device")."""
    with torch.no_grad():
        return {"ms": cuda_ms(fwd, 20), "device": device_ms(fwd), "sdpa_ms": cuda_ms(sdpa, 20),
                "sdpa_device": device_ms(sdpa)}


def fwd_line(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms (events), device {t['device']:.4f} ms, SDPA "
            f"{t['sdpa_ms']:.4f} ms (events), device {t['sdpa_device']:.4f} ms")


def time_flash_fct() -> list:
    """The flash forward and the backward pair at FCT's shapes beside SDPA
    (without dropout) and their bounds."""
    rows = []
    for (b, h, s, dh), dtype, _, rate, seed in FCT_CASES:
        scale, bh = 1 / math.sqrt(dh), b * h
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 130)
        seed_t = device_seed(seed)
        q4, k4, v4 = (x.detach().view(b, h, s, dh).requires_grad_() for x in (q, k, v))
        backend = sdpa_backend(q4, k4, v4, scale)
        t = time_fwd(lambda: fa._flash_fwd_cuda(q, k, v, scale, rate, seed_t),
                     lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
        b_ms, b_by = flash_fwd_bound(bh, s, dh, dtype)
        bf16x2_ms = exp_ms(bh, s, 2 * EX2_PER_CLOCK_PER_SM)
        tb = time_bwd_pair((q, k, v, do, lse, delta, scale, rate, seed_t), q4, k4, v4, do.view(b, h, s, dh), scale)
        pb_ms, pb_by = flash_bwd_bound(bh, s, dh, dtype, 3, 5, 2)
        print(f"[14 times] flash_fwd FCT {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: {fwd_line(t)} "
              f"({backend}, without dropout), bound {b_ms:.4f} ms ({b_by}: the larger of bytes, products and "
              f"{bh * s * s / 1e9:.3f} G fp32 exponentials; at the bf16x2 rate {bf16x2_ms:.4f} ms); "
              f"backward {bwd_pair_line(tb)}, pair bound {pb_ms:.4f} ms ({pb_by}: the larger of bytes, 5 products "
              f"and 2 x {bh * s * s / 1e9:.3f} G exponentials)")
        rows.append({"shape": [b, h, s, dh], "ms": t["ms"], "device_ms": t["device"], "bound_ms": b_ms,
                     "exp_bf16x2_ms": bf16x2_ms,
                     "bound_by": b_by, "library_ms": t["sdpa_ms"], "library_device_ms": t["sdpa_device"],
                     "bwd_pair_ms": tb["ms"], "bwd_pair_device_ms": tb["device"], "bwd_bound_ms": pb_ms,
                     "bwd_bound_by": pb_by, "library_bwd_ms": tb["sdpa_ms"],
                     "library_bwd_device_ms": tb["sdpa_device"]})
        del q, k, v, do, lse, delta, q4, k4, v4
        free_cuda()
    return rows


def time_flash(fwd_launches: int, fwd_err: float, bwd_launches: dict, bwd_errs: dict) -> list:
    # Forward at the inference main path's shape (bf16), and the host's time
    # per call of mha on the transformer's views there.
    b, h, s, dh = 8, 8, 128, 392
    scale = 1 / 56
    q, k, v = qkv((b * h, s, dh), torch.bfloat16, seed=7)
    q4, k4, v4 = (t.view(b, h, s, dh) for t in (q, k, v))
    backend = sdpa_backend(q4, k4, v4, scale)
    t = time_fwd(lambda: fa._flash_fwd_cuda(q, k, v, scale, 0.0, 0),
                 lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
    plain_ms = cuda_ms(lambda: fa.mha_reference(q, k, v, scale))
    bound_ms, bound_by = flash_fwd_bound(b * h, s, dh, torch.bfloat16)
    views = [_split_heads(t, h) for t in qkv((b, s, h * dh), torch.bfloat16, 17)]  # as the transformer's
    with torch.no_grad():
        mha_host_ms = host_ms(lambda: fa.mha(*views, scale=scale))
    print(f"[14 times] flash_fwd {(b, h, s, dh)} bf16: {fwd_line(t)} ({backend}), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); host time of mha on _split_heads views under no_grad "
          f"{mha_host_ms:.4f} ms per call (least of 5 turns of 200 calls issued on an idle card)")
    # The forward on the training path: fp32 with dropout; SDPA without.
    (tb, th, ts, tdh), _, tscale, trate, tseed = TRAIN_CASE
    tq, tk, tv = qkv((tb * th, ts, tdh), torch.float32, seed=8)
    seed_t = device_seed(tseed)
    tq4, tk4, tv4 = (t.view(tb, th, ts, tdh) for t in (tq, tk, tv))
    train_backend = sdpa_backend(tq4, tk4, tv4, tscale)
    tt = time_fwd(lambda: fa._flash_fwd_cuda(tq, tk, tv, tscale, trate, seed_t),
                  lambda: F.scaled_dot_product_attention(tq4, tk4, tv4, scale=tscale))
    train_plain_ms = cuda_ms(lambda: fa.mha_reference(tq, tk, tv, tscale, trate, tseed))
    train_bound, train_by = flash_fwd_bound(tb * th, ts, tdh, torch.float32)
    print(f"[14 times] flash_fwd {(tb, th, ts, tdh)} float32 dropout {trate}: {fwd_line(tt)} (without dropout, "
          f"{train_backend}), plain {train_plain_ms:.4f} ms, bound {train_bound:.4f} ms ({train_by})")
    records = [record("flash_fwd", "flash_fwd.cu", f"{FLASH_PY}:192", fwd_launches, fwd_err, t["ms"],
                      plain_ms, bound_ms, bound_by, t["sdpa_ms"], device_ms=t["device"],
                      library_device_ms=t["sdpa_device"], mha_host_ms_per_call=mha_host_ms,
                      train={"ms": tt["ms"], "device_ms": tt["device"], "library_ms": tt["sdpa_ms"],
                             "library_device_ms": tt["sdpa_device"], "bound_ms": train_bound},
                      fct=time_flash_fct())]

    # Backward: the training shape (fp32, dropout 0.1, in the JSON), then the
    # inference shape in bf16. Each kernel's bound counts the exponentials
    # it recomputes (BH x S^2); the pair's the larger of 5 products, the
    # bytes and 2 x BH x S^2 exponentials.
    for case in (TRAIN_CASE, INFER_BWD_CASE):
        (b, h, s, dh), dtype, scale, rate, seed = case
        bh = b * h
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 30)
        args = (q, k, v, do, lse, delta, scale, rate, device_seed(seed))
        plain_args = (q, k, v, do, lse, delta, scale, rate, seed)
        q4, k4, v4 = (t.detach().view(b, h, s, dh).requires_grad_() for t in (q, k, v))
        backend = sdpa_backend(q4, k4, v4, scale)
        tb = time_bwd_pair(args, q4, k4, v4, do.view(b, h, s, dh), scale)
        for name, fn, plain, n_out, n_products in (
            ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa.mha_bwd_dq_reference, 1, 3),
            ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa.mha_bwd_dkv_reference, 2, 4),
        ):
            ms, dev = cuda_ms(lambda: fn(*args), 20), device_ms(lambda: fn(*args))
            p_ms = cuda_ms(lambda: plain(*plain_args), 20)
            b_ms, b_by = flash_bwd_bound(bh, s, dh, dtype, n_out, n_products, 1)
            print(f"[14 times] {name} {(b, h, s, dh)} {str(dtype)[6:]} dropout {rate}: kernel {ms:.4f} ms "
                  f"(events), device {dev:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if case is TRAIN_CASE:
                line = 374 if name == "flash_bwd_dq" else 403
                records.append(record(name, "flash_bwd.cu", f"{FLASH_PY}:{line}",
                                      bwd_launches[name], bwd_errs[name], ms, p_ms, b_ms, b_by, tb["sdpa_ms"],
                                      device_ms=dev, library_device_ms=tb["sdpa_device"],
                                      pair_ms=tb["ms"], pair_device_ms=tb["device"]))
        pair_ms, pair_by = flash_bwd_bound(bh, s, dh, dtype, 3, 5, 2)
        print(f"[14 times] backward pair {(b, h, s, dh)} {str(dtype)[6:]}: {bwd_pair_line(tb)} (without dropout, "
              f"{backend}), bound {pair_ms:.4f} ms ({pair_by})")
    return records


def time_band(band_launches: dict, band_errs: dict) -> list:
    """The banded kernels at config 2's shape (forward in the JSON, and the
    backward) and the training shape (backward in the JSON, and the
    forward). The bound counts the band's pairs of these shapes; SDPA gets
    the boolean band as ``attn_mask`` (and no dropout)."""
    records = []
    for case in (BAND_CONFIG2, BAND_TRAIN):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        bh, esize = b * h, torch.finfo(dtype).bits // 8
        mask = fa.band_mask(s, w, torch.device("cuda"))
        pairs = bh * int(mask.sum().item())
        row_bytes, stat_bytes = bh * s * dh * esize, bh * s * 4
        tag = f"{(b, h, s, dh)} {str(dtype)[6:]} window {w} dropout {rate}"
        q, k, v, do, lse, delta = bwd_inputs((b, h, s, dh), dtype, scale, rate, seed, 70, window=w)
        seed_t = device_seed(seed)
        q4, k4, v4 = (t.detach().view(b, h, s, dh).requires_grad_() for t in (q, k, v))
        backend = sdpa_backend(q4, k4, v4, scale, mask)

        t = window_fwd_times(lambda: fa.band_fwd_cuda(q, k, v, scale, w, rate, seed_t),
                             lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale))
        fwd_plain = cuda_ms(lambda: fa.windowed_mha_reference(q, k, v, scale, w, rate, seed), 20)
        fwd_bound, fwd_by = bound(4 * row_bytes + stat_bytes, 2 * 2 * pairs * dh, dtype)
        print(f"[14 times] band_fwd {tag}: {window_fwd_line(t)}, plain {fwd_plain:.4f} ms, SDPA with the "
              f"band mask ({backend}) {t['sdpa_ms']:.4f} ms (events), device {t['sdpa_device']:.4f} ms, bound "
              f"{fwd_bound:.4f} ms ({fwd_by}); band pairs {pairs // bh} per bh")
        if case is BAND_CONFIG2:
            records.append(record("band_fwd", "band_attention.cu", f"{FLASH_PY}:611",
                                  band_launches["band_fwd"], band_errs["band_fwd"], t["ms"], fwd_plain,
                                  fwd_bound, fwd_by, t["sdpa_ms"], device_ms=t["device"],
                                  library_device_ms=t["sdpa_device"]))

        out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale)
        sdpa = lambda: torch.autograd.grad(out4, (q4, k4, v4), do.view(b, h, s, dh), retain_graph=True)  # noqa: E731
        records += time_window_bwd("band", tag, (q, k, v, do, lse, delta), scale, w, rate, seed, None, pairs,
                                   sdpa, backend, band_launches, band_errs, keep=case is BAND_TRAIN)
        del q, k, v, do, q4, k4, v4, out4
        free_cuda()
    return records


# The banded and halo backward's C launchers and the TPU kernels they replace:
# pass A forms P_drop and dS for both of the TPU's kernels (the dq kernel's
# line first), pass B's dq the dq kernel's products, dk/dv the dk/dv kernel's.
WINDOW_BWD_LINES = {"band": {"ds": (657, 683), "dq": (657,), "dkv": (683,)},
                    "halo": {"ds": (1103, 1139), "dq": (1103,), "dkv": (1139,)}}


def time_window_bwd(kind: str, tag: str, tensors, scale, w, rate, seed, prev, pairs, sdpa, backend,
                    launches: dict, errs: dict, keep: bool) -> list:
    """The banded (``prev`` None) or halo backward's three passes, each by
    events around 20 calls and on the device (``device_ms``), beside its
    plain version and its bound; the three passes together and SDPA's
    backward with the band as its mask (``sdpa``, without dropout) the same
    two ways, and the pair's bound. Returns the passes' records where
    ``keep``. Bounds: the inputs read once and the outputs written once (the
    scratch is pass A's output and pass B's input), and the products of the
    band's ``pairs`` (pass A S and dP, pass B dq dS K, dk/dv dS^T Q and
    P_drop^T dO; the pair all five), the larger."""
    q, k, v, do, lse, delta = tensors
    bh, s, dh = q.shape
    kv, esize = k.shape[1], torch.finfo(q.dtype).bits // 8
    seed_t = device_seed(seed)
    hp = None if prev is None else 1
    if prev is None:
        ds_fn = lambda: fa.band_bwd_ds_cuda(q, k, v, do, lse, delta, scale, w, rate, seed_t)  # noqa: E731
        dq_fn = lambda sc: fa.band_bwd_dq_cuda(sc, k, w)  # noqa: E731
        dkv_fn = lambda sc: fa.band_bwd_dkv_cuda(sc, q, do, w)  # noqa: E731
    else:
        ds_fn = lambda: fa.halo_bwd_ds_cuda(q, k, v, do, lse, delta, scale, w, prev, rate, seed_t)  # noqa: E731
        dq_fn = lambda sc: fa.halo_bwd_dq_cuda(sc, k, w, prev)  # noqa: E731
        dkv_fn = lambda sc: fa.halo_bwd_dkv_cuda(sc, q, do, w, prev)  # noqa: E731
    scratch = ds_fn()
    q_bytes, kv_bytes, stat_bytes = bh * s * dh * esize, bh * kv * dh * esize, bh * s * 4
    half_bytes = scratch[0].numel() * esize
    passes = (
        ("ds", ds_fn, lambda: fa.window_bwd_scratch_reference(q, k, v, do, lse, delta, scale, w, rate, seed, hp),
         2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + 2 * half_bytes, 2),
        ("dq", lambda: dq_fn(scratch), lambda: fa.window_bwd_dq_reference(scratch, k, w, hp),
         half_bytes + kv_bytes + q_bytes, 1),
        ("dkv", lambda: dkv_fn(scratch), lambda: fa.window_bwd_dkv_reference(scratch, q, do, w, hp),
         2 * half_bytes + 2 * q_bytes + 2 * kv_bytes, 2),
    )
    records, line = [], f"{kind} backward {tag}:"
    for name, fn, plain, nbytes, n_products in passes:
        ms, dev = cuda_ms(fn, 20), device_ms(fn)
        p_ms = cuda_ms(plain, 20)
        b_ms, b_by = bound(nbytes, n_products * 2 * pairs * dh, q.dtype)
        line += f" {name} {ms:.4f} ms (events), device {dev:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by});"
        if keep:
            lines = WINDOW_BWD_LINES[kind][name]
            rec_name = f"{kind}_bwd_{name}"
            records.append(record(rec_name, f"{kind}_attention.cu", f"{FLASH_PY}:{lines[0]}",
                                  launches[rec_name], errs[rec_name], ms, p_ms, b_ms, b_by, None, device_ms=dev,
                                  replaces_also=[f"{FLASH_PY}:{x}" for x in lines[1:]]))
    pair = lambda: window_passes(q, k, v, do, lse, delta, scale, w, rate, seed_t, prev)  # noqa: E731
    pair_ms, pair_dev = cuda_ms(pair, 20), device_ms(pair)
    lib_ms, lib_dev = cuda_ms(sdpa, 20), device_ms(sdpa)
    pb_ms, pb_by = bound(3 * q_bytes + 4 * kv_bytes + 2 * stat_bytes, 10 * pairs * dh, q.dtype)
    print(f"[14 times] {line} the three passes {pair_ms:.4f} ms (events), device {pair_dev:.4f} ms; SDPA backward "
          f"with the {kind} mask, without dropout ({backend}) {lib_ms:.4f} ms (events), device {lib_dev:.4f} ms; "
          f"pair bound {pb_ms:.4f} ms ({pb_by})")
    for r in records:  # one PyTorch call computes the whole backward: SDPA's, beside every pass
        r.update(library_ms=lib_ms, library_device_ms=lib_dev, pair_ms=pair_ms, pair_device_ms=pair_dev,
                 pair_bound_ms=pb_ms)
    return records


def time_halo(halo_launches: dict, halo_errs: dict) -> list:
    """The halo kernels (has_prev 1) at the config-2 shard (forward in the
    JSON, and the backward) and the windowed-training shard (backward in the
    JSON, and the forward). The bound counts the halo band's pairs of these
    shapes; SDPA gets the (S, S + w) band as ``attn_mask`` (and no
    dropout)."""
    records = []
    for case in (HALO_CONFIG2, HALO_TRAIN):
        (b, h, s, dh), dtype, scale, w, rate, seed = case
        bh, esize = b * h, torch.finfo(dtype).bits // 8
        prev = torch.ones(1, dtype=torch.int32, device="cuda")
        mask = fa.halo_band_mask(s, w, 1, torch.device("cuda"))
        pairs = bh * int(mask.sum().item())
        # q, out, do, dq: S rows; k_ext, v_ext, dk_ext, dv_ext: S + w rows.
        q_bytes, kv_bytes, stat_bytes = bh * s * dh * esize, bh * (s + w) * dh * esize, bh * s * 4
        tag = f"{(bh, s, s + w, dh)} {str(dtype)[6:]} window {w} dropout {rate}"
        q, k, v, do, lse, delta = halo_inputs((b, h, s, dh), dtype, scale, w, rate, seed, 1, 110)
        seed_t = device_seed(seed)
        q4 = q.detach().view(b, h, s, dh).requires_grad_()
        k4, v4 = (t.detach().view(b, h, s + w, dh).requires_grad_() for t in (k, v))
        backend = sdpa_backend(q4, k4, v4, scale, mask)

        t = window_fwd_times(lambda: fa.halo_fwd_cuda(q, k, v, scale, w, prev, rate, seed_t),
                             lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale))
        fwd_plain = cuda_ms(lambda: fa.windowed_mha_halo_reference(q, k, v, scale, w, prev, rate, seed), 20)
        fwd_bound, fwd_by = bound(2 * q_bytes + 2 * kv_bytes + stat_bytes, 2 * 2 * pairs * dh, dtype)
        print(f"[14 times] halo_fwd {tag}: {window_fwd_line(t)}, plain {fwd_plain:.4f} ms, SDPA with the "
              f"halo band mask ({backend}) {t['sdpa_ms']:.4f} ms (events), device {t['sdpa_device']:.4f} ms, "
              f"bound {fwd_bound:.4f} ms ({fwd_by}); halo band pairs {pairs // bh} per bh")
        if case is HALO_CONFIG2:
            records.append(record("halo_fwd", "halo_attention.cu", f"{FLASH_PY}:1057",
                                  halo_launches["halo_fwd_launches"], halo_errs["halo_fwd"], t["ms"], fwd_plain,
                                  fwd_bound, fwd_by, t["sdpa_ms"], device_ms=t["device"],
                                  library_device_ms=t["sdpa_device"]))

        out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale)
        sdpa = lambda: torch.autograd.grad(out4, (q4, k4, v4), do.view(b, h, s, dh), retain_graph=True)  # noqa: E731
        records += time_window_bwd("halo", tag, (q, k, v, do, lse, delta), scale, w, rate, seed, prev, pairs,
                                   sdpa, backend, halo_launches, halo_errs, keep=case is HALO_TRAIN)
        del q, k, v, do, q4, k4, v4, out4
        free_cuda()
    return records


# The fused tail's input on the decoder path: (tag of phase 5b, record name, B, H, W).
TAIL_MAIN_SHAPES = (("config 1", "fused_tail", 128, 112, 112),
                    ("config 2 group", "fused_tail_config2", 128, 192, 192))


def folded_cudnn_tail(folded: dict, output_type: str = "image"):
    """The tail as cuDNN's chain with the eval BNs folded into its weights
    (``folded``, rounded to bf16 as the kernel reads them): ConvTranspose
    2x2/s2, three 3x3 convs, the ReLUs and the head's activation, on a bf16
    NCHW tensor in channels-last memory. A yardstick of phase 14, never on
    the port's path."""
    cl = torch.channels_last
    c1 = folded["b_up"].shape[0]
    w_up = folded["w_up"].reshape(-1, 2, 2, c1).permute(0, 3, 1, 2)  # ConvTranspose2d (Cin, C1, 2, 2)
    ws = [w_up] + [folded[k].permute(3, 2, 0, 1) for k in ("w0", "w1", "w2")]  # OIHW
    ws = [w.to("cuda", torch.bfloat16).contiguous(memory_format=cl) for w in ws]
    bs = [folded[k].to("cuda", torch.bfloat16) for k in ("b_up", "b0", "b1", "b2")]
    act = torch.sigmoid if output_type == "mask" else torch.relu

    def tail(x_cl: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x_cl, ws[0], bs[0], stride=2).relu_()
        y = F.conv2d(y, ws[1], bs[1], padding=1).relu_()
        y = F.conv2d(y, ws[2], bs[2], padding=1).relu_()
        return act(F.conv2d(y, ws[3], bs[3], padding=1))

    return tail


def time_fused_tail(tail_launches: dict) -> list:
    """The fused tail at config 1's and config 2's decode shapes (bf16, the
    NHWC view of an NCHW input as on the decoder path) against its plain
    version, beside ``Decoder32K.tail`` in eval mode on the NCHW tensor (the
    cuDNN chain it replaces) and the same chain with the BNs folded into its
    convs in channels-last memory (its input made channels-last outside the
    timing), each by events around 3 calls and by device time, and its
    bound."""
    decoder = init_flax_default(Decoder32K(), torch.Generator().manual_seed(0))
    decoder = seed_decoder(decoder, 20).to("cuda", torch.bfloat16).eval()
    folded = ft.fold_tail_params(decoder)
    plain_folded = {k: v.bfloat16().float() for k, v in folded.items()}
    folded_chain = folded_cudnn_tail(folded)
    c4 = folded["b2"].shape[0]
    records = []
    for tag, name, b, h, w in TAIL_MAIN_SHAPES:
        free_cuda()
        gen = torch.Generator(device="cuda").manual_seed(90)
        x_nchw = torch.randn((b, ft.CIN, h, w), generator=gen, device="cuda", dtype=torch.bfloat16)
        x = x_nchw.permute(0, 2, 3, 1)
        with torch.inference_mode():
            got = ft.fused_tail_cuda(x, folded)
            ref = ft.fused_tail_reference(x, plain_folded)
            err, scale = rel_err(got, ref)
            del got
            x_cl = x_nchw.contiguous(memory_format=torch.channels_last)
            chain_err = rel_err(folded_chain(x_cl).permute(0, 2, 3, 1), ref)[0]
            del ref
            check(math.isfinite(err) and err <= 2e-2 * scale, f"fused tail vs plain at {tag}: {err} > 2e-2 x {scale}")
            # A yardstick computes the same function: within 5e-2 x max|ref| (the
            # unfolded bf16 chain reads 2.85e-2 on the decoder path).
            check(chain_err <= 5e-2 * scale, f"folded cuDNN tail vs plain at {tag}: {chain_err} > 5e-2 x {scale}")
            kernel = lambda: ft.fused_tail_cuda(x, folded)  # noqa: E731
            kernel_ms, kernel_dev = cuda_ms(kernel, 3), device_ms(kernel, 5)
            plain_ms = cuda_ms(lambda: ft.fused_tail_reference(x, plain_folded), 3)
            library = lambda: decoder.tail(x_nchw)  # noqa: E731
            library_ms, library_dev = cuda_ms(library, 3), device_ms(library, 5)
            chain = lambda: folded_chain(x_cl)  # noqa: E731
            chain_ms, chain_dev = cuda_ms(chain, 3), device_ms(chain, 5)
            del x_cl
        # Multiply-adds: the 1x1 up-projection per input pixel to 4 phases x
        # C1, then the three 3x3 convs per output pixel; bytes: the input
        # read once, the output written once.
        flops = 2 * b * (h * w * ft.CIN * 4 * ft.C1
                         + 4 * h * w * 9 * (ft.C1 * ft.C2 + ft.C2 * ft.C3 + ft.C3 * c4))
        nbytes = 2 * b * h * w * ft.CIN + 2 * b * 4 * h * w * c4
        bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
        print(f"[14 times] fused_tail {tag} {(b, h, w, ft.CIN)} bf16: kernel {kernel_ms:.3f} ms (events), device "
              f"{kernel_dev:.3f} ms; plain {plain_ms:.3f} ms; Decoder32K.tail (cuDNN) {library_ms:.3f} ms (events), "
              f"device {library_dev:.3f} ms; folded cuDNN chain, channels-last {chain_ms:.3f} ms (events), device "
              f"{chain_dev:.3f} ms (vs plain {chain_err / scale:.3g} x max|ref|); bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB); vs plain max abs {err:.3g}, "
              f"max|ref| {scale:.3g}; {flops / kernel_dev / 1e9:.2f} TFLOP/s on the device")
        records.append(record(name, "fused_tail.cu", "tchvp_tpu/kernels/fused_tail.py:324",
                              tail_launches[tag], err, kernel_ms, plain_ms, bound_ms, bound_by, library_ms,
                              device_ms=kernel_dev, library_device_ms=library_dev, folded_cudnn_ms=chain_ms,
                              folded_cudnn_device_ms=chain_dev))
        del x, x_nchw
    del decoder
    free_cuda()
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
    band_errs = phase_band_kernels()
    halo_errs = phase_halo_kernels()
    phase_head_dims()
    phase_fused_tail_kernel()
    tail_launches = phase_decoder_path()
    phase_flagship_fp32()
    phase_flagship_grads()
    phase_flagship_416()
    eval_ref = phase_windowed_flagship()
    fwd_launches = phase_infer_main_path()
    band_fwd_launches = phase_config2()
    train, train_ms = phase_train("11 train", batch=8, frames=8)
    windowed, _ = phase_train("12 windowed train", batch=2, frames=32, window=64)
    halo_launches = phase_seq_two_ranks(eval_ref)
    phase_streaming()
    phase_data_path(train_ms)
    cli_counts = phase_runtime(train_ms)
    phase_config3()
    fct = phase_fct()
    phase_conv_families()
    records = time_flash(fwd_launches, fwd_err, {"flash_bwd_dq": train["dq_launches"],
                                                 "flash_bwd_dkv": train["dkv_launches"]}, bwd_errs)
    records += time_band({"band_fwd": band_fwd_launches, "band_bwd_ds": windowed["band_ds_launches"],
                          "band_bwd_dq": windowed["band_dq_launches"],
                          "band_bwd_dkv": windowed["band_dkv_launches"]}, band_errs)
    records += time_halo(dict(halo_launches, **{f"halo_bwd_{p_}": halo_launches[f"halo_{p_}_launches"]
                                                for p_ in ("ds", "dq", "dkv")}), halo_errs)
    records += time_fused_tail(tail_launches)
    for rec in records:  # phase 16: the launches of the CLI's training runs
        rec["cli_launches"] = cli_counts[counter_of(rec["name"])]
        if counter_of(rec["name"]) in FLASH3:  # phase 18: FCT's forward (a) and its CLI (c)
            rec["fct_launches"] = fct["launches"][counter_of(rec["name"])]
            rec["fct_step"] = fct["step"]["attention"]
        rec["conv_family_launches"] = CONV_LAUNCHES[counter_of(rec["name"])]  # phase 19 (a)-(e)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
