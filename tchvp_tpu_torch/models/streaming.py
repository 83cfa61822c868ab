"""Streaming long-video processing (BASELINE config 4) and over-memory
batches (config 2).

Counterpart of ``tchvp_tpu/models/streaming.py`` over a
:class:`VideoHybridNet` that holds its own weights (the JAX functions take
``variables``):

* :func:`stream_video` pads 1080p-class frames and cuts them into tiles
  (:mod:`tchvp_tpu_torch.ops.tiling`); each tile is a clip of the batch.
* :func:`stream_clip` runs a clip in chunks of ``chunk_len`` frames. Each
  chunk's temporal transformer attends over the raw encoder tokens of the
  previous chunk's last ``ctx_frames`` frames followed by its own: the
  overlapping window of the streaming path, carried by a Python loop where
  JAX runs ``lax.scan``. The first chunk's context is zeros, as JAX's.
* :func:`microbatched_infer` runs a batch as sequential groups into one
  preallocated output, so peak activation memory is one group's.

A frame autoencoder (``models/frame_ae.py``, ``--model ae32k|ae4k``) has
no temporal stage and no context to carry: its chunks run through the
model as they are.

All of them are inference: they run the model in eval mode under
``torch.inference_mode`` and give its training flag back afterwards. Input
clips are cast to the model's dtype first, as the flax modules cast theirs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, Optional

import torch

from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.ops import tiling


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Operating point of the streaming path.

    ``tile``: square patch size frames are tiled into (frames no larger
    than ``tile`` pass through untiled). ``chunk_len``: frames per chunk.
    ``ctx_frames``: frames of previous-chunk context visible to each
    chunk's temporal attention (the overlap of the overlapping window).
    """

    tile: int = 256
    chunk_len: int = 8
    ctx_frames: int = 4


@contextlib.contextmanager
def _inference(model: VideoHybridNet) -> Iterator[torch.dtype]:
    """Eval mode and inference mode for the block; yields the model's dtype."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield next(model.parameters()).dtype
    finally:
        model.train(was_training)


def stream_clip(model: VideoHybridNet, clip: torch.Tensor, chunk_len: int,
                ctx_frames: int = 0) -> torch.Tensor:
    """Process (B, T, H, W, C) in chunks of ``chunk_len`` frames, carrying
    the raw encoder tokens of the last ``ctx_frames`` frames; each chunk's
    temporal transformer attends over [context || chunk] and only the
    chunk's tokens are decoded. T must be a multiple of ``chunk_len``.
    Returns the reconstructed clip (B, T, H, W, C')."""
    b, t = clip.shape[0], clip.shape[1]
    if t % chunk_len:
        raise ValueError(f"clip length {t} not a multiple of chunk {chunk_len}")
    if ctx_frames > chunk_len:
        raise ValueError("ctx_frames must be <= chunk_len")
    frame_wise = not hasattr(model, "temporal_mix")
    ctx_tokens = 0 if frame_wise else ctx_frames * model.config.tokens_per_frame
    d = (clip.shape[2] // 4) * (clip.shape[3] // 4)  # tokens embed the H/4 x W/4 latent map
    recon = None
    with _inference(model) as dtype:
        clip = clip.to(dtype)
        carry = clip.new_zeros((b, ctx_tokens, d))
        for start in range(0, t, chunk_len):
            part = clip[:, start:start + chunk_len]
            if frame_wise:
                chunk = model(part)[1]
            else:
                tokens, hw = model.encode_clip(part)
                if ctx_tokens:
                    out_tokens = model.temporal_mix(torch.cat([carry, tokens], dim=1))[:, ctx_tokens:]
                    carry = tokens[:, -ctx_tokens:]
                else:
                    out_tokens = model.temporal_mix(tokens)
                chunk = model.decode_tokens(out_tokens, hw)
            if recon is None:
                recon = chunk.new_empty((b, t) + chunk.shape[2:])
            recon[:, start:start + chunk_len] = chunk
    return recon


def stream_video(model: VideoHybridNet, clip: torch.Tensor,
                 cfg: StreamingConfig = StreamingConfig()) -> torch.Tensor:
    """The streaming path: pad -> tile -> chunked :func:`stream_clip` ->
    untile -> crop. ``clip``: (B, T, H, W, C) at any resolution (e.g.
    1080p); returns the reconstruction at the input resolution."""
    if clip.shape[2] > cfg.tile or clip.shape[3] > cfg.tile:
        padded, orig_hw = tiling.pad_frames(clip, cfg.tile)
        tiles, grid = tiling.tile_frames(padded, cfg.tile)
        recon = stream_clip(model, tiles, cfg.chunk_len, cfg.ctx_frames)
        return tiling.untile_frames(recon, grid, orig_hw)
    # The encoder downsamples 4x: keep dims a multiple of 4.
    padded, (h, w) = tiling.pad_frames(clip, 4)
    recon = stream_clip(model, padded, cfg.chunk_len, cfg.ctx_frames)
    return recon[:, :, :h, :w, :]


def microbatched_infer(model: VideoHybridNet, clip: torch.Tensor, microbatch: int) -> torch.Tensor:
    """Inference at a batch size whose activations would not fit at once.

    Clips are independent (temporal attention couples frames only within a
    clip), so the batch runs as ``B / microbatch`` sequential groups: peak
    activation memory is one group's, and each group writes its slice of
    one preallocated output. This is how BASELINE config 2 runs batch 16.
    ``clip``: (B, T, H, W, C), B a multiple of ``microbatch``. Returns the
    reconstruction.
    """
    b = clip.shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} not a multiple of microbatch {microbatch}")
    recon = None
    with _inference(model) as dtype:
        for start in range(0, b, microbatch):
            _, group = model(clip[start:start + microbatch].to(dtype))
            if recon is None:
                recon = group.new_empty((b,) + group.shape[1:])
            recon[start:start + microbatch] = group
    return recon


def make_streamer(model: VideoHybridNet, cfg: StreamingConfig = StreamingConfig(),
                  mesh: Optional[object] = None,
                  int8_engine: Optional[object] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """A reusable streaming function ``f(clip) -> recon`` over ``model``."""
    if mesh is not None:
        raise NotImplementedError(
            "make_streamer over a mesh is not ported yet "
            "(ROADMAP.md, modules to port, item 11: parallelism)")
    if int8_engine is not None:
        raise NotImplementedError(
            "make_streamer with an int8 engine is not ported yet "
            "(ROADMAP.md, modules to port, item 10: infer/quant.py)")
    return lambda clip: stream_video(model, clip, cfg)
