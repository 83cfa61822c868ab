"""On-device preprocessing of uint8 frames and clips.

Counterpart of ``tchvp_tpu/data/pipeline.py``'s ``normalize_uint8``,
``resize_bilinear``, ``preprocess_images`` and ``preprocess_clip``.
``jax.image.resize(..., "bilinear")`` antialiases when it downscales, so
the resize here is ``F.interpolate(..., antialias=True)``, which matches it
(without antialiasing a downscale differs by tenths).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tchvp_tpu_torch import layout


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]."""
    return x.to(torch.float32) / 255.0


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear (antialiased on downscale) resize of (B, H, W, C) to
    (B, size[0], size[1], C)."""
    y = F.interpolate(layout.nhwc_to_nchw(x), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return layout.nchw_to_nhwc(y)


def preprocess_images(
    raw: torch.Tensor, image_size: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, H, W, C) uint8 -> resized, normalized (B, S, S, C) float."""
    x = normalize_uint8(raw)
    if raw.shape[1] != image_size or raw.shape[2] != image_size:
        x = resize_bilinear(x, (image_size, image_size))
    return x.to(dtype)


def preprocess_clip(
    raw: torch.Tensor, image_size: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, T, H, W, C) uint8 -> (B, T, S, S, C) float."""
    b = raw.shape[0]
    return layout.unfold_time(preprocess_images(layout.fold_time(raw), image_size, dtype), b)
