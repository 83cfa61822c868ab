"""On-device preprocessing of uint8 frames and clips.

Counterpart of ``tchvp_tpu/data/pipeline.py``'s ``normalize_uint8``,
``resize_bilinear``, ``preprocess_images``, ``preprocess_clip``,
``gaussian_noise`` and ``augment_geometric``.
``jax.image.resize(..., "bilinear")`` antialiases when it downscales, so
the resize here is ``F.interpolate(..., antialias=True)``, which matches it
(without antialiasing a downscale differs by tenths). Random draws come
from an explicit ``torch.Generator``, as the JAX functions take a key.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import AugmentConfig


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


def gaussian_noise(generator: torch.Generator, x: torch.Tensor, std: float = 0.05) -> torch.Tensor:
    """``x`` plus N(0, std^2) noise drawn from ``generator``."""
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + noise * torch.tensor(std, dtype=x.dtype).item()


def augment_geometric(generator: torch.Generator, clean: torch.Tensor,
                      cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """The beyond-reference suite (rot90, crop-resize, colour jitter) on the
    clean images. All of it is off by default, and then ``clean`` comes
    back as it is; the suite itself is not ported yet."""
    if cfg.rot90_prob > 0.0 or cfg.crop_prob > 0.0 or cfg.jitter_prob > 0.0:
        raise NotImplementedError(
            "augment_geometric (rot90, crop, jitter) is not ported yet "
            "(ROADMAP.md, modules to port, item 8: the augmentations)"
        )
    return clean
