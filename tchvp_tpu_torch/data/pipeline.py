"""On-device preprocessing and augmentation of uint8 frames and clips.

Counterpart of ``tchvp_tpu/data/pipeline.py``. ``jax.image.resize(...,
"bilinear")`` antialiases when it downscales, so the resize here is
``F.interpolate(..., antialias=True)``, which matches it both ways, edges
included (without antialiasing a downscale differs by tenths).

Randomness. torch cannot reproduce ``jax.random`` streams, so each
augmentation comes in two parts: ``*_draws(generator, ...)`` makes its
random draws on the input's device from an explicit ``torch.Generator``
(as the JAX functions take a key; a Bernoulli gate is ``uniform < p``, as
``jax.random.bernoulli`` draws it), and ``*_with(x, ...)`` applies given
draws. The public function chains the two. The tests hold each ``*_with``
to the JAX function on JAX's own draws.

No host sync. Where JAX branches (``lax.cond``) or selects per sample, the
port computes the alternatives and picks with ``torch.where`` on device
tensors, and the crop gathers rows and columns at device offsets, so no
augmentation waits for the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import AugmentConfig


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]."""
    return x.to(torch.float32) / 255.0


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear (antialiased on downscale) resize of (..., H, W, C) to
    (..., size[0], size[1], C)."""
    lead, c = tuple(x.shape[:-3]), x.shape[-1]
    flat = x.reshape((-1,) + tuple(x.shape[-3:]))
    y = F.interpolate(layout.nhwc_to_nchw(flat), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return layout.nchw_to_nhwc(y).reshape(lead + tuple(size) + (c,))


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


def _bernoulli(generator: torch.Generator, prob: float, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < prob


def _per_sample(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) against an ``ndim``-dimensional batch."""
    return v.reshape((v.shape[0],) + (1,) * (ndim - 1))


# ----------------------------------------------------------------- noise


def noise_with(x: torch.Tensor, noise: torch.Tensor, std: float) -> torch.Tensor:
    """``x`` plus standard-normal ``noise`` scaled by ``std`` (in x's dtype)."""
    return x + noise * torch.tensor(std, dtype=x.dtype).item()


def gaussian_noise(generator: torch.Generator, x: torch.Tensor, std: float = 0.05) -> torch.Tensor:
    """``x`` plus N(0, std^2) noise drawn from ``generator``."""
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return noise_with(x, noise, std)


# ----------------------------------------------------------------- hflip


def hflip_draws(generator: torch.Generator, x: torch.Tensor, prob: float = 0.5) -> Tuple[torch.Tensor]:
    """The flip bit, one for the whole batch."""
    return (_bernoulli(generator, prob, (), x.device),)


def hflip_with(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """The batch mirrored along W where the 0-d bool ``flip`` is set."""
    return torch.where(flip, x.flip(-2), x)


def random_hflip(generator: torch.Generator, x: torch.Tensor, prob: float = 0.5) -> torch.Tensor:
    """Batch-level horizontal flip (the whole batch at once)."""
    return hflip_with(x, *hflip_draws(generator, x, prob))


# -------------------------------------------------------------- blackout


def blackout_draws(generator: torch.Generator, x: torch.Tensor, max_patches: int = 3,
                   patch: int = 16) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n_active, r0, c0): the count of active patches in [0, max_patches]
    and each slot's top-left corner. Where a patch does not fit, its corner
    is 0, as ``jax.random.randint`` gives for an empty range."""
    h, w = x.shape[-3], x.shape[-2]
    kw = dict(generator=generator, device=x.device)
    n_active = torch.randint(0, max_patches + 1, (), **kw)
    r0 = torch.randint(0, max(h - patch + 1, 1), (max_patches,), **kw)
    c0 = torch.randint(0, max(w - patch + 1, 1), (max_patches,), **kw)
    return n_active, r0, c0


def blackout_with(x: torch.Tensor, n_active: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                  patch: int = 16) -> torch.Tensor:
    """Zero the first ``n_active`` of the patch x patch squares at (r0, c0),
    the same locations for the whole batch."""
    h, w = x.shape[-3], x.shape[-2]
    rows = torch.arange(h, device=x.device).reshape(1, h, 1)
    cols = torch.arange(w, device=x.device).reshape(1, 1, w)
    r0, c0 = r0.reshape(-1, 1, 1), c0.reshape(-1, 1, 1)
    active = (torch.arange(r0.shape[0], device=x.device) < n_active).reshape(-1, 1, 1)
    inside = (rows >= r0) & (rows < r0 + patch) & (cols >= c0) & (cols < c0 + patch)
    mask = torch.where((inside & active).any(0), 0.0, 1.0).to(x.dtype)
    return x * mask[..., None]


def random_blackout(generator: torch.Generator, x: torch.Tensor, max_patches: int = 3,
                    patch: int = 16) -> torch.Tensor:
    """Zero 0..max_patches random patch x patch squares (the whole batch
    shares the patch locations)."""
    return blackout_with(x, *blackout_draws(generator, x, max_patches, patch), patch)


# ----------------------------------------------------------------- rot90


def rot90_draws(generator: torch.Generator, x: torch.Tensor, prob: float) -> Tuple[torch.Tensor]:
    """Per-sample k in {0, 1, 2, 3}: uniform where the sample's gate fires, else 0."""
    b = x.shape[0]
    gate = _bernoulli(generator, prob, (b,), x.device)
    ks = torch.randint(0, 4, (b,), generator=generator, device=x.device)
    return (torch.where(gate, ks, 0),)


def rot90_with(x: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Each sample rotated by ks[i] quarter turns in the (H, W) plane; all
    four rotations are formed and ks selects."""
    if x.shape[-3] != x.shape[-2]:
        raise ValueError("random_rot90 needs square spatial dims")
    sel = _per_sample(ks, x.ndim)
    out = x
    for k in (1, 2, 3):
        out = torch.where(sel == k, torch.rot90(x, k, dims=(-3, -2)), out)
    return out


def random_rot90(generator: torch.Generator, x: torch.Tensor, prob: float) -> torch.Tensor:
    """Per-sample rotation by a random multiple of 90 degrees (square images)."""
    return rot90_with(x, *rot90_draws(generator, x, prob))


# ----------------------------------------------------------- crop-resize


def crop_size(h: int, w: int, frac: float) -> Tuple[int, int]:
    """The static crop of ``frac`` of (h, w), at least one pixel each."""
    return max(int(round(h * frac)), 1), max(int(round(w * frac)), 1)


def crop_draws(generator: torch.Generator, x: torch.Tensor, prob: float, frac: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(off_h, off_w, gate), each (B,): the crop's per-sample offsets and
    whether it applies."""
    h, w = x.shape[-3], x.shape[-2]
    ch, cw = crop_size(h, w, frac)
    b = x.shape[0]
    kw = dict(generator=generator, device=x.device)
    gate = _bernoulli(generator, prob, (b,), x.device)
    off_h = torch.randint(0, h - ch + 1, (b,), **kw)
    off_w = torch.randint(0, w - cw + 1, (b,), **kw)
    return off_h, off_w, gate


def crop_resize_with(x: torch.Tensor, off_h: torch.Tensor, off_w: torch.Tensor, gate: torch.Tensor,
                     frac: float) -> torch.Tensor:
    """Where ``gate`` is set, the sample's crop of ``frac`` of H and W at
    (off_h, off_w), shared by a clip's frames, resized back to (H, W). The
    crop gathers rows, then columns, at the device offsets."""
    h, w = x.shape[-3], x.shape[-2]
    ch, cw = crop_size(h, w, frac)
    if (ch, cw) == (h, w):
        return x
    lead, c = tuple(x.shape[:-3]), x.shape[-1]
    ones = (1,) * (len(lead) - 1)

    rows = (off_h[:, None] + torch.arange(ch, device=x.device)).reshape((-1,) + ones + (ch, 1, 1))
    cropped = x.gather(-3, rows.expand(lead + (ch, w, c)))
    cols = (off_w[:, None] + torch.arange(cw, device=x.device)).reshape((-1,) + ones + (1, cw, 1))
    cropped = cropped.gather(-2, cols.expand(lead + (ch, cw, c)))
    resized = resize_bilinear(cropped, (h, w)).to(x.dtype)
    return torch.where(_per_sample(gate, x.ndim), resized, x)


def random_crop_resize(generator: torch.Generator, x: torch.Tensor, prob: float, frac: float
                       ) -> torch.Tensor:
    """Per-sample random crop of a fixed fraction, resized back; for clips
    the crop is shared across the sample's frames."""
    return crop_resize_with(x, *crop_draws(generator, x, prob, frac), frac)


# ---------------------------------------------------------------- jitter


def jitter_draws(generator: torch.Generator, x: torch.Tensor, prob: float, strength: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(bright, contrast, sat, gate), each (B,): brightness in [-s, s),
    contrast and saturation in [1 - s, 1 + s), and whether the jitter
    applies."""
    b = x.shape[0]
    gate = _bernoulli(generator, prob, (b,), x.device)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((b,), generator=generator, device=x.device, dtype=x.dtype)

    bright = uniform(-strength, strength)
    contrast = uniform(1.0 - strength, 1.0 + strength)
    sat = uniform(1.0 - strength, 1.0 + strength)
    return bright, contrast, sat, gate


def jitter_with(x: torch.Tensor, bright: torch.Tensor, contrast: torch.Tensor, sat: torch.Tensor,
                gate: torch.Tensor) -> torch.Tensor:
    """Saturation about the per-pixel channel mean, then contrast about the
    per-sample mean over all non-batch axes, then brightness, clipped to
    [0, 1], where ``gate`` is set."""
    bright, contrast, sat = (_per_sample(v, x.ndim) for v in (bright, contrast, sat))
    gray = x.mean(dim=-1, keepdim=True)
    y = (x - gray) * sat + gray
    mean = y.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    y = (y - mean) * contrast + mean + bright
    y = torch.clamp(y, 0.0, 1.0)
    return torch.where(_per_sample(gate, x.ndim), y, x)


def color_jitter(generator: torch.Generator, x: torch.Tensor, prob: float, strength: float
                 ) -> torch.Tensor:
    """Per-sample brightness / contrast / saturation jitter on [0,1] images."""
    return jitter_with(x, *jitter_draws(generator, x, prob, strength))


# ---------------------------------------------------------------- suites


def geometric_draws(generator: torch.Generator, x: torch.Tensor,
                    cfg: AugmentConfig = AugmentConfig()) -> Dict[str, tuple]:
    """The draws of every augmentation ``cfg`` turns on, in the order
    :func:`augment_geometric_with` applies them."""
    draws = {}
    if cfg.rot90_prob > 0.0:
        draws["rot90"] = rot90_draws(generator, x, cfg.rot90_prob)
    if cfg.crop_prob > 0.0:
        draws["crop"] = crop_draws(generator, x, cfg.crop_prob, cfg.crop_frac)
    if cfg.jitter_prob > 0.0:
        draws["jitter"] = jitter_draws(generator, x, cfg.jitter_prob, cfg.jitter_strength)
    return draws


def augment_geometric_with(clean: torch.Tensor, cfg: AugmentConfig, draws: Dict[str, tuple]
                           ) -> torch.Tensor:
    """rot90, crop-resize and colour jitter on given draws (each one only
    where ``draws`` has it)."""
    if "rot90" in draws:
        clean = rot90_with(clean, *draws["rot90"])
    if "crop" in draws:
        clean = crop_resize_with(clean, *draws["crop"], cfg.crop_frac)
    if "jitter" in draws:
        clean = jitter_with(clean, *draws["jitter"])
    return clean


def augment_geometric(generator: torch.Generator, clean: torch.Tensor,
                      cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """The beyond-reference suite (per-sample rot90, fixed-fraction
    crop-resize, colour jitter) on the clean images, before corruption, so
    the reconstruction targets stay consistent with the inputs. All of it
    is off by default, and then ``clean`` comes back as it is."""
    return augment_geometric_with(clean, cfg, geometric_draws(generator, clean, cfg))


def denoising_draws(generator: torch.Generator, image: torch.Tensor,
                    cfg: AugmentConfig = AugmentConfig()) -> Dict[str, tuple]:
    """The flip bit, the noise gate, the noise, the blackout gate and the
    blackout's draws, all drawn whatever the gates say."""
    return {
        "flip": hflip_draws(generator, image, cfg.hflip_prob),
        "noise_gate": _bernoulli(generator, cfg.noise_prob, (), image.device),
        "noise": torch.randn(image.shape, generator=generator, device=image.device, dtype=image.dtype),
        "patch_gate": _bernoulli(generator, 0.5, (), image.device),
        "blackout": blackout_draws(generator, image, cfg.max_blackout_patches, cfg.blackout_size),
    }


def augment_denoising_with(image: torch.Tensor, cfg: AugmentConfig, draws: Dict[str, tuple]
                           ) -> torch.Tensor:
    """The denoising chain on given draws: the flipped batch, or, where the
    noise gate fires, the noised (and, where the patch gate fires, blacked
    out) batch. As in JAX, the noise is added to ``image``, not to the
    flipped batch, so a fired noise gate drops the flip."""
    flipped = hflip_with(image, *draws["flip"])
    noised = noise_with(image, draws["noise"], cfg.noise_std)
    blacked = torch.where(draws["patch_gate"],
                          blackout_with(noised, *draws["blackout"], cfg.blackout_size), noised)
    return torch.where(draws["noise_gate"], blacked, flipped)


def augment_denoising(generator: torch.Generator, image: torch.Tensor,
                      cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """The reference's denoising-AE augmentation chain: hflip p 0.5, noise
    x ``noise_std`` p ``noise_prob``, 0-3 blackout patches p 0.5. Returns
    the corrupted input; the loss target stays the clean image."""
    return augment_denoising_with(image, cfg, denoising_draws(generator, image, cfg))


def corrupt_for_test(generator: torch.Generator, image: torch.Tensor,
                     cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Test-time inpainting corruption: 0-3 random blackouts of
    ``test_blackout_size``."""
    return random_blackout(generator, image, cfg.max_blackout_patches, cfg.test_blackout_size)
