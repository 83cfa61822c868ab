"""A frame autoencoder run over clips: the ``video --model ae32k|ae4k``
models.

Counterpart of the ``FrameAE`` of ``tchvp_tpu/cli.py::_video_model``: the
clip's frames fold into the batch around a per-frame ``Autoencoder32K`` or
``Autoencoder4K`` (held as ``ae``, flax's name, so a checkpoint's keys
start with ``ae.``), and the reconstruction unfolds back into the clip.

It meets the interface the video train and eval steps call on the
flagship (``train/steps.py``): :meth:`draw_dropout` makes a train-mode
pass's randomness before it runs, and ``forward(clip, draws=...)`` returns
``(latent, recon)``, the latent of every frame (the frame AE's layout,
frames folded into the batch) and the clip's reconstruction ``(B, T, H,
W, C')``. There are no stage boundaries to name, so the ``"stages"`` remat
policy recomputes the whole forward, as it does in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.models.resnet_ae import AEDraws


class FrameAE(nn.Module):
    """Fold clip frames into the batch around the per-frame AE ``ae``, which
    lives on its own device (built by the caller)."""

    def __init__(self, ae: nn.Module):
        super().__init__()
        self.ae = ae

    def draw_dropout(self, clip_shape: torch.Size, generator: Optional[torch.Generator],
                     device: torch.device, has_mask: bool = False) -> AEDraws:
        """The randomness of one train-mode pass over a clip of
        ``clip_shape`` (B, T, H, W, C), drawn from ``generator``."""
        del has_mask
        b, t, h, w = clip_shape[:4]
        return self.ae.draw(b * t, (h, w), generator, device)

    def forward(self, clip: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws: Optional[AEDraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """clip (B, T, H, W, C) -> (latent, recon (B, T, H, W, C')). Takes
        ``draws``, or draws them from ``generator`` first."""
        b = clip.shape[0]
        if draws is None:
            draws = self.draw_dropout(clip.shape, generator, clip.device)
        latent, recon = self.ae(layout.fold_time(clip), draws=draws)
        return latent, layout.unfold_time(recon, b)
