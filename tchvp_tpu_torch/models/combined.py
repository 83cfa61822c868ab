"""Composed image -> image -> mask model: the AutoEncoder reconstructs the
frame, the UNet segments the reconstruction.

Counterpart of ``tchvp_tpu/models/combined.py``'s ``Image2Image2Mask``,
with its module names (``image2image_ae``, ``unet``). Returns ``(latent,
reconstruction, mask)`` in the JAX package's layouts (NHWC).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import AutoEncoderConfig, UNetConfig
from tchvp_tpu_torch.models.autoencoder import AutoEncoder
from tchvp_tpu_torch.models.unet import UNet
from tchvp_tpu_torch.ops.blocks import init_flax_default


class Image2Image2Mask(nn.Module):
    """AutoEncoder then UNet. Weights are initialised like flax's defaults
    from ``generator`` (a fresh ``torch.Generator`` seeded 0 when None) on
    the CPU, then moved to ``device``. In train mode the AutoEncoder's
    dropout draws from the generator the forward is given and the UNet's
    BatchNorm uses batch statistics."""

    def __init__(self, ae_config: AutoEncoderConfig = AutoEncoderConfig(),
                 unet_config: UNetConfig = UNetConfig(), *, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # Built where torch builds modules (the CPU; ``meta`` under ``with
        # torch.device("meta")``, as ``shards`` plans), drawn below.
        built = torch.get_default_device()
        self.image2image_ae = AutoEncoder(ae_config, in_channels=unet_config.in_channels, device=built)
        self.unet = UNet(unet_config, device=built)
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, C) -> (latent, recon (B, H, W, C'), mask (B, H, W, 1))."""
        latent, recon = self.image2image_ae.forward_nchw(layout.nhwc_to_nchw(x),
                                                        generator)
        mask = self.unet.forward_nchw(recon)
        return layout.nchw_to_nhwc(latent), layout.nchw_to_nhwc(recon), layout.nchw_to_nhwc(mask)
