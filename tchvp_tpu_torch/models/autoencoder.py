"""Plain multi-scale-input conv autoencoder: image -> (latent,
reconstruction).

Counterpart of ``tchvp_tpu/models/autoencoder.py``'s ``Encoder``,
``Decoder`` and ``AutoEncoder``, with its module names
(``encoder.block_1`` .. ``block_5``, ``decoder.block_4`` .. ``block_1``,
``decoder.ds``). The encoder's middle blocks take an image pyramid (2x2
average pools, flax's VALID) through ``conv1_b``; the reference's unused
fifth scale is left out, as in JAX. The deep-supervision head ends in ReLU
for the AutoEncoder (the reference's choice).

The public layouts are the JAX package's: image ``(B, H, W, C)`` in,
latent ``(B, H/32, W/32, filters[-1])`` and reconstruction ``(B, H, W,
out_channels)`` out, at the default five filters; the convolutions run
NCHW. Element-wise dropout acts in train mode and draws from the
generator the forward is given.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import AutoEncoderConfig
from tchvp_tpu_torch.ops.basic import avg_pool_2x2
from tchvp_tpu_torch.ops.blocks import (
    DecoderBlock,
    DeepSupervisionBlock,
    EncoderBlock,
    init_flax_default,
)


class Encoder(nn.Module):
    """Multi-scale-input conv encoder: ``block_1`` ("first"), the middle
    blocks fed the pyramid, ``block_n`` ("bottleneck"). NCHW."""

    def __init__(self, filters: Sequence[int] = (8, 16, 32, 64, 128), dropout_rate: float = 0.3,
                 in_channels: int = 3):
        super().__init__()
        f = list(filters)
        n = len(f)
        self.n = n
        self.add_module("block_1", EncoderBlock("first", in_channels, f[0], dropout_rate))
        for i in range(1, n - 1):
            self.add_module(f"block_{i + 1}", EncoderBlock("middle", f[i - 1], f[i], dropout_rate,
                                                            image_channels=in_channels))
        self.add_module(f"block_{n}", EncoderBlock("bottleneck", f[n - 2], f[n - 1], dropout_rate))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        scale_imgs, s = [], x
        for _ in range(self.n - 2):
            s = avg_pool_2x2(s)
            scale_imgs.append(s)
        h = self.block_1(x, generator=generator)
        for i in range(1, self.n - 1):
            h = getattr(self, f"block_{i + 1}")(h, scale_imgs[i - 1], generator=generator)
        return getattr(self, f"block_{self.n}")(h, generator=generator)


class Decoder(nn.Module):
    """Mirrored conv decoder: ``block_{n-1}`` .. ``block_1``, then ``ds``. NCHW."""

    def __init__(self, filters: Sequence[int] = (8, 16, 32, 64, 128), out_channels: int = 3,
                 dropout_rate: float = 0.3, final_activation: str = "relu"):
        super().__init__()
        rev = list(filters)[::-1]
        self.names = []
        for i in range(len(rev) - 1):
            name = f"block_{len(rev) - 1 - i}"
            self.add_module(name, DecoderBlock(rev[i], rev[i + 1], dropout_rate))
            self.names.append(name)
        self.ds = DeepSupervisionBlock(rev[-1], out_channels, final_activation)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, generator=generator)
        return self.ds(x)


class AutoEncoder(nn.Module):
    """(latent, reconstruction) conv AE over ``in_channels``-channel images
    (flax infers that from its example input; here it is given). Weights
    are initialised like flax's defaults from ``generator`` (a fresh
    ``torch.Generator`` seeded 0 when None) on the CPU, then moved to
    ``device``. Entry points run on the card unless the caller asks for the
    CPU."""

    def __init__(self, config: AutoEncoderConfig = AutoEncoderConfig(), *, in_channels: int = 3,
                 device: torch.device | str = "cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config.filters, config.dropout_rate, in_channels)
        self.decoder = Decoder(config.filters, config.out_channels, config.dropout_rate)
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def forward_nchw(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        latent = self.encoder(x, generator=generator)
        return latent, self.decoder(latent, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, C) -> (latent (B, h, w, C'), recon (B, H, W, out)).
        Train mode with dropout on draws from ``generator``."""
        latent, recon = self.forward_nchw(layout.nhwc_to_nchw(x), generator)
        return layout.nchw_to_nhwc(latent), layout.nchw_to_nhwc(recon)
