"""Classic 4-down/4-up UNet: image -> one-channel mask.

Counterpart of ``tchvp_tpu/models/unet.py``, with its module names:
conv-BN-ReLU double blocks (``encoder1`` .. ``encoder4``, ``bottleneck``,
``decoder4`` .. ``decoder1``), ``ConvTranspose`` k2 s2 upsampling
(``upconv4`` .. ``upconv1``: flax's "SAME" gives exactly 2x, as torch's
``padding=0`` does), each decoder block fed ``[up, skip]`` in that order,
and a 1x1 ``conv`` head under a sigmoid.

The public layouts are the JAX package's: image ``(B, H, W, C)`` in, mask
``(B, H, W, out_channels)`` out; the convolutions run NCHW. BatchNorm uses
batch statistics in train mode and moves its running stats as flax does
(:class:`~tchvp_tpu_torch.ops.blocks.BatchNorm`). There is no dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import UNetConfig
from tchvp_tpu_torch.ops.basic import max_pool_2x2
from tchvp_tpu_torch.ops.blocks import ConvBNReLUBlock, ConvTranspose2d, conv, init_flax_default


class UNet(nn.Module):
    """UNet over ``config.in_channels``-channel images. Weights are
    initialised like flax's defaults from ``generator`` (a fresh
    ``torch.Generator`` seeded 0 when None) on the CPU, then moved to
    ``device``. Entry points run on the card unless the caller asks for
    the CPU."""

    def __init__(self, config: UNetConfig = UNetConfig(), *, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        f = config.init_features
        widths = [f, 2 * f, 4 * f, 8 * f]
        cin = config.in_channels
        for i, w in enumerate(widths):
            self.add_module(f"encoder{i + 1}", ConvBNReLUBlock(cin, w))
            cin = w
        self.bottleneck = ConvBNReLUBlock(cin, 16 * f)
        cin = 16 * f
        for i in reversed(range(4)):
            w = widths[i]
            self.add_module(f"upconv{i + 1}", ConvTranspose2d(cin, w, 2, stride=2))
            self.add_module(f"decoder{i + 1}", ConvBNReLUBlock(2 * w, w))
            cin = w
        self.conv = conv(f, config.out_channels, 1, bias=True)
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, out_channels, H, W) mask."""
        skips = []
        for i in range(1, 5):
            x = getattr(self, f"encoder{i}")(x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bottleneck(x)
        for i in reversed(range(1, 5)):
            up = getattr(self, f"upconv{i}")(x)
            x = getattr(self, f"decoder{i}")(torch.cat([up, skips[i - 1]], dim=1))
        return torch.sigmoid(self.conv(x))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) image -> (B, H, W, out_channels) mask in [0, 1];
        ``generator`` is taken for a uniform step interface and unused."""
        del generator
        return layout.nchw_to_nhwc(self.forward_nchw(layout.nhwc_to_nchw(x)))
