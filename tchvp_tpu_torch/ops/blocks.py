"""Conv building blocks of the main path: BatchNorm and the ResNet Bottleneck.

Counterparts of ``tchvp_tpu/ops/blocks.py``'s ``BatchNorm`` and
``Bottleneck``, NCHW. flax's BatchNorm momentum 0.9 is torch's 0.1; eps
is 1e-5 in both. In train mode torch updates the running variance with the
unbiased batch variance where flax uses the biased one; the port runs
inference only so far (ROADMAP.md, modules to port, item 2).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn


class BatchNorm(nn.BatchNorm2d):
    """Torch-default BatchNorm2d (eps 1e-5, momentum 0.1)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Inverted dropout whose keep mask, of ``shape`` (default: x's),
    broadcasts over x and is drawn from ``generator``."""
    if generator is None:
        raise ValueError("active dropout requires a torch.Generator")
    keep = torch.rand(shape or x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
         bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4: 1x1 -> 3x3(stride) -> 1x1(x4) convs
    with BN; optional 1x1-conv+BN downsample on the residual path.

    The 3x3 conv pads (1, 1) on both sides at stride 2 (XLA's SAME would
    pad (0, 1)); the 1x1 stride-2 downsample pads nothing.
    """

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, expansion: int = 4):
        super().__init__()
        out_ch = planes * expansion
        self.conv1 = conv(in_ch, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.downsample_conv: Optional[nn.Conv2d] = None
        self.downsample_bn: Optional[BatchNorm] = None
        if downsample:
            self.downsample_conv = conv(in_ch, out_ch, 1, stride=stride)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


def init_flax_default(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise like flax's defaults, from ``generator``: conv, transposed
    conv and linear weights lecun-normal (truncated at 2 sigma, fan-in over
    input channels x kernel taps), biases zero, norm scales one and shifts
    zero, BN running stats (0, 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
    return module
