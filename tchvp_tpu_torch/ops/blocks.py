"""Conv building blocks of the main path: BatchNorm and the ResNet Bottleneck.

Counterparts of ``tchvp_tpu/ops/blocks.py``'s ``BatchNorm`` and
``Bottleneck``, NCHW. flax's BatchNorm momentum 0.9 is torch's 0.1; eps
is 1e-5 in both. In train mode flax normalises with the biased batch
variance and updates the running variance with the biased one too, where
torch's own BatchNorm2d would update it with the unbiased one; the port's
:class:`BatchNorm` does what flax does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5, momentum 0.1) with flax's train-mode update.

    Train mode normalises with the batch mean and biased variance and moves
    the running stats toward them: ``r = 0.9 * r + 0.1 * batch``. While
    ``freeze_stats`` is set (:func:`frozen_batch_stats`) train mode updates
    nothing: the recompute of a checkpointed forward must not move the
    stats a second time.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.freeze_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # One pass: the normalisation also returns the batch mean and
        # 1/sqrt(biased var + eps), from which the running stats move.
        out, mean, rstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        if not self.freeze_stats:
            with torch.no_grad():
                m = self.momentum
                var = rstd.float().pow(-2) - self.eps
                self.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return out


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Within the scope, train-mode :class:`BatchNorm` layers of ``module``
    leave their running stats alone."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.freeze_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.freeze_stats = False


def draw_keep(shape: Tuple[int, ...], rate: float, generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """Bool keep mask (True = keep, P = 1 - rate) drawn from ``generator``
    on its own device, then moved to ``device``."""
    if generator is None:
        raise ValueError("active dropout requires a torch.Generator")
    return (torch.rand(shape, generator=generator, device=generator.device) >= rate).to(device)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shape: Optional[Tuple[int, ...]] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout whose keep mask, of ``shape`` (default: x's),
    broadcasts over x: ``keep`` when given (drawn beforehand), else drawn
    from ``generator``."""
    if keep is None:
        keep = draw_keep(shape or tuple(x.shape), rate, generator, x.device)
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
