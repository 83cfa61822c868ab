"""ResNet-bottleneck encoder and decoder of the flagship, NCHW.

Counterparts of ``tchvp_tpu/models/resnet_ae.py``'s ``Encoder32K``,
``Decoder32K``, ``latent_to_tokens`` and ``tokens_to_latent``. Module
names follow the flax parameter names, so ``convert.from_flax`` maps
them one to one.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tchvp_tpu_torch.config import ResNetAEConfig
from tchvp_tpu_torch.ops.blocks import (
    BatchNorm,
    Bottleneck,
    ConvTranspose2d,
    conv,
    draw_keep,
    dropout,
)


class Encoder32K(nn.Module):
    """ResNet-style spatial compressor: (N, 3, H, W) -> (N, 8, H/4, W/4).

    7x7/s2 stem with a symmetric (3, 3) pad, Bottleneck stages (the second
    at stride 2), then a conv-BN-ReLU squeeze chain whose last stage keeps
    its ReLU. Dropout2d (whole channels) acts in train mode only.
    BatchNorm in train mode normalises with batch statistics and moves its
    running stats as flax does (:class:`~tchvp_tpu_torch.ops.blocks.BatchNorm`).
    """

    def __init__(self, config: ResNetAEConfig = ResNetAEConfig()):
        super().__init__()
        self.config = config
        self.stem_conv = conv(3, config.stem_features, 7, stride=2, padding=3)  # RGB
        self.stem_bn = BatchNorm(config.stem_features)
        blocks = OrderedDict()
        ch, planes = config.stem_features, config.stem_features
        for stage, n in enumerate(config.layers):
            stride = 1 if stage == 0 else 2
            for b in range(n):
                first = b == 0
                blocks[f"layer{stage + 1}_block{b}"] = Bottleneck(
                    ch, planes, stride=stride if first else 1, downsample=first
                )
                ch = planes * 4
            planes *= 2
        self.blocks = nn.Sequential(blocks)
        squeeze = []
        for feat in config.squeeze_features:
            squeeze += [conv(ch, feat, 3, padding=1), BatchNorm(feat), nn.ReLU()]
            ch = feat
        self.squeeze = nn.Sequential(*squeeze)

    def draw_dropout(self, n: int, generator: Optional[torch.Generator],
                     device: torch.device) -> Optional[torch.Tensor]:
        """The train-mode Dropout2d keep mask of ``n`` frames, (n, C, 1, 1),
        from ``generator``; None when the rate is 0."""
        if self.config.dropout_rate <= 0.0:
            return None
        c = self.config.squeeze_features[-1]
        return draw_keep((n, c, 1, 1), self.config.dropout_rate, generator, device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep`` (train mode): the Dropout2d mask drawn beforehand
        (:meth:`draw_dropout`); without it the pass draws from ``generator``."""
        h = torch.relu(self.stem_bn(self.stem_conv(x)))
        h = self.squeeze(self.blocks(h))
        if self.training and self.config.dropout_rate > 0.0:
            if keep is None:
                keep = self.draw_dropout(h.shape[0], generator, h.device)
            h = dropout(h, self.config.dropout_rate, None, keep=keep)
        return h


class Decoder32K(nn.Module):
    """Latent map -> image/mask decoder: (N, 8, h, w) -> (N, C', 4h, 4w).

    :meth:`body` (conv chain + first upsample, output at half resolution)
    and :meth:`tail` (second upsample, full-resolution convs, head);
    ``forward`` is ``tail(body(x))``. Only ``head_conv`` has a bias.
    """

    def __init__(self, output_type: str = "image",
                 conv_features: Sequence[int] = (16, 64, 128, 256)):
        super().__init__()
        self.output_type = output_type
        chans = [8, *conv_features]  # the encoder's 8 latent channels
        self.convs = nn.ModuleList(conv(a, b, 3, padding=1) for a, b in zip(chans, chans[1:]))
        self.conv_bns = nn.ModuleList(BatchNorm(f) for f in conv_features)
        ups = [chans[-1], 384, 192]
        self.upconvs = nn.ModuleList(
            ConvTranspose2d(a, b, 2, stride=2) for a, b in zip(ups, ups[1:])
        )
        self.up_bns = nn.ModuleList(BatchNorm(f) for f in ups[1:])
        posts = [ups[-1], 64, 8]
        self.post_convs = nn.ModuleList(conv(a, b, 3, padding=1) for a, b in zip(posts, posts[1:]))
        self.post_bns = nn.ModuleList(BatchNorm(f) for f in posts[1:])
        out_ch = 1 if output_type == "mask" else 3
        self.head_conv = conv(posts[-1], out_ch, 3, padding=1, bias=True)
        self.head_bn = BatchNorm(out_ch)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        for c, bn in zip(self.convs, self.conv_bns):
            x = torch.relu(bn(c(x)))
        return torch.relu(self.up_bns[0](self.upconvs[0](x)))

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.up_bns[1](self.upconvs[1](x)))
        for c, bn in zip(self.post_convs, self.post_bns):
            x = torch.relu(bn(c(x)))
        x = self.head_bn(self.head_conv(x))
        if self.output_type == "mask":
            return torch.sigmoid(x)
        return torch.relu(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.body(x))


def latent_to_tokens(latent: torch.Tensor) -> torch.Tensor:
    """(B, C, H', W') -> (B, C, H'*W'): channels become tokens, the spatial
    map flattens to the embedding dim (the JAX package's element order)."""
    b, c, h, w = latent.shape
    return latent.reshape(b, c, h * w)


def tokens_to_latent(tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H'*W') -> (B, C, H', W')."""
    b, c, _ = tokens.shape
    return tokens.reshape(b, c, hw[0], hw[1])
