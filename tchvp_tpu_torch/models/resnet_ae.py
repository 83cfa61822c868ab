"""ResNet-bottleneck autoencoder family: the flagship's encoder and
decoder (NCHW) and the frame autoencoders built from them.

Counterparts of ``tchvp_tpu/models/resnet_ae.py``'s ``Encoder32K``,
``Decoder32K``, ``latent_to_tokens``, ``tokens_to_latent``,
``Autoencoder32K`` and ``Autoencoder4K``. Module names follow the flax
parameter names, so ``convert.from_flax`` maps them one to one.

The two autoencoders take and give the JAX package's layouts: image
``(B, H, W, 3)`` in, reconstruction ``(B, H, W, C')`` out; the latent is
``(B, H/4, W/4, 8)`` (``Autoencoder32K``; ``(B, 8, H/4*W/4)`` tokens with
``token_latent``) or the channel-first flatten of the ``(16, H/4, W/4)``
map (``Autoencoder4K``, 4096 at 64^2). The convolutions take the NCHW
view of the NHWC input as it is, channels-last in memory, as the flagship's
``encode_clip`` does: cuDNN keeps that layout through encoder and decoder,
and train-mode BatchNorm runs its channels-last kernels. A contiguous NCHW
copy there sent every BatchNorm to the NCHW kernels: ``video --model
ae32k``'s step (batch 8 x 8 frames at 256^2, fp32) took 286.93 ms with it
and 201.84 ms without (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase
19).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import ResNetAEConfig
from tchvp_tpu_torch.ops.blocks import (
    BatchNorm,
    Bottleneck,
    ConvTranspose2d,
    conv,
    draw_keep,
    dropout,
    init_flax_default,
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
    """Latent map -> image/mask decoder: (N, latent_channels, h, w) ->
    (N, C', 4h, 4w).

    :meth:`body` (conv chain + first upsample, output at half resolution)
    and :meth:`tail` (second upsample, full-resolution convs, head);
    ``forward`` is ``tail(body(x))``. Only ``head_conv`` has a bias.
    ``latent_channels`` is the width of the latent it decodes (flax infers
    it from the input): the flagship's and ``Autoencoder32K``'s 8,
    ``Autoencoder4K``'s 16.
    """

    def __init__(self, output_type: str = "image",
                 conv_features: Sequence[int] = (16, 64, 128, 256), latent_channels: int = 8):
        super().__init__()
        self.output_type = output_type
        chans = [latent_channels, *conv_features]
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


@dataclasses.dataclass
class AEDraws:
    """The randomness of one train-mode pass of a frame autoencoder, drawn
    before it runs: the encoder's Dropout2d keep mask (None at rate 0) and,
    with ``vae``, the reparameterisation's standard-normal ``eps`` (which
    JAX draws in eval mode too)."""

    keep: Optional[torch.Tensor] = None
    eps: Optional[torch.Tensor] = None


class Autoencoder32K(nn.Module):
    """encode -> decode: (latent, reconstruction) (module docstring).

    With ``config.vae`` the latent is ``mu + exp(0.5 logvar) * eps`` from
    per-channel 1x1 ``mu``/``logvar`` heads. Weights are initialised like
    flax's defaults from ``generator`` (a fresh ``torch.Generator`` seeded 0
    when None) on the CPU, then moved to ``device``."""

    def __init__(self, config: ResNetAEConfig = ResNetAEConfig(), *,
                 device: torch.device | str = "cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        _unported_axes(config)
        self.config = config
        c = config.squeeze_features[-1]
        self.encoder = Encoder32K(config)
        self.decoder = Decoder32K(output_type=config.output_type, latent_channels=c)
        if config.vae:
            self.mu = conv(c, c, 1, bias=True)
            self.logvar = conv(c, c, 1, bias=True)
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def draw(self, n: int, hw: Tuple[int, int], generator: Optional[torch.Generator],
             device: torch.device) -> AEDraws:
        """The draws of a pass over ``n`` images of ``hw`` = (H, W): the
        keep mask in train mode, ``eps`` of the (n, C, H/4, W/4) latent with
        ``vae``."""
        keep = self.encoder.draw_dropout(n, generator, device) if self.training else None
        eps = None
        if self.config.vae:
            if generator is None:
                raise ValueError("vae=True draws eps and requires a torch.Generator")
            h, w = (hw[0] + 1) // 2, (hw[1] + 1) // 2  # the stem, then the stride-2 stage
            shape = (n, self.config.squeeze_features[-1], (h + 1) // 2, (w + 1) // 2)
            eps = torch.randn(shape, generator=generator, device=generator.device).to(device)
        return AEDraws(keep, eps)

    def forward_nchw(self, x: torch.Tensor, draws: AEDraws) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) -> (latent map (N, C, h, w), recon (N, C', H, W))."""
        latent = self.encoder(x, keep=draws.keep)
        if self.config.vae:
            mu, logvar = self.mu(latent), self.logvar(latent)
            latent = mu + torch.exp(0.5 * logvar) * draws.eps.to(mu.dtype)
        return latent, self.decoder(latent)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws: Optional[AEDraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) -> (latent, recon (B, H, W, C')). Takes ``draws``,
        or draws them from ``generator`` first (:meth:`draw`)."""
        if draws is None:
            draws = self.draw(x.shape[0], (x.shape[1], x.shape[2]), generator, x.device)
        latent, recon = self.forward_nchw(layout.nhwc_to_nchw(x), draws)
        recon = layout.nchw_to_nhwc(recon)
        if self.config.token_latent:
            return latent_to_tokens(latent), recon
        return layout.nchw_to_nhwc(latent), recon


class Autoencoder4K(nn.Module):
    """Flat-4096-latent AE for 64^2 inputs: the encoder squeezes
    512 -> 128 -> 64 -> 32 -> 16 (Dropout2d 0.1), the latent is the
    channel-first flatten of the (16, 16, 16) map, and the decoder opens its
    conv chain at 32 from the 16-channel map. Initialised as
    :class:`Autoencoder32K`."""

    def __init__(self, output_type: str = "image", tp_axis: Optional[str] = None,
                 sp_axis: Optional[str] = None, *, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = ResNetAEConfig(squeeze_features=(128, 64, 32, 16), dropout_rate=0.1,
                                     output_type=output_type, tp_axis=tp_axis, sp_axis=sp_axis)
        _unported_axes(self.config)
        self.encoder = Encoder32K(self.config)
        self.decoder = Decoder32K(output_type=output_type, conv_features=(32, 64, 128, 256),
                                  latent_channels=16)
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def draw(self, n: int, hw: Tuple[int, int], generator: Optional[torch.Generator],
             device: torch.device) -> AEDraws:
        """The train-mode keep mask of a pass over ``n`` images."""
        del hw
        return AEDraws(self.encoder.draw_dropout(n, generator, device) if self.training else None)

    def forward_nchw(self, x: torch.Tensor, draws: AEDraws) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) -> (flat latent (N, 16 h w), recon (N, C', H, W))."""
        latent_map = self.encoder(x, keep=draws.keep)
        return latent_map.reshape(latent_map.shape[0], -1), self.decoder(latent_map)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws: Optional[AEDraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) -> (flat latent (B, 16 H/4 W/4), recon (B, H, W, C'))."""
        if draws is None:
            draws = self.draw(x.shape[0], (x.shape[1], x.shape[2]), generator, x.device)
        latent, recon = self.forward_nchw(layout.nhwc_to_nchw(x), draws)
        return latent, layout.nchw_to_nhwc(recon)


def _unported_axes(cfg: ResNetAEConfig) -> None:
    for name in ("tp_axis", "sp_axis"):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"ResNetAEConfig {name} is not ported yet (ROADMAP.md, modules to port, item 11: "
                "parallelism)")
