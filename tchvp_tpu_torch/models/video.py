"""Flagship video pipeline: per-frame CNN encoder -> temporal transformer ->
per-frame CNN decoder.

Counterpart of ``tchvp_tpu/models/video.py``. Frames fold into the batch
for the convs (NCHW on cuDNN); each frame's 8 latent channels become
temporal tokens of dim (H/4)*(W/4), concatenated over the clip. The public
layouts are the JAX package's: clip ``(B, T, H, W, 3)``, tokens
``(B, T*8, (H/4)*(W/4))``, recon ``(B, T, H, W, C')``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import VideoModelConfig
from tchvp_tpu_torch.models.resnet_ae import (
    Decoder32K,
    Encoder32K,
    latent_to_tokens,
    tokens_to_latent,
)
from tchvp_tpu_torch.models.transformer import TransformerEncoder
from tchvp_tpu_torch.ops.blocks import init_flax_default


def sinusoidal_posenc(seq_len: int, dim: int) -> np.ndarray:
    """Standard sinusoidal positional encoding, (seq_len, dim) float32."""
    position = np.arange(seq_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, dim, 2).astype(np.float32) * (-np.log(10000.0) / dim))
    pe = np.zeros((seq_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe


class VideoHybridNet(nn.Module):
    """CNN spatial compression + transformer temporal mixing + CNN decode.

    Weights are initialised like flax's defaults from ``generator`` (a
    fresh ``torch.Generator`` seeded 0 when None) on the CPU, then moved to
    ``device`` and ``dtype``. Entry points run on the card unless the
    caller asks for the CPU.
    """

    def __init__(self, config: VideoModelConfig = VideoModelConfig(), *,
                 device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.encoder = Encoder32K(config.encoder)
        self.temporal = TransformerEncoder(config.temporal)
        self.decoder = Decoder32K(output_type=config.output_type)
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        self._posenc: Dict[Tuple, torch.Tensor] = {}
        self.to(device=device, dtype=dtype)

    def encode_clip(self, clip: torch.Tensor, generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """(B, T, H, W, C) -> (tokens (B, T*tpf, D), latent (hh, ww))."""
        b, t = clip.shape[0], clip.shape[1]
        frames = layout.nhwc_to_nchw(layout.fold_time(clip))  # (B*T, C, H, W)
        latent = self.encoder(frames, generator=generator)
        _, cc, hh, ww = latent.shape
        tokens = latent_to_tokens(latent)  # (B*T, C', hh*ww)
        return tokens.reshape(b, t * cc, tokens.shape[-1]), (hh, ww)

    def _posenc_for(self, tokens: torch.Tensor) -> torch.Tensor:
        s, d = tokens.shape[-2], tokens.shape[-1]
        key = (s, d, tokens.device, tokens.dtype)
        if key not in self._posenc:
            self._posenc[key] = torch.from_numpy(sinusoidal_posenc(s, d)).to(
                device=tokens.device, dtype=tokens.dtype)
        return self._posenc[key]

    def temporal_mix(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Temporal transformer over (B, S, D) tokens (+ optional posenc)."""
        if self.config.use_posenc:
            tokens = tokens + self._posenc_for(tokens)[None]
        return self.temporal(tokens, mask=mask, generator=generator)

    def decode_tokens(self, tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """(B, T*tpf, D) tokens -> (B, T, H, W, C') reconstructed frames."""
        b = tokens.shape[0]
        cc = self.config.tokens_per_frame
        t = tokens.shape[1] // cc
        latent = tokens_to_latent(tokens.reshape(b * t, cc, tokens.shape[-1]), hw)
        recon = self.decoder(latent)  # (B*T, C', H, W)
        return layout.unfold_time(layout.nchw_to_nhwc(recon), b)

    def forward(self, clip: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """clip: (B, T, H, W, C) -> (tokens (B, T*tpf, D), recon (B, T, H, W, C'))."""
        tokens, hw = self.encode_clip(clip, generator=generator)
        tokens = self.temporal_mix(tokens, mask=mask, generator=generator)
        return tokens, self.decode_tokens(tokens, hw)
