"""Flagship video pipeline: per-frame CNN encoder -> temporal transformer ->
per-frame CNN decoder.

Counterpart of ``tchvp_tpu/models/video.py``. Frames fold into the batch
for the convs (NCHW on cuDNN); each frame's 8 latent channels become
temporal tokens of dim (H/4)*(W/4), concatenated over the clip. The public
layouts are the JAX package's: clip ``(B, T, H, W, 3)``, tokens
``(B, T*8, (H/4)*(W/4))``, recon ``(B, T, H, W, C')``.

Sequence parallelism (``config.temporal.seq_axis`` under a mesh carrying
the axis): the clip a rank is given is its contiguous block of each clip's
frames (``parallel.mesh.shard_frames``). The encoder and decoder run per
frame; train-mode BatchNorm takes its statistics over the axis; the
positional encoding is the global sequence's rows of this block; dropout
draws are made for the whole clip, the same on every rank, each keeping its
part. JAX's arrays are global under GSPMD, so this is what it computes.

Tensor parallelism (``config.encoder.tp_axis`` and ``config.temporal.tp_axis``,
the ``model`` axis of ``flagship_video_config(tp_axis=)``, under a mesh
carrying it): the encoder and decoder compute each rank's block of their
channels (``models/resnet_ae.py``), the latent is gathered whole before it
becomes tokens, and the transformer runs its heads and FFN hidden dim in
blocks (``models/transformer.py``); every rank is given the same clip and
ends with the same reconstruction.

Spatial partitioning (``config.encoder.sp_axis``, the ``spatial`` axis of
``flagship_video_config(sp_axis=)``, under a mesh carrying it): every rank
is given the same clip; the encoder and decoder run on this rank's block of
each frame's rows (``models/resnet_ae.py``), the latent is gathered whole
before it becomes tokens, the transformer runs whole on every rank, and
the decoder slices the latent again and gathers the reconstruction whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

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
from tchvp_tpu_torch.models.transformer import TransformerDraws, TransformerEncoder
from tchvp_tpu_torch.ops.blocks import BatchNorm, init_flax_default, set_tp_axis
from tchvp_tpu_torch.ops.moe import MoEStats
from tchvp_tpu_torch.parallel import spatial, tp
from tchvp_tpu_torch.parallel.mesh import axis_shards


def sinusoidal_posenc(seq_len: int, dim: int) -> np.ndarray:
    """Standard sinusoidal positional encoding, (seq_len, dim) float32."""
    position = np.arange(seq_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, dim, 2).astype(np.float32) * (-np.log(10000.0) / dim))
    pe = np.zeros((seq_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe


@dataclasses.dataclass
class VideoDraws:
    """All dropout randomness of one train-mode pass, drawn before it runs:
    the encoder's Dropout2d mask and the temporal transformer's draws."""

    latent_keep: Optional[torch.Tensor]
    temporal: TransformerDraws


class VideoHybridNet(nn.Module):
    """CNN spatial compression + transformer temporal mixing + CNN decode.

    Weights are initialised like flax's defaults from ``generator`` (a
    fresh ``torch.Generator`` seeded 0 when None) on the CPU, then moved to
    ``device`` and ``dtype``. Entry points run on the card unless the
    caller asks for the CPU.

    ``dtype`` casts the parameters themselves (the serving models).
    ``compute_dtype`` is mixed precision for training, the counterpart of
    the JAX package's ``VideoHybridNet(dtype=bfloat16)`` with its default
    fp32 ``param_dtype``: the parameters stay in ``dtype`` (the master
    copy AdamW updates) and each stage runs under ``torch.autocast``, which
    casts every conv's and matmul's inputs and weights to
    ``compute_dtype`` as flax's layers cast theirs. The rounding points
    are flax's: a biased layer rounds its product, then adds its bias
    (``ops/blocks.py``); attention logits and softmax are fp32; BatchNorm
    and LayerNorm compute in fp32 from the bf16 activations and hand their
    output on in bf16; the running stats stay fp32.

    In train mode every dropout's randomness comes from one
    :class:`VideoDraws`, drawn up front (:meth:`draw_dropout`) the way the
    JAX step splits its dropout key before the forward, so that the stages
    can be recomputed under ``torch.utils.checkpoint`` with the same masks.
    """

    def __init__(self, config: VideoModelConfig = VideoModelConfig(), *,
                 device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.encoder = Encoder32K(config.encoder)
        self.temporal = TransformerEncoder(config.temporal)
        self.decoder = Decoder32K(output_type=config.output_type,
                                  latent_channels=config.encoder.squeeze_features[-1])
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.seq_axis = config.temporal.seq_axis
        set_tp_axis(self.encoder, config.encoder.tp_axis)
        set_tp_axis(self.decoder, config.encoder.tp_axis)
        spatial.set_sp_axis(self.encoder, config.encoder.sp_axis)
        spatial.set_sp_axis(self.decoder, config.encoder.sp_axis)
        self._posenc: Dict[Tuple, torch.Tensor] = {}
        self.to(device=device, dtype=dtype)

    def draw_dropout(self, clip_shape: torch.Size, generator: Optional[torch.Generator],
                     device: torch.device, has_mask: bool = False) -> VideoDraws:
        """The dropout randomness of one train-mode pass over a clip of
        ``clip_shape`` (B, T, H, W, C), drawn from ``generator``; under
        sequence parallelism (module docstring) T is this rank's frames."""
        b, t, h, w = clip_shape[:4]
        n, i = axis_shards(self.config.temporal.seq_axis)
        latent_keep = self.encoder.draw_dropout(b * t * n, generator, device)
        if latent_keep is not None and n > 1:
            latent_keep = latent_keep.reshape((b, n * t) + latent_keep.shape[1:])[:, i * t:(i + 1) * t]
            latent_keep = latent_keep.reshape((b * t,) + latent_keep.shape[2:])
        s = t * self.config.tokens_per_frame
        d = (h // 4) * (w // 4)
        return VideoDraws(latent_keep,
                          self.temporal.draw_dropout((b, s, d), generator, device, has_mask))

    def _compute(self, x: torch.Tensor):
        """The autocast scope of ``compute_dtype`` (a no-op without one)."""
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=self.compute_dtype)

    def encode_clip(self, clip: torch.Tensor, generator: Optional[torch.Generator] = None,
                    draws: Optional[VideoDraws] = None) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """(B, T, H, W, C) -> (tokens (B, T*tpf, D), latent (hh, ww))."""
        with self._compute(clip):
            return self._encode_clip(clip, generator, draws)

    def _encode_clip(self, clip, generator, draws):
        b, t = clip.shape[0], clip.shape[1]
        frames = layout.nhwc_to_nchw(layout.fold_time(clip))  # (B*T, C, H, W)
        keep = draws.latent_keep if draws is not None else None
        sp = self.config.encoder.sp_axis
        with spatial.rows(sp, frames.shape[2], self.encoder.row_factor()):
            latent = self.encoder(frames, generator=generator, keep=keep)
            latent = tp.to_replicated(latent, self.config.encoder.tp_axis, self.config.encoder.squeeze_features[-1])
            latent = spatial.gather_rows(latent, sp)
        _, cc, hh, ww = latent.shape
        tokens = latent_to_tokens(latent)  # (B*T, C', hh*ww)
        return tokens.reshape(b, t * cc, tokens.shape[-1]), (hh, ww)

    def _posenc_for(self, tokens: torch.Tensor) -> torch.Tensor:
        """The (S, D) encoding of ``tokens``; under sequence parallelism
        rows [i S, (i + 1) S) of the n S global positions."""
        s, d = tokens.shape[-2], tokens.shape[-1]
        n, i = axis_shards(self.config.temporal.seq_axis)
        key = (s, d, n, i, tokens.device, tokens.dtype)
        if key not in self._posenc:
            table = sinusoidal_posenc(n * s, d)[i * s:(i + 1) * s]
            self._posenc[key] = torch.from_numpy(table).to(device=tokens.device, dtype=tokens.dtype)
        return self._posenc[key]

    def temporal_mix(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[VideoDraws] = None,
                     moe_sink: Optional[List[MoEStats]] = None) -> torch.Tensor:
        """Temporal transformer over (B, S, D) tokens (+ optional posenc);
        its MoE layers append their stats to ``moe_sink`` when given."""
        with self._compute(tokens):
            if self.config.use_posenc:
                tokens = tokens + self._posenc_for(tokens)[None]
            return self.temporal(tokens, mask=mask, generator=generator,
                                 draws=draws.temporal if draws is not None else None,
                                 moe_sink=moe_sink)

    def decode_tokens(self, tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """(B, T*tpf, D) tokens -> (B, T, H, W, C') reconstructed frames."""
        b = tokens.shape[0]
        cc = self.config.tokens_per_frame
        t = tokens.shape[1] // cc
        with self._compute(tokens):
            latent = tokens_to_latent(tokens.reshape(b * t, cc, tokens.shape[-1]), hw)
            recon = self.decoder(latent)  # (B*T, C', H, W)
            return layout.unfold_time(layout.nchw_to_nhwc(recon), b)

    def forward(self, clip: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[VideoDraws] = None,
                moe_sink: Optional[List[MoEStats]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """clip: (B, T, H, W, C) -> (tokens (B, T*tpf, D), recon (B, T, H, W, C')).

        Train mode takes ``draws``, or draws them from ``generator`` first.
        ``moe_sink``: a list the MoE layers append their stats to."""
        if self.training and draws is None:
            draws = self.draw_dropout(clip.shape, generator, clip.device, mask is not None)
        tokens, hw = self.encode_clip(clip, draws=draws)
        tokens = self.temporal_mix(tokens, mask=mask, draws=draws, moe_sink=moe_sink)
        return tokens, self.decode_tokens(tokens, hw)
