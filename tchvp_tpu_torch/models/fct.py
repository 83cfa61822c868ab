"""FCT, the Fully Convolutional Transformer U-Net (reference
``FCT.py:210-254``): image -> segmentation mask.

Counterpart of ``tchvp_tpu/models/fct.py``, with its module names: 5
multi-scale-input encoder blocks (``block_1`` .. ``block_5``), 4
skip-connected decoder blocks (``block_6`` .. ``block_9``) and the
deep-supervision sigmoid head (``ds``). Every block ends in a
:class:`~tchvp_tpu_torch.ops.conv_attention.SpatialTransformer`, whose
H*W-token attention runs the flash kernels on CUDA under ``"auto"``.

The public layouts are the JAX package's: image ``(B, H, W, C)`` in, mask
``(B, H, W, out_channels)`` out; the convolutions run NCHW. H and W must be
multiples of 32. Dropout (``dropout_rate`` per block, 0.1 in each
Wide-Focus branch) and drop-path (``stochastic_depth_rate`` on the
reference's linspace schedule) act in train mode and draw from the
generator the forward is given.

``compute_dtype`` is mixed precision, the counterpart of flax's
``FCT(dtype=bfloat16)`` over fp32 parameters: the forward runs under
``torch.autocast``; biased layers round their product, then add their
bias (``ops/blocks.py``); attention logits and softmax are fp32; each
LayerNorm computes in fp32 and hands its output on in the compute dtype.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from tchvp_tpu_torch import layout
from tchvp_tpu_torch.config import FCTConfig
from tchvp_tpu_torch.ops.basic import avg_pool_2x2, max_pool_2x2, upsample2x_nearest
from tchvp_tpu_torch.ops.blocks import dropout, init_flax_default
from tchvp_tpu_torch.ops.conv_attention import PaddedConv2d, SpatialTransformer


def _conv3x3(in_ch: int, out_ch: int) -> PaddedConv2d:
    return PaddedConv2d(in_ch, out_ch, 3)


def _unported_axes(cfg: FCTConfig) -> None:
    for name, value in (("attn_impl='ring'", cfg.attn_impl == "ring"), ("seq_axis", cfg.seq_axis),
                        ("sp_axis", cfg.sp_axis)):
        if value:
            raise NotImplementedError(
                f"FCTConfig {name} is not ported yet (ROADMAP.md, modules to port, item 11: "
                "parallelism)")


class BlockEncoderBottleneck(nn.Module):
    """FCT encoder or bottleneck block (reference ``FCT.py:136-162``).

    "first" and "bottleneck": two 3x3 convs on x (``in_channels``). The
    others: a 3x3 conv of the scaled image (``image_channels`` ->
    ``in_channels``) joined to x, then two 3x3 convs. Then dropout, a 2x2
    max pool and the spatial transformer."""

    def __init__(self, blk: str, in_channels: int, out_channels: int, att_heads: int,
                 image_channels: int = 3, dropout_rate: float = 0.3, attn_impl: str = "xla",
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.blk = blk
        self.dropout_rate = dropout_rate
        if blk in ("first", "bottleneck"):
            self.conv1_a = _conv3x3(in_channels, out_channels)
            self.conv2 = _conv3x3(out_channels, out_channels)
        else:
            self.conv1_b = _conv3x3(image_channels, in_channels)
            self.conv2 = _conv3x3(2 * in_channels, out_channels)
            self.conv3 = _conv3x3(out_channels, out_channels)
        self.trans = SpatialTransformer(out_channels, att_heads, attn_impl=attn_impl,
                                        drop_path_rate=drop_path_rate)

    def forward(self, x: torch.Tensor, scale_img: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.blk in ("first", "bottleneck"):
            x1 = torch.relu(self.conv2(torch.relu(self.conv1_a(x))))
        else:
            skip_x = torch.relu(self.conv1_b(scale_img))
            x1 = torch.relu(self.conv2(torch.cat([skip_x, x], dim=1)))
            x1 = torch.relu(self.conv3(x1))
        if self.training and self.dropout_rate > 0.0:
            x1 = dropout(x1, self.dropout_rate, generator)
        return self.trans(max_pool_2x2(x1), generator)


class BlockDecoder(nn.Module):
    """FCT decoder block (reference ``FCT.py:167-186``): 2x nearest
    upsample, a 3x3 conv, the skip joined before it, two 3x3 convs,
    dropout and the spatial transformer."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int, att_heads: int,
                 dropout_rate: float = 0.3, attn_impl: str = "xla", drop_path_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv1 = _conv3x3(in_channels, out_channels)
        self.conv2 = _conv3x3(skip_channels + out_channels, out_channels)
        self.conv3 = _conv3x3(out_channels, out_channels)
        self.trans = SpatialTransformer(out_channels, att_heads, attn_impl=attn_impl,
                                        drop_path_rate=drop_path_rate)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x1 = torch.relu(self.conv1(upsample2x_nearest(x)))
        x1 = torch.relu(self.conv2(torch.cat([skip, x1], dim=1)))
        x1 = torch.relu(self.conv3(x1))
        if self.training and self.dropout_rate > 0.0:
            x1 = dropout(x1, self.dropout_rate, generator)
        return self.trans(x1, generator)


class DSOut(nn.Module):
    """Deep-supervision sigmoid head (reference ``FCT.py:191-206``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _conv3x3(in_channels, in_channels)
        self.conv2 = _conv3x3(in_channels, in_channels)
        self.conv3 = _conv3x3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = torch.relu(self.conv1(upsample2x_nearest(x)))
        x1 = torch.relu(self.conv2(x1))
        return torch.sigmoid(self.conv3(x1))


class FCT(nn.Module):
    """The 9-block FCT segmentation model over ``in_channels``-channel
    images (flax infers that from its example input; here it is given).

    Weights are initialised like flax's defaults from ``generator`` (a
    fresh ``torch.Generator`` seeded 0 when None) on the CPU, in fp32, then
    moved to ``device``. Entry points run on the card unless the caller
    asks for the CPU. ``compute_dtype``: module docstring."""

    def __init__(self, config: FCTConfig = FCTConfig(), *, in_channels: int = 3,
                 device: torch.device | str = "cuda", generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _unported_axes(config)
        self.config = config
        self.compute_dtype = compute_dtype
        f = list(config.filters)
        if len(f) != 9:
            raise ValueError(f"FCT takes 9 filter widths, got {len(f)}")
        n = len(f)
        # Per-block drop-path schedule (FCT.py:217-218 linspace).
        dpr = [config.stochastic_depth_rate * i / (n - 1) for i in range(n)]
        common = dict(att_heads=config.att_heads, dropout_rate=config.dropout_rate,
                      attn_impl=config.attn_impl)
        for i, (blk, cin) in enumerate((("first", in_channels), ("second", f[0]), ("third", f[1]),
                                        ("fourth", f[2]), ("bottleneck", f[3]))):
            self.add_module(f"block_{i + 1}", BlockEncoderBottleneck(
                blk, cin, f[i], image_channels=in_channels, drop_path_rate=dpr[i], **common))
        for i in range(5, 9):
            self.add_module(f"block_{i + 1}", BlockDecoder(
                f[i - 1], f[8 - i], f[i], drop_path_rate=dpr[i], **common))
        self.ds = DSOut(f[8], config.out_channels)
        init_flax_default(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def _compute(self, x: torch.Tensor):
        """The autocast scope of ``compute_dtype`` (a no-op without one)."""
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=self.compute_dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) image -> (B, H, W, out_channels) mask in [0, 1].
        Train mode with dropout on draws from ``generator``."""
        h, w = x.shape[1], x.shape[2]
        if h % 32 or w % 32:
            raise ValueError(f"FCT input spatial dims must be divisible by 32 "
                             f"(5 encoder downsamples); got {h}x{w}")
        with self._compute(x):
            return layout.nchw_to_nhwc(self._forward(layout.nhwc_to_nchw(x).contiguous(), generator))

    def _forward(self, x: torch.Tensor, g: Optional[torch.Generator]) -> torch.Tensor:
        # Multi-scale input pyramid (FCT.py:238-240).
        scale_img_2 = avg_pool_2x2(x)
        scale_img_3 = avg_pool_2x2(scale_img_2)
        scale_img_4 = avg_pool_2x2(scale_img_3)
        x1 = self.block_1(x, generator=g)
        x2 = self.block_2(x1, scale_img_2, generator=g)
        x3 = self.block_3(x2, scale_img_3, generator=g)
        x4 = self.block_4(x3, scale_img_4, generator=g)
        h = self.block_5(x4, generator=g)
        h = self.block_6(h, x4, generator=g)
        h = self.block_7(h, x3, generator=g)
        h = self.block_8(h, x2, generator=g)
        h = self.block_9(h, x1, generator=g)
        return self.ds(h)
