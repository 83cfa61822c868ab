"""FCT building blocks: conv-projection attention, the Wide-Focus FFN and
the spatial transformer, over NCHW feature maps.

Counterparts of ``tchvp_tpu/ops/conv_attention.py`` (reference
``FCT.py:24-132``), with its parameter names:

* depthwise 3x3 conv q/k/v projections (``groups=C``), ReLU and a
  LayerNorm over the channels;
* the H*W pixels as tokens of C features, in JAX's NHWC order (row-major
  over (h, w)): from NCHW that is ``x.flatten(2).transpose(1, 2)``, and
  the output goes back through (B, hq, wq, C); non-square maps work;
* :class:`~tchvp_tpu_torch.ops.attention.TorchMultiheadAttention` at the
  1/sqrt(Dh) scale, whose ``"auto"`` takes the flash kernels on CUDA;
* the multi-dilation conv FFN with exact GELU (:func:`gelu`);
* attention -> conv -> residual -> LayerNorm -> FFN -> residual.

Padding follows flax: "SAME" pads (total // 2) before and the rest after,
so at a stride above 1 it may be asymmetric, which torch's
``padding="same"`` refuses (:class:`PaddedConv2d` pads explicitly then).
The k/v projections pad by ``stride_kv``, an int, as the reference's do
(``FCT.py:33,35``); ``padding_kv`` is accepted and unused. With
``stride_kv > 1`` k and v have fewer tokens than q: the dense core
computes that, the flash kernels raise (as JAX's ``mha`` does).

Under autocast (a model's ``compute_dtype``) each LayerNorm computes in
fp32 and hands its output on in the compute dtype, as flax's
``LayerNorm(dtype=bfloat16)`` rounds it. Dropout and drop-path act in
train mode only and draw from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tchvp_tpu_torch.ops.attention import TorchMultiheadAttention
from tchvp_tpu_torch.ops.blocks import Conv2d, dropout

LN_EPS = 1e-5
Padding = Union[str, int]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU: ``F.gelu(approximate="none")`` in fp32; in a lower
    precision (a compute dtype) as ``jax.nn.gelu(approximate=False)``
    rounds it, 0.5 * x * erfc(-x * sqrt(1/2)) with the constant and each
    step in x's dtype."""
    if x.dtype in (torch.float32, torch.float64):
        return F.gelu(x, approximate="none")
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype).item()
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), the pixels in row-major (h, w) order."""
    return x.flatten(2).transpose(1, 2)


def from_tokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) tokens -> (B, C, H, W), contiguous."""
    b, _, c = t.shape
    return t.transpose(1, 2).reshape(b, c, h, w)


def token_layer_norm(norm: nn.LayerNorm, t: torch.Tensor) -> torch.Tensor:
    """``norm`` over the last dim, handed on in t's dtype (autocast returns
    fp32 on CUDA; flax rounds to the compute dtype)."""
    return norm(t).to(t.dtype)


def channel_layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` over the channels of an NCHW map, per pixel."""
    h, w = x.shape[2:]
    return from_tokens(token_layer_norm(norm, to_tokens(x)), h, w)


def flax_pads(size: int, kernel: int, stride: int, padding: Padding,
              dilation: int = 1) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim as flax's ``nn.Conv``
    pads it: "SAME" (output ceil(size / stride)), "VALID", or an int on
    both sides."""
    if isinstance(padding, int):
        return padding, padding
    mode = padding.upper()
    if mode == "VALID":
        return 0, 0
    if mode != "SAME":
        raise ValueError(f"padding must be 'same', 'valid' or an int, got {padding!r}")
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class PaddedConv2d(Conv2d):
    """A square-kernel :class:`~tchvp_tpu_torch.ops.blocks.Conv2d` padded
    as flax pads (:func:`flax_pads`): by the conv itself where the padding
    is symmetric whatever the input size (an int, "VALID", "SAME" at stride
    1), else by ``F.pad`` before it (stride > 1 "SAME")."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME", dilation: int = 1, groups: int = 1, bias: bool = True):
        flax_pads(kernel, kernel, stride, padding, dilation)  # validates
        static = None
        if isinstance(padding, int) or padding.upper() == "VALID":
            static = flax_pads(0, kernel, stride, padding, dilation)[0]
        elif stride == 1 and (kernel - 1) * dilation % 2 == 0:
            static = (kernel - 1) * dilation // 2
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=static or 0,
                         dilation=dilation, groups=groups, bias=bias)
        self.flax_padding = None if static is not None else padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.flax_padding is not None:
            k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
            top, bottom = flax_pads(x.shape[2], k, s, self.flax_padding, d)
            left, right = flax_pads(x.shape[3], k, s, self.flax_padding, d)
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


class ConvProjAttention(nn.Module):
    """Conv-projected spatial self-attention over NCHW maps (reference
    ``FCT.py:25``): depthwise 3x3 projections of q (stride ``stride_q``,
    padding ``padding_q``) and k, v (stride and padding ``stride_kv``), each
    through ReLU and a LayerNorm over the channels, then
    :class:`TorchMultiheadAttention` over the pixels; the output has q's
    spatial size. JAX's ``use_bias``, ``kernel_size`` and ``proj_drop`` keep
    their defaults: no caller sets them."""

    def __init__(self, channels: int, num_heads: int, attn_impl: str = "xla", stride_q: int = 1,
                 stride_kv: int = 1, padding_q: Padding = "same", padding_kv: Padding = "same"):
        super().__init__()
        del padding_kv  # dead in the reference too

        def depthwise(stride: int, padding: Padding) -> PaddedConv2d:
            return PaddedConv2d(channels, channels, 3, stride=stride, padding=padding, groups=channels)

        self.conv_q = depthwise(stride_q, padding_q)
        self.conv_k = depthwise(stride_kv, stride_kv)
        self.conv_v = depthwise(stride_kv, stride_kv)
        self.layernorm_q = nn.LayerNorm(channels, eps=LN_EPS)
        self.layernorm_k = nn.LayerNorm(channels, eps=LN_EPS)
        self.layernorm_v = nn.LayerNorm(channels, eps=LN_EPS)
        self.attention = TorchMultiheadAttention(channels, num_heads, impl=attn_impl)

    @staticmethod
    def _project(conv: nn.Module, norm: nn.LayerNorm, x: torch.Tensor):
        y = torch.relu(conv(x))
        return token_layer_norm(norm, to_tokens(y)), y.shape[2:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, (hq, wq) = self._project(self.conv_q, self.layernorm_q, x)
        k, _ = self._project(self.conv_k, self.layernorm_k, x)
        v, _ = self._project(self.conv_v, self.layernorm_v, x)
        return from_tokens(self.attention(q, k, v), hq, wq)


class WideFocus(nn.Module):
    """Multi-dilation conv FFN (reference ``FCT.py:107-132``): three 3x3
    convs at dilation 1, 2 and 3, each through exact GELU and dropout,
    summed, then a 3x3 conv, exact GELU and dropout. ``dropout_rate`` is
    0.1 in every FCT block, as in JAX."""

    def __init__(self, features: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv1 = PaddedConv2d(features, features, 3, dilation=1)
        self.conv2 = PaddedConv2d(features, features, 3, dilation=2)
        self.conv3 = PaddedConv2d(features, features, 3, dilation=3)
        self.conv4 = PaddedConv2d(features, features, 3)

    def _act(self, y: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        y = gelu(y)
        if self.training and self.dropout_rate > 0.0:
            y = dropout(y, self.dropout_rate, generator)
        return y

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        added = (self._act(self.conv1(x), generator) + self._act(self.conv2(x), generator)
                 + self._act(self.conv3(x), generator))
        return self._act(self.conv4(added), generator)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth: zero a residual branch per sample with
    probability ``rate``, scaling the survivors by 1/(1-rate)."""
    return dropout(x, rate, generator, shape=(x.shape[0],) + (1,) * (x.dim() - 1))


class SpatialTransformer(nn.Module):
    """Attention -> 3x3 conv -> residual -> LayerNorm -> WideFocus ->
    residual (reference ``FCT.py:84-102``). ``drop_path_rate`` gates the
    two residual branches per sample in train mode (0.0: never)."""

    def __init__(self, channels: int, num_heads: int, attn_impl: str = "xla",
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.attention_output = ConvProjAttention(channels, num_heads, attn_impl=attn_impl)
        self.conv1 = PaddedConv2d(channels, channels, 3)
        self.layernorm = nn.LayerNorm(channels, eps=LN_EPS)
        self.wide_focus = WideFocus(channels)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x1 = self.conv1(self.attention_output(x))
        sd_active = self.drop_path_rate > 0.0 and self.training
        if sd_active:
            x1 = drop_path(x1, self.drop_path_rate, generator)
        x2 = x1 + x
        x3 = self.wide_focus(channel_layer_norm(self.layernorm, x2), generator)
        if sd_active:
            x3 = drop_path(x3, self.drop_path_rate, generator)
        return x2 + x3
