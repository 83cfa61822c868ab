"""Pooling and resampling primitives over NCHW, and the bias of mixed
precision.

Counterparts of ``tchvp_tpu/ops/basic.py``: flax's ``max_pool`` and
``avg_pool`` with a 2x2 window, stride 2 and VALID padding (an odd last row
or column is dropped), and the nearest-neighbour 2x upsample. Under
``torch.autocast`` a biased layer rounds as flax's does: the product in the
compute dtype, then the bias added in it (:func:`add_bias`;
``ops/blocks.py``, ``parallel/tp.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool over NCHW."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool over NCHW (FCT's image pyramid)."""
    return F.avg_pool2d(x, kernel_size=2, stride=2)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample over NCHW: each pixel becomes a 2x2
    block."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def autocast_enabled(x: torch.Tensor) -> bool:
    """Whether autocast is on for ``x``'s device type."""
    return torch.is_autocast_enabled(x.device.type)


def add_bias(y: torch.Tensor, bias: torch.Tensor, channel_dim: int) -> torch.Tensor:
    """``y + bias`` in y's dtype, the bias along ``channel_dim`` of y."""
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(y.dtype).reshape(shape)
