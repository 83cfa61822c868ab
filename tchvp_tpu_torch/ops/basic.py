"""Pooling and resampling primitives over NCHW.

Counterparts of ``tchvp_tpu/ops/basic.py``: flax's ``max_pool`` and
``avg_pool`` with a 2x2 window, stride 2 and VALID padding (an odd last row
or column is dropped), and the nearest-neighbour 2x upsample.
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
