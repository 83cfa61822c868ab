"""Sobel edge visualization on the device.

Counterpart of ``tchvp_tpu/ops/sobel.py`` (reference ``FCT.py:398-402``,
``scipy.ndimage.sobel`` on the host there): reflect padding, the axis-0
and axis-1 3x3 pair per channel, the gradient magnitude, normalised by
its maximum. A maximum below ``SobelConfig.edge_floor_rel`` of the input's
range (a flat input, or rounding residue on one) gives zeros. No host
sync: the floor is a ``torch.where`` on the device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tchvp_tpu_torch.config import SobelConfig

_KY = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel_edges(x: torch.Tensor, config: Optional[SobelConfig] = None) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C) fp32 gradient magnitude in [0, 1]."""
    cfg = config or SobelConfig()
    b, h, w, c = x.shape
    xf = x.float()
    ky = torch.tensor(_KY, dtype=torch.float32, device=x.device)
    kern = torch.stack([ky, ky.T]).unsqueeze(1).repeat(c, 1, 1, 1)  # (2C, 1, 3, 3)
    xpad = F.pad(xf.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    g = F.conv2d(xpad, kern, groups=c).reshape(b, c, 2, h, w)
    mag = torch.sqrt(torch.sum(g * g, dim=2)).permute(0, 2, 3, 1)
    mx = mag.max()
    floor = cfg.edge_floor_rel * torch.clamp(xf.abs().max(), min=cfg.eps)
    return torch.where(mx > floor, mag / torch.maximum(mx, floor), torch.zeros_like(mag))
